"""Device seconds per update of the fermion force: the ``force`` marks the
port captures in the update's segments around each ``forces(...)`` call
(``dynamics/hmc.py``: the first, the middle and each step's), as their
share of each graph's last replay times that graph's device seconds in the
traced update."""

from harness.port_spans import marked_s


def read(record):
    return marked_s(record, ("force",))
