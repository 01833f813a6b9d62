"""Device seconds per update of the KPM preconditioner's set-up and
refreshes: the ``kpm.setup`` and ``kpm.refresh`` marks the port captures in
the update's segments (``dynamics/hmc.py``: ``precond.setup`` in the start,
``precond.refresh`` before each solve's start), as their share of each
graph's last replay times that graph's device seconds in the traced
update."""

from harness.port_spans import marked_s


def read(record):
    return marked_s(record, ("kpm.setup", "kpm.refresh"))
