"""Device seconds per update of the KPM preconditioner's applies inside
the solves: the ``kpm.apply`` marks the port captures in its graphs around
each apply a solve makes (``dynamics/graphs.CGSolve._P``,
``NonsymSolve._P``), as their share of each block graph's last replay
times that graph's device seconds in the traced update; a block graph is
one the ``solve`` spans replay (the apply of a solve's start, inside the
update's segments, is not counted)."""

from harness.port_spans import marked_s


def read(record):
    return marked_s(record, ("kpm.apply",), under="solve")
