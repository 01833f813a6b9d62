"""Device seconds per update of the solves: the port's ``solve`` spans
(``dynamics/graphs.CGSolve.solve``, ``NonsymSolve.solve``: the block
replays, the host reads between them, the verification and a retry), each
from a CUDA event at its entry to one at its exit, in the traced update."""

from harness.port_spans import device_s


def read(record):
    return device_s(record, "solve")
