"""Host seconds per update waiting on a host read: the port's
``host_read`` spans (``solvers.host_any``: the solvers' loop flags and the
verification's flag, each waiting for the work queued before it) in the
traced update."""

from harness.port_spans import host_s


def read(record):
    return host_s(record, "host_read")
