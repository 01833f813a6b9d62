"""Host seconds per update inside ``CUDAGraph.replay()``: the port's
``graph.replay`` spans (``dynamics/graphs.UpdateGraphs.replay``) in the
traced update. The host launching a graph of many nodes while the device
waits shows here."""

from harness.port_spans import host_s


def read(record):
    return host_s(record, "graph.replay")
