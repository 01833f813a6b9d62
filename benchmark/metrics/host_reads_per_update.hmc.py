"""The port's host reads per update over the window (``solvers.host_reads``:
the solvers' loop flags and the verification's flag). A graphed update
replays one graph more than it reads."""


def read(record):
    if record.counters is None:
        return None
    return record.counters["host_reads"] / len(record.steps)
