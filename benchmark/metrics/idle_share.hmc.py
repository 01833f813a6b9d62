"""Share (%) of the traced window in which no operation ran on the device:
1 − (union of device activity intervals ÷ the window), from the profiler."""


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
