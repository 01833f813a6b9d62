"""Chain-updates per second: chains × whole HMC updates in the window ÷ the
window's seconds (host clock; the window ends at the first update that
finishes after the run's seconds, each update ending in a synchronise)."""


def read(record):
    return record.config.chains * len(record.steps) / record.window_s
