"""Chebyshev steps of the complex KPM recurrence per update: the port's
counter ``ops/kpm.cheb_steps["complex"]`` (one count per step, counted
again by each graph replay), which ``parts/complex_update.port`` sets to 0
before each update, so after the trace it holds the traced update's steps.
None from a port without the counter, or without a trace."""


def read(record):
    if record.trace is None:
        return None
    try:
        from elphdynamics_tpu_torch.ops import kpm
    except ImportError:
        return None
    steps = getattr(kpm, "cheb_steps", None)
    if not isinstance(steps, dict) or "complex" not in steps:
        return None
    return float(steps["complex"])
