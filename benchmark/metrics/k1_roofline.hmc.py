"""K1 (``csrc/ckb_fold.cu``) in the traced update: the bound of its counted
launches (bytes and operations of ``counts.ops`` at each launch's shape)
over their device time in the profiler's trace, in %."""

from harness.kernels import roofline


def read(record):
    return roofline(record, "fold")
