"""A checkerboard kernel's share of its roofline in the traced steps.

Time: the device intervals of the kernel's launches in the profiler's trace
of the traced steps (``ckb_fold_kernel<…>`` for K1, ``ckb_fold_fused_kernel<…>``
for K2): the kernel at the cell's own shapes, inside the update's graph
replays, among the operations around it. Bytes and operations: per launch,
from its field shape and table form (:mod:`counts.ops`), over the launches
the port counted in the same steps (``ckb_cuda.table_launches`` by form,
``launch_shapes`` for each form's shape). The share is the mean counted
launch's bound over the mean traced launch's time; where the trace holds
every launch this is the whole bound over the whole time. None where the
trace or the counts hold no launch of the kernel, where one form went
through more than one shape, or where a complex launch was counted.
"""

from __future__ import annotations

import math

import torch

from counts import ops
from harness import device as dev

TRACE_NAMES = {"fold": "ckb_fold_kernel<", "fused": "ckb_fold_fused_kernel<"}


def traced_launches(record, kernel: str) -> tuple[float, int]:
    """(seconds, launches) of ``kernel`` in the traced steps."""
    key = TRACE_NAMES[kernel]
    secs, n = 0.0, 0
    for name, (s, c) in record.trace.ops.items():
        if key in name:
            secs, n = secs + s, n + c
    return secs, n


def counted_bound(record, kernel: str) -> tuple[float, int] | None:
    """(bound seconds of all counted launches, their number) of ``kernel``
    in the traced steps, or None where it cannot be told."""
    m = record.model
    nb = m.bonds.pairs.shape[1]
    counts = record.trace_counts
    total_s, total_n = 0.0, 0
    for form, n in counts["table_launches"].items():
        if not form.startswith(f"{kernel}/") or n == 0:
            continue
        if form.endswith("/complex"):
            return None
        shapes = {(s, d) for f, s, d in counts["launch_shapes"] if f == form}
        if len(shapes) != 1:
            return None
        ((shape, dtype),) = shapes
        item = torch.empty((), dtype=dtype).element_size()
        table = form.split("/")[1]
        if kernel == "fold":
            b, f = ops.k1_bytes(shape, table, nb, item), ops.k1_flops(shape, nb, m.N)
        else:
            b, f = ops.k2_bytes(shape, table, nb, item), ops.k2_flops(shape, nb, m.N)
        total_s += n * dev.bound_s(b, f)
        total_n += n
    return (total_s, total_n) if total_n else None


def roofline(record, kernel: str) -> float | None:
    """``kernel``'s (``fold``: K1, ``fused``: K2) share (%) of its roofline
    in the traced steps; None where there is nothing to read."""
    if record.trace is None or record.trace_counts is None:
        return None
    secs, n_traced = traced_launches(record, kernel)
    bound = counted_bound(record, kernel)
    if n_traced == 0 or secs <= 0 or bound is None:
        return None
    bound_s, n_counted = bound
    share = 100.0 * (bound_s / n_counted) / (secs / n_traced)
    return share if math.isfinite(share) else None
