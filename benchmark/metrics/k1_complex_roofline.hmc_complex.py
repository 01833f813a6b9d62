"""K1 (``csrc/ckb_fold.cu``) in its complex mode in the traced update: the
bound of its counted complex launches over their device time in the
profiler's trace (``ckb_fold_kernel<ckb::cplx<…>…>``), in %. The bound is
summed per (form, shape) from the port's launch counts per shape
(``ckb_cuda.launch_shapes``: the ``fold/<table>/complex`` forms), with the
bytes and operations of ``counts.complex_ops``. None where the port keeps
no counts per shape, where they do not add up to the complex forms' counts
of the traced steps, or where the trace or the counts hold no complex
launch."""

from pathlib import Path

import torch

from counts import complex_ops
from harness import device as dev
from harness import spec

# the port's launch counts per (form, shape, dtype), or None
shape_counts = spec.load_reader("k1_roofline_by_shape.hmc",
                                Path(__file__).resolve().parent.parent).shape_counts


def traced(record) -> tuple[float, int]:
    """(seconds, launches) of K1's complex instantiations in the trace."""
    secs, n = 0.0, 0
    for name, (s, c) in record.trace.ops.items():
        if "ckb_fold_kernel<" in name and "cplx<" in name:
            secs, n = secs + s, n + c
    return secs, n


def bound(record, counts) -> tuple[float, int] | None:
    """(bound seconds of K1's counted complex launches, their number)."""
    m = record.model
    nb = m.bonds.pairs.shape[1]
    per_form: dict = {}
    total_s, total_n = 0.0, 0
    for (form, shape, dtype), n in counts.items():
        if not (form.startswith("fold/") and form.endswith("/complex")) or n == 0:
            continue
        item = torch.empty((), dtype=dtype).element_size()
        table = form.split("/")[1]
        total_s += n * dev.bound_s(complex_ops.k1_bytes(shape, table, nb, item),
                                   complex_ops.k1_flops(shape, nb, m.N))
        total_n += n
        per_form[form] = per_form.get(form, 0) + n
    launched = {f: n for f, n in record.trace_counts["table_launches"].items()
                if f.startswith("fold/") and f.endswith("/complex") and n}
    if per_form != launched or total_n == 0:
        return None
    return total_s, total_n


def read(record):
    if record.trace is None or record.trace_counts is None:
        return None
    counts = shape_counts()
    if counts is None:
        return None
    secs, n_traced = traced(record)
    b = bound(record, counts)
    if n_traced == 0 or secs <= 0 or b is None:
        return None
    bound_s, n_counted = b
    return 100.0 * (bound_s / n_counted) / (secs / n_traced)
