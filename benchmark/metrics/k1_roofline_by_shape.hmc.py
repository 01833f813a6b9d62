"""K1 (``csrc/ckb_fold.cu``) in the traced update, as ``k1_roofline.hmc``
reckons it (``harness/kernels.py``: the counted launches' bound over their
traced time, in %), with the bound summed per (form, shape) from the
port's launch counts per shape (``ckb_cuda.launch_shapes``, a count per
(form, field shape, dtype)), so that a form launched at two shapes is
read too. None where the port keeps shapes without counts, where the
counts per shape do not add up to the counts per form of the traced
steps, or where a complex launch was counted."""

import torch

from counts import ops
from harness import device as dev
from harness.kernels import traced_launches


def shape_counts():
    """The port's launch counts per (form, shape, dtype), or None."""
    try:
        from elphdynamics_tpu_torch.ops import ckb_cuda
    except ImportError:
        return None
    counts = ckb_cuda.launch_shapes
    return dict(counts) if isinstance(counts, dict) else None


def bound(record, counts) -> tuple[float, int] | None:
    """(bound seconds of K1's counted launches, their number), or None."""
    m = record.model
    nb = m.bonds.pairs.shape[1]
    per_form: dict = {}
    total_s, total_n = 0.0, 0
    for (form, shape, dtype), n in counts.items():
        if not form.startswith("fold/") or n == 0:
            continue
        if form.endswith("/complex"):
            return None
        item = torch.empty((), dtype=dtype).element_size()
        table = form.split("/")[1]
        total_s += n * dev.bound_s(ops.k1_bytes(shape, table, nb, item),
                                   ops.k1_flops(shape, nb, m.N))
        total_n += n
        per_form[form] = per_form.get(form, 0) + n
    launched = {f: n for f, n in record.trace_counts["table_launches"].items()
                if f.startswith("fold/") and n}
    if per_form != launched or total_n == 0:
        return None
    return total_s, total_n


def read(record):
    if record.trace is None or record.trace_counts is None:
        return None
    counts = shape_counts()
    if counts is None:
        return None
    secs, n_traced = traced_launches(record, "fold")
    b = bound(record, counts)
    if n_traced == 0 or secs <= 0 or b is None:
        return None
    bound_s, n_counted = b
    return 100.0 * (bound_s / n_counted) / (secs / n_traced)
