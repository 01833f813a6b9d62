"""The update's share (%) of the card's float32 peak: the operations the
window's updates need (``counts.ops.update_flops``: each chain's CG
iterations, as ``stats.iters`` reports them, and its Nt + 1 fermion forces,
counted from the configuration's shapes) over the window's seconds and
67 TFLOP/s."""

from counts import ops
from harness import device as dev


def read(record):
    if record.device.type != "cuda":
        return None
    m = record.model
    h = record.config.run["hmc"]
    Nt = max(1, round(float(h["trajectory_time"]) / float(h["dt"])))
    kpm = record.config.run["solver"].get("preconditioner")
    max_order = int(kpm.get("max_order", 64)) if kpm is not None else 0
    nb = m.bonds.pairs.shape[1]
    F = 2 * m.N * m.Lt
    total = 0.0
    for s in record.steps:
        for it in s["update"]["iters"].tolist():
            total += ops.update_flops(it * (Nt + 2), Nt + 1, F, m.Nph, m.Lt, max_order, nb, m.N)
    return 100.0 * total / record.window_s / dev.F32_FLOPS_PER_S
