"""The complex update's share (%) of the card's float32 peak: the real
operations the window's updates need (``counts.complex_ops.update_flops``,
each complex multiply-add 8: each chain's CG iterations, as ``stats.iters``
reports them, and its Nt + 1 fermion forces, counted from the
configuration's shapes) over the window's seconds and 67 TFLOP/s."""

from counts import complex_ops
from harness import device as dev


def max_order(run_cfg: dict) -> int:
    """The KPM cap the port runs: the file's ``max_order``, else the port's
    default (``ops/kpm.KPMConfig``); 0 without a preconditioner."""
    from elphdynamics_tpu_torch.ops.kpm import KPMConfig

    kpm = run_cfg["solver"].get("preconditioner")
    if kpm is None:
        return 0
    return int(kpm.get("max_order", KPMConfig().max_order))


def read(record):
    if record.device.type != "cuda":
        return None
    m = record.model
    h = record.config.run["hmc"]
    Nt = max(1, round(float(h["trajectory_time"]) / float(h["dt"])))
    order = max_order(record.config.run)
    nb = m.bonds.pairs.shape[1]
    F = m.N * m.Lt
    total = 0.0
    for s in record.steps:
        for it in s["complex_update"]["iters"].tolist():
            total += complex_ops.update_flops(it * (Nt + 2), Nt + 1, F, m.Nph, m.Lt, order,
                                              nb, m.N)
    return 100.0 * total / record.window_s / dev.F32_FLOPS_PER_S
