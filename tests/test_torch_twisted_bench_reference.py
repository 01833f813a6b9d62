"""The benchmark's plain complex reference (``benchmark/reference/twisted.py``,
which decides ``correct`` in the twisted-boundary cell) against the port's
CPU path: one HMC update of the twisted Holstein input at 4×4, β 4, 2
chains, from the benchmark's own initial field and draws; in float64 the
port holds to tolerances that a float32 port misses."""

import copy
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"

# what the float64 port holds to the reference, and a float32 run misses
DH_TOL, X_TOL = 1e-6, 1e-7


def port_and_reference(dtype: str):
    """One update of the port (``dtype``) and of the float64 reference:
    (widest |ΔH gap|, widest relative gap of the new field, same
    decisions)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    from harness import spec
    from harness.program import Program
    from harness.traffic import WINDOW, Traffic
    from reference.models import Model
    from reference.twisted import HMC, TwistedModel

    part = spec.load_module("parts", "complex_update")
    # the port solves to 1e-8: over the trajectory, solves at 1e-7 would
    # move ΔH by ~1e-6 (float64)
    cfg = spec.load_config("holstein_64_twisted",
                           overrides={"lattice.L": 4, "chains": 2, "solver.tol": 1e-8})
    run = copy.deepcopy(cfg.run)
    traffic = Traffic(2 ** 33 + 5, Model(run, "cpu", torch.float64), cfg.chains, "cpu",
                      torch.float64)
    x0 = traffic.initial_field()
    d = part.draws(traffic, WINDOW, 0)
    assert d.pseudofermion.dtype == torch.complex128
    prog = Program("hmc", run, cfg.chains, dtype, "cpu", 9)
    cplx = torch.complex128 if prog.dtype == torch.float64 else torch.complex64
    pd = type(d)(d.momentum.to(prog.dtype), d.pseudofermion.to(cplx), d.uniform)
    new, stats = prog.step(part, prog.state(x0.to(prog.dtype)), pd)
    ref = HMC(TwistedModel(run, "cpu"), run["hmc"], run.get("fourier_acceleration", []),
              tol=1e-10).update(x0, d.momentum, d.pseudofermion, d.uniform)
    dH_gap = float((stats.delta_H.double() - ref.dH).abs().max())
    x_gap = 0.0
    for c in range(cfg.chains):
        want = ref.x[c] if ref.accept[c] else x0[c]
        x_gap = max(x_gap, float((new.x[c].double() - want).norm() / want.norm()))
    return dH_gap, x_gap, torch.equal(stats.accepted, ref.accept)


def test_twisted_reference_update_matches_the_port():
    dH_gap, x_gap, same = port_and_reference("float64")
    assert dH_gap <= DH_TOL and x_gap <= X_TOL and same, (dH_gap, x_gap)


def test_float32_port_misses_the_tolerances():
    dH_gap, x_gap, _ = port_and_reference("float32")
    assert dH_gap > DH_TOL or x_gap > X_TOL, (dH_gap, x_gap)
