"""The plain reference against the port's CPU path at a small lattice, and
the reference's independence from the port."""

import copy
import ast
from pathlib import Path

import pytest
import torch

from harness import spec
from harness.traffic import WINDOW, Traffic
from reference.hmc import HMC
from reference.models import Model


@pytest.mark.parametrize("config", ["holstein_64", "ssh_64"])
def test_reference_update_matches_the_port(config, tiny):
    from harness.program import Program

    name = config.split("_")[0]
    # the port solves to 1e-8: over the 100 steps a trajectory takes, its
    # solves at 1e-7 move ΔH by ~1e-6 (float64)
    ov = dict(tiny[name], **{"solver.tol": 1e-8})
    cfg = spec.load_config(config, overrides=ov)
    run = copy.deepcopy(cfg.run)
    model = Model(run, "cpu", torch.float64)
    prog = Program("hmc", run, cfg.chains, "float64", "cpu", 9)
    update = spec.load_module("parts", "update")
    traffic = Traffic(2 ** 33 + 5, model, cfg.chains, "cpu", torch.float64)
    x0 = traffic.initial_field()
    d = update.draws(traffic, WINDOW, 0)
    new, stats = prog.step(update, prog.state(x0), d)
    ref = HMC(model, run["hmc"], run.get("fourier_acceleration", []), tol=1e-10).update(
        x0, d.momentum, d.pseudofermion, d.uniform)
    assert torch.allclose(stats.delta_H, ref.dH, rtol=0, atol=1e-6)
    assert torch.equal(stats.accepted, ref.accept)
    for c in range(cfg.chains):
        want = ref.x[c] if ref.accept[c] else x0[c]
        assert (new.x[c] - want).norm() <= 1e-7 * want.norm()


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "dataclasses", "numpy", "torch",
                                  "reference"}, path.name


def test_checkerboard_groups_match_the_port():
    """The reference works out the port's checkerboard order again: its
    dense exp(−Δτ·K) equals the port's at 4×4 and 6×6."""
    from elphdynamics_tpu_torch.io.config import build_setup
    from elphdynamics_tpu_torch.ops import checkerboard as ckb

    for L in (4, 6):
        for config in ("holstein_64", "ssh_64"):
            cfg = spec.load_config(config, overrides={"lattice.L": L})
            run = copy.deepcopy(cfg.run)
            model = Model(run, "cpu", torch.float64)
            setup = build_setup(copy.deepcopy(cfg.run), "", "cpu", torch.float64)
            eye = torch.eye(model.N, dtype=torch.float64)[None, None]
            x = torch.zeros(1, model.Nph, model.N, dtype=torch.float64)
            mine = model.fold(model.coeffs(model.hopping(x)), eye)
            sp = setup.ops.spec
            t = torch.as_tensor(model.t_bond)[torch.as_tensor(sp.ckb_to_bond)]
            theirs = ckb.fold(sp.ckb, torch.cosh(model.dtau * t), torch.sinh(model.dtau * t),
                              eye)
            assert torch.allclose(mine, theirs, rtol=0, atol=1e-14)
