"""The HMC update of every chain of a complex-hopping configuration: the
port's ``example.step`` with draws made by the benchmark, checked against
the plain complex reference (``reference/twisted.py``).

As ``parts/update.py``, with the fermion fields complex: each update draws
the two spins' unit normals R↑, R↓ and packs them as the port does,
R = R↑ + i·R↓ ``[C, 1, N, Lτ]`` (``utils/dtypes.pseudofermion_noise``). The
numbers compared, for every chain of the step drawn, are the update part's
``dH_gap``, ``state_gap`` and ``accept_flips``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import torch

from harness import spec
from reference.twisted import HMC, TwistedModel

_update = spec.load_module("parts", "update", Path(__file__).resolve().parent.parent)

NUMBERS = _update.NUMBERS
STATS = _update.STATS
before, snapshot = _update.before, _update.snapshot


@dataclass(frozen=True)
class Draws:
    momentum: torch.Tensor        # [C, Nph, Lτ] unit normals, served dtype
    pseudofermion: torch.Tensor   # [C, 1, N, Lτ] R↑ + i·R↓, its complex type
    uniform: torch.Tensor         # [C] accept uniforms, float64


def draws(traffic, stream: int, step: int) -> Draws:
    m, C, dtype, device = traffic.model, traffic.C, traffic.dtype, traffic.device
    g = traffic.generator(stream, step)
    mom = torch.randn((C, m.Nph, m.Lt), generator=g, dtype=dtype, device=device)
    eta = torch.randn((C, 2, m.N, m.Lt), generator=g, dtype=dtype, device=device)
    uni = torch.rand((C,), generator=g, dtype=torch.float64, device=device)
    return Draws(mom, torch.complex(eta[:, 0:1], eta[:, 1:2]), uni)


def port(program, state, d: Draws):
    """The port's update; its complex Chebyshev-step count
    (``ops/kpm.cheb_steps``, where the port has it) set to 0 first, so the
    count read after a step is that update's."""
    from elphdynamics_tpu_torch.dynamics.hmc import HMCDraws
    from elphdynamics_tpu_torch.ops import kpm

    if hasattr(kpm, "reset_counts"):
        kpm.reset_counts()
    hd = HMCDraws(momentum=d.momentum, pseudofermion=d.pseudofermion, uniform=d.uniform)
    return program.example.step(program.example.params, state, None, hd)


def _reference(run_cfg: dict, model: TwistedModel, **kw) -> HMC:
    return HMC(model, run_cfg["hmc"], run_cfg.get("fourier_acceleration", []), **kw)


def control(ctrl, state, d: Draws):
    """The complex reference's update stored in bfloat16 (sums in float32),
    its solves to the input file's tolerance until their residual
    stalls."""
    sol = ctrl.run_cfg["solver"]
    hmc = ctrl.cached("complex_update", lambda: _reference(
        ctrl.run_cfg, TwistedModel(ctrl.run_cfg, ctrl.device, torch.bfloat16),
        tol=float(sol.get("tol", 1e-5)), maxiter=int(sol.get("maxiter", 1000))))
    u = hmc.update(state.x, d.momentum, d.pseudofermion, d.uniform)
    a3 = u.accept[:, None, None]
    x = torch.where(a3, u.x.float(), state.x)
    v = torch.where(a3, u.v.float(), -u.v0.float())
    zero = torch.zeros_like(u.accept, dtype=torch.int32)
    return SimpleNamespace(x=x, v=v), SimpleNamespace(
        accepted=u.accept, iters=zero, delta_H=u.dH.double(), flag=zero)


def compare(run_cfg: dict, snap: dict, d: Draws, device) -> dict:
    """The complex reference (float64, complex128) runs the whole update of
    every chain from the port's field before the step ``snap["step"]``,
    with that step's draws made again from the seed."""
    hmc = _reference(run_cfg, TwistedModel(run_cfg, device, torch.float64))
    x0 = snap["x_before"].to(device).double()
    x1 = snap["x_after"].to(device).double()
    v1 = snap["v_after"].to(device).double()
    acc = snap["accepted"].to(device).bool()
    dH = snap["delta_H"].to(device).double()
    t = time.perf_counter()
    ref = hmc.update(x0, d.momentum, d.pseudofermion, d.uniform)
    out = {"step": snap["step"], "n_accepted": int(acc.sum()), "n_chains": int(acc.numel()),
           "reference_iterations": hmc.iterations, "reference_s": time.perf_counter() - t}
    out["dH_gap"] = _update._max((dH - ref.dH).abs())
    a3 = acc[:, None, None]
    due_x = torch.where(a3, ref.x, x0)
    due_v = torch.where(a3, ref.v, -ref.v0)
    out["state_gap"] = max(_update._max(_update._rel(x1, due_x)),
                           _update._max(_update._rel(v1, due_v)))
    u = d.uniform.double()
    band = _update.ACCEPT_BAND
    lo = torch.clamp(ref.P * math.exp(-band), max=1.0)
    hi = torch.clamp(ref.P * math.exp(band), max=1.0)
    clear = (u < lo) | (u >= hi)
    out["accept_flips"] = int(((acc != ref.accept) & clear).sum())
    return out
