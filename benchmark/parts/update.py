"""The HMC update of every chain: the port's ``example.step`` with draws
made by the benchmark, checked against the plain reference.

A part is a module ``parts/<name>.py`` that a mix names under ``"parts"``;
the harness finds it by name and calls, for each step of the window:

* ``draws(traffic, stream, step)``: the part's inputs, from the seed;
* ``port(program, state, d)``: the port's call, ``(state, stats)``;
* ``control(ctrl, state, d)``: the plain reference in the port's place in
  the precision below the configuration's, ``(state, stats)``;
* ``before(state)`` and ``snapshot(step, before, state, stats)``: what the
  check keeps of the step it follows (copies: the port reuses its buffers);
* ``compare(run_cfg, snap, d, device)``: the numbers compared, each named in
  ``NUMBERS`` and limited in ``limits/<cell>.json``.

``STATS`` names the stats (tensors with a leading chain axis) that the run
keeps per step for the metric readers; a ``flag`` among them counts a
failed chain.

The numbers of the update, for every chain of the step drawn:

* ``dH_gap``: the widest gap between a chain's ΔH as the port reported it
  and the reference's;
* ``state_gap``: the widest relative gap (‖a − b‖/‖b‖ per chain) of the
  port's new field and momenta from what the port's own accept decision
  makes due: the reference's proposal where it accepted, the old field and
  the reversed refreshed momenta −v₀ where it rejected;
* ``accept_flips``: the chains whose decision differs from the reference's
  where no ΔH within ``ACCEPT_BAND`` of the reference's could explain it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from reference.hmc import HMC
from reference.models import Model

NUMBERS = ("dH_gap", "state_gap", "accept_flips")
STATS = ("accepted", "iters", "delta_H", "flag")
# the ΔH error that may explain a differing decision: e-fold in the
# acceptance probability, well above the widest ΔH gap of sound runs
# (PERF.md)
ACCEPT_BAND = 1.0


@dataclass(frozen=True)
class Draws:
    momentum: torch.Tensor        # [C, Nph, Lτ] unit normals, served dtype
    pseudofermion: torch.Tensor   # [C, 2, N, Lτ] unit normals, served dtype
    uniform: torch.Tensor         # [C] accept uniforms, float64


def draws(traffic, stream: int, step: int) -> Draws:
    m, C, dtype, device = traffic.model, traffic.C, traffic.dtype, traffic.device
    g = traffic.generator(stream, step)
    mom = torch.randn((C, m.Nph, m.Lt), generator=g, dtype=dtype, device=device)
    eta = torch.randn((C, 2, m.N, m.Lt), generator=g, dtype=dtype, device=device)
    uni = torch.rand((C,), generator=g, dtype=torch.float64, device=device)
    return Draws(mom, eta, uni)


def port(program, state, d: Draws):
    from elphdynamics_tpu_torch.dynamics.hmc import HMCDraws

    hd = HMCDraws(momentum=d.momentum, pseudofermion=d.pseudofermion, uniform=d.uniform)
    return program.example.step(program.example.params, state, None, hd)


def _reference(run_cfg: dict, model: Model, **kw) -> HMC:
    return HMC(model, run_cfg["hmc"], run_cfg.get("fourier_acceleration", []), **kw)


def control(ctrl, state, d: Draws):
    """The reference's update with every field, table and solve vector
    stored in bfloat16 (sums in float32), its solves to the input file's
    tolerance until their residual stalls."""
    sol = ctrl.run_cfg["solver"]
    hmc = ctrl.cached("update", lambda: _reference(
        ctrl.run_cfg, Model(ctrl.run_cfg, ctrl.device, torch.bfloat16),
        tol=float(sol.get("tol", 1e-5)), maxiter=int(sol.get("maxiter", 1000))))
    u = hmc.update(state.x, d.momentum, d.pseudofermion, d.uniform)
    a3 = u.accept[:, None, None]
    x = torch.where(a3, u.x.float(), state.x)
    v = torch.where(a3, u.v.float(), -u.v0.float())
    zero = torch.zeros_like(u.accept, dtype=torch.int32)
    return SimpleNamespace(x=x, v=v), SimpleNamespace(
        accepted=u.accept, iters=zero, delta_H=u.dH.double(), flag=zero)


def before(state) -> dict:
    return {"x_before": state.x.clone()}


def snapshot(step: int, kept: dict, state, stats) -> dict:
    return dict(kept, step=step, x_after=state.x.clone(), v_after=state.v.clone(),
                accepted=stats.accepted.clone(), delta_H=stats.delta_H.clone())


def _rel(a, b) -> torch.Tensor:
    """Per-chain ‖a − b‖/‖b‖ over the last two axes."""
    a, b = a.double(), b.double()
    return (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1).clamp_min(1e-300)


def _max(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    v = float(t.double().max())
    return v if math.isfinite(v) else math.inf


def compare(run_cfg: dict, snap: dict, d: Draws, device) -> dict:
    """The reference (float64) runs the whole update of every chain from
    the port's field before the step ``snap["step"]``, with that step's
    draws made again from the seed."""
    hmc = _reference(run_cfg, Model(run_cfg, device, torch.float64))
    x0 = snap["x_before"].to(device).double()
    x1 = snap["x_after"].to(device).double()
    v1 = snap["v_after"].to(device).double()
    acc = snap["accepted"].to(device).bool()
    dH = snap["delta_H"].to(device).double()
    t = time.perf_counter()
    ref = hmc.update(x0, d.momentum, d.pseudofermion, d.uniform)
    out = {"step": snap["step"], "n_accepted": int(acc.sum()), "n_chains": int(acc.numel()),
           "reference_iterations": hmc.iterations, "reference_s": time.perf_counter() - t}
    out["dH_gap"] = _max((dH - ref.dH).abs())
    a3 = acc[:, None, None]
    due_x = torch.where(a3, ref.x, x0)
    due_v = torch.where(a3, ref.v, -ref.v0)
    out["state_gap"] = max(_max(_rel(x1, due_x)), _max(_rel(v1, due_v)))
    u = d.uniform.double()
    lo = torch.clamp(ref.P * math.exp(-ACCEPT_BAND), max=1.0)
    hi = torch.clamp(ref.P * math.exp(ACCEPT_BAND), max=1.0)
    clear = (u < lo) | (u >= hi)
    out["accept_flips"] = int(((acc != ref.accept) & clear).sum())
    return out
