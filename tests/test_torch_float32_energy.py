"""The HMC energy of a float32 update against float64 on the same draws,
on the CPU.

The stock Holstein example (``examples/holstein_hmc_square.toml``: its
Fourier-acceleration mass 0.1 spreads the mass operator's spectrum) at
8×8, β = 4, dt 0.025, one trajectory of 40 steps, 4 chains: the start
fields and every draw are made in float64 and cast for the float32 update.
H at the start (H − ΔH of the stats) holds the same state in both dtypes,
so the two differ only through float32: each chain within u·(|S| + K),
u = 2⁻²⁴, every term of H rounded once; ΔH holds two evaluations, within
twice that. With the mass operator's circulants rounded to float32, H at
the start was several u·(|S| + K) low (the kinetic energy) and the
accelerations M⁻¹ disagreed with K, which put ΔH beyond its bound, low on
every chain; the operator is applied in float64.
"""

import os
from dataclasses import replace

import torch

from elphdynamics_tpu_torch.dynamics import hmc
from elphdynamics_tpu_torch.dynamics.hmc import HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu_torch.io.config import build_setup, load_toml
from elphdynamics_tpu_torch.ops import kpm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U32 = 2.0 ** -24


def test_float32_energy_within_rounding(tmp_path):
    cfg = load_toml(os.path.join(REPO, "examples", "holstein_hmc_square.toml"))
    cfg["lattice"]["L"] = 8
    cfg["holstein"]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, trajectory_time=1.0)
    C = 4
    g = torch.Generator().manual_seed(1)
    stats = {}
    for dtype in (torch.float64, torch.float32):
        s = build_setup(cfg, str(tmp_path), torch.device("cpu"), dtype)
        if dtype == torch.float64:
            x0 = init_phonons_half_filled(s.ops, s.params, C, g)
            d64 = hmc.draw(s.ops, C, torch.float64, "cpu", g)
        step = make_hmc_step(s.ops, s.fa_mass, s.hmc_cfg, kpm.make_precond(s.ops, s.kpm_cfg))
        draws = replace(d64, momentum=d64.momentum.to(dtype),
                        pseudofermion=d64.pseudofermion.to(dtype))
        x = x0.to(dtype)
        _, stats[dtype] = step(s.params, HMCState(x=x, v=torch.zeros_like(x)), draws=draws)
    a, b = stats[torch.float32], stats[torch.float64]
    assert bool((a.flag == 0).all()) and bool((b.flag == 0).all())
    rounding = U32 * (b.S.abs() + b.K)
    dH0 = ((a.H - a.delta_H) - (b.H - b.delta_H)).abs()
    assert bool((dH0 <= rounding).all()), (dH0, rounding)
    ddH = (a.delta_H - b.delta_H).abs()
    assert bool((ddH <= 2 * rounding).all()), (ddH, 2 * rounding)
