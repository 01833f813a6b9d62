"""Independent draws across seeds in the PyTorch port's driver, on the CPU.

``simulation.simulate`` runs the stock 4×4 example
(``examples/holstein_hmc_square.toml``, one sampling update, 4 chains,
float64) at seeds 2, 3 and 4. The draw seams record what the run drew from
its generator (``torch.Generator(...).manual_seed(random_seed)`` in
``simulate``): ``init_phonons_half_filled`` the start fields x₀,
``dynamics.hmc.draw`` the first update's momenta, pseudofermion noise and
Metropolis uniforms. Every chain's x₀, momenta, pseudofermions and uniform
differ between every two seeds, and the chains of one seed differ from each
other.
"""

import itertools
import os

import numpy as np
import torch

from elphdynamics_tpu_torch import simulation
from elphdynamics_tpu_torch.dynamics import hmc
from elphdynamics_tpu_torch.io.config import load_toml
from elphdynamics_tpu_torch.io.output import dump_toml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (2, 3, 4)
CHAINS = 4


def _first_draws(tmp_path, monkeypatch, seed: int) -> dict:
    cfg = load_toml(os.path.join(REPO, "examples", "holstein_hmc_square.toml"))
    cfg["hmc"].update(burnin_updates=0, simulation_updates=1, meas_freq=1,
                      trajectory_time=0.05)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=1, random_seed=seed)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    path = tmp_path / f"seed{seed}.toml"
    path.write_text(dump_toml(cfg))
    seen: dict = {"x0": [], "draws": []}
    init, draw = simulation.init_phonons_half_filled, hmc.draw

    def rec_init(*a, **k):
        x = init(*a, **k)
        seen["x0"].append(x.clone())
        return x

    def rec_draw(*a, **k):
        d = draw(*a, **k)
        seen["draws"].append(d)
        return d

    monkeypatch.setattr(simulation, "init_phonons_half_filled", rec_init)
    monkeypatch.setattr(hmc, "draw", rec_draw)
    simulation.simulate(str(path), run_id=seed, n_chains=CHAINS, device="cpu",
                        dtype=torch.float64)
    monkeypatch.undo()
    assert len(seen["x0"]) == 1 and len(seen["draws"]) == 1
    d = seen["draws"][0]
    return dict(x0=seen["x0"][0], momentum=d.momentum, pseudofermion=d.pseudofermion,
                uniform=d.uniform)


def test_first_update_draws_differ_across_seeds(tmp_path, monkeypatch):
    runs = {s: _first_draws(tmp_path, monkeypatch, s) for s in SEEDS}
    for name in ("x0", "momentum", "pseudofermion", "uniform"):
        for a, b in itertools.combinations(SEEDS, 2):
            for c in range(CHAINS):
                ta, tb = runs[a][name][c], runs[b][name][c]
                assert not torch.equal(ta, tb), (name, a, b, c)
                assert float((ta - tb).abs().max()) > 1e-6, (name, a, b, c)
        for s in SEEDS:
            rows = runs[s][name].reshape(CHAINS, -1)
            for c1, c2 in itertools.combinations(range(CHAINS), 2):
                assert not torch.equal(rows[c1], rows[c2]), (name, s, c1, c2)
    u = np.array([runs[s]["uniform"].numpy() for s in SEEDS])
    assert len(np.unique(u)) == u.size, u
