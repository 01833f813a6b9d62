"""The 2-D chain × site layout and parallel tempering across ranks in the
PyTorch port, against one rank, on gloo ranks on the CPU in float64.

* Tempering exchanges (both pair parities, 4 rungs × 1 lane on a 4×4
  lattice; the rungs 1 ↔ 2 pair crosses the chain blocks) over 2 chain
  ranks, over 2 site ranks, and on the 2×2 layout (Holstein and SSH): the
  one-rank run's decisions and acceptances, x to 1e-9.
* The driver on the stock 4×4 examples ``holstein_hmc_square.toml`` and
  ``ssh_hmc_square.toml`` (cut in depth: 2 sampling updates,
  4 probes, 2 bins; SSH's KPM at max_order 8), 4 chains on 2 chain × 2
  site ranks: every binned measurement within 1e-9 of the one-rank run's,
  x within 1e-9, the same acceptance.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu_torch.io.config import load_toml
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.parallel.multihost import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
LADDER = (1.0, 0.97, 0.94, 0.91)


def _fields(model, n_chains=4, seed=3):
    spec, _ = (W.build(4, 1.0, 0.1, "plain") if model == "holstein"
               else W.build_ssh_model(4, 1.0, 0.1))
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((n_chains, spec.Nph, 1)) + 0.1 * rng.standard_normal(
        (n_chains, spec.Nph, spec.Ltau))
    if model == "ssh":
        x = x[:, spec.primary_phonon]
    return x


@pytest.mark.parametrize("model,n_devices,site_devices",
                         [("holstein", 2, 1), ("holstein", 1, 2), ("holstein", 2, 2),
                          ("ssh", 2, 2)])
def test_exchange_across_ranks_matches_one_rank(model, n_devices, site_devices, tmp_path):
    x = _fields(model)
    one = W.exchange_worker(torch.device("cpu"), 1, 1, model, LADDER, x, 7)
    out = launch(W.exchange_worker, n_devices * site_devices, "gloo", "cpu",
                 (n_devices, site_devices, model, LADDER, x, 7), timeout_s=TIMEOUT, threads=1,
                 store_dir=str(tmp_path))
    site_axis = model == "holstein" and site_devices > 1
    for k, ref in enumerate(one):
        blocks = []
        for b in range(n_devices):
            ranks = [out[b * site_devices + s][k] for s in range(site_devices)]
            for r in ranks:
                assert (r["rate"], r["flag"]) == (ref["rate"], ref["flag"]), (k, r, ref)
            if site_axis:
                blocks.append(np.concatenate([r["x"] for r in ranks], axis=-2))
            else:
                for r in ranks[1:]:     # SSH's bond field is whole on every site rank
                    np.testing.assert_array_equal(r["x"], ranks[0]["x"])
                blocks.append(ranks[0]["x"])
        np.testing.assert_allclose(np.concatenate(blocks), ref["x"], rtol=0, atol=1e-9)
    # the exchange was attempted, and some pair swapped
    assert max(r["rate"] for r in one) > 0 and all(r["flag"] == 0 for r in one)


def _config(tmp_path, example):
    cfg = load_toml(os.path.join(REPO, "examples", f"{example}.toml"))
    cfg["hmc"].update(burnin_updates=0, simulation_updates=2, trajectory_time=0.05)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2, random_seed=5)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    path = tmp_path / f"{example}.toml"
    path.write_text(dump_toml(cfg))
    return str(path)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("example", ["holstein_hmc_square", "ssh_hmc_square"])
def test_driver_on_2x2_layout_matches_one_rank(example, tmp_path):
    cfg = _config(tmp_path, example)
    stats1, bins1 = W.simulate_worker(torch.device("cpu"), cfg, 1, 4)
    out = launch(W.simulate_worker, 4, "gloo", "cpu", (cfg, 2, 4, 2, 2), timeout_s=TIMEOUT,
                 threads=1, store_dir=str(tmp_path))
    bins2 = out[0][1]
    assert all(o[1] == [] for o in out[1:]) and len(bins1) == len(bins2) == 2
    n = 0
    for b1, b2 in zip(bins1, bins2):
        got = dict(_leaves(b2))
        for path, want in _leaves(b1):
            np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-9, err_msg=path)
            n += 1
    assert n > 10
    with np.load(os.path.join(tmp_path, f"{example}-1", "checkpoint.npz")) as z1, \
            np.load(os.path.join(tmp_path, f"{example}-2", "checkpoint.npz")) as z2:
        np.testing.assert_allclose(z2["x"], z1["x"], rtol=0, atol=1e-9)
    assert all(o[0]["acceptance_rate"] == stats1["acceptance_rate"] for o in out)
    assert "Ranks: 4 (2 chain x 2 site, backend gloo)" in (
        tmp_path / f"{example}-2" / f"{example}.log").read_text()
