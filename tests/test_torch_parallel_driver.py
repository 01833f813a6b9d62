"""The PyTorch port's driver on several gloo ranks on the CPU (float64),
against the one-rank driver on the same input: the stock example
``examples/holstein_hmc_square.toml`` cut in depth (1 burn-in and 2
sampling updates, trajectory time 0.05, 4 probes, 2 bins), its reflection
and swap moves and measurements as shipped.

* ``--devices 2`` with 4 chains: every chain's final x and v (the
  checkpoint), the HMC log and every bin file equal the one-rank run's bit
  for bit (through the CLI);
* ``--site-devices 2`` with 1 chain: the binned measurements within 1e-10
  of the one-rank run's, x within 1e-12;
* the stock SSH example (``examples/ssh_hmc_square.toml``, 4×4, uncut
  width) with ``chip_smoke.py`` phase (f)'s settings (seed 17, trajectory
  0.05, nᵥ 4, KPM ``max_order`` 8, float64) at 0 + 2 updates and 2 bins on
  2 site ranks: every bin array within an absolute 1e-9 of the one-rank
  run's, equal acceptance;
* ``--multihost``: two processes started with the launcher's environment
  variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
  write what ``--devices 2`` writes.
"""

import filecmp
import os
import socket
import subprocess
import sys

import numpy as np
import torch

import torch_parallel_workers as W
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch.io.config import load_toml
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.parallel.multihost import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _config(tmp_path, name="cut.toml"):
    cfg = load_toml(os.path.join(REPO, "examples", "holstein_hmc_square.toml"))
    cfg["hmc"].update(burnin_updates=1, simulation_updates=2, trajectory_time=0.05)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2, random_seed=5)
    cfg["measurements"]["num_random_vectors"] = 4
    path = tmp_path / name
    path.write_text(dump_toml(cfg))
    return str(path)


def _folder(tmp_path, run_id):
    return tmp_path / f"holstein_hmc_square-{run_id}"


def _same_tree(a, b):
    """Every output file but the run log, the summary (timers) and the
    copied input is byte-identical."""
    skip = {"holstein_hmc_square.log", "holstein_hmc_square_summary.out", "checkpoint.json",
            "checkpoint.npz"}
    for root, _, files in os.walk(a):
        for f in files:
            if f in skip or f.endswith(".toml"):
                continue
            pa = os.path.join(root, f)
            pb = os.path.join(b, os.path.relpath(pa, a))
            assert filecmp.cmp(pa, pb, shallow=False), pa


def _checkpoint(folder):
    with np.load(os.path.join(folder, "checkpoint.npz")) as z:
        return z["x"], z["v"]


def test_chain_sharded_cli_is_bitwise_one_rank(tmp_path):
    cfg = _config(tmp_path)
    assert cli.main([cfg, "1", "--device", "cpu", "--x64", "--chains", "4"]) == 0
    assert cli.main([cfg, "2", "--device", "cpu", "--x64", "--chains", "4",
                     "--devices", "2"]) == 0
    one, two = _folder(tmp_path, 1), _folder(tmp_path, 2)
    x1, v1 = _checkpoint(one)
    x2, v2 = _checkpoint(two)
    assert x1.shape[0] == 4
    np.testing.assert_array_equal(x2, x1)
    np.testing.assert_array_equal(v2, v1)
    _same_tree(one, two)
    assert "Ranks: 2 (2 chain x 1 site, backend gloo)" in (
        two / "holstein_hmc_square.log").read_text()


def test_site_sharded_driver_bins_match_one_rank(tmp_path):
    cfg = _config(tmp_path)
    _, bins1 = W.simulate_worker(torch.device("cpu"), cfg, 1, 1)
    out = launch(W.simulate_worker, 2, "gloo", "cpu", (cfg, 2, 1, 1, 2), timeout_s=TIMEOUT,
                 threads=1, store_dir=str(tmp_path))
    bins2 = out[0][1]
    assert out[1][1] == [] and len(bins1) == len(bins2) == 2
    n = 0
    for b1, b2 in zip(bins1, bins2):
        got = dict(_leaves(b2))
        for path, want in _leaves(b1):
            np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-10, err_msg=path)
            n += 1
    assert n > 10
    x1, _ = _checkpoint(_folder(tmp_path, 1))
    x2, _ = _checkpoint(_folder(tmp_path, 2))
    np.testing.assert_allclose(x2, x1, rtol=0, atol=1e-12)
    assert out[0][0]["acceptance_rate"] == out[1][0]["acceptance_rate"]


def test_site_sharded_ssh_example_bins_match_one_rank(tmp_path):
    """The SSH example on 2 site ranks at 0 + 2 updates, no cut but the
    counts of phase (f) (its 4×4 lattice and every measurement as
    shipped)."""
    cfg = load_toml(os.path.join(REPO, "examples", "ssh_hmc_square.toml"))
    cfg["hmc"].update(burnin_updates=0, simulation_updates=2, trajectory_time=0.05)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2, random_seed=17)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    path = tmp_path / "ssh.toml"
    path.write_text(dump_toml(cfg))
    stats1, bins1 = W.simulate_worker(torch.device("cpu"), str(path), 1, 1)
    out = launch(W.simulate_worker, 2, "gloo", "cpu", (str(path), 2, 1, 1, 2),
                 timeout_s=TIMEOUT, threads=1, store_dir=str(tmp_path))
    bins2 = out[0][1]
    assert len(bins1) == len(bins2) == 2
    n = 0
    for b1, b2 in zip(bins1, bins2):
        got = dict(_leaves(b2))
        for p, want in _leaves(b1):
            np.testing.assert_allclose(got[p], want, rtol=0, atol=1e-9, err_msg=p)
            n += 1
    assert n > 10
    assert out[0][0]["acceptance_rate"] == stats1["acceptance_rate"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_env_matches_devices(tmp_path):
    cfg = _config(tmp_path)
    out = launch(W.simulate_worker, 2, "gloo", "cpu", (cfg, 1, 4, 2), timeout_s=TIMEOUT,
                 threads=1, store_dir=str(tmp_path))
    assert out[0][0]["acceptance_rate"] == out[1][0]["acceptance_rate"]
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "elphdynamics_tpu_torch", cfg, "2", "--device", "cpu",
             "--x64", "--chains", "4", "--devices", "2", "--multihost"],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    assert b"acceptance_rate" in outs[0][0] and outs[1][0] == b""
    np.testing.assert_array_equal(_checkpoint(_folder(tmp_path, 2))[0],
                                  _checkpoint(_folder(tmp_path, 1))[0])
    _same_tree(_folder(tmp_path, 1), _folder(tmp_path, 2))
