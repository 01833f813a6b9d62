"""The burn-in step-size tuner of the PyTorch port against the JAX package.

* Over a fixed sequence of acceptance probabilities the dual-averaging
  state (float32 on both sides) equals JAX's ``dt_tuner_update`` step by
  step within 1e-6 relative, and the clamp rails hold.
* The driver with ``[hmc] tune_dt`` on a depth-cut copy of
  ``examples/holstein_hmc_deep_beta.toml`` (L = 2, β = 2, a few updates, 2
  bins, float64 on the CPU): it tunes during burn-in, freezes dt into the
  sampling step, logs and reports ``tuned_dt``; a run stopped mid-burn-in
  resumes with the checkpointed tuner state and ends where the uninterrupted
  run ends; a resume after burn-in re-freezes the checkpointed dt.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics.hmc import dt_tuner_init as j_dt_tuner_init
from elphdynamics_tpu.dynamics.hmc import dt_tuner_update as j_dt_tuner_update
from elphdynamics_tpu_torch import simulation as tsim
from elphdynamics_tpu_torch.dynamics.hmc import (
    DtTunerState, dt_tuner_init, dt_tuner_update)
from elphdynamics_tpu_torch.io import checkpoint as ckpt
from elphdynamics_tpu_torch.io.config import load_toml

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
FIELDS = ("m", "log_dt", "log_dt_avg", "h_bar", "mu", "lo", "hi")


def _jax_values(t):
    return np.array([float(getattr(t, f)) for f in FIELDS])


def _values(t: DtTunerState):
    assert all(getattr(t, f).dtype == torch.float32 and getattr(t, f).ndim == 0 for f in FIELDS)
    return np.array(t.as_list())


@pytest.mark.parametrize("target", [0.65, 0.85])
def test_tuner_matches_jax_step_by_step(target):
    """A fixed acceptance sequence (a synthetic acceptance curve of the
    current dt with noise, zeros for flagged updates) through both tuners."""
    rng = np.random.default_rng(3)
    jt, tt = j_dt_tuner_init(0.05), dt_tuner_init(0.05, device="cpu")
    np.testing.assert_allclose(_values(tt), _jax_values(jt), rtol=1e-6)
    for i in range(120):
        dt = float(np.exp(_jax_values(jt)[1]))
        p = float(np.clip(np.exp(-(dt / 0.2) ** 2) + 0.05 * rng.standard_normal(), 0.0, 1.0))
        if i % 17 == 5:
            p = 0.0
        jt = j_dt_tuner_update(jt, np.float32(p), target)
        tt = dt_tuner_update(tt, torch.tensor(p, dtype=torch.float64), target)
        np.testing.assert_allclose(_values(tt), _jax_values(jt), rtol=1e-6, atol=1e-7)
    # the averaged iterate settles where the curve meets the target
    dt_star = float(np.exp(_values(tt)[2]))
    assert abs(np.exp(-(dt_star / 0.2) ** 2) - target) < 0.1


def test_tuner_clamp_rails():
    t = dt_tuner_init(0.1, lo=0.05, hi=0.4, device="cpu")
    for _ in range(100):
        t = dt_tuner_update(t, 1.0, 0.8)     # always accepted: dt rises
    assert float(torch.exp(t.log_dt)) <= 0.4 * (1 + 1e-6)
    assert float(torch.exp(t.log_dt)) == pytest.approx(0.4, rel=1e-6)
    for _ in range(300):
        t = dt_tuner_update(t, 0.0, 0.8)     # always rejected: dt falls
    assert float(torch.exp(t.log_dt)) >= 0.05 * (1 - 1e-6)
    # the default rails are dt0/64 and 64·dt0
    d = dt_tuner_init(0.02, device="cpu")
    np.testing.assert_allclose(np.exp(d.as_list()[5:]), [0.02 / 64, 0.02 * 64], rtol=1e-6)
    # the checkpoint round trip is exact
    assert DtTunerState.from_list(t.as_list(), "cpu").as_list() == t.as_list()


def _deep_beta(tmp_path, burnin=6, updates=2):
    """The stock deep-β example cut in depth: L = 2, β = 2, ``burnin``
    tuned updates, ``updates`` sampling updates, 2 bins, 4 probes."""
    cfg = load_toml(os.path.join(EXAMPLES, "holstein_hmc_deep_beta.toml"))
    cfg["lattice"]["L"] = 2
    cfg["holstein"]["beta"] = 2.0
    cfg["hmc"].update(burnin_updates=burnin, simulation_updates=updates, meas_freq=1,
                      trajectory_time=0.2)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2, random_seed=5)
    cfg["measurements"]["num_random_vectors"] = 4
    return cfg


def _sim(cfg):
    return tsim.simulate(copy.deepcopy(cfg), run_id=1, n_chains=2, device="cpu",
                         dtype=torch.float64)


def test_tune_dt_driver_freezes_and_reports(tmp_path):
    cfg = _deep_beta(tmp_path)
    stats = _sim(cfg)
    tuned = stats["tuned_dt"]
    assert tuned != cfg["hmc"]["dt"] and 0.05 / 64 <= tuned <= 0.05 * 64
    assert stats.get("solver_failures", 0) == 0 and stats["acceptance_rate"] > 0
    folder = tmp_path / "holstein_hmc_deep_beta-1"
    log = (folder / "holstein_hmc_deep_beta.log").read_text()
    assert log.count("tune_dt: frozen dt=") == 1
    assert f"frozen dt={tuned:.6g}" in log
    # the sampling step runs Nt = round(trajectory_time / tuned dt) steps
    nt = max(1, round(0.2 / tuned))
    assert f"Nt={nt} " in log
    st = ckpt.load_checkpoint(str(folder))
    assert st["sim_stats"]["tuned_dt"] == tuned and "dt_tuner" not in st["extras"]


def test_tune_dt_resumes_mid_burnin(tmp_path, monkeypatch):
    """A run stopped in its fourth burn-in update resumes from the checkpoint
    written before it (the tuner's state in ``extras``) and freezes the same
    dt as the run that was never stopped."""
    whole = _sim(_deep_beta(tmp_path / "whole"))["tuned_dt"]

    cfg = _deep_beta(tmp_path / "cut")
    cfg["simulation"]["checkpoint_freq"] = -1    # a checkpoint before every update
    calls = []

    def stop_at_fourth(t, p, target):
        calls.append(1)
        if len(calls) == 4:
            raise KeyboardInterrupt
        return dt_tuner_update(t, p, target)

    monkeypatch.setattr(tsim, "dt_tuner_update", stop_at_fourth)
    with pytest.raises(KeyboardInterrupt):
        _sim(cfg)
    folder = tmp_path / "cut" / "holstein_hmc_deep_beta-1"
    st = ckpt.load_checkpoint(str(folder))
    assert st["counters"]["burnin_start"] == 3
    saved = st["extras"]["dt_tuner"]
    assert saved[0] == 3.0 and "tuned_dt" not in st["sim_stats"]

    monkeypatch.setattr(tsim, "dt_tuner_update", dt_tuner_update)
    resumed = _sim(cfg)["tuned_dt"]
    assert resumed == whole
    assert "resumed from checkpoint: burnin_start=3" in (
        folder / "holstein_hmc_deep_beta.log").read_text()


def test_tune_dt_resume_after_burnin_refreezes(tmp_path):
    cfg = _deep_beta(tmp_path, burnin=4, updates=4)
    tuned = _sim(cfg)["tuned_dt"]
    folder = tmp_path / "holstein_hmc_deep_beta-1"
    # rewind the checkpoint's counters to the middle of the sampling phase
    meta = json.loads((folder / "checkpoint.json").read_text())
    meta["counters"]["sim_start"] = 2
    (folder / "checkpoint.json").write_text(json.dumps(meta))
    again = _sim(cfg)
    assert again["tuned_dt"] == tuned
    log = (folder / "holstein_hmc_deep_beta.log").read_text()
    assert "resumed from checkpoint: burnin_start=4 sim_start=2" in log
    assert log.count(f"tune_dt: frozen dt={tuned:.6g}") == 2
