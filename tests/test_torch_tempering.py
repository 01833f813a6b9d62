"""Parallel tempering of the PyTorch port against the JAX package, float64
on the CPU.

* ``ladder_params`` (Holstein λ, λ₂ and SSH α, α₂ scaled by ladder[r] and
  ladder[r]²; in the port only the couplings become per-chain ``[C, ...]``
  leaves) and ``target_mask`` equal JAX's.
* With JAX's draws fed in (``ExchangeDraws``: the φ noise per chain and the
  uniform per pair), one exchange equals JAX's ``make_exchange_step`` for 2
  and 3 rungs and both parities, Holstein and SSH: the same swaps (x, v
  exactly), acceptance rate within 1e-12, equal flags.
* Identical rungs always accept, and swap the configurations exactly.
* The driver with ``[tempering]`` measures the rung-0 chains only (at the
  physical couplings) and reports ``tempering_acceptance_rate``; a ladder
  that does not divide the chains, or that does not start at 1, is a
  ``ValueError``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics import tempering as jtemp
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu_torch import simulation as tsim
from elphdynamics_tpu_torch.dynamics.tempering import (
    ExchangeDraws, TemperingConfig, check_ladder, ladder_params, make_exchange_step,
    rung_params, target_mask)
from elphdynamics_tpu_torch.io.config import load_toml
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, alpha2=0.1, alpha2_std=0.02,
           omega=1.0, omega_std=0.1, omega4=0.05, o1=0, o2=0)


def _holstein():
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.2, lam2=0.1, mu=0.0, dense_threshold=2048)
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 2), 1.0, 0.1,
                              rng=np.random.default_rng(5), **kw)
    ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC), 2), 1.0, 0.1,
                            rng=np.random.default_rng(5), device="cpu", **kw)
    return js, jp, ts, tp


def _ssh():
    hops = [dict(HOP, dL=(1, 0, 0), name="x"), dict(HOP, dL=(0, 1, 0), name="y")]
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC), 2), 1.0, 0.1, hoppings=hops,
                          mu_assignments=[(-0.2, 0.1, None)], rng=np.random.default_rng(3))
    ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC), 2), 1.0, 0.1, hoppings=hops,
                          mu_assignments=[(-0.2, 0.1, None)], rng=np.random.default_rng(3),
                          dtype=torch.float64, device="cpu")
    return js, jp, ts, tp


MODELS = {"holstein": _holstein, "ssh": _ssh}


def _fields(ts, C, seed):
    """Per-chain fields around a chain-dependent offset (so that rungs hold
    distinct configurations), tied for SSH."""
    rng = np.random.default_rng(seed)
    x = (0.4 * rng.standard_normal((C, ts.Nph, 1)) - 0.3
         + 0.2 * rng.standard_normal((C, ts.Nph, ts.Ltau)))
    v = rng.standard_normal(x.shape)
    if hasattr(ts, "primary_phonon"):
        x, v = (TS.tie_fields(ts, torch.as_tensor(a)).numpy() for a in (x, v))
    return x, v


def _jax_draws(keys, N, Ltau):
    """The exchange's draws from each chain key: the φ-refresh normals
    (``_refresh_phi``), then the pair uniform from the split key."""
    R, U = [], []
    for key in keys:
        rest, kp = jax.random.split(key)
        R.append(np.asarray(jax.random.normal(kp, (2, N, Ltau), dtype=jnp.float64)))
        pair, _ = jax.random.split(rest)
        U.append(float(jax.random.uniform(pair, dtype=jnp.float64)))
    return ExchangeDraws(pseudofermion=torch.as_tensor(np.stack(R)),
                         uniform=torch.as_tensor(np.asarray(U)))


@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_ladder_params_and_target_mask_match_jax(name):
    js, jp, ts, tp = MODELS[name]()
    tcfg = TemperingConfig(ladder=(1.0, 0.9, 0.7), freq=2)
    jps = jtemp.ladder_params(jp, jtemp.TemperingConfig(ladder=tcfg.ladder, freq=2), 6)
    tps = ladder_params(tp, tcfg, 6)
    lin, quad = ("lam", "lam2") if name == "holstein" else ("alpha", "alpha2")
    for leaf in (lin, quad):
        assert getattr(tps, leaf).shape == (6,) + tuple(getattr(tp, leaf).shape)
        np.testing.assert_allclose(getattr(tps, leaf).numpy(), np.asarray(getattr(jps, leaf)),
                                   rtol=1e-15)
    # every other leaf stays shared, and rung 0 is the physical coupling
    assert tps.omega is tp.omega
    assert torch.equal(getattr(rung_params(tps), lin), getattr(tp, lin))
    np.testing.assert_array_equal(target_mask(tcfg, 6),
                                  jtemp.target_mask(jtemp.TemperingConfig(ladder=tcfg.ladder), 6))
    assert target_mask(tcfg, 6).tolist() == [True, True, False, False, False, False]


CASES = [("holstein", (1.0, 0.85), 4, 0), ("holstein", (1.0, 0.85), 4, 1),
         ("holstein", (1.0, 0.9, 0.75), 3, 0), ("holstein", (1.0, 0.9, 0.75), 3, 1),
         ("ssh", (1.0, 0.8), 4, 0), ("ssh", (1.0, 0.9, 0.7), 3, 0),
         ("ssh", (1.0, 0.9, 0.7), 3, 1)]


@pytest.mark.parametrize("name,ladder,C,parity", CASES,
                         ids=[f"{c[0]}-K{len(c[1])}-C{c[2]}-p{c[3]}" for c in CASES])
def test_exchange_matches_jax(name, ladder, C, parity):
    js, jp, ts, tp = MODELS[name]()
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    x, v = _fields(ts, C, seed=C + parity)
    jcfg = jtemp.TemperingConfig(ladder=ladder, freq=1, tol=1e-8, maxiter=500)
    tcfg = TemperingConfig(ladder=ladder, freq=1, tol=1e-8, maxiter=500)
    keys = jax.random.split(jax.random.PRNGKey(20 + C), C)
    jex = jax.jit(jtemp.make_exchange_step(jops, jcfg, C), static_argnames="parity")
    jx, jv, jacc, _, jflag, _ = jex(jtemp.ladder_params(jp, jcfg, C), jnp.asarray(x),
                                    jnp.asarray(v), keys, parity=parity)
    tex = make_exchange_step(tops, tcfg, C)
    tx, tv, tacc, titers, tflag = tex(ladder_params(tp, tcfg, C), torch.as_tensor(x),
                                      torch.as_tensor(v), parity,
                                      draws=_jax_draws(keys, ts.Nsites, ts.Ltau))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=0, atol=1e-12)
    assert int(tflag) == int(jflag) == 0 and float(titers) > 0


def test_exchange_decisions_mix_and_parity_pairs():
    """Three rungs of one lane: parity 0 pairs rungs (0, 1) and leaves rung 2
    alone, parity 1 pairs (1, 2) and leaves rung 0; a far ladder rejects and
    a near one accepts."""
    _, _, ts, tp = _holstein()
    ops = make_model_ops(ts)
    x, v = _fields(ts, 3, seed=9)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    for parity, moved, fixed in ((0, (0, 1), 2), (1, (1, 2), 0)):
        tcfg = TemperingConfig(ladder=(1.0, 1.0, 1.0), tol=1e-9)
        draws = ExchangeDraws(pseudofermion=torch.randn((3, 2, ts.Nsites, ts.Ltau),
                                                        dtype=torch.float64,
                                                        generator=torch.Generator().manual_seed(1)),
                              uniform=torch.full((3,), 0.5, dtype=torch.float64))
        x2, v2, acc, _, _ = make_exchange_step(ops, tcfg, 3)(ladder_params(tp, tcfg, 3), xt, vt,
                                                             parity, draws=draws)
        a, b = moved
        assert torch.equal(x2[a], xt[b]) and torch.equal(x2[b], xt[a])
        assert torch.equal(v2[a], vt[b]) and torch.equal(x2[fixed], xt[fixed])
        assert float(acc) == 1.0
    far = TemperingConfig(ladder=(1.0, 0.2, 0.1), tol=1e-9)
    x3, _, acc, _, _ = make_exchange_step(ops, far, 3)(
        ladder_params(tp, far, 3), xt, vt, 0, generator=torch.Generator().manual_seed(2))
    assert 0.0 <= float(acc) <= 1.0 and torch.isfinite(x3).all()


@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_identical_rungs_always_accept(name):
    _, _, ts, tp = MODELS[name]()
    ops = make_model_ops(ts)
    tcfg = TemperingConfig(ladder=(1.0, 1.0), freq=1, tol=1e-8)
    x, v = (torch.as_tensor(a) for a in _fields(ts, 4, seed=1))
    ex = make_exchange_step(ops, tcfg, 4)
    gen = torch.Generator().manual_seed(0)
    x2, v2, acc, _, flag = ex(ladder_params(tp, tcfg, 4), x, v, 0, gen)
    assert float(acc) == 1.0 and int(flag) == 0
    assert torch.equal(x2[:2], x[2:]) and torch.equal(x2[2:], x[:2])
    assert torch.equal(v2[:2], v[2:])
    # odd parity with two rungs: no complete pair, nothing moves
    x3, v3, acc3, _, _ = ex(ladder_params(tp, tcfg, 4), x, v, 1, gen)
    assert torch.equal(x3, x) and torch.equal(v3, v) and float(acc3) == 0.0


def test_bad_ladders_raise():
    _, _, _, tp = _holstein()
    with pytest.raises(ValueError, match="divisible"):
        ladder_params(tp, TemperingConfig(ladder=(1.0, 1.25, 1.5)), 5)
    with pytest.raises(ValueError, match="ladder\\[0\\]"):
        ladder_params(tp, TemperingConfig(ladder=(1.1, 1.2)), 4)
    with pytest.raises(ValueError, match="divisible"):
        check_ladder(TemperingConfig(ladder=(1.0, 0.5)), 3)


def _driver_cfg(tmp_path, ladder):
    cfg = load_toml(os.path.join(EXAMPLES, "holstein_hmc_square.toml"))
    cfg["lattice"]["L"] = 2
    cfg["holstein"]["beta"] = 1.0
    cfg["hmc"].update(burnin_updates=2, simulation_updates=4, meas_freq=1, trajectory_time=0.2)
    cfg["hmc"].pop("reflection_update", None)
    cfg["hmc"].pop("swap_update", None)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2, random_seed=3)
    cfg["solver"]["preconditioner"]["max_order"] = 8
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["tempering"] = {"ladder": ladder, "freq": 1}
    return cfg


def test_driver_bins_rung0_and_reports_exchange_rate(tmp_path, monkeypatch):
    seen = []
    make = tsim.make_measurement_step

    def spying(*a, **kw):
        mstep = make(*a, **kw)

        def run(params, x, gen):
            seen.append((x.shape[0], params.lam.clone()))
            return mstep(params, x, gen)
        return run

    monkeypatch.setattr(tsim, "make_measurement_step", spying)
    cfg = _driver_cfg(tmp_path, [1.0, 0.8])
    stats = tsim.simulate(copy.deepcopy(cfg), run_id=1, n_chains=4, device="cpu",
                          dtype=torch.float64)
    assert 0.0 <= stats["tempering_acceptance_rate"] <= 1.0
    assert stats.get("solver_failures", 0) == 0
    # 4 sampling updates, one measurement each, of the 2 rung-0 chains at
    # the physical λ of the file (one per site)
    assert len(seen) == 4 and all(n == 2 for n, _ in seen)
    phys = cfg["holstein"]["lambda"][0]["val"]
    assert all(lam.ndim == 1 and torch.allclose(lam, torch.full_like(lam, phys))
               for _, lam in seen)
    folder = tmp_path / f"{cfg['simulation']['foldername']}-1"
    log = (folder / f"{cfg['simulation']['foldername']}.log").read_text()
    assert "parallel tempering: ladder=[1.0, 0.8] freq=1 (2 chains/rung)" in log


@pytest.mark.parametrize("chains,ladder", [(3, [1.0, 0.8]), (4, [0.9, 0.8])],
                         ids=["not_dividing", "not_physical"])
def test_driver_refuses_bad_ladders(tmp_path, chains, ladder):
    with pytest.raises(ValueError):
        tsim.simulate(_driver_cfg(tmp_path, ladder), run_id=1, n_chains=chains, device="cpu",
                      dtype=torch.float64)
