"""The optical SSH model of the PyTorch port under site sharding, against
the JAX package's unsharded samplers and the port's one-rank ones, on 2 and
4 gloo ranks on the CPU in float64.

The bond field stays whole on every rank and the fermion fields are cut
into site blocks; the fermionic force is each rank's share of the group
walk, all-reduced once per evaluation. On a 4×4 lattice with x and y bonds
(disorder on every parameter, α₂ and ω₄ terms) and 2 chains, with the
JAX package's own draws fed in (each rank keeps its block of the
pseudofermions and probes, the bond momenta and η whole), each sharded
sampler in its eager form and in its segmented one (the graphed calls'
segments, run directly on the CPU; the probes by
``measurements.make_probe_solve``):

* one HMC update with the KPM preconditioner and warm starts, real and
  twisted (complex hopping), CG to 1e-9;
* one Runge-Kutta Langevin step, CG to 1e-9;
* three swap moves;
* a Green's-function sample of 4 probes (the solutions gathered).

x agrees with JAX to 1e-10 and with the one-rank port to 1e-12 (probe
solutions to 1e-10); decisions, flags and iterations are equal; the bond
field is bitwise equal on every rank after each sampler. The per-group
phonon tables of the sharded force walk equal the JAX package's.

Block CG on complex fields on 2 site ranks against one rank, on a twisted
4×4 SSH model (the checks of ``test_torch_parallel_hmc_twisted.py``): one
HMC update whose trajectory solves run Hermitian block CG and a block-CG
probe sample; x and the probe solutions to 1e-12, equal decisions and
iterations, the bond field bit for bit the same on both ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu.dynamics import special_updates as jsu
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.measure.greens import sample_greens as j_sample_greens
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass, build_Q
from elphdynamics_tpu.parallel.lattice_shard import _ssh_group_phonons
from elphdynamics_tpu.parallel.lattice_shard import build_shard_plan as j_build_shard_plan
from elphdynamics_tpu_torch.parallel.lattice_shard import ssh_group_phonons
from elphdynamics_tpu_torch.parallel.multihost import launch
from test_torch_parallel_hmc_twisted import check_twisted_block

torch.set_num_threads(1)

L, BETA = 4, 1.0
C = 2
KPM = dict(max_order=4)
HMC = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-9, maxiter=500, construct_guess=True,
           guess_order=3)
SCFG = dict(tol=1e-9, maxiter=500)
TWIST = (0.3, 0.1)
FA = [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]
TIMEOUT = 180


def _jax_model(twist=None):
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*W.UC), L), BETA, 0.1,
                          hoppings=W.SSH_HOPPINGS, mu_assignments=W.SSH_MU, twist=twist,
                          rng=np.random.default_rng(3))
    return js, jp, j_make_model_ops(js)


def _stack(runs):
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *runs)


def _start(N, cplx):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    dt = jnp.complex128 if cplx else jnp.float64
    return [np.asarray(jax.random.normal(k, (N, 1), dtype=dt)) for k in (k1, k2)]


def _fields(js, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((C, js.Nph, 1)) + 0.1 * rng.standard_normal(
        (C, js.Nph, js.Ltau))
    x = x[:, np.asarray(js.primary_phonon)]
    v = rng.standard_normal(x.shape)[:, np.asarray(js.primary_phonon)]
    return x, v


def _hmc(twist):
    js, jp, jops = _jax_model(twist)
    N, Lt, Nph = js.Nsites, js.Ltau, js.Nph
    x0, v0 = _fields(js, 11)
    mass = build_mass(np.asarray(jp.omega), 0.1, Lt, FA)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**HMC),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    ref = _stack([jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])[:2]
                  for c in range(C)])
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (Nph, Lt), dtype=jnp.float64)))
        r = np.asarray(jax.random.normal(k_p, (2, N, Lt), dtype=jnp.float64))
        Rpm.append((r[0] + 1j * r[1])[None] if twist else r)
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    inp = dict(cfg=HMC, kpm=KPM, mass=mass, x0=x0, v0=v0, momentum=np.stack(R),
               pseudofermion=np.stack(Rpm), uniform=np.asarray(U),
               kpm_start=_start(N, twist is not None))
    return ("hmc", twist, inp), ref


def _langevin():
    js, jp, jops = _jax_model()
    N, Lt, Nph = js.Nsites, js.Ltau, js.Nph
    x0, _ = _fields(js, 12)
    Q = build_Q(np.asarray(jp.omega), 0.1, Lt, FA)
    jstep = jax.jit(j_make_langevin_step(jops, Q, 0.01, "rk", JSolverConfig(**SCFG),
                                         jkpm.make_symmetric_precond(jops,
                                                                     jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    ref = _stack([jstep(jp, jnp.asarray(x0[c]), keys[c])[:2] for c in range(C)])
    eta, g = [], [[], []]
    for key in keys:
        key, kn = jax.random.split(key)
        eta.append(np.asarray(jax.random.normal(kn, (Nph, Lt), dtype=jnp.float64)))
        for gi in g:
            key, kg = jax.random.split(key)
            gi.append(np.asarray(jax.random.normal(kg, (N, Lt), dtype=jnp.float64)))
    inp = dict(kpm=KPM, Q=Q, dt=0.01, scfg=SCFG, x0=x0, eta=np.stack(eta),
               g=[np.stack(gi) for gi in g], kpm_start=_start(N, False))
    return ("langevin_rk", None, inp), ref


def _swap():
    js, jp, jops = _jax_model()
    N, Lt, Nph = js.Nsites, js.Ltau, js.Nph
    x0, _ = _fields(js, 13)
    cfg = dict(freq=1, n_moves=3, tol=1e-5, maxiter=2000)
    jupd = jax.jit(jsu.make_swap_update(jops, jsu.SpecialUpdateConfig(**cfg),
                                        jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    ref = _stack([jupd(jp, jnp.asarray(x0[c]), keys[c])[:2] for c in range(C)])
    picks, pf, uni = [], [], []
    for key in keys:
        pc, fc, uc = [], [], []
        for _ in range(cfg["n_moves"]):
            key, k1, k2 = jax.random.split(key, 3)
            i = int(jax.random.randint(k1, (), 0, Nph))
            j = int(jax.random.randint(k2, (), 0, Nph - 1))
            pc.append((i, j + 1 if j >= i else j))
            key, kp = jax.random.split(key)
            fc.append(np.asarray(jax.random.normal(kp, (2, N, Lt), dtype=jnp.float64)))
            key, ka = jax.random.split(key)
            uc.append(float(jax.random.uniform(ka, dtype=jnp.float64)))
        picks.append(pc)
        pf.append(fc)
        uni.append(uc)
    inp = dict(cfg=cfg, kpm=KPM, x0=x0, picks=np.swapaxes(np.asarray(picks), 0, 1),
               pseudofermion=np.swapaxes(np.asarray(pf), 0, 1),
               uniform=np.swapaxes(np.asarray(uni), 0, 1), kpm_start=_start(N, False))
    return ("swap", None, inp), ref


def _greens():
    js, jp, jops = _jax_model()
    x0, _ = _fields(js, 14)
    pre = jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    gds = [j_sample_greens(jops, jp, jnp.asarray(x0[c]), keys[c], 4, JSolverConfig(**SCFG),
                           pre)[0] for c in range(C)]
    ref = _stack([(g.MinvR, g.iters, g.flag) for g in gds])
    inp = dict(kpm=KPM, scfg=SCFG, x0=x0, R=np.stack([np.asarray(g.R) for g in gds]),
               kpm_start=_start(js.Nsites, False))
    return ("greens", None, inp), ref


@functools.lru_cache(maxsize=None)
def _jax_runs():
    runs = dict(hmc=_hmc(None), hmc_twisted=_hmc(TWIST), langevin_rk=_langevin(),
                swap=_swap(), greens=_greens())
    return {k: v[0] for k, v in runs.items()}, {k: v[1] for k, v in runs.items()}


def test_ssh_group_phonons_match_jax():
    js, _, _ = _jax_model()
    ts, _ = W.build_ssh_model(L, BETA, 0.1)
    for D in (2, 4):
        got = ssh_group_phonons(ts, D)
        want = _ssh_group_phonons(js, j_build_shard_plan(js.ckb, D))
        for a, b in zip(got, want):
            for ga, gb in zip(a, b):
                np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("form", ["eager", "segmented"])
@pytest.mark.parametrize("D", [2, 4])
def test_site_sharded_ssh_samplers_match_jax(D, form, tmp_path):
    runs, refs = _jax_runs()
    out = launch(W.ssh_worker, D, "gloo", "cpu", (L, BETA, runs, form), timeout_s=TIMEOUT,
                 threads=1, store_dir=str(tmp_path))
    one = out[0]
    for name in runs:
        sh = [r[name]["sharded"] for r in out]
        ref = refs[name]
        if name == "greens":
            z = np.concatenate([s["MinvR"] for s in sh], axis=-2)
            np.testing.assert_allclose(z, np.asarray(ref[0]), rtol=0, atol=1e-10)
            np.testing.assert_allclose(z, one[name]["one"]["MinvR"], rtol=0, atol=1e-10)
            for s in sh:
                np.testing.assert_array_equal(s["iters"], np.asarray(ref[1]))
                np.testing.assert_array_equal(s["iters"], one[name]["one"]["iters"])
                assert int(s["flag"].max()) == int(np.max(ref[2])) == 0
            continue
        # the bond field is whole on every rank, bit for bit the same
        for s in sh[1:]:
            np.testing.assert_array_equal(s["x"], sh[0]["x"], err_msg=name)
        x, jx = sh[0]["x"], np.asarray(ref[0] if name != "hmc" and name != "hmc_twisted"
                                       else ref[0].x)
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(x, one[name]["one"]["x"], rtol=0, atol=1e-12, err_msg=name)
        assert float(np.abs(x - runs[name][2]["x0"]).max()) > 1e-4, name
        if name.startswith("hmc"):
            st = ref[1]
            np.testing.assert_allclose(sh[0]["v"], np.asarray(ref[0].v), rtol=0, atol=1e-10)
            np.testing.assert_allclose(sh[0]["delta_H"], np.asarray(st.delta_H), rtol=0,
                                       atol=1e-9)
            for k in ("accepted", "iters", "flag"):
                np.testing.assert_array_equal(sh[0][k], np.asarray(getattr(st, k)), err_msg=k)
                np.testing.assert_array_equal(sh[0][k], one[name]["one"][k], err_msg=k)
            assert int(np.max(st.flag)) == 0
        elif name == "langevin_rk":
            np.testing.assert_array_equal(sh[0]["iters"], np.asarray(ref[1].iters))
            np.testing.assert_array_equal(sh[0]["iters"], one[name]["one"]["iters"])
            assert int(np.max(ref[1].flag)) == 0
        else:
            # JAX's rate is a float32 quotient of the accept count
            n = runs[name][2]["cfg"]["n_moves"]
            np.testing.assert_array_equal(np.round(sh[0]["rate"] * n),
                                          np.round(np.asarray(ref[1], np.float64) * n))
            np.testing.assert_array_equal(sh[0]["rate"], one[name]["one"]["rate"])
    # the walk crossed blocks, and one force all-reduce carries the bond field
    msgs, folds, allreduces, nbytes = one["hmc"]["counts"]
    assert msgs > 0 and folds > 0 and allreduces > 0 and nbytes > 0


def test_site_sharded_ssh_twisted_block_cg_equals_one_rank(tmp_path):
    check_twisted_block("ssh", 1, 2, tmp_path)
