"""The solver aids of the PyTorch port under site sharding, against the JAX
package's unsharded ones and the port's one-rank ones, on 2 and 4 gloo
ranks on the CPU in float64 (4×4 Holstein, 2 chains).

* Block CG with ``reduce`` (its Grams and norms all-reduced over the site
  group) on MᵀM with two right-hand sides per chain and the symmetric KPM
  preconditioner, against the JAX package's ``block_cg``: X to 1e-10,
  equal iterations. The nᵥ probe
  blocks of a Green's-function sample with ``[solver] block`` and the KPM
  preconditioner against the JAX package's ``sample_greens``: 1e-10.
* An HMC update whose trajectory solves run block CG over the two spins
  (tol 1e-6, the gate's floor), and an HMC update with slow-mode
  deflation (CholeskyQR2 with all-reduced float64 Grams, the projection's
  W†r all-reduced), each against the JAX package's unsharded
  ``make_hmc_step`` from its own draws and the same float64 basis: x and v
  to 1e-10, equal decisions and iterations; against the one-rank port to
  1e-12, the projector onto span(W) to 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu import solvers as jsolvers
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.dynamics.solve import resolve_precond as j_resolve_precond
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.measure.greens import sample_greens as j_sample_greens
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import deflation as jdefl
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch.parallel.multihost import launch

torch.set_num_threads(1)

L, BETA = 4, 1.0
C = 2
KPM = dict(max_order=4)
TIMEOUT = 180
HMC = dict(dt=0.05, trajectory_time=0.2, Nb=2, maxiter=500, construct_guess=True, guess_order=3)
CASES = {"block": dict(HMC, tol=1e-6, block=True),
         "deflation": dict(HMC, tol=1e-6, deflate_k=4, deflate_filter=4, deflate_power=3)}


def _jax_model():
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*W.UC), L), BETA, 0.1,
                              rng=np.random.default_rng(5), **W.holstein_kw("plain"))
    return js, jp, j_make_model_ops(js)


def _start(N):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    return [np.asarray(jax.random.normal(k, (N, 1), dtype=jnp.float64)) for k in (k1, k2)]


@functools.lru_cache(maxsize=None)
def _block_ref():
    js, jp, jops = _jax_model()
    N, Lt = js.Nsites, js.Ltau
    rng = np.random.default_rng(21)
    x = 0.2 * rng.standard_normal((C, N, Lt))
    B = rng.standard_normal((C, 2, N, Lt))
    res = []
    pre = jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))
    for c in range(C):
        xc = jnp.asarray(x[c])
        d = jops.derived(jp, xc)
        r = jsolvers.block_cg(lambda v: jops.mulMTM(jp, d, v), jnp.asarray(B[c]), tol=1e-10,
                              maxiter=500,
                              apply_P=j_resolve_precond(pre, jp, xc).symmetric)
        res.append((np.asarray(r.x), np.asarray(r.iters)))
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    scfg = JSolverConfig(tol=1e-10, maxiter=500, block=True)
    gds = [j_sample_greens(jops, jp, jnp.asarray(x[c]), keys[c], 4, scfg, pre)[0]
           for c in range(C)]
    return x, B, res, gds, _start(N)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Per D, one launch of every sharded run of this file: the block-CG
    solves and the HMC update of each case of ``CASES``."""
    x, B, _, gds, start = _block_ref()
    block_args = (L, x, B, np.stack([np.asarray(g.R) for g in gds]), 1e-10, start)
    hmc_runs = {}
    for case in CASES:
        _, mass, x0, v0, draws, defl = _hmc_ref(case)
        hmc_runs[case] = (L, BETA, "plain", CASES[case], KPM, mass, x0, v0, draws, None, defl)
    runs = {}

    def get(D):
        if D not in runs:
            runs[D] = launch(W.aids_worker, D, "gloo", "cpu", (block_args, hmc_runs),
                             timeout_s=TIMEOUT, threads=1,
                             store_dir=str(tmp_path_factory.mktemp(f"aids{D}")))
        return runs[D]

    return get


@pytest.mark.parametrize("D", [2, 4])
def test_block_cg_with_reduce_matches_jax(D, sharded):
    x, B, res, gds, start = _block_ref()
    out = [o["block_cg"] for o in sharded(D)]
    X = np.concatenate([o["sharded"]["X"] for o in out], axis=-2)
    Z = np.concatenate([o["sharded"]["MinvR"] for o in out], axis=-2)
    one = out[0]["one"]
    for c in range(C):
        np.testing.assert_allclose(X[c], res[c][0], rtol=0, atol=1e-10)
        np.testing.assert_array_equal(out[0]["sharded"]["iters"][c], res[c][1])
        np.testing.assert_allclose(Z[c], np.asarray(gds[c].MinvR), rtol=0, atol=1e-10)
        assert int(out[0]["sharded"]["giters"][c]) == int(gds[c].iters)
        assert int(out[0]["sharded"]["gflag"][c]) == int(gds[c].flag) == 0
    np.testing.assert_allclose(X, one["X"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(Z, one["MinvR"], rtol=0, atol=1e-10)
    for o in out[1:]:
        np.testing.assert_array_equal(o["sharded"]["iters"], out[0]["sharded"]["iters"])
    assert out[0]["allreduces"] > 0


@functools.lru_cache(maxsize=None)
def _hmc_ref(case):
    js, jp, jops = _jax_model()
    N, Lt = js.Nsites, js.Ltau
    cfg = CASES[case]
    mass = build_mass(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0,
                                                           mass=0.5)])
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, N, 1)) + 0.1 * rng.standard_normal((C, N, Lt))
    v0 = rng.standard_normal((C, N, Lt))
    defl = None
    jdefls = [None] * C
    if cfg.get("deflate_k"):
        jdefls = [jdefl.init(jax.random.PRNGKey(40 + c), cfg["deflate_k"], N, Lt,
                             dtype=jnp.float64) for c in range(C)]
        defl = tuple(np.stack([np.asarray(getattr(d, f)) for d in jdefls])
                     for f in ("W", "chol", "pvec", "lam_max"))
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c]), defl=jdefls[c]),
                  keys[c]) for c in range(C)]
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N, Lt), dtype=jnp.float64)))
        Rpm.append(np.asarray(jax.random.normal(k_p, (2, N, Lt), dtype=jnp.float64)))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    draws = dict(momentum=np.stack(R), pseudofermion=np.stack(Rpm), uniform=np.asarray(U),
                 kpm_start=_start(N))
    return runs, mass, x0, v0, draws, defl


def _projector(Wb):
    """The orthogonal projector onto span(W) of each chain's flattened
    basis, free of sign, order and normalisation (CholeskyQR2's jittered
    Cholesky leaves the rows orthonormal to ~1e-6 only; the deflated start
    depends on the span alone)."""
    f = Wb.reshape(Wb.shape[0], Wb.shape[1], -1)
    Q = np.linalg.qr(np.swapaxes(f, 1, 2))[0]
    return np.einsum("cik,cjk->cij", Q, Q.conj())


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_hmc_with_solver_aid_matches_jax(case, D, sharded):
    runs, mass, x0, v0, draws, defl = _hmc_ref(case)
    out = [o[case] for o in sharded(D)]
    x = np.concatenate([o["x"] for o in out], axis=-2)
    v = np.concatenate([o["v"] for o in out], axis=-2)
    st, one = out[0]["stats"], out[0]
    for c, (jst, jstats) in enumerate(r[:2] for r in runs):
        np.testing.assert_allclose(x[c], np.asarray(jst.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(v[c], np.asarray(jst.v), rtol=0, atol=1e-10)
        np.testing.assert_allclose(st["delta_H"][c], float(jstats.delta_H), rtol=0, atol=1e-9)
        assert bool(st["accepted"][c]) == bool(jstats.accepted)
        assert int(st["iters"][c]) == int(jstats.iters)
        assert int(st["flag"][c]) == int(jstats.flag) == 0
    np.testing.assert_allclose(x, one["one_x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(v, one["one_v"], rtol=0, atol=1e-12)
    for k in ("accepted", "iters", "flag"):
        np.testing.assert_array_equal(st[k], one["one_stats"][k])
        for o in out[1:]:
            np.testing.assert_array_equal(o["stats"][k], st[k])
    if defl is not None:
        Wb = np.concatenate([o["W"] for o in out], axis=-2)
        jW = np.stack([np.asarray(r[0].defl.W) for r in runs])
        np.testing.assert_allclose(_projector(Wb), _projector(jW), rtol=0, atol=1e-8)
