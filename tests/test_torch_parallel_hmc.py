"""The site-sharded Holstein HMC update of the PyTorch port against the JAX
package's unsharded ``make_hmc_step`` and the port's one-rank step, on 2
and 4 gloo ranks on the CPU in float64.

One update of 2 chains on a 4×4 lattice, in the eager form and in the
segmented one (the graphed update's segments, run directly on the CPU),
with the symmetric KPM preconditioner, warm starts (``guess_order = 3``) and Nb = 2 bosonic
substeps, CG to 1e-9, with the JAX package's own draws fed in (each rank keeps its
block of sites): plain, with ωᵢⱼ dispersion and an ω₄ term, on a twisted
lattice (complex hopping; ``test_torch_parallel_hmc_twisted.py``), and
with a dynamic dt (there too). The assembled x and v
agree with JAX to 1e-10 and with the one-rank port to 1e-12; ΔH to 1e-9;
the accept decisions, flags and mean CG iterations are equal. (The JAX
package's own slow tests hold its sharded step equal to the same unsharded
step.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as W
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch.parallel.multihost import launch

L, BETA = 4, 1.0
CFG = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-9, maxiter=500,
           construct_guess=True, guess_order=3)
KPM = dict(max_order=4)
C = 2
TIMEOUT = 180


@functools.lru_cache(maxsize=None)
def _jax_run(case, dt=None):
    """The JAX package's update of each chain, its draws and inputs."""
    jspec, jparams = j_build_holstein(JLattice.create(JUnitCell.create(*W.UC), L), BETA, 0.1,
                                      rng=np.random.default_rng(5), **W.holstein_kw(case))
    N, Lt = jspec.Nsites, jspec.Ltau
    mass = build_mass(np.asarray(jparams.omega), 0.1, Lt,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, N, 1)) + 0.1 * rng.standard_normal((C, N, Lt))
    v0 = rng.standard_normal((C, N, Lt))
    jops = j_make_model_ops(jspec)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**CFG),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM)),
                                    dynamic_dt=dt is not None))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    extra = () if dt is None else (jnp.asarray(dt, dtype=jnp.float64),)
    runs = [jstep(jparams, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c],
                  *extra) for c in range(C)]
    cplx = case == "twist"
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N, Lt), dtype=jnp.float64)))
        r = np.asarray(jax.random.normal(k_p, (2, N, Lt), dtype=jnp.float64))
        Rpm.append((r[0] + 1j * r[1])[None] if cplx else r)
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = [np.asarray(jax.random.normal(k, (N, 1), dtype=jnp.float64)) for k in (k1, k2)]
    draws = dict(momentum=np.stack(R), pseudofermion=np.stack(Rpm), uniform=np.asarray(U),
                 kpm_start=start)
    return runs, mass, x0, v0, draws


def _check(case, dt, D, tmp_path, form="segmented"):
    """One sharded update on D ranks, in ``form`` (``segmented``: the
    graphed update's segments; ``eager``), against JAX and the one-rank
    port."""
    runs, mass, x0, v0, draws = _jax_run(case, dt)
    out = launch(W.hmc_worker, D, "gloo", "cpu",
                 (L, BETA, case, CFG, KPM, mass, x0, v0, draws, dt, None, form),
                 timeout_s=TIMEOUT, threads=1, store_dir=str(tmp_path))
    x = np.concatenate([o["x"] for o in out], axis=-2)
    v = np.concatenate([o["v"] for o in out], axis=-2)
    st = out[0]["stats"]
    for o in out[1:]:  # every rank took the same decisions
        for k in ("accepted", "iters", "flag"):
            np.testing.assert_array_equal(o["stats"][k], st[k])
    for c, (jst, jstats) in enumerate(r[:2] for r in runs):
        np.testing.assert_allclose(x[c], np.asarray(jst.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(v[c], np.asarray(jst.v), rtol=0, atol=1e-10)
        np.testing.assert_allclose(st["delta_H"][c], float(jstats.delta_H), rtol=0, atol=1e-9)
        assert bool(st["accepted"][c]) == bool(jstats.accepted)
        assert int(st["iters"][c]) == int(jstats.iters)
        assert int(st["flag"][c]) == int(jstats.flag) == 0
    one = out[0]
    np.testing.assert_allclose(x, one["one_x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(v, one["one_v"], rtol=0, atol=1e-12)
    for k in ("accepted", "iters", "flag"):
        np.testing.assert_array_equal(st[k], one["one_stats"][k])
    np.testing.assert_allclose(st["delta_H"], one["one_stats"]["delta_H"], rtol=0, atol=1e-10)
    msgs, nbytes, folds, allreduces = one["halo"]
    assert msgs > 0 and nbytes > 0 and folds > 0 and allreduces > 0


@pytest.mark.parametrize("form", ["eager", "segmented"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["plain", "wij"])
def test_sharded_hmc_update_matches_jax(case, D, form, tmp_path):
    _check(case, None, D, tmp_path, form)
