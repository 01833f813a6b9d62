"""The JAX package's block CG on complex fields (complex hopping), unsharded
and site-sharded, beside the PyTorch port's Hermitian block CG, on the CPU
in float64.

    python scripts/block_complex_reference.py

Unsharded: the twisted 4×4 Holstein and SSH models, fields and nᵥ = 4
probes per chain of ``tests/test_torch_block_complex.py`` (KPM max_order 8,
tol 1e-10): per chain the JAX package's ``block_cg`` iterations and true
residuals of the normal equations, its checked ``solve_minv(block=True)``
iterations, residuals and flags, and the port's block-CG and CG
iterations. Sharded: the twisted Holstein model on 2 virtual CPU devices,
``make_sharded_greens_sampler`` with ``[solver] block`` (tol 1e-10 and
1e-6, with and without the KPM preconditioner): its iterations and flag,
and each probe's ‖M·z − R‖/‖R‖ from the unsharded operator, beside the
unsharded checked solve of the same probes. One line per case; no card.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from elphdynamics_tpu import solvers as jsolvers  # noqa: E402
from elphdynamics_tpu.dynamics import solve as jsolve  # noqa: E402
from elphdynamics_tpu.measure.greens import sample_greens  # noqa: E402
from elphdynamics_tpu.ops import kpm as jkpm  # noqa: E402
from elphdynamics_tpu.parallel.lattice_shard import (  # noqa: E402
    build_shard_plan, make_sharded_greens_sampler, site_mesh)
from tests import test_torch_block_complex as T  # noqa: E402


def _norms(a):
    a = np.asarray(a)
    return np.linalg.norm(a.reshape(a.shape[0], -1), axis=1)


def unsharded() -> None:
    for name in ("holstein", "ssh"):
        js, jp, jops, ts, tp, tops, x = T._model(name)
        R = T._cnormal(np.random.default_rng(11), (T.C, T.NV, ts.Nsites, ts.Ltau)) / np.sqrt(2.0)
        ds = tops.stack(tops.derived(tp, T._T(x)))
        pa = T._port_pa(tops, tp, x)
        kw = dict(tol=1e-10, maxiter=500)
        port = {kind: T.tsolve.solve_minv(tops, tp, ds, T._T(R),
                                          T.tsolve.SolverConfig(block=block, **kw), pa,
                                          block=True).iters.tolist()
                for kind, block in (("block_cg", True), ("cg", False))}
        jcfg = jkpm.KPMConfig(**T.KPM)
        for c in range(T.C):
            xc = jnp.asarray(x[c])
            st = jkpm.setup(jops, jp, xc, jcfg, jax.random.PRNGKey(1234))
            P = lambda v: jkpm.apply_symmetric(jops, st, v, jcfg)  # noqa: E731
            d = jops.derived(jp, xc)
            b = jops.mulMT(jp, d, jnp.asarray(R[c]))
            raw = jsolvers.block_cg(lambda v: jops.mulMTM(jp, d, v), b, apply_P=P, **kw)
            resid = _norms(jops.mulMTM(jp, d, raw.x) - b) / _norms(b)
            chk = jsolve.solve_minv(jops, jp, d, jnp.asarray(R[c]),
                                    jsolve.SolverConfig(block=True, **kw),
                                    jsolve.PrecondApplies(symmetric=P, left=None, right=None),
                                    block=True)
            print(f"unsharded {name} chain={c}: jax block_cg iters="
                  f"{np.asarray(raw.iters).tolist()} normal-equation residuals="
                  f"{resid.tolist()}; jax checked iters={np.asarray(chk.iters).tolist()} "
                  f"residuals={np.asarray(chk.residual).tolist()} flags="
                  f"{np.asarray(chk.flag).tolist()}; port block_cg iters="
                  f"{port['block_cg'][c]} cg iters={port['cg'][c]}", flush=True)


def sharded() -> None:
    js, jp, jops, ts, tp, tops, x = T._model("holstein")
    plan, mesh = build_shard_plan(js.ckb, 2), site_mesh(2)
    for tol in (1e-10, 1e-6):
        scfg = jsolve.SolverConfig(tol=tol, maxiter=500, block=True)
        for kcfg in (None, jkpm.KPMConfig(**T.KPM)):
            sample = make_sharded_greens_sampler(js, plan, mesh, T.NV, scfg, kcfg)
            pre = None if kcfg is None else jkpm.make_symmetric_precond(jops, kcfg)
            for c in range(T.C):
                xc, key = jnp.asarray(x[c]), jax.random.PRNGKey(5 + c)
                R, MinvR, iters, flag = sample(jp, xc, key)[:4]
                d = jops.derived(jp, xc)
                rel = _norms(jops.mulM(jp, d, MinvR) - R) / _norms(R)
                gd, _ = sample_greens(jops, jp, xc, key, T.NV, scfg, pre)
                urel = _norms(jops.mulM(jp, d, gd.MinvR) - gd.R) / _norms(gd.R)
                print(f"sharded holstein D=2 tol={tol} kpm={kcfg is not None} chain={c}: "
                      f"iters={int(iters)} flag={int(flag)} |M z - R|/|R|={rel.tolist()}; "
                      f"unsharded checked iters={int(gd.iters)} flag={int(gd.flag)} "
                      f"|M z - R|/|R|={urel.tolist()}", flush=True)


if __name__ == "__main__":
    unsharded()
    sharded()
