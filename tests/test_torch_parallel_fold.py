"""The site-sharded fold and solve of the PyTorch port, on 2 and 4 gloo
ranks on the CPU (float64), against the JAX package and the one-rank port.

* The halo fold in its four directions (forward, transpose, inverse,
  inverse transpose) on the ranks' blocks, assembled, equals the JAX
  package's unsharded ``ops/checkerboard`` fold to 1e-12, for real and
  complex (conj(s) on the second endpoint) tables on the square lattice
  (4×4 and 8×8) and on the honeycomb lattice; per-chain ``[C, Nb]``
  tables equal the port's plain fold.
* On a 4×4 Holstein model (plain, with ωᵢⱼ dispersion and ω₄, twisted):
  M, Mᵀ, ∂M/∂x, Sb and ∂Sb/∂x on the blocks, the KPM window and a checked
  KPM-CG solve of MᵀM equal the one-rank port's (1e-12; solve to 1e-10),
  with equal iterations and flags.

The collectives themselves (gather to the host, broadcasts, the
all-reduce, real and complex128 with the same bits on every rank, the
two-way halo exchange with distinct neighbours and with
one rank on both sides) are checked on their own first.

Each test spawns its ranks (``parallel.multihost.launch``, a ``file://``
store in a fresh directory under ``tmp_path``, one thread per rank) with a
timeout, so a hang fails the test instead of the suite.
"""

import copy
import os

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.ops import checkerboard as jckb
from elphdynamics_tpu_torch.ops import checkerboard as tckb
from elphdynamics_tpu_torch.parallel.multihost import launch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
TIMEOUT = 120


def _table(name, L):
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml"))
    cfg["lattice"]["L"] = L
    cfg["simulation"]["random_seed"] = 1
    return jconfig.build_setup(copy.deepcopy(cfg), "unused").ops.spec.ckb


@pytest.mark.parametrize("D", [2, 4])
def test_collectives(D, tmp_path):
    out = launch(W.collectives_worker, D, "gloo", "cpu", timeout_s=TIMEOUT, threads=1,
                 store_dir=str(tmp_path))
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["fetch"], np.repeat(np.arange(D, dtype=float), 2)[:, None]
                                      * np.ones((1, 3)))
        np.testing.assert_array_equal(o["tree"]["a"]["b"], np.repeat(np.arange(D, dtype=float), 3))
        assert (o["int"], o["str"], o["primary"]) == (7, "rank 0", r == 0)
        np.testing.assert_array_equal(o["sum"], [D, D * (D - 1) / 2])
        # complex sums: right, and the same bits on every rank
        assert o["csum"].dtype == np.complex128
        np.testing.assert_allclose(o["csum"], [[D * (1 + 2j), 1j * D * (D - 1) / 2],
                                               [0.1 * D * (D + 1) / 2,
                                                0.3j * sum(1 / k for k in range(1, D + 1))]],
                                   rtol=1e-15, atol=0)
        np.testing.assert_array_equal(o["csum"], out[0]["csum"])
        # the previous rank's "next" message and the next rank's "prev" one
        np.testing.assert_array_equal(o["from_prev"], np.full((1, 2), 10.0 * ((r - 1) % D)))
        np.testing.assert_array_equal(o["from_next"], np.full((3,), -1.0 * ((r + 1) % D)))
        assert o["none"] == (None, None)


@pytest.mark.parametrize("D", [2, 4])
def test_halo_fold_matches_jax(D, tmp_path):
    rng = np.random.default_rng(D)
    specs = [_table("holstein_hmc_square", 4), _table("holstein_hmc_square", 8),
             _table("holstein_hmc_honeycomb", 4)]
    cases, refs = [], []
    for spec in specs:
        nb, N = spec.nbonds, spec.nsites
        c = np.cosh(0.1 * (1 + 0.2 * rng.random(nb)))
        s = np.sinh(0.1 * (1 + 0.2 * rng.random(nb)))
        v = rng.standard_normal((2, 3, N, 5))
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, nb))
        for cc, ss, vv in ((c, s, v), (c.astype(complex), ph * s,
                                       v + 1j * rng.standard_normal(v.shape))):
            cases.append((spec.neighbor_table, N, cc, ss, vv))
            refs.append({name: np.asarray(fn(spec, cc, ss, vv)) for name, fn in (
                ("mul", jckb.ckb_mul), ("transpose", jckb.ckb_transpose_mul),
                ("inverse", jckb.ckb_inverse_mul),
                ("inverse_transpose", jckb.ckb_inverse_transpose_mul))})
    # per-chain [C, Nb] tables (the JAX fold has none) against the port's plain fold
    spec = specs[0]
    tspec = tckb.build_checkerboard_spec(spec.nsites, spec.neighbor_table)
    cc = np.cosh(0.1 * (1 + rng.random((2, spec.nbonds))))
    ss = np.sinh(0.1 * (1 + rng.random((2, spec.nbonds))))
    vv = rng.standard_normal((2, 3, spec.nsites, 5))
    cases.append((spec.neighbor_table, spec.nsites, cc, ss, vv))
    refs.append({name: tckb.fold(tspec, torch.as_tensor(cc), torch.as_tensor(ss),
                                 torch.as_tensor(vv), reverse=rev, sign=sg).numpy()
                 for name, rev, sg in W.FOLDS})
    out = launch(W.fold_worker, D, "gloo", "cpu", (cases,), timeout_s=TIMEOUT, threads=1,
                 store_dir=str(tmp_path))
    for i, ref in enumerate(refs):
        for name, want in ref.items():
            got = np.concatenate([o[(i, name)] for o in out], axis=-2)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=f"case {i} {name}")
        msgs, nbytes, folds = out[0][(i, "halo")]
        assert folds == 4 and msgs > 0 and nbytes > 0


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_operators_and_cg_match_one_rank(D, tmp_path):
    out = launch(W.solve_worker, D, "gloo", "cpu", (4, ("plain", "wij", "twist"), 2),
                 timeout_s=TIMEOUT, threads=1, store_dir=str(tmp_path))
    for rank_out in out:
        for case, r in rank_out.items():
            for key in ("mulM", "mulMT", "muldMdx", "Sb", "dSbdx", "lam_avg", "lam_mag"):
                assert r[key] < 1e-12, (case, key, r[key])
            assert r["cg_x"] < 1e-10, (case, r["cg_x"])
            assert r["iters"][0] == r["iters"][1], (case, r["iters"])
            assert r["flags"][0] == r["flags"][1] == [[0, 0], [0, 0]]
            # two all-reduces per CG iteration, a handful around each solve
            assert r["allreduces"] >= 2 * max(max(row) for row in r["iters"][1])
