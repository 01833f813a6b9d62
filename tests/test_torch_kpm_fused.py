"""The fused Chebyshev step of the PyTorch port against the JAX package,
float64 on the CPU.

* The plain twin ``checkerboard.fold_fused`` (what the CUDA kernel
  ``csrc/ckb_fold_fused.cu`` is held to on the card) against JAX's
  ``fold_kn_fused`` in Pallas interpret mode: every combination of
  pre/post/a/b/c/prev, both fold directions and the inverse, one chain and
  2 chains × nᵥ = 3 rows with per-chain scalars and diagonals, and with
  one coefficient table per chain (SSH's Ā) against the JAX kernel run
  chain by chain with that chain's table. rtol 1e-10. Each of these steps
  also adds its term of the Chebyshev sum into ``acc``, held to the
  product of complex tensors.
* The sum (``acc``, ``coeff``, ``init``: the coefficient sum of the KPM
  recurrence riding the step) against the product of complex tensors, in
  the init form and added to a sum: shared and per-chain tables, with and
  without ``prev``, float32 and float64, Lω = 20 and an odd Lω; the step's
  result is the same in both forms.
* The port's fold-branch recurrence (``_chebyshev_apply_stacked`` on a
  state with ``expK = None``, which routes to the fused steps) against
  JAX's ``_chebyshev_apply_stacked_pallas`` (interpret mode) and against
  the dense recurrence of both packages, as ``tests/test_kpm.py:263``
  checks the JAX side. 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.ckb_pallas import fold_kn_fused
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.ops import kpm

torch.set_num_threads(1)

UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
KW = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))],
          omega=1.0, lam=0.6, mu=-0.2)
# (direction, reverse, sign, prev, diagonals): both fold directions with
# every combination of prev and pre/post, and the inverse fold once
CASES = ([(d, rev, 1.0, p, g) for d, rev in (("forward", False), ("transpose", True))
          for p in (False, True) for g in ("none", "pre", "post", "both")]
         + [("inverse", True, -1.0, True, "both")])


@pytest.fixture(scope="module")
def models():
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 4), 1.0, 0.1,
                              rng=np.random.default_rng(3), **KW)
    ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1,
                            rng=np.random.default_rng(3), device="cpu", **KW)
    return js, jp, ts, tp


def _jax_fused(js, jp, v, rev, sign, pre, post, a, b, c, prev, tables=None):
    """JAX's fold_kn_fused chain by chain on the [C, nv, N, K] port layout:
    each chain's rows go in as one [nv·K, N] block with its own scalars (and,
    given per-chain ``tables`` (cosh [C, Nb], sinh [C, Nb]), its own)."""
    C, nv, N, K = v.shape
    out = np.empty_like(v)

    def kn(arr):
        return jnp.asarray(arr.transpose(0, 2, 1).reshape(nv * K, N))

    for ch in range(C):
        cb, sb = (jp.cosht, jp.sinht) if tables is None else (tables[0][ch], tables[1][ch])
        o = fold_kn_fused(js.ckb, cb, sb, kn(v[ch]), reverse=rev, sign=sign,
                          pre=None if pre is None else jnp.asarray(pre[ch]),
                          post=None if post is None else jnp.asarray(post[ch]),
                          a=float(a[ch]), b=float(b[ch]), c=c,
                          prev=None if prev is None else kn(prev[ch]), interpret=True)
        out[ch] = np.asarray(o).reshape(nv, K, N).transpose(0, 2, 1)
    return out


def _complex_term(halves, v):
    """The step's term of the Chebyshev sum from complex tensors: per-chain
    ``halves`` ``[C, 2Lω]`` (real | imaginary) times the stacked-real field
    ``v`` ``[C, ..., N, 2Lω]``, back on the stacked-real halves."""
    Lw = v.shape[-1] // 2
    cc = torch.complex(halves[:, :Lw], halves[:, Lw:])
    t = cc.reshape(cc.shape[:1] + (1,) * (v.ndim - 2) + cc.shape[1:]) * \
        torch.complex(v[..., :Lw], v[..., Lw:])
    return torch.cat([t.real, t.imag], dim=-1)


def _sum_operands(rng, v):
    """A start ``acc`` and ``coeff`` halves for a fused step on ``v``."""
    C, K = v.shape[0], v.shape[-1]
    return (torch.as_tensor(rng.standard_normal(v.shape)).to(v.dtype),
            torch.as_tensor(rng.standard_normal((C, K))).to(v.dtype))


@pytest.mark.parametrize("name,rev,sign,use_prev,diag", CASES,
                         ids=[f"{c[0]}-{'prev' if c[3] else 'no_prev'}-{c[4]}" for c in CASES])
@pytest.mark.parametrize("C,nv", [(1, 1), (2, 3)], ids=["1chain", "2chains_nv3"])
def test_fold_fused_twin_matches_jax(models, C, nv, name, rev, sign, use_prev, diag):
    js, jp, ts, tp = models
    N, K = ts.Nsites, 6
    rng = np.random.default_rng([C, nv, int(rev), int(sign < 0), int(use_prev),
                                 ("none", "pre", "post", "both").index(diag)])
    v = rng.standard_normal((C, nv, N, K))
    prev = rng.standard_normal((C, nv, N, K)) if use_prev else None
    pre = rng.uniform(0.5, 1.5, (C, N)) if diag in ("pre", "both") else None
    post = rng.uniform(0.5, 1.5, (C, N)) if diag in ("post", "both") else None
    a, b = rng.uniform(0.5, 2.0, C), rng.uniform(-1.0, 1.0, C)
    c = -1.0 if use_prev else 0.0
    want = _jax_fused(js, jp, v, rev, sign, pre, post, a, b, c, prev)

    def T(arr):
        return None if arr is None else torch.as_tensor(arr)

    acc0, halves = _sum_operands(rng, T(v))
    acc = acc0.clone()
    before = ckb_cuda.fused_launches
    got = ckb_cuda.fold_fused(ts.ckb, tp.cosht, tp.sinht, T(v), reverse=rev, sign=sign,
                              pre=T(pre), post=T(post), a=T(a), b=T(b), c=c, prev=T(prev),
                              acc=acc, coeff=halves, init=False)
    assert ckb_cuda.fused_launches == before  # a CPU tensor takes the twin
    assert got.shape == v.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(acc, acc0 + _complex_term(halves, T(v)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,rev,sign,use_prev,diag",
                         [c for c in CASES if c[4] in ("pre", "post")],
                         ids=[f"{c[0]}-{'prev' if c[3] else 'no_prev'}-{c[4]}"
                              for c in CASES if c[4] in ("pre", "post")])
def test_fold_fused_chain_tables_match_jax(models, name, rev, sign, use_prev, diag):
    """[C, Nb] tables (one per chain, as SSH's τ-averaged Ā has) against
    JAX's fold_kn_fused (interpret mode) run chain by chain with that
    chain's table."""
    js, jp, ts, tp = models
    C, nv, N, K = 2, 3, ts.Nsites, 6
    rng = np.random.default_rng([7, int(rev), int(use_prev), ("pre", "post").index(diag)])
    cb = np.asarray(jp.cosht)[None] * (1.0 + 0.1 * rng.uniform(size=(C, ts.Nbonds)))
    sb = np.asarray(jp.sinht)[None] * (1.0 + 0.2 * rng.standard_normal((C, ts.Nbonds)))
    v = rng.standard_normal((C, nv, N, K))
    prev = rng.standard_normal((C, nv, N, K)) if use_prev else None
    d = rng.uniform(0.5, 1.5, (C, N))
    pre, post = (d, None) if diag == "pre" else (None, d)
    a, b = rng.uniform(0.5, 2.0, C), rng.uniform(-1.0, 1.0, C)
    c = -1.0 if use_prev else 0.0
    want = _jax_fused(js, jp, v, rev, sign, pre, post, a, b, c, prev, tables=(cb, sb))

    def T(arr):
        return None if arr is None else torch.as_tensor(arr)

    acc0, halves = _sum_operands(rng, T(v))
    acc = acc0.clone()
    got = ckb_cuda.fold_fused(ts.ckb, T(cb), T(sb), T(v), reverse=rev, sign=sign, pre=T(pre),
                              post=T(post), a=T(a), b=T(b), c=c, prev=T(prev), acc=acc,
                              coeff=halves, init=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(acc, acc0 + _complex_term(halves, T(v)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("Lw", [20, 7], ids=["Lw20", "Lw7"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("use_prev", [False, True], ids=["no_prev", "prev"])
@pytest.mark.parametrize("tables", ["shared", "chain"])
def test_fold_fused_accumulates_the_complex_product(models, tables, use_prev, dtype, Lw):
    """The step adds its term c_m ⊙ v of the Chebyshev sum (the product of
    complex tensors) into ``acc`` in place; the init form sets ``acc`` to
    that term without reading it; the step's result is the same in both."""
    _, jp, ts, _ = models
    C, nv, N, K = 2, 3, ts.Nsites, 2 * Lw
    rng = np.random.default_rng([Lw, int(use_prev), int(dtype == torch.float32),
                                 ("shared", "chain").index(tables)])

    def T(arr):
        return None if arr is None else torch.as_tensor(arr).to(dtype)

    cb, sb = np.array(jp.cosht), np.array(jp.sinht)
    if tables == "chain":
        cb = cb[None] * (1.0 + 0.1 * rng.uniform(size=(C, ts.Nbonds)))
        sb = sb[None] * (1.0 + 0.2 * rng.standard_normal((C, ts.Nbonds)))
    v = T(rng.standard_normal((C, nv, N, K)))
    coeff = torch.as_tensor(rng.standard_normal((C, Lw)) + 1j * rng.standard_normal((C, Lw)))
    halves = torch.cat([coeff.real, coeff.imag], dim=-1).to(dtype)
    kw = dict(reverse=tables == "chain", pre=T(rng.uniform(0.5, 1.5, (C, N))),
              a=T(rng.uniform(0.5, 2.0, C)), b=T(rng.uniform(-1.0, 1.0, C)),
              c=-1.0 if use_prev else 0.0,
              prev=T(rng.standard_normal((C, nv, N, K))) if use_prev else None)
    term = _complex_term(halves, v)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else dict(rtol=1e-6, atol=1e-6)
    acc = torch.full_like(v, float("nan"))
    first = ckb_cuda.fold_fused(ts.ckb, T(cb), T(sb), v, acc=acc, coeff=halves, init=True, **kw)
    torch.testing.assert_close(acc, term, **tol)
    acc0 = T(rng.standard_normal((C, nv, N, K)))
    acc = acc0.clone()
    got = ckb_cuda.fold_fused(ts.ckb, T(cb), T(sb), v, acc=acc, coeff=halves, init=False, **kw)
    torch.testing.assert_close(got, first, rtol=0, atol=0)
    torch.testing.assert_close(acc, acc0 + term, **tol)


def test_fold_fused_refuses_per_column_tables(models):
    """The fused step takes [Nb] and [C, Nb] tables only."""
    _, _, ts, _ = models
    t = torch.ones((2, ts.Nbonds, 6), dtype=torch.float64)
    with pytest.raises(ValueError, match="must be one of"):
        ckb.fold_fused(ts.ckb, t, t, _ones(2, ts.Nsites, 6), a=_ones(2), b=_ones(2),
                       acc=_ones(2, ts.Nsites, 6), coeff=_ones(2, 6), init=False)


def _ones(*shape):
    return torch.ones(shape, dtype=torch.float64)


@pytest.mark.parametrize("bad", [
    dict(v=_ones(16, 6)),                   # an [N, K] block: no chain axis
    dict(a=1.5),                            # a number where a [C] tensor goes
    dict(b=_ones(1)),                       # [1] for 2 chains
    dict(pre=_ones(16)),                    # [N] where [C, N] goes
    dict(post=_ones(2, 16).float()),        # another dtype
    dict(prev=_ones(1, 16, 6)),             # not v's shape
    dict(coeff=None),                       # a sum with no coefficients
    dict(acc=None),                         # coefficients with no sum
    dict(v=_ones(2, 16, 5), acc=_ones(2, 16, 5), coeff=_ones(2, 5)),    # odd K
    dict(coeff=_ones(2, 3)),                # [C, Lω] coeff
    dict(acc=_ones(2, 16, 6).float()),      # another dtype
], ids=["block", "number_a", "short_b", "flat_pre", "f32_post", "short_prev", "no_coeff",
        "no_acc", "odd_K", "half_coeff", "f32_acc"])
def test_fold_fused_refuses_other_forms(models, bad):
    """The twin takes exactly the kernel's operand forms: [C] scalars,
    [C, N] diagonals, a sum of the field's shape and [C, K] coefficients on
    a [C, ..., N, K] field with K even."""
    _, _, ts, tp = models
    kw = dict(v=_ones(2, ts.Nsites, 6), a=_ones(2), b=_ones(2), acc=_ones(2, ts.Nsites, 6),
              coeff=_ones(2, 6), init=False) | bad
    with pytest.raises(ValueError):
        ckb.fold_fused(ts.ckb, tp.cosht, tp.sinht, kw.pop("v"), **kw)


def test_fold_fused_refuses_acc_sharing_storage(models):
    """``acc`` is updated in place, so it may not share storage with the
    step's ``v`` or ``prev``."""
    _, _, ts, tp = models
    base = _ones(2, 2, ts.Nsites, 6)
    kw = dict(a=_ones(2), b=_ones(2), coeff=_ones(2, 6), init=False)
    with pytest.raises(ValueError):
        ckb.fold_fused(ts.ckb, tp.cosht, tp.sinht, base[:, 0], acc=base[:, 1], **kw)
    with pytest.raises(ValueError):
        ckb.fold_fused(ts.ckb, tp.cosht, tp.sinht, _ones(2, ts.Nsites, 6), acc=base[:, 1],
                       prev=base[:, 0], c=-1.0, **kw)


def test_fold_fused_twin_without_bonds():
    """With no bonds (no hopping) the fold is the identity and the step is
    a·post⊙pre⊙v + b·v + c·prev."""
    spec = ckb.build_checkerboard_spec(6, np.zeros((2, 0), dtype=np.int64))
    assert spec.ngroups == 0
    rng = np.random.default_rng(11)
    v, prev = (torch.as_tensor(rng.standard_normal((2, 3, 6, 4))) for _ in range(2))
    pre, post = (torch.as_tensor(rng.uniform(0.5, 1.5, (2, 6))) for _ in range(2))
    a, b = torch.tensor([1.5, 0.5]).double(), torch.tensor([-0.25, 0.75]).double()
    empty = torch.zeros(0, dtype=torch.float64)
    acc, halves = torch.empty_like(v), torch.as_tensor(rng.standard_normal((2, 4)))
    got = ckb_cuda.fold_fused(spec, empty, empty, v, pre=pre, post=post, a=a, b=b,
                              c=-1.0, prev=prev, acc=acc, coeff=halves, init=True)
    d = (pre * post)[:, None, :, None]
    want = a[:, None, None, None] * d * v + b[:, None, None, None] * v - prev
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(acc, _complex_term(halves, v), rtol=1e-14, atol=1e-14)


@pytest.fixture(scope="module")
def states(models):
    js, jp, ts, tp = models
    C = 2
    x = 0.3 * np.random.default_rng(4).standard_normal((C, ts.Nph, ts.Ltau))
    cfg = dict(max_order=8)
    key = jax.random.PRNGKey(0)
    jops = j_make_model_ops(js)
    jst = [jkpm.setup(jops, jp, jnp.asarray(x[c]), jkpm.KPMConfig(**cfg), key)
           for c in range(C)]
    k1, k2 = jax.random.split(key)
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (ts.Nsites, 1),
                                                             dtype=jnp.float64)))
                  for k in (k1, k2))
    tops = make_model_ops(ts)
    tst = kpm.setup(tops, tp, torch.as_tensor(x), kpm.KPMConfig(**cfg), start)
    assert tst.expK is not None  # small N: the dense branch by default
    return jops, jst, tops, tst


@pytest.mark.parametrize("transposed", [False, True], ids=["A", "AT"])
@pytest.mark.parametrize("inner", [(), (3,)], ids=["C_N_K", "C_nv3_N_K"])
def test_fused_recurrence_matches_jax(states, transposed, inner):
    jops, jst, tops, tst = states
    C = len(jst)
    Lw = (tops.Ltau + 1) // 2
    w = np.random.default_rng(5).standard_normal((C,) + inner + (tops.Nsites, 2 * Lw))
    st_fold = dataclasses.replace(tst, expK=None, expK_inv=None)
    before = ckb_cuda.fused_launches
    got = kpm._chebyshev_apply_stacked(tops, st_fold, torch.as_tensor(w), tst.coeff,
                                       transposed).numpy()
    assert ckb_cuda.fused_launches == before
    dense = kpm._chebyshev_apply_stacked(tops, tst, torch.as_tensor(w), tst.coeff,
                                         transposed).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-9, atol=1e-9)
    for c in range(C):
        jfold = jst[c]._replace(expK=None, expK_inv=None)
        jw = jnp.asarray(w[c])
        want = np.asarray(jkpm._chebyshev_apply_stacked_pallas(
            jops, jfold, jw, jst[c].coeff, transposed=transposed, interpret=True))
        np.testing.assert_allclose(got[c], want, rtol=1e-9, atol=1e-9)
        jdense = np.asarray(jkpm._chebyshev_apply_stacked(
            jops, jst[c], jw, jst[c].coeff, transposed=transposed))
        np.testing.assert_allclose(got[c], jdense, rtol=1e-9, atol=1e-9)


def test_apply_symmetric_fold_branch_matches_dense(states):
    """The whole preconditioner on the fold branch (fused recurrence) equals
    the dense one on a CG-shaped [C, 2, N, Lτ] field."""
    _, _, tops, tst = states
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, 2, tops.Nsites, tops.Ltau)))
    st_fold = dataclasses.replace(tst, expK=None, expK_inv=None)
    cfg = kpm.KPMConfig(max_order=8)
    torch.testing.assert_close(kpm.apply_symmetric(tops, st_fold, v, cfg),
                               kpm.apply_symmetric(tops, tst, v, cfg),
                               rtol=1e-9, atol=1e-9)
