"""The CUDA checkerboard-fold kernel and the fused Chebyshev-step kernel
against their plain torch twins, on the card. Every test here needs an
NVIDIA GPU and skips without one. The file imports neither JAX nor the JAX
package, so a machine with only PyTorch runs it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q -m cuda

The shapes cover the cluster split (cs > 1, and ranks with unequal site
counts where N is not a multiple of cs), the K-tiled route (128×128: a row
larger than 16 slabs), K = 1, odd K with ragged chunk tails, and fields
whose chunks start off a 16-byte boundary (a view one element into its
storage); K2 takes even K = 2Lω only, so its ragged cases are K = 2 and
K = 14 (Lω = 7). Both kernels also run with one coefficient table per chain
([C, Nb], SSH's Ā), and the fold with one coefficient per chain, bond and
column ([C, Nb, K], SSH's fermion operator), whose tables may themselves
start off a vector boundary; table forms a kernel does not take are
refused. The fold's complex mode (complex64 / complex128 fields and tables,
the bond's second endpoint taking conj(s)) runs the same shapes and forms,
with complex c as the twin carries it. The deep-β shapes: K = Lτ = 160
(β = 16) for both kernels, at every launch candidate, with the deflation
filter's [C·k]-row batches; and K2's per-chain diagonals of a tempering
ladder (λ per chain). Every K2 launch also adds its term of the KPM
coefficient sum into a sum, checked against the twin's beside the step's
result; the init form and the sum at every launch candidate of the
benchmark cells' shapes, a K-tiled row, Lω no multiple of the vector width
and a misaligned field, and inside one graphed preconditioner apply."""

import functools

import numpy as np
import pytest
import torch

from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu_torch.dynamics.tempering import TemperingConfig, ladder_params
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda, kpm
from elphdynamics_tpu_torch.utils import capture

DIRECTIONS = [("forward", False, 1.0), ("transpose", True, 1.0),
              ("inverse", True, -1.0), ("inverse_transpose", False, -1.0)]
# relative to max|twin|: float64 differs from the twin only by FMA contraction
# and the order of the epilogue's terms
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5, torch.complex128: 1e-12,
        torch.complex64: 1e-5}
COMPLEX = [torch.complex128, torch.complex64]
COMPLEX_IDS = ["c128", "c64"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fold kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _spec(L):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, L), 1.0, 0.1, dense_threshold=0, rng=np.random.default_rng(0),
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))], device="cpu")
    return spec.ckb, params


def _err(got, want):
    """The largest error relative to max|want| of a kernel's output, or of
    each of K2's outputs (the step's result, the sum) on its own."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(((x - y).abs().max() / y.abs().max()).item() for x, y in pairs)


def _sum_operands(v, g):
    """A start sum and per-chain ``[C, K]`` coefficients for K2 on ``v``."""
    return (torch.randn(v.shape, generator=g, device=v.device, dtype=v.dtype),
            torch.randn((v.shape[0], v.shape[-1]), generator=g, device=v.device,
                        dtype=v.dtype))


def _k2(fn, acc0):
    """K2 or its twin (``fn``) adding into a fresh copy of the start sum
    ``acc0`` on every call: (the step's result, the sum)."""
    def run(*operands, **kw):
        acc = acc0.clone()
        return fn(*operands, acc=acc, **kw), acc
    return run


def _randn(shape, offset, g, device, dtype):
    """A contiguous normal field; with ``offset``, a view that starts one
    element into its storage (its chunks are not 16-byte aligned)."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g, device=device, dtype=dtype)
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "L,shape,offset",
    [(6, (4, 2, 40), 0), (64, (32, 40), 0), (64, (16, 1), 0), (5, (3, 7), 0), (6, (2, 1), 0),
     (128, (2, 40), 0), (64, (32, 40), 1), (5, (3, 7), 1)],
    ids=["6x6", "64x64_fermion", "64x64_power", "5x5_K7", "6x6_K1", "128x128_ktiled",
         "64x64_misaligned", "5x5_K7_misaligned"])
def test_kernel_matches_twin(cuda, name, rev, sign, dtype, L, shape, offset):
    spec, params = _spec(L)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    v = _randn(shape[:-1] + (spec.nsites, shape[-1]), offset, g, cuda, dtype)
    before = ckb_cuda.launches
    got = ckb_cuda.fold(spec, c, s, v, reverse=rev, sign=sign)
    assert ckb_cuda.launches == before + 1
    want = ckb.fold(spec, c, s, v, reverse=rev, sign=sign)
    torch.cuda.synchronize()
    assert got.shape == v.shape and got.dtype == dtype
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOLS[dtype]


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    spec, params = _spec(6)
    c, s = params.cosht.to(cuda), params.sinht.to(cuda)
    v = torch.randn((spec.nsites, 8), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        ckb_cuda.fold(spec, c.float(), s.float(), v)                 # dtype mismatch
    with pytest.raises(ValueError):
        ckb_cuda.fold(spec, c, s, v.t().contiguous().t())            # not contiguous
    with pytest.raises(ValueError):
        ckb_cuda.fold(spec, c, s, v[:-1].contiguous())               # wrong site count
    with pytest.raises(TypeError):
        ckb_cuda.fold(spec, c.half(), s.half(), v.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kernel,lead", [("fold", (16,)), ("fold", (160,)), ("fused", (16, 1)),
                                         ("fused", (4, 10))],
                         ids=["fold_16", "fold_160", "fused_16x1", "fused_4x10"])
def test_every_launch_candidate_matches_twin(cuda, kernel, lead, dtype):
    """Each geometry the tuning may keep for a shape (``launch_candidates``)
    computes the twin's values, at the 64×64 row counts of a Langevin step
    (16 chains), of nᵥ = 10 probe solves (160 rows; 4 chains × 10) — and the
    launches' shapes are recorded until the counts are reset."""
    spec, params = _spec(64)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    v = torch.randn(lead + (spec.nsites, 40), generator=g, device=cuda, dtype=dtype)
    if kernel == "fold":
        fast, plain, name, kws = ckb_cuda.fold, ckb.fold, "ckb_fold", [
            dict(reverse=rev, sign=sign) for _, rev, sign in DIRECTIONS]
    else:
        C = lead[0]
        diag = 0.5 + torch.rand((C, spec.nsites), generator=g, device=cuda, dtype=dtype)
        a = 0.5 + torch.rand(C, generator=g, device=cuda, dtype=dtype)
        b = torch.rand(C, generator=g, device=cuda, dtype=dtype) - 0.5
        acc0, coeff = _sum_operands(v, g)
        fast, plain, name = _k2(ckb_cuda.fold_fused, acc0), _k2(ckb.fold_fused, acc0), \
            "ckb_fold_fused"
        kws = [dict(reverse=rev, pre=None if rev else diag, post=diag if rev else None, a=a,
                    b=b, c=-1.0, prev=torch.randn_like(v), coeff=coeff, init=False)
               for rev in (False, True)]
    cands = ckb_cuda.launch_candidates(spec, v, name)
    assert len(cands) > 1 and len(set(cands)) == len(cands)
    ckb_cuda.reset_counts()
    for kw in kws:
        want = plain(spec, c, s, v, **kw)
        for geo in cands:
            got = fast(spec, c, s, v, geometry=geo, **kw)
            assert _err(got, want) <= TOLS[dtype], geo
    assert ckb_cuda.launch_shapes == {(f"{kernel}/shared", tuple(v.shape), dtype):
                                      len(kws) * len(cands)}
    assert ckb_cuda.table_launches[f"{kernel}/shared"] == len(kws) * len(cands)
    ckb_cuda.reset_counts()
    assert not ckb_cuda.launch_shapes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kernel,lead", [("fold", (8,)), ("fold", (128,)), ("fused", (4, 2)),
                                         ("fused", (4, 32))],
                         ids=["fold_8", "fold_128", "fused_4x2", "fused_4x32"])
def test_deep_beta_k160_candidates_match_twin(cuda, kernel, lead, dtype):
    """K = Lτ = 160 (β = 16 at Δτ = 0.1) at 64×64: a row of 4096 × 160
    needs the K-tiled route in float32 and float64; every launch candidate
    against the twin, all directions, at the row counts of the deep-β solves
    (4 chains × 2 spins) and of the deflation filter (4 chains × k = 32)."""
    spec, params = _spec(64)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    v = torch.randn(lead + (spec.nsites, 160), generator=g, device=cuda, dtype=dtype)
    if kernel == "fold":
        fast, plain, name, kws = ckb_cuda.fold, ckb.fold, "ckb_fold", [
            dict(reverse=rev, sign=sign) for _, rev, sign in DIRECTIONS]
    else:
        C = lead[0]
        diag = 0.5 + torch.rand((C, spec.nsites), generator=g, device=cuda, dtype=dtype)
        a = 0.5 + torch.rand(C, generator=g, device=cuda, dtype=dtype)
        b = torch.rand(C, generator=g, device=cuda, dtype=dtype) - 0.5
        acc0, coeff = _sum_operands(v, g)
        fast, plain, name = _k2(ckb_cuda.fold_fused, acc0), _k2(ckb.fold_fused, acc0), \
            "ckb_fold_fused"
        kws = [dict(reverse=rev, pre=None if rev else diag, post=diag if rev else None, a=a,
                    b=b, c=-1.0, prev=torch.randn_like(v) if p else None, coeff=coeff,
                    init=False)
               for rev in (False, True) for p in (False, True)]
    cands = ckb_cuda.launch_candidates(spec, v, name)
    assert cands and all(geo.kt < 160 for geo in cands)      # tiled
    for kw in kws:
        want = plain(spec, c, s, v, **kw)
        for geo in cands:
            got = fast(spec, c, s, v, geometry=geo, **kw)
            assert _err(got, want) <= TOLS[dtype], geo
        got = fast(spec, c, s, v, **kw)                       # the tuned geometry
        assert _err(got, want) <= TOLS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("use_prev", [False, True], ids=["no_prev", "prev"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fused_kernel_ladder_diagonals_match_twin(cuda, dtype, rev, use_prev):
    """K2 with the per-chain diagonals of a tempering ladder: Ā's τ-averaged
    exp(−Δτ·V) of a 64×64 Holstein model whose 16 chains hold λ·(1.0, 0.9,
    0.8, 0.7) (4 lanes each), the hopping table [Nb] shared."""
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, 64), 4.0, 0.1, rng=np.random.default_rng(0), device=cuda,
        dtype=dtype, t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, lam2=0.1)
    ops = make_model_ops(spec)
    x = init_phonons_half_filled(ops, params, 16, torch.Generator(device=cuda).manual_seed(1))
    lp = ladder_params(params, TemperingConfig(ladder=(1.0, 0.9, 0.8, 0.7)), 16)
    diag = ops.derived(lp, x).mean(dim=-1)                    # [16, N]
    assert not torch.allclose(diag[0], diag[-1])              # the rungs differ
    g = torch.Generator(device=cuda).manual_seed(12)
    v = torch.randn((16, 2, spec.Nsites, 40), generator=g, device=cuda, dtype=dtype)
    a = 0.5 + torch.rand(16, generator=g, device=cuda, dtype=dtype)
    b = torch.rand(16, generator=g, device=cuda, dtype=dtype) - 0.5
    acc0, coeff = _sum_operands(v, g)
    kw = dict(reverse=rev, pre=None if rev else diag, post=diag if rev else None, a=a, b=b,
              c=-1.0, prev=torch.randn_like(v) if use_prev else None, coeff=coeff, init=False)
    c, s = params.cosht, params.sinht
    ckb_cuda.reset_counts()
    got = _k2(ckb_cuda.fold_fused, acc0)(spec.ckb, c, s, v, **kw)
    want = _k2(ckb.fold_fused, acc0)(spec.ckb, c, s, v, **kw)
    assert ckb_cuda.table_launches["fused/shared"] == 1
    assert _err(got, want) <= TOLS[dtype]


# (L, chains, rows per chain, K, offset): 16 chains, and 16 chains × nᵥ = 10
# Green's-function rows; small ragged cases (K = 2Lω: Lω = 7, Lω = 1), the
# K-tiled route and misaligned v and prev
FUSED_SHAPES = [(6, 2, 3, 14, 0), (64, 16, 1, 40, 0), (64, 16, 10, 40, 0), (5, 3, 1, 14, 0),
                (6, 2, 2, 2, 0), (128, 2, 1, 40, 0), (64, 16, 2, 40, 1), (5, 3, 1, 14, 1)]
FUSED_IDS = ["6x6", "64x64_C16", "64x64_C16_nv10", "5x5_K14", "6x6_K2", "128x128_ktiled",
             "64x64_C16_misaligned", "5x5_K14_misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("use_prev", [False, True], ids=["no_prev", "prev"])
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS[:2], ids=[d[0] for d in DIRECTIONS[:2]])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("L,C,nv,K,offset", FUSED_SHAPES, ids=FUSED_IDS)
def test_fused_kernel_matches_twin(cuda, L, C, nv, K, offset, dtype, name, rev, sign, use_prev):
    spec, params = _spec(L)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    N = spec.nsites
    g = torch.Generator(device=cuda).manual_seed(3)
    v = _randn((C, nv, N, K), offset, g, cuda, dtype)
    prev = _randn((C, nv, N, K), offset, g, cuda, dtype) if use_prev else None
    pre = 0.5 + torch.rand((C, N), generator=g, device=cuda, dtype=dtype)
    post = 0.5 + torch.rand((C, N), generator=g, device=cuda, dtype=dtype)
    a = 0.5 + torch.rand(C, generator=g, device=cuda, dtype=dtype)
    b = torch.rand(C, generator=g, device=cuda, dtype=dtype) - 0.5
    acc0, coeff = _sum_operands(v, g)
    kw = dict(reverse=rev, sign=sign, pre=pre if not rev else None,
              post=post if rev else None, a=a, b=b, c=-1.0, prev=prev, coeff=coeff, init=False)
    before = ckb_cuda.fused_launches
    got = _k2(ckb_cuda.fold_fused, acc0)(spec, c, s, v, **kw)
    assert ckb_cuda.fused_launches == before + 1
    want = _k2(ckb.fold_fused, acc0)(spec, c, s, v, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == v.shape and got[0].dtype == dtype
    assert got[0].data_ptr() not in (v.data_ptr(), None if prev is None else prev.data_ptr())
    assert _err(got, want) <= TOLS[dtype]


@pytest.mark.cuda
def test_fused_kernel_refuses_bad_inputs(cuda):
    spec, params = _spec(6)
    c, s = params.cosht.to(cuda), params.sinht.to(cuda)
    v = torch.randn((2, spec.nsites, 8), device=cuda, dtype=torch.float64)
    ok = dict(a=torch.ones(2, device=cuda, dtype=torch.float64),
              b=torch.zeros(2, device=cuda, dtype=torch.float64), acc=torch.zeros_like(v),
              coeff=torch.ones((2, 8), device=cuda, dtype=torch.float64), init=False)
    bad = [dict(a=torch.ones(3, device=cuda, dtype=torch.float64)),
           dict(b=0.5),                                              # a number
           dict(pre=torch.ones((2, 5), device=cuda, dtype=torch.float64)),
           dict(post=torch.ones(spec.nsites, device=cuda, dtype=torch.float64)),
           dict(prev=v[:1].contiguous()),
           dict(a=torch.ones(2, device=cuda)),                       # float32 a
           dict(acc=None), dict(coeff=None),
           dict(coeff=torch.ones((2, 4), device=cuda, dtype=torch.float64)),   # [C, Lω]
           dict(acc=torch.zeros((2, spec.nsites, 16), device=cuda,
                                dtype=torch.float64)[..., ::2]),     # not contiguous
           dict(acc=v)]                                              # the step's own input
    before = (ckb_cuda.fused_launches, ckb_cuda.fused_acc_launches)
    for kw in bad:
        with pytest.raises(ValueError):
            ckb_cuda.fold_fused(spec, c, s, v, **(ok | kw))
    with pytest.raises(ValueError):
        ckb_cuda.fold_fused(spec, c, s, v[0], **ok)                  # no chain axis
    odd = torch.randn((2, spec.nsites, 7), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):                                  # K = 7 is no 2Lω
        ckb_cuda.fold_fused(spec, c, s, odd, **(ok | dict(
            acc=torch.zeros_like(odd), coeff=torch.ones((2, 7), device=cuda,
                                                        dtype=torch.float64))))
    assert (ckb_cuda.fused_launches, ckb_cuda.fused_acc_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernels_launch_without_bonds(cuda, dtype):
    """A model with no hopping has no bond groups: both kernels still launch
    (the group sweep does nothing) and match their twins."""
    spec = ckb.build_checkerboard_spec(36, np.zeros((2, 0), dtype=np.int64))
    assert spec.ngroups == 0
    empty = torch.zeros(0, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    v, prev = (torch.randn((4, 3, 36, 10), generator=g, device=cuda, dtype=dtype)
               for _ in range(2))
    before = ckb_cuda.launches
    got = ckb_cuda.fold(spec, empty, empty, v)
    assert ckb_cuda.launches == before + 1
    assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()
    acc0, coeff = _sum_operands(v, g)
    kw = dict(pre=0.5 + torch.rand((4, 36), generator=g, device=cuda, dtype=dtype),
              post=0.5 + torch.rand((4, 36), generator=g, device=cuda, dtype=dtype),
              a=0.5 + torch.rand(4, generator=g, device=cuda, dtype=dtype),
              b=torch.rand(4, generator=g, device=cuda, dtype=dtype) - 0.5,
              c=-1.0, prev=prev, coeff=coeff, init=False)
    before = ckb_cuda.fused_launches
    got = _k2(ckb_cuda.fold_fused, acc0)(spec, empty, empty, v, **kw)
    assert ckb_cuda.fused_launches == before + 1
    want = _k2(ckb.fold_fused, acc0)(spec, empty, empty, v, **kw)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOLS[dtype]


def _tables(params, C, K, form, g, device, dtype, offset=0):
    """Per-chain perturbations of the model's coefficients, ``[C, Nb]`` or
    ``[C, Nb, K]``; with ``offset``, views one element into their storage."""
    shape = (C, params.cosht.numel()) + ((K,) if form == "chain_column" else ())
    base = (slice(None), slice(None)) + ((None,) if form == "chain_column" else ())
    c0 = params.cosht.to(device=device, dtype=dtype)[None][base]
    s0 = params.sinht.to(device=device, dtype=dtype)[None][base]
    c = c0 * (1.0 + 0.1 * _randn(shape, offset, g, device, dtype).abs())
    s = s0 * (1.0 + 0.2 * _randn(shape, offset, g, device, dtype))
    if offset:
        c, s = (_randn(shape, offset, g, device, dtype).copy_(t) for t in (c, s))
    return c, s


# (L, field shape [C, (inner,) N, K] without N, offset): SSH 64×64's
# fermion operator [8, 2, 4096, 40], its power iteration [8, 4096, 1] and
# Chebyshev block [8, 2, 4096, 40]; small ragged cases, K-tiled, misaligned
TABLE_SHAPES = [(6, (3, 2, 10), 0), (64, (8, 2, 40), 0), (64, (8, 1), 0), (5, (3, 7), 0),
                (128, (2, 1, 40), 0), (64, (8, 2, 40), 1), (5, (3, 2, 7), 1)]
TABLE_IDS = ["6x6", "64x64_fermion", "64x64_power", "5x5_K7", "128x128_ktiled",
             "64x64_misaligned", "5x5_K7_misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["chain", "chain_column"])
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("L,shape,offset", TABLE_SHAPES, ids=TABLE_IDS)
def test_kernel_tables_match_twin(cuda, L, shape, offset, dtype, name, rev, sign, form):
    spec, params = _spec(L)
    g = torch.Generator(device=cuda).manual_seed(6)
    v = _randn(shape[:-1] + (spec.nsites, shape[-1]), offset, g, cuda, dtype)
    c, s = _tables(params, shape[0], shape[-1], form, g, cuda, dtype, offset)
    before = ckb_cuda.launches
    got = ckb_cuda.fold(spec, c, s, v, reverse=rev, sign=sign)
    assert ckb_cuda.launches == before + 1
    want = ckb.fold(spec, c, s, v, reverse=rev, sign=sign)
    torch.cuda.synchronize()
    assert got.shape == v.shape and got.dtype == dtype
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOLS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("use_prev", [False, True], ids=["no_prev", "prev"])
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS[:2], ids=[d[0] for d in DIRECTIONS[:2]])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("L,C,nv,K,offset", FUSED_SHAPES, ids=FUSED_IDS)
def test_fused_kernel_chain_tables_match_twin(cuda, L, C, nv, K, offset, dtype, name, rev,
                                              sign, use_prev):
    spec, params = _spec(L)
    N = spec.nsites
    g = torch.Generator(device=cuda).manual_seed(7)
    c, s = _tables(params, C, K, "chain", g, cuda, dtype, offset)
    v = _randn((C, nv, N, K), offset, g, cuda, dtype)
    prev = _randn((C, nv, N, K), offset, g, cuda, dtype) if use_prev else None
    d = 0.5 + torch.rand((C, N), generator=g, device=cuda, dtype=dtype)
    a = 0.5 + torch.rand(C, generator=g, device=cuda, dtype=dtype)
    b = torch.rand(C, generator=g, device=cuda, dtype=dtype) - 0.5
    acc0, coeff = _sum_operands(v, g)
    kw = dict(reverse=rev, sign=sign, pre=None if rev else d, post=d if rev else None, a=a, b=b,
              c=-1.0, prev=prev, coeff=coeff, init=False)
    before = ckb_cuda.fused_launches
    got = _k2(ckb_cuda.fold_fused, acc0)(spec, c, s, v, **kw)
    assert ckb_cuda.fused_launches == before + 1
    want = _k2(ckb.fold_fused, acc0)(spec, c, s, v, **kw)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOLS[dtype]


@pytest.mark.cuda
def test_kernels_refuse_other_table_forms(cuda):
    """A table form a kernel does not take raises before any launch: other
    chain counts, bond counts or column counts, per-column tables for the
    fused step, chain tables on a field without a chain axis, tables of
    another dtype, device or layout."""
    spec, params = _spec(6)
    nb, N = spec.nbonds, spec.nsites
    f64 = dict(device=cuda, dtype=torch.float64)
    v = torch.randn((3, 2, N, 8), **f64)
    before = (ckb_cuda.launches, ckb_cuda.fused_launches)
    for shape in ((4, nb), (3, nb + 1), (3, nb, 7), (3, nb, 8, 1), (nb, 8)):
        t = torch.ones(shape, **f64)
        with pytest.raises(ValueError):
            ckb_cuda.fold(spec, t, t, v)
    with pytest.raises(ValueError):
        ckb_cuda.fold(spec, torch.ones((3, nb), **f64), torch.ones((3, nb), **f64), v[0, 0])
    with pytest.raises(ValueError):                                   # cosh and sinh differ
        ckb_cuda.fold(spec, torch.ones((3, nb), **f64), torch.ones((3, nb, 8), **f64), v)
    with pytest.raises(ValueError):                                   # float32 tables
        ckb_cuda.fold(spec, torch.ones((3, nb, 8), device=cuda), torch.ones((3, nb, 8),
                                                                         device=cuda), v)
    with pytest.raises(ValueError):                                   # tables on the CPU
        ckb_cuda.fold(spec, torch.ones((3, nb)).double(), torch.ones((3, nb)).double(), v)
    with pytest.raises(ValueError):                                   # not contiguous
        t = torch.ones((3, 8, nb), **f64).transpose(1, 2)
        ckb_cuda.fold(spec, t, t, v)
    ok = dict(a=torch.ones(3, **f64), b=torch.zeros(3, **f64), acc=torch.zeros_like(v),
              coeff=torch.ones((3, 8), **f64), init=False)
    for shape in ((3, nb, 8), (2, nb)):
        t = torch.ones(shape, **f64)
        with pytest.raises(ValueError):
            ckb_cuda.fold_fused(spec, t, t, v, **ok)
    assert (ckb_cuda.launches, ckb_cuda.fused_launches) == before


@functools.lru_cache(maxsize=None)
def _twisted_spec(L):
    """A twisted lattice: complex128 coefficient tables (Peierls phases)."""
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, L), 1.0, 0.1, dense_threshold=0, rng=np.random.default_rng(0),
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))],
        twist=(np.pi / 4, np.pi / 8), device="cpu")
    assert params.sinht.is_complex()
    return spec.ckb, params


def _check_complex(got, want, dtype):
    assert got.shape == want.shape and got.dtype == dtype
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOLS[dtype]


COMPLEX_SHAPES = [(6, (4, 2, 40), 0), (64, (16, 40), 0), (64, (8, 1), 0), (5, (3, 7), 0),
                  (128, (2, 40), 0), (64, (16, 40), 1), (5, (3, 7), 1)]
COMPLEX_SHAPE_IDS = ["6x6", "64x64_fermion", "64x64_power", "5x5_K7", "128x128_ktiled",
                     "64x64_misaligned", "5x5_K7_misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
@pytest.mark.parametrize("L,shape,offset", COMPLEX_SHAPES, ids=COMPLEX_SHAPE_IDS)
def test_complex_kernel_matches_twin(cuda, name, rev, sign, dtype, L, shape, offset):
    """K1's complex mode with one [Nb] table: every direction, both complex
    types, the cluster split, K-tiling, K = 1, odd K and misaligned rows."""
    spec, params = _twisted_spec(L)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    v = _randn(shape[:-1] + (spec.nsites, shape[-1]), offset, g, cuda, dtype)
    before = ckb_cuda.table_launches["fold/shared/complex"]
    got = ckb_cuda.fold(spec, c, s, v, reverse=rev, sign=sign)
    assert ckb_cuda.table_launches["fold/shared/complex"] == before + 1
    want = ckb.fold(spec, c, s, v, reverse=rev, sign=sign)
    torch.cuda.synchronize()
    _check_complex(got, want, dtype)


def _complex_tables(params, C, K, form, g, device, dtype, offset=0):
    """Per-chain complex tables ``[C, Nb]`` or ``[C, Nb, K]`` around the
    twisted model's, with a nonzero imaginary part of c (the kernel carries
    c complex, as the twin does)."""
    shape = (C, params.cosht.numel()) + ((K,) if form == "chain_column" else ())
    base = (slice(None), slice(None)) + ((None,) if form == "chain_column" else ())
    c0 = params.cosht.to(device=device, dtype=dtype)[None][base]
    s0 = params.sinht.to(device=device, dtype=dtype)[None][base]
    c = c0 * (1.0 + 0.1 * _randn(shape, offset, g, device, dtype))
    s = s0 * (1.0 + 0.2 * _randn(shape, offset, g, device, dtype))
    if offset:
        c, s = (_randn(shape, offset, g, device, dtype).copy_(t) for t in (c, s))
    assert c.imag.abs().max() > 0
    return c, s


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["chain", "chain_column"])
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
@pytest.mark.parametrize("L,shape,offset", TABLE_SHAPES, ids=TABLE_IDS)
def test_complex_kernel_tables_match_twin(cuda, L, shape, offset, dtype, name, rev, sign, form):
    """K1's complex mode with per-chain [C, Nb] and per-(chain, bond, column)
    [C, Nb, K] tables (twisted SSH's Ā and fermion operator)."""
    spec, params = _twisted_spec(L)
    g = torch.Generator(device=cuda).manual_seed(6)
    v = _randn(shape[:-1] + (spec.nsites, shape[-1]), offset, g, cuda, dtype)
    c, s = _complex_tables(params, shape[0], shape[-1], form, g, cuda, dtype, offset)
    key = "fold/column/complex" if form == "chain_column" else "fold/chain/complex"
    before = ckb_cuda.table_launches[key]
    got = ckb_cuda.fold(spec, c, s, v, reverse=rev, sign=sign)
    assert ckb_cuda.table_launches[key] == before + 1
    want = ckb.fold(spec, c, s, v, reverse=rev, sign=sign)
    torch.cuda.synchronize()
    _check_complex(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
def test_complex_kernel_every_candidate_matches_twin(cuda, dtype):
    """Every geometry the tuner may keep for a twisted 64×64 fermion field
    (16 chains) computes the twin's values in the complex mode."""
    spec, params = _twisted_spec(64)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    v = torch.randn((16, spec.nsites, 40), generator=g, device=cuda, dtype=dtype)
    cands = ckb_cuda.launch_candidates(spec, v, "ckb_fold")
    assert len(cands) >= 1 and len(set(cands)) == len(cands)
    for _, rev, sign in DIRECTIONS:
        want = ckb.fold(spec, c, s, v, reverse=rev, sign=sign)
        for geo in cands:
            got = ckb_cuda.fold(spec, c, s, v, reverse=rev, sign=sign, geometry=geo)
            _check_complex(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
def test_complex_kernel_launches_without_bonds(cuda, dtype):
    """No bond groups: the complex mode still launches and copies the field."""
    spec = ckb.build_checkerboard_spec(36, np.zeros((2, 0), dtype=np.int64))
    empty = torch.zeros(0, device=cuda, dtype=dtype)
    v = torch.randn((4, 3, 36, 10), device=cuda, dtype=dtype)
    before = ckb_cuda.launches
    got = ckb_cuda.fold(spec, empty, empty, v)
    assert ckb_cuda.launches == before + 1
    assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()


@pytest.mark.cuda
def test_complex_kernel_refuses_mismatched_tables(cuda):
    """The complex mode takes tables of the field's complex dtype only, and
    the fused step takes no complex field: each raises before a launch,
    and no complex field goes to the twin."""
    spec, params = _twisted_spec(6)
    c128 = params.cosht.to(cuda)
    s128 = params.sinht.to(cuda)
    v128 = torch.randn((2, spec.nsites, 8), device=cuda, dtype=torch.complex128)
    before = (ckb_cuda.launches, ckb_cuda.fused_launches)
    with pytest.raises(ValueError):                   # complex64 field, complex128 tables
        ckb_cuda.fold(spec, c128, s128, v128.to(torch.complex64))
    with pytest.raises(ValueError):                   # complex field, real tables
        ckb_cuda.fold(spec, c128.real.contiguous(), s128.real.contiguous(), v128)
    with pytest.raises(ValueError):                   # real field, complex tables
        ckb_cuda.fold(spec, c128, s128, v128.real.contiguous())
    with pytest.raises(TypeError):                    # K2 is real-only
        ckb_cuda.fold_fused(spec, c128, s128, v128, a=torch.ones(2, device=cuda),
                            b=torch.zeros(2, device=cuda), acc=torch.zeros_like(v128),
                            coeff=torch.ones((2, 8), device=cuda), init=True)
    assert (ckb_cuda.launches, ckb_cuda.fused_launches) == before


# (chains and rows per chain, K, table form, offset): the K2 shapes of the
# benchmark cells (Holstein 64×64: 32 chains × 2 spins, one [Nb] table; SSH
# 64×64: 8 chains, [C, Nb] tables), the K-tiled deep-β row (K = 160),
# Lω = 21 and 10 (no multiple of the vector width: the partner columns
# column by column), and a field one element into its storage
ACC_SHAPES = [((32, 2), 40, "shared", 0), ((8, 2), 40, "chain", 0), ((4, 2), 160, "shared", 0),
              ((4, 2), 42, "chain", 0), ((4, 2), 20, "shared", 0), ((4, 2), 40, "chain", 1)]
ACC_IDS = ["holstein_cell", "ssh_cell", "k160_tiled", "Lw21", "Lw10", "misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("lead,K,tables,offset", ACC_SHAPES, ids=ACC_IDS)
def test_fused_accumulating_kernel_matches_twin(cuda, lead, K, tables, offset, dtype):
    """K2 against the twin at every launch candidate and at the tuned
    geometry: both directions, the init form and the accumulation; the
    step's result and the sum acc ← acc + c_m ⊙ v in place; each launch
    counted under its ``fused/<form>`` key and in ``fused_acc_launches``."""
    spec, params = _spec(64)
    N, C = spec.nsites, lead[0]
    g = torch.Generator(device=cuda).manual_seed(21)
    if tables == "shared":
        c, s = (t.to(device=cuda, dtype=dtype) for t in (params.cosht, params.sinht))
    else:
        c, s = _tables(params, C, K, "chain", g, cuda, dtype)
    v = _randn(lead + (N, K), offset, g, cuda, dtype)
    prev = _randn(lead + (N, K), offset, g, cuda, dtype)
    d = 0.5 + torch.rand((C, N), generator=g, device=cuda, dtype=dtype)
    a = 0.5 + torch.rand(C, generator=g, device=cuda, dtype=dtype)
    b = torch.rand(C, generator=g, device=cuda, dtype=dtype) - 0.5
    coeff = torch.randn((C, K), generator=g, device=cuda, dtype=dtype)
    acc0 = torch.randn(lead + (N, K), generator=g, device=cuda, dtype=dtype)
    cands = ckb_cuda.launch_candidates(spec, v, "ckb_fold_fused")
    assert cands and len(set(cands)) == len(cands)
    assert all(geo.kt < K for geo in cands) == (K == 160)
    ckb_cuda.reset_counts()
    n = 0
    for rev in (False, True):
        kw = dict(reverse=rev, pre=None if rev else d, post=d if rev else None, a=a, b=b,
                  c=-1.0, prev=prev)
        for init in (True, False):
            want_acc = acc0.clone()
            want = ckb.fold_fused(spec, c, s, v, acc=want_acc, coeff=coeff, init=init, **kw)
            for geo in cands + [None]:
                acc = acc0.clone()
                got = ckb_cuda.fold_fused(spec, c, s, v, acc=acc, coeff=coeff, init=init,
                                          geometry=geo, **kw)
                n += 1
                torch.cuda.synchronize()
                for x, y in ((got, want), (acc, want_acc)):
                    assert ((x - y).abs().max() / y.abs().max()).item() <= TOLS[dtype], geo
    assert ckb_cuda.fused_acc_launches == ckb_cuda.table_launches[f"fused/{tables}"] == n
    assert ckb_cuda.launch_shapes == {(f"fused/{tables}", tuple(v.shape), dtype): n}
    ckb_cuda.reset_counts()
    assert ckb_cuda.fused_acc_launches == 0


@pytest.mark.cuda
def test_graphed_symmetric_apply_accumulates_in_every_k2_launch(cuda):
    """One graphed preconditioner apply on the fold branch (a 64×64 Holstein
    model, β = 4: Ā is no dense matrix): its replay launches K2 2·max_order
    times, every launch carrying the coefficient sum, and gives the eager
    apply's values."""
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, 64), 4.0, 0.1, rng=np.random.default_rng(0), device=cuda,
        dtype=torch.float32, omega=1.0, lam=1.0,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))])
    ops = make_model_ops(spec)
    x = init_phonons_half_filled(ops, params, 2, torch.Generator(device=cuda).manual_seed(1))
    cfg = kpm.KPMConfig(max_order=8)
    st = kpm.setup(ops, params, x, cfg, kpm.start_vectors(ops.Nsites))
    assert st.expK is None and st.S_fwd is None
    v = torch.randn((2, 2, ops.Nsites, ops.Ltau), generator=torch.Generator(device=cuda)
                    .manual_seed(2), device=cuda)
    want = kpm.apply_symmetric(ops, st, v, cfg)          # the warm-up tunes the geometry
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    ckb_cuda.reset_counts()
    with capture.recording() as rec:
        with torch.cuda.graph(graph):
            got = kpm.apply_symmetric(ops, st, v, cfg)
    assert ckb_cuda.fused_launches == 0                  # a capture launches nothing
    graph.replay()
    rec.replayed()
    torch.cuda.synchronize()
    fused = sum(n for k, n in ckb_cuda.table_launches.items() if k.startswith("fused/"))
    assert fused == 2 * cfg.max_order
    assert ckb_cuda.fused_acc_launches == fused
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    ckb_cuda.reset_counts()
