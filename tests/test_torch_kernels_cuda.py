"""The CUDA checkerboard-fold kernel and the fused Chebyshev-step kernel
against their plain torch twins, on the card. Every test here needs an
NVIDIA GPU and skips without one. The file imports neither JAX nor the JAX
package, so a machine with only PyTorch runs it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q -m cuda

The shapes cover the cluster split (cs > 1, and ranks with unequal site
counts where N is not a multiple of cs), the K-tiled route (128×128: a row
larger than 16 slabs), K = 1, odd K with ragged chunk tails, and fields
whose chunks start off a 16-byte boundary (a view one element into its
storage)."""

import functools

import numpy as np
import pytest
import torch

from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda

DIRECTIONS = [("forward", False, 1.0), ("transpose", True, 1.0),
              ("inverse", True, -1.0), ("inverse_transpose", False, -1.0)]
# relative to max|twin|: float64 differs from the twin only by FMA contraction
# and the order of the epilogue's terms
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}


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


# (L, chains, rows per chain, K, offset): the K2 shapes of chip_smoke.py —
# 16 chains, and 16 chains × nᵥ = 10 Green's-function rows — small ragged
# cases, the K-tiled route and misaligned v and prev
FUSED_SHAPES = [(6, 2, 3, 7, 0), (64, 16, 1, 40, 0), (64, 16, 10, 40, 0), (5, 3, 1, 7, 0),
                (6, 2, 2, 1, 0), (128, 2, 1, 40, 0), (64, 16, 2, 40, 1), (5, 3, 1, 7, 1)]
FUSED_IDS = ["6x6", "64x64_C16", "64x64_C16_nv10", "5x5_K7", "6x6_K1", "128x128_ktiled",
             "64x64_C16_misaligned", "5x5_K7_misaligned"]


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
    kw = dict(reverse=rev, sign=sign, pre=pre if not rev else None,
              post=post if rev else None, a=a, b=b, c=-1.0, prev=prev)
    before = ckb_cuda.fused_launches
    got = ckb_cuda.fold_fused(spec, c, s, v, **kw)
    assert ckb_cuda.fused_launches == before + 1
    want = ckb.fold_fused(spec, c, s, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == v.shape and got.dtype == dtype
    assert got.data_ptr() not in (v.data_ptr(), None if prev is None else prev.data_ptr())
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOLS[dtype]


@pytest.mark.cuda
def test_fused_kernel_refuses_bad_inputs(cuda):
    spec, params = _spec(6)
    c, s = params.cosht.to(cuda), params.sinht.to(cuda)
    v = torch.randn((2, spec.nsites, 8), device=cuda, dtype=torch.float64)
    ok = dict(a=torch.ones(2, device=cuda, dtype=torch.float64),
              b=torch.zeros(2, device=cuda, dtype=torch.float64))
    bad = [dict(a=torch.ones(3, device=cuda, dtype=torch.float64)),
           dict(b=0.5),                                              # a number
           dict(pre=torch.ones((2, 5), device=cuda, dtype=torch.float64)),
           dict(post=torch.ones(spec.nsites, device=cuda, dtype=torch.float64)),
           dict(prev=v[:1].contiguous()),
           dict(a=torch.ones(2, device=cuda))]                       # float32 a
    for kw in bad:
        with pytest.raises(ValueError):
            ckb_cuda.fold_fused(spec, c, s, v, **(ok | kw))
    with pytest.raises(ValueError):
        ckb_cuda.fold_fused(spec, c, s, v[0], **ok)                  # no chain axis


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
    kw = dict(pre=0.5 + torch.rand((4, 36), generator=g, device=cuda, dtype=dtype),
              post=0.5 + torch.rand((4, 36), generator=g, device=cuda, dtype=dtype),
              a=0.5 + torch.rand(4, generator=g, device=cuda, dtype=dtype),
              b=torch.rand(4, generator=g, device=cuda, dtype=dtype) - 0.5,
              c=-1.0, prev=prev)
    before = ckb_cuda.fused_launches
    got = ckb_cuda.fold_fused(spec, empty, empty, v, **kw)
    assert ckb_cuda.fused_launches == before + 1
    want = ckb.fold_fused(spec, empty, empty, v, **kw)
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOLS[dtype]
