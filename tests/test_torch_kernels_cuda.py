"""The CUDA checkerboard-fold kernel against its plain torch twin, on the
card. Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so a machine with only PyTorch
runs it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q -m cuda
"""

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
TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fold kernel has no CPU mode)")
    return torch.device("cuda")


def _spec(L):
    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, L), 1.0, 0.1, dense_threshold=0, rng=np.random.default_rng(0),
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))])
    return spec.ckb, params


@pytest.mark.cuda
@pytest.mark.parametrize("name,rev,sign", DIRECTIONS, ids=[d[0] for d in DIRECTIONS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("L,shape", [(6, (4, 2, 40)), (64, (32, 40)), (64, (16, 1))],
                         ids=["6x6", "64x64_fermion", "64x64_power"])
def test_kernel_matches_twin(cuda, name, rev, sign, dtype, L, shape):
    spec, params = _spec(L)
    c = params.cosht.to(device=cuda, dtype=dtype)
    s = params.sinht.to(device=cuda, dtype=dtype)
    v = torch.randn(shape[:-1] + (spec.nsites, shape[-1]), device=cuda, dtype=dtype)
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
