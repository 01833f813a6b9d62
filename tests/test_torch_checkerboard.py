"""The checkerboard fold of the PyTorch port: the plain torch twin against
the JAX package's XLA fold and its Pallas kernel (interpret mode), and the
CUDA wrapper's CPU behaviour. The kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import checkerboard as jckb
from elphdynamics_tpu.ops import ckb_pallas
from elphdynamics_tpu_torch.lattice import Lattice as TLattice
from elphdynamics_tpu_torch.lattice import UnitCell as TUnitCell
from elphdynamics_tpu_torch.models.holstein import build_holstein as t_build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as tckb
from elphdynamics_tpu_torch.ops import ckb_cuda

torch.set_num_threads(1)

# (name, reverse, sign, JAX XLA fold, port twin)
DIRECTIONS = [
    ("forward", False, 1.0, jckb.ckb_mul, tckb.ckb_mul),
    ("transpose", True, 1.0, jckb.ckb_transpose_mul, tckb.ckb_transpose_mul),
    ("inverse", True, -1.0, jckb.ckb_inverse_mul, tckb.ckb_inverse_mul),
    ("inverse_transpose", False, -1.0, jckb.ckb_inverse_transpose_mul,
     tckb.ckb_inverse_transpose_mul),
]
IDS = [d[0] for d in DIRECTIONS]


def _model(L=6):
    """The disordered 6×6 lattice of tests/test_checkerboard.py's Pallas
    test (non-uniform t on both bond families), built by both packages."""
    kw = dict(beta=1.0, dtau=0.1, omega=1.0, lam=0.5, mu=0.0, dense_threshold=0,
              t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.8, 0.1, 0, 0, (0, 1, 0))])
    uc_args = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = j_build_holstein(JLattice.create(JUnitCell.create(*uc_args), L),
                                    rng=np.random.default_rng(0), **kw)
    tspec, tparams = t_build_holstein(TLattice.create(TUnitCell.create(*uc_args), L),
                                      rng=np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(tparams.cosht.numpy(), np.asarray(params.cosht))
    return spec, np.array(params.cosht), np.array(params.sinht), tspec.ckb


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
@pytest.mark.parametrize("shape", [(16,), (3, 2, 5)], ids=["NK", "B2NK"])
def test_twin_matches_xla_fold(model, name, rev, sign, jfn, tfn, shape):
    spec, c, s, tspec = model
    N = spec.Nsites
    v = np.random.default_rng(1).standard_normal(shape[:-1] + (N, shape[-1]))
    want = np.asarray(jfn(spec.ckb, c, s, v))
    ct, st, vt = torch.as_tensor(c), torch.as_tensor(s), torch.as_tensor(v)
    np.testing.assert_allclose(tfn(tspec, ct, st, vt).numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tckb.fold(tspec, ct, st, vt, reverse=rev, sign=sign).numpy(),
                               want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,rev,sign,jfn,tfn", DIRECTIONS, ids=IDS)
@pytest.mark.parametrize("shape", [(16,), (3, 2, 5)], ids=["NK", "B2NK"])
def test_twin_matches_pallas_interpret(model, name, rev, sign, jfn, tfn, shape):
    spec, c, s, tspec = model
    N = spec.Nsites
    v = np.random.default_rng(2).standard_normal(shape[:-1] + (N, shape[-1]))
    v2, restore = ckb_pallas._to_2d(v)
    want = np.asarray(restore(ckb_pallas.fold_2d(spec.ckb, c, s, v2, reverse=rev, sign=sign,
                                                 interpret=True)))
    got = ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), torch.as_tensor(v),
                        reverse=rev, sign=sign)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_spec_rebuilt_from_lattice_inputs_matches(model):
    spec, _, _, tspec = model
    for f in ("partner", "bond_of_site", "mask", "neighbor_table", "groups"):
        np.testing.assert_array_equal(getattr(tspec, f), getattr(spec.ckb, f))


def test_cuda_wrapper_on_cpu_uses_twin_without_launching(model):
    """ckb_cuda imports and runs with no nvcc and no card: a CPU tensor goes
    to the plain twin and counts no launch."""
    _, c, s, tspec = model
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((2, tspec.nsites, 4)))
    before = ckb_cuda.launches
    for _, rev, sign, _, tfn in DIRECTIONS:
        got = ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), v, reverse=rev, sign=sign)
        assert torch.equal(got, tfn(tspec, torch.as_tensor(c), torch.as_tensor(s), v))
    assert ckb_cuda.launches == before


def test_tile_choice():
    # 64×64 float32 on an H100 (227 KB opt-in, 132 SMs): one wave of blocks
    smem, sms = 232448, 132
    assert ckb_cuda.choose_tile(32, 4096, 40, 4, smem, sms) == 10
    assert ckb_cuda.choose_tile(16, 4096, 1, 4, smem, sms) == 1
    kt = ckb_cuda.choose_tile(32, 4096, 40, 8, smem, sms)
    assert kt * 4096 * 8 <= smem
    for B, N, K, item in ((1, 64, 40, 4), (128, 4096, 40, 4), (3, 1000, 7, 8)):
        kt = ckb_cuda.choose_tile(B, N, K, item, smem, sms)
        assert 1 <= kt <= K and kt * N * item <= smem
    with pytest.raises(ValueError):
        ckb_cuda.choose_tile(1, 40000, 4, 8, smem, sms)


def test_other_devices_refused(model):
    _, c, s, tspec = model
    v = torch.zeros((tspec.nsites, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ckb_cuda.fold(tspec, torch.as_tensor(c), torch.as_tensor(s), v)
