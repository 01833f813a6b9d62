"""The dispersive (ωᵢⱼ) phonon force added in a fixed order, float64 on the
CPU.

``models/holstein.calc_dSbdx`` and ``parallel/lattice_shard.SiteShard.
wij_dsb`` add each site's ωᵢⱼ terms with gathers in a fixed order (its
pairs as first endpoint, then as second), where two ``index_add`` calls
made, on a card, an atomic sum in no fixed order over a site that ends
several pairs. On the 4×4 dispersive model, whose every site is the first
endpoint of two pairs (bonds along x and y) and the second of two:

* the force equals the JAX package's ``calc_dSbdx`` to 1e-12;
* it equals the two ``index_add`` calls bit for bit (float64 and float32),
  which on the CPU add in source order;
* on 2 gloo site ranks each rank's force equals the old form bit for bit
  and its block of the one-rank force to 1e-12;
* ``utils.math.add_plan`` orders the sources per row and leaves out the
  masked ones.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import holstein as JH
from elphdynamics_tpu_torch.models import holstein as H
from elphdynamics_tpu_torch.parallel.multihost import launch
from elphdynamics_tpu_torch.utils.math import add_plan, ordered_add

torch.set_num_threads(1)


def _fields(spec, dtype=torch.float64, seed=0):
    return torch.randn((3, spec.Nsites, spec.Ltau), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed)).to(dtype)


def _index_add_form(spec, p, x):
    """The force as the two ``index_add`` calls made it."""
    om2, om4 = (p.omega ** 2)[:, None], p.omega4[:, None]
    lap = torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1) - 2.0 * x
    d = spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
    i, j = (torch.as_tensor(spec.wij_table[k]) for k in (0, 1))
    sgn = torch.as_tensor(spec.wij_sign, dtype=x.dtype)[:, None]
    pair = spec.dtau * (p.wij ** 2)[:, None] * (x.index_select(-2, i) + sgn * x.index_select(-2, j))
    return d.index_add(-2, i, pair).index_add(-2, j, sgn * pair)


def test_model_repeats_endpoints():
    spec, _ = W.build(4, 1.0, 0.1, "wij")
    assert spec.wij_table.shape == (2, 32)
    assert np.bincount(spec.wij_table[0]).tolist() == [2] * 16
    assert np.bincount(spec.wij_table[1]).tolist() == [2] * 16


@pytest.mark.parametrize("shifted", [False, True])
def test_force_matches_jax(shifted):
    spec, p = W.build(4, 1.0, 0.1, "wij")
    jspec, jp = JH.build_holstein(JLattice.create(JUnitCell.create(*W.UC), 4), 1.0, 0.1,
                                  rng=np.random.default_rng(5), **W.holstein_kw("wij"))
    x = _fields(spec, seed=1)
    want = np.asarray(JH.calc_dSbdx(jspec, jp, x.numpy(), shifted))
    np.testing.assert_allclose(H.calc_dSbdx(spec, p, x, shifted).numpy(), want, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_fixed_order_equals_index_add(dtype):
    spec, p = W.build(4, 1.0, 0.1, "wij")
    for seed in range(3):
        x = _fields(spec, dtype, seed)
        assert torch.equal(H.calc_dSbdx(spec, p, x), _index_add_form(spec, p, x))


def test_sharded_force_equals_index_add_and_one_rank(tmp_path):
    spec, p = W.build(4, 1.0, 0.1, "wij")
    whole = H.calc_dSbdx(spec, p, _fields(spec, seed=4)).numpy()
    out = launch(W.wij_force_worker, 2, "gloo", "cpu", (4,), timeout_s=120, threads=1,
                 store_dir=str(tmp_path))
    for new, old in out:
        np.testing.assert_array_equal(new, old)
    np.testing.assert_allclose(np.concatenate([new for new, _ in out], axis=-2), whole,
                               rtol=0, atol=1e-12)


def test_add_plan_orders_and_masks():
    members, valid = add_plan([2, 0, 2, 1, 2], 4, keep=[True, True, True, True, False])
    assert members.shape == (2, 4)
    assert valid.tolist() == [[True, True, True, False], [False, False, True, False]]
    assert members[0, :3].tolist() == [1, 3, 0] and members[1, 2] == 2
    d = torch.zeros((4, 1), dtype=torch.float64)
    src = torch.arange(1.0, 6.0, dtype=torch.float64)[:, None]
    got = ordered_add(d, src, torch.as_tensor(members), torch.as_tensor(valid[:, :, None]))
    assert got[:, 0].tolist() == [2.0, 4.0, 4.0, 0.0]
    members, valid = add_plan([], 3)
    assert members.shape == (1, 3) and not valid.any()
