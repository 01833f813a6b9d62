"""Host-side pieces of the PyTorch port's multi-rank execution, against the
JAX package where it has them; no rank is spawned here.

* The halo plans (``build_shard_plan``, ``build_wij_plan``) equal the JAX
  package's, table for table, on the square lattice (4×4, 8×8) and the
  honeycomb lattice for D = 2 and 4, with ωᵢⱼ dispersion; bonds that reach
  a block that is not ring-adjacent are refused by both.
* ``ChainBlock`` cuts a batch into equal contiguous blocks;
  ``auto_chains`` (``--chains 0``) follows its per-card table, scales with
  40/Lτ and the number of chain ranks.
* Every layout of the next slice (H2) raises ``NotImplementedError``
  naming it, before any rank starts.
"""

import copy
import os

import numpy as np
import pytest
import torch

from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.ops.checkerboard import build_checkerboard_spec as j_build_ckb
from elphdynamics_tpu.parallel.lattice_shard import build_shard_plan as j_build_shard_plan
from elphdynamics_tpu.parallel.lattice_shard import build_wij_plan as j_build_wij_plan
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.ops.checkerboard import build_checkerboard_spec
from elphdynamics_tpu_torch.parallel.chains import ChainBlock
from elphdynamics_tpu_torch.parallel.lattice_shard import build_shard_plan, build_wij_plan
from elphdynamics_tpu_torch.simulation import CHAINS_PER_CARD, auto_chains, check_parallel

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _stock(name):
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml"))
    cfg["simulation"]["random_seed"] = 3
    return cfg


def _with_wij(cfg):
    cfg["holstein"]["omega_ij"] = [dict(val=0.3, orbit=[1, 1], dL=[1, 0, 0]),
                                   dict(val=0.2, sign=-1, orbit=[1, 1], dL=[0, 1, 0])]
    return cfg


@pytest.mark.parametrize("name,L,D", [("holstein_hmc_square", 4, 2),
                                      ("holstein_hmc_square", 4, 4),
                                      ("holstein_hmc_square", 8, 2),
                                      ("holstein_hmc_square", 8, 4),
                                      ("holstein_hmc_honeycomb", 4, 2),
                                      ("holstein_hmc_honeycomb", 4, 4)])
def test_plans_match_jax(name, L, D, tmp_path):
    cfg = _stock(name)
    cfg["lattice"]["L"] = L
    if name == "holstein_hmc_square":
        cfg = _with_wij(cfg)
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path / "jax"))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path / "torch"), "cpu", torch.float64)
    jp = j_build_shard_plan(js.ops.spec.ckb, D)
    tp = build_shard_plan(ts.ops.spec.ckb, D)
    assert (tp.D, tp.B, tp.ngroups, tp.hp, tp.hn) == (jp.D, jp.B, jp.ngroups, jp.hp, jp.hn)
    for field in ("send_next", "send_prev", "partner_local", "bond_of_site", "mask", "is_lo"):
        for a, b in zip(getattr(tp, field), getattr(jp, field)):
            np.testing.assert_array_equal(a, b, err_msg=field)
    # some group crosses a block boundary (with D = 2 the neighbour on both
    # sides is one rank, and the plan counts it as the previous one)
    assert max(tp.hp) > 0 and (D == 2 or max(tp.hn) > 0)
    np.testing.assert_array_equal(ts.ops.spec.wij_table, js.ops.spec.wij_table)
    jw = j_build_wij_plan(js.ops.spec.wij_table, js.ops.Nsites, D)
    tw = build_wij_plan(ts.ops.spec.wij_table, ts.ops.Nsites, D)
    if jw is None:
        assert tw is None
        return
    assert (tw.D, tw.B, tw.hp, tw.hn) == (jw.D, jw.B, jw.hp, jw.hn)
    for field in ("send_next", "send_prev", "row_i", "ext_j", "k_i", "mask_i", "row_j",
                  "ext_i", "k_j", "mask_j"):
        np.testing.assert_array_equal(getattr(tw, field), getattr(jw, field), err_msg=field)


def test_plan_refuses_non_adjacent_bonds():
    """Bonds i → i+2 on 8 sites: blocks of one site are not ring-adjacent to
    the partner's, blocks of two are (both packages)."""
    table = np.asarray([[0, 1, 2, 3, 4, 5, 6, 7], [2, 3, 4, 5, 6, 7, 0, 1]])
    ckb, jckb = build_checkerboard_spec(8, table), j_build_ckb(8, table)
    for build, spec in ((build_shard_plan, ckb), (j_build_shard_plan, jckb)):
        with pytest.raises(NotImplementedError, match="non-adjacent"):
            build(spec, 8)
    assert build_shard_plan(ckb, 4).B == j_build_shard_plan(jckb, 4).B == 2
    with pytest.raises(NotImplementedError, match="non-adjacent"):
        build_wij_plan(table, 8, 8)
    with pytest.raises(ValueError, match="divisible"):
        build_shard_plan(ckb, 3)


def test_chain_block_and_auto_chains():
    blocks = [ChainBlock.of(12, 3, r) for r in range(3)]
    assert [(b.lo, b.n, b.total) for b in blocks] == [(0, 4, 12), (4, 4, 12), (8, 4, 12)]
    x = torch.arange(24.0).reshape(12, 2)
    np.testing.assert_array_equal(torch.cat([b.local(x) for b in blocks]).numpy(), x.numpy())
    with pytest.raises(ValueError, match="multiple"):
        ChainBlock.of(10, 4, 0)
    for model, table in CHAINS_PER_CARD.items():
        hol = model == "holstein"
        for n, per_card in table.items():
            assert auto_chains(n, 40, 1, hol) == per_card
            assert auto_chains(n, 40, 4, hol) == 4 * per_card
            assert auto_chains(n, 80, 1, hol) == max(1, per_card // 2)
    # between two measured sizes the nearer one in log N; never below one
    assert auto_chains(100, 40, 1, True) == CHAINS_PER_CARD["holstein"][64]
    assert auto_chains(4096, 40 * 65, 2, False) == 2


H2 = [
    ("ssh_site", lambda c: c.update(ssh={}), 1, 2),
    ("both_layouts", lambda c: None, 2, 2),
    ("gmres_site", lambda c: c["solver"].update(type="GMRES"), 1, 2),
    ("block_site", lambda c: c["solver"].update(block=True), 1, 2),
    ("deflation_site", lambda c: c["solver"].update(deflation={"k": 4}), 1, 2),
    ("nearnull_site", lambda c: c["solver"].update(nearnull={"k": 4}), 1, 2),
    ("2mn_site", lambda c: c["hmc"].update(integrator="2mn"), 1, 2),
    ("tempering_site", lambda c: c.update(tempering={"ladder": [1.0, 0.5]}), 1, 2),
    ("tempering_chains", lambda c: c.update(tempering={"ladder": [1.0, 0.5]}), 2, 1),
]


@pytest.mark.parametrize("edit,devices,site_devices", [h[1:] for h in H2],
                         ids=[h[0] for h in H2])
def test_h2_layouts_raise(edit, devices, site_devices, tmp_path):
    """Each layout of the next slice is refused by ``check_parallel`` and
    by the CLI before it spawns a rank."""
    cfg = _stock("holstein_hmc_square")
    edit(cfg)
    with pytest.raises(NotImplementedError, match="slice H2"):
        check_parallel(cfg, devices, site_devices)
    path = tmp_path / "h2.toml"
    path.write_text(dump_toml(cfg))
    with pytest.raises(NotImplementedError, match="slice H2"):
        cli.main([str(path), "--device", "cpu", "--devices", str(devices),
                  "--site-devices", str(site_devices)])
    check_parallel(_stock("holstein_hmc_square"), devices, 1)
