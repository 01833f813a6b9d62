"""Host-side pieces of the PyTorch port's multi-rank execution, against the
JAX package where it has them; no rank is spawned here.

* The halo plans (``build_shard_plan``, ``build_wij_plan``) equal the JAX
  package's, table for table, on the square lattice (4×4, 8×8) and the
  honeycomb lattice for D = 2 and 4, with ωᵢⱼ dispersion; bonds that reach
  a block that is not ring-adjacent are refused by both.
* ``ChainBlock`` cuts a batch into equal contiguous blocks;
  ``auto_chains`` (``--chains 0``) follows its per-card table, scales with
  40/Lτ and the number of chain ranks.
* Under ``--site-devices`` the near-null preconditioner, 2MN and
  BiCGStab / GMRES raise ``NotImplementedError`` naming the cause, before
  any rank starts; every layout slice H2 ported (SSH under site sharding,
  the 2-D layout, block CG, deflation, tempering on site or chain ranks)
  passes ``check_parallel`` and runs through the CLI on gloo ranks with the
  one-rank run's bins.
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


RUN = [
    ("ssh_site", "ssh_hmc_square", lambda c: None, 1, 2, 1),
    ("both_layouts", "holstein_hmc_square", lambda c: None, 2, 2, 4),
    ("block_site", "holstein_hmc_square", lambda c: c["solver"].update(block=True), 1, 2, 1),
    ("deflation_site", "holstein_hmc_square",
     lambda c: c["solver"].update(deflation={"k": 4}), 1, 2, 1),
    ("tempering_site", "holstein_hmc_square",
     lambda c: c.update(tempering={"ladder": [1.0, 0.9], "freq": 1}), 1, 2, 2),
    ("tempering_chains", "holstein_hmc_square",
     lambda c: c.update(tempering={"ladder": [1.0, 0.9], "freq": 1}), 2, 1, 4),
]

REFUSED = [
    ("nearnull_site", lambda c: c["solver"].update(nearnull={"k": 4}), "refuses it too"),
    ("2mn_site", lambda c: c["hmc"].update(integrator="2mn"), "2MN integrator.*run leapfrog"),
    ("gmres_site", lambda c: c["solver"].update(type="GMRES"), "BiCGStab / GMRES.*by CG"),
    ("bicgstab_site", lambda c: c["solver"].update(type="BiCGStab"), "BiCGStab / GMRES.*by CG"),
]


@pytest.mark.parametrize("edit,pattern", [h[1:] for h in REFUSED], ids=[h[0] for h in REFUSED])
def test_h2_layouts_raise(edit, pattern, tmp_path):
    """The three layouts the JAX package does not really run under
    ``--site-devices`` are refused by ``check_parallel`` and by the CLI
    before it spawns a rank, each message naming its cause (ROADMAP §3);
    without ``--site-devices`` the same file passes."""
    cfg = _stock("holstein_hmc_square")
    edit(cfg)
    with pytest.raises(NotImplementedError, match=pattern):
        check_parallel(cfg, 1, 2)
    path = tmp_path / "h2.toml"
    path.write_text(dump_toml(cfg))
    with pytest.raises(NotImplementedError, match=pattern):
        cli.main([str(path), "--device", "cpu", "--devices", "2", "--site-devices", "2"])
    check_parallel(cfg, 2, 1)


def _bin_numbers(root):
    """Every number of every per-bin file under ``root``, by relative path."""
    out = {}
    for folder, _, files in os.walk(root):
        if not folder.endswith("_f"):
            continue
        for f in files:
            path = os.path.join(folder, f)
            vals = []
            for tok in open(path).read().split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
            out[os.path.relpath(path, root)] = np.asarray(vals)
    return out


@pytest.mark.parametrize("example,edit,devices,site_devices,chains", [h[1:] for h in RUN],
                         ids=[h[0] for h in RUN])
def test_h2_layouts_run(example, edit, devices, site_devices, chains, tmp_path, monkeypatch):
    """Each layout that slice H2 ported is accepted by ``check_parallel``,
    and a cut CLI run on gloo ranks (Holstein on a 2×2 lattice, SSH on
    4×4) ends at the one-rank run's x and writes its bins, to 1e-9. Every
    process runs one torch thread: with more, torch adds some CPU sums in
    another order per thread count, x differs at rounding, and the probe
    solves (tol 1e-5, the KPM order a floor of the spectral bounds) can
    carry that to ~1e-5 relative in the estimators."""
    cfg = _stock(example)
    edit(cfg)
    check_parallel(cfg, devices, site_devices)
    if example.startswith("holstein"):
        cfg["lattice"]["L"] = 2   # SSH's bond-phonon Green's function needs L > 2
    cfg["hmc"].update(burnin_updates=0, simulation_updates=2, trajectory_time=0.05)
    cfg["simulation"].update(filepath=str(tmp_path), num_bins=2)
    cfg["measurements"]["num_random_vectors"] = 2
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    path = tmp_path / "h2.toml"
    path.write_text(dump_toml(cfg))
    base = [str(path), "--device", "cpu", "--x64", "--chains", str(chains)]
    # one torch thread in every process: the CLI gives each rank the host's
    # cores over the ranks
    monkeypatch.setattr(os, "cpu_count", lambda: devices * site_devices)
    torch.set_num_threads(1)
    assert cli.main(base + ["1"]) == 0
    assert cli.main(base + ["2", "--devices", str(devices),
                            "--site-devices", str(site_devices)]) == 0
    folder = cfg["simulation"]["foldername"]
    xs = []
    for i in (1, 2):
        with np.load(tmp_path / f"{folder}-{i}" / "checkpoint.npz") as z:
            xs.append(z["x"])
    np.testing.assert_allclose(xs[1], xs[0], rtol=0, atol=1e-9)
    one, many = (_bin_numbers(tmp_path / f"{folder}-{i}") for i in (1, 2))
    assert len(one) > 5 and one.keys() == many.keys()
    for name, want in one.items():
        np.testing.assert_allclose(many[name], want, rtol=0, atol=1e-9, err_msg=name)
