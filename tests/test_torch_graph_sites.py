"""The site-sharded sampler calls segmented (``dynamics/graphs.py`` on a
site shard: on a card on NCCL ranks they replay CUDA graphs with the site
group's all-reduces and halo exchanges inside them) against their eager
forms, on gloo ranks on the CPU in float64 at 4×4 (Lτ = 10), where the
segments run directly with the same collectives inside them.

On 2 site ranks (``torch_parallel_workers.graph_sites_worker``): Holstein
(the update twice, the dt tuner's update, the block-CG and the deflated
update, the Euler and Runge-Kutta Langevin steps, the reflection and swap
moves, the measurement's probe solves by CG and block CG), Holstein with
ωᵢⱼ dispersion, SSH, and both under complex hopping. On 4 ranks (2 chain ×
2 site): a laddered update and the tempering exchange of both parities.
Every call equals its eager form bit for bit on the same draws (results,
host reads, the shard's counters), and the ranks of a site group take
equal host reads, graph replays, counters, decisions and iterations (SSH's
bond field, whole on every rank, bit for bit). The halo exchange
delivers each neighbour's rows on 2 and 4 ranks. The gate
(``graphs.graphable``) reads the site group's backend: a gloo site group on
a card runs the eager calls. A stand-in capture counts
the host-to-device copies of a second call on a one-rank site group: none
(the ωᵢⱼ signs among them, uploaded once per device and dtype). The
segmented sharded update against the JAX package is in
``test_torch_parallel_hmc.py`` and ``test_torch_parallel_ssh.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_workers as W
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.dynamics.special_updates import (
    SpecialUpdateConfig, make_reflection_update)
from elphdynamics_tpu_torch.measure.measurements import make_probe_solve
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.ops.fourier_accel import build_mass, build_Q
from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard, shard_holstein
from elphdynamics_tpu_torch.parallel.multihost import launch
from elphdynamics_tpu_torch.utils.dtypes import trace_noise
from test_torch_graph_update_ssh import HostUploads

TIMEOUT = 240
# the fields each call's result carries that must agree across a site group
AGREE = ("accepted", "iters", "rate", "flag")


def _check(ranks: list, n_chain: int) -> None:
    n_site = len(ranks) // n_chain
    for out in ranks:
        bad = {k for k, r in out.items() if not (r["same"] and r["segmented"])}
        assert not bad, bad
    for b in range(n_chain):
        group = ranks[b * n_site:(b + 1) * n_site]
        for name, first in group[0].items():
            assert first["reads"] > 0, name
            for r in group[1:]:
                got = r[name]
                for k in ("reads", "replays", "counts"):
                    assert got[k] == first[k], (name, k, got[k], first[k])
                for k in AGREE:
                    if k in first:
                        np.testing.assert_array_equal(got[k], first[k], err_msg=f"{name}.{k}")
                if name.startswith("ssh") and "x" in first:
                    # the bond field is whole on every rank
                    np.testing.assert_array_equal(got["x"], first["x"], err_msg=name)
            assert first["counts"]["allreduces"] > 0 and first["counts"]["folds"] > 0, name
            if n_site > 1:
                assert first["counts"]["halo_msgs"] > 0, name


@pytest.mark.parametrize("cases", [("holstein",), ("wij", "ssh"), ("twist", "ssh_twist")],
                         ids=["holstein", "wij_ssh", "twisted"])
def test_site_ranks_segmented_equal_eager(cases, tmp_path):
    ranks = launch(W.graph_sites_worker, 2, "gloo", "cpu", (1, cases), timeout_s=TIMEOUT,
                   threads=1, store_dir=str(tmp_path))
    _check(ranks, 1)
    names = {k.rsplit("_", 1)[0] for k in ranks[0]}
    assert all(any(n.startswith(c) for n in names) for c in cases)


def test_2x2_layout_update_and_exchange_equal_eager(tmp_path):
    ranks = launch(W.graph_sites_worker, 4, "gloo", "cpu", (2, ("ladder",), 4),
                   timeout_s=TIMEOUT, threads=1, store_dir=str(tmp_path))
    _check(ranks, 2)
    # the exchange decides every pair on every rank alike
    for parity in (0, 1):
        key = f"ladder_exchange{parity}"
        assert len({(r[key]["rate"], r[key]["flag"]) for r in ranks}) == 1


@pytest.mark.parametrize("D", [2, 4])
def test_halo_exchange_delivers_the_neighbours_rows(D, tmp_path):
    """``comm.halo_exchange`` (the exchange the graphs capture on NCCL)
    delivers the rows each neighbour sent, real and complex, with the two
    neighbours one rank (D = 2) or two."""
    ranks = launch(W.halo_worker, D, "gloo", "cpu", (), timeout_s=TIMEOUT, threads=1,
                   store_dir=str(tmp_path))
    assert all(same and n > 0 for same, n in ranks)


# --- stand-in capture on a one-rank site group

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["update", "langevin", "reflect", "probes"])
def test_stand_in_capture_uploads_nothing_on_a_shard(what, one_rank_group, monkeypatch):
    """The dispersive Holstein model on a one-rank site shard (its ωᵢⱼ
    action and force on the shard's tables), each call built and run once
    under the mode, which then counts through a second call: no
    host-to-device copy."""
    mode = HostUploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        spec, params = W.build(4, 1.0, 0.1, "wij")
        shard = SiteShard(spec.ckb, spec.wij_table, 1, 0)
        lspec, lp = shard_holstein(spec, params, shard)
        ops = make_model_ops(lspec)
        omega = params.omega.numpy()
        blocks = [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]
        pre = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
        x = torch.zeros((2, spec.Nsites, spec.Ltau), dtype=torch.float64, device="cpu")
        x += 0.3 * torch.randn(x.shape, dtype=x.dtype, device="cpu",
                               generator=torch.Generator().manual_seed(2))
        gen = torch.Generator().manual_seed(4)
        if what == "update":
            step = make_hmc_step(ops, build_mass(omega, spec.dtau, spec.Ltau, blocks),
                                 HMCConfig(dt=0.05, trajectory_time=0.1, Nb=2, tol=1e-6), pre)
            call = lambda: step(lp, HMCState(x=x, v=torch.zeros_like(x)),  # noqa: E731
                                draws=step.draw(lp, x, 2, gen))
        elif what == "langevin":
            step = make_langevin_step(ops, build_Q(omega, spec.dtau, spec.Ltau, blocks), 1e-3,
                                      "rk", SolverConfig(tol=1e-6), pre)
            call = lambda: step(lp, x, draws=step.draw(lp, x, 2, gen))  # noqa: E731
        elif what == "reflect":
            step = make_reflection_update(ops, SpecialUpdateConfig(n_moves=2, tol=1e-4), pre)
            call = lambda: step(lp, x, draws=step.draw(lp, x, 2, gen))  # noqa: E731
        else:
            step = make_probe_solve(ops, 2, SolverConfig(tol=1e-8), pre)
            call = lambda: step(lp, x, R=trace_noise(  # noqa: E731
                (2, 2, spec.Nsites, spec.Ltau), torch.float64, "cpu", gen))
        assert step.segmented
        call()
        mode.counting = True
        call()
        mode.counting = False
    assert mode.calls == []
    assert shard.allreduces > 0
