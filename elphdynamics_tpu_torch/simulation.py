"""Top-level simulation driver, on one device.

Counterpart of ``elphdynamics_tpu/simulation.py``. One call runs: config →
datafolder naming (auto-incrementing ``-<id>`` suffix) → new run or resume
→ burn-in → sampling with measurements every ``meas_freq`` updates → bins
→ summary, with checkpoints on a wall-clock cadence and at bin boundaries.
The sampler is HMC (``[hmc]``) or Langevin dynamics (``[langevin]``, where
an update is one time step and every step is accepted). With ``[hmc]
tune_dt`` the burn-in tunes the step size toward ``target_acceptance``
(dual averaging on the device) and the sampling step is rebuilt once with
the frozen value; ``[tempering]`` runs the chains on a coupling ladder with
an exchange every ``freq`` updates, and only rung-0 chains are measured;
``[solver.deflation]`` carries a per-chain slow-mode basis in the sampler
state; ``[solver.nearnull]`` replaces the KPM preconditioner by the
two-level one.

The ``n_chains`` Markov chains are one batch on the device (an explicit
leading chain axis). Measurements average over the chains within each bin;
chains whose probe solves failed are left out of the average and logged.

Per-update statistics (acceptance, solver iterations, solver flags) are
folded into accumulators on the device and read by the host once per
window (a bin, a checkpoint, the end of the run), not once per update; so
are the rows of ``hmc_sim_log.out`` (``[hmc] log = true``), drained every
``LOG_ROWS`` updates. Only ``[hmc] verbose = true`` (one log row per
leapfrog step) reads them every update.

The timers around device work (``_clock``) do not synchronise the card:
an update's queued tail can land in the next interval, by less than the
runs' noise.

Several ranks (:mod:`.parallel`, one process each, joined in a
``torch.distributed`` process group before :func:`simulate` runs on every
one of them):

* ``n_devices`` ranks shard the chains: each runs the one-card update on
  its block of chains (:class:`.parallel.chains.ChainBlock`), the draws
  made for the whole batch and cut to the block, and the per-chain
  statistics, increments and fields gathered where every chain is needed;
  on a card its update, moves, measurement and exchange replay CUDA graphs
  as one rank's do (:mod:`.dynamics.graphs`), the gathers between replays;
* ``site_devices`` ranks shard the lattice: every rank runs the same
  samplers on its block of sites (:mod:`.parallel.lattice_shard`; SSH's
  bond field stays whole on every rank), and the measurements gather the
  probe solutions for the estimator stage;
* both at once, the 2-D layout: ``n_devices`` chain blocks of
  ``site_devices`` site ranks each (rank r is chain block r // site_devices
  and site block r % site_devices). A site group's collectives (halos, the
  sums over sites) involve only its own ranks, so its solves stop at their
  own iteration counts; the chain group of a site block gathers chains.
  Each chain block's measurement runs on its gathered lattice with the
  one-card measurement, as the JAX package's combined mode does.

Tempering runs on every layout; across chain ranks the exchange gathers
the partners' fields over the chain group and takes the one-rank run's
decisions. A site-sharded layout replays CUDA graphs too, its site
group's collectives (the all-reduces and halo exchanges inside every
solve) captured in them, on NCCL ranks, one card each; on a site group
under gloo on a card (ranks sharing one card) every site-sharded part runs
eagerly (``dynamics/graphs.graphable`` reads the backend; the log's
``Ranks`` line says which). Every rank runs the same loop and reaches every
collective; the files (datafolder, logs, bins, summary, checkpoint) are
written by rank 0 only, and every host decision comes from values equal on
every rank that shares a collective. Under site sharding the near-null preconditioner, 2MN
and BiCGStab / GMRES raise ``NotImplementedError`` (:func:`check_parallel`).
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import time
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.hmc import (
    SITE_2MN, DtTunerState, HMCState, dt_tuner_init, dt_tuner_update, init_deflation,
    make_hmc_step)
from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
from elphdynamics_tpu_torch.dynamics.solve import SITE_NONSYM
from elphdynamics_tpu_torch.dynamics.special_updates import (
    make_reflection_update, make_swap_update)
from elphdynamics_tpu_torch.dynamics.tempering import (
    chain_params, check_ladder, ladder_params, make_exchange_step, rung_params)
from elphdynamics_tpu_torch.io import checkpoint as ckpt
from elphdynamics_tpu_torch.io import output as out_io
from elphdynamics_tpu_torch.io.config import SimulationSetup, build_setup, load_toml
from elphdynamics_tpu_torch.io.summary import write_summary
from elphdynamics_tpu_torch.measure.measurements import (
    make_measurement_step, make_probe_solve, mean_over_chains, process_bin, zero_container)
from elphdynamics_tpu_torch.measure.mufinder import MuTuner
from elphdynamics_tpu_torch.models.adapter import global_sites, make_model_ops
from elphdynamics_tpu_torch.ops import deflation, kpm
from elphdynamics_tpu_torch.ops.nearnull import make_nearnull_precond
from elphdynamics_tpu_torch.parallel import multihost
from elphdynamics_tpu_torch.parallel.chains import ChainBlock
from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard, shard_model, shard_params
from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import field_dtype, trace_noise

logger = logging.getLogger("elphdynamics_tpu_torch")

# hmc_sim_log.out rows held on the device between host reads
LOG_ROWS = 64
# per-stream accumulator slots: updates, Σacceptance, Σiterations, flagged
# chains, first and last flagged update, largest flag
_N, _ACC, _ITERS, _NFLAG, _FIRST, _LAST, _FMAX = range(7)


def _clock(device: torch.device) -> float:
    """The driver's timer read around device work: ``time.time()`` with no
    synchronisation of ``device`` (a queued tail of an update lands in the
    next interval; on an NVIDIA H100 at 700 W a synchronising clock moved the
    64×64 run's update/measurement split by less than its run-to-run noise,
    PERF.md)."""
    return time.time()


def name_datafolder(filepath: str, foldername: str, run_id: int | None = None) -> str:
    """``<foldername>-<id>``: an existing folder with a checkpoint is reused
    (resume); otherwise the id increments past every existing folder."""
    if run_id is not None:
        return os.path.join(filepath, f"{foldername}-{run_id}")
    i = 1
    while True:
        cand = os.path.join(filepath, f"{foldername}-{i}")
        if not os.path.isdir(cand) or ckpt.has_checkpoint(cand):
            return cand
        i += 1


# chains per card at Lτ = 40 by site count: the knee of the sweeps/s of
# tools/sweep_chains.py (the fewest chains within 90% of the best) on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6); in between, the nearer
# entry in log N
CHAINS_PER_CARD = {"holstein": {64: 2048, 1024: 64, 4096: 32},
                   "ssh": {64: 2048, 1024: 64, 4096: 64}}


def auto_chains(Nsites: int, Ltau: int, n_devices: int = 1, is_holstein: bool = True) -> int:
    """The chain count of ``--chains 0``: the measured per-card count for the
    nearest site count, shrunk ∝ 40/Lτ, times ``n_devices`` chain ranks."""
    table = CHAINS_PER_CARD["holstein" if is_holstein else "ssh"]
    n = min(table, key=lambda k: abs(math.log(k) - math.log(max(Nsites, 1))))
    per_card = max(1, int(table[n] * 40.0 / max(Ltau, 1)))
    return per_card * max(n_devices, 1)


# the refusal of the near-null preconditioner under site sharding, and why
# (ROADMAP §3)
SITE_NEARNULL = ("[solver.nearnull] with --site-devices: the JAX package refuses it too "
                 "(its sharded steps build their own preconditioner applies and the "
                 "two-level state is not threaded through them; ROADMAP section 3)")


def check_parallel(cfg: dict, n_devices: int = 1, site_devices: int = 1) -> None:
    """Raise ``NotImplementedError`` for the three layouts the JAX package
    does not really run, each message naming its cause: under
    ``site_devices`` the near-null preconditioner (the JAX package raises),
    the 2MN integrator and BiCGStab / GMRES (its sharded steps run leapfrog
    and CG whatever is asked; ROADMAP §3)."""
    if n_devices < 1 or site_devices < 1:
        raise ValueError("--devices and --site-devices must be >= 1")
    sol = cfg.get("solver", {})
    h = cfg.get("hmc", {})
    why = []
    if site_devices > 1:
        if "nearnull" in sol:
            why.append(SITE_NEARNULL)
        if any(str(t.get("integrator", "leapfrog")).lower() == "2mn"
               for t in (h, h.get("burnin", {}))):
            why.append(SITE_2MN)
        if str(sol.get("type", "CG")).lower() != "cg":
            why.append(SITE_NONSYM)
    if why:
        raise NotImplementedError("; ".join(why))


def simulate(config, run_id: int | None = None, n_chains: int = 1, device="cuda",
             dtype: torch.dtype = torch.float32, n_devices: int = 1,
             site_devices: int = 1) -> dict:
    """Run a full simulation from a TOML path or a parsed config dict on
    ``device`` in ``dtype``; return the run statistics. ``n_chains = 0``
    takes :func:`auto_chains`.

    With ``n_devices > 1`` (chains) or ``site_devices > 1`` (the lattice)
    every rank of the process group calls this with the same arguments
    (:func:`.parallel.multihost.launch`, or ``torchrun`` and
    ``--multihost``); ``device`` is the rank's own
    (:func:`.parallel.multihost.rank_device`)."""
    if n_chains < 0:
        raise ValueError(f"n_chains must be >= 0, got {n_chains}")
    device = require_device(device)
    cfg = load_toml(config) if isinstance(config, str) else dict(config)
    check_parallel(cfg, n_devices, site_devices)
    world = n_devices * site_devices
    if world != multihost.world():
        raise ValueError(f"{n_devices} chain x {site_devices} site ranks need a process group "
                         f"of {world}, this process is in one of {multihost.world()} (start "
                         "the ranks with parallel.multihost.launch or torchrun)")
    if n_chains == 0 and site_devices > 1:
        raise ValueError("--chains 0 (auto) needs an explicit chain count with --site-devices")
    primary = multihost.is_primary()
    sim = cfg["simulation"] = dict(cfg["simulation"])
    if world > 1 and "random_seed" not in sim:
        # every rank draws the same numbers: rank 0's fresh seed for all
        sim["random_seed"] = multihost.bcast_int(
            int(np.random.SeedSequence().entropy % (2 ** 31)))
    datafolder = multihost.bcast_str(
        name_datafolder(sim.get("filepath", "."), sim["foldername"], run_id))
    setup = build_setup(cfg, datafolder, device, dtype)
    if n_chains == 0:
        n_chains = auto_chains(setup.ops.Nsites, setup.ops.Ltau, n_devices,
                               setup.ops.is_holstein)
    if primary:
        os.makedirs(datafolder, exist_ok=True)
        with open(os.path.join(datafolder, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
        if isinstance(config, str) and os.path.isfile(config):
            shutil.copy(config, os.path.join(datafolder, os.path.basename(config)))
        else:
            with open(os.path.join(datafolder, "input.toml"), "w") as f:
                f.write(out_io.dump_toml(cfg))
        handler = logging.FileHandler(os.path.join(datafolder,
                                                   f"{setup.sim_params.foldername}.log"))
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    else:
        handler = logging.NullHandler()   # the other ranks log nowhere
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    site_group, chain_group = (multihost.layout_groups(n_devices, site_devices) if world > 1
                               else (None, None))
    block, d = divmod(multihost.rank(), site_devices)
    spec = setup.ops.spec
    par = _Parallel(
        chains=(ChainBlock.of(n_chains, n_devices, block, chain_group) if n_devices > 1
                else None),
        shard=(SiteShard(spec.ckb, getattr(spec, "wij_table", None),
                         site_devices, d, site_group, base=block * site_devices)
               if site_devices > 1 else None),
        cut_phonons=setup.ops.is_holstein)
    try:
        import elphdynamics_tpu_torch
        logger.info("elphdynamics_tpu_torch version: %s", elphdynamics_tpu_torch.__version__)
        logger.info("Random Seed: %d", setup.sim_params.random_seed)
        logger.info("Device: %s (%s), dtype %s", device,
                    torch.cuda.get_device_name(device) if device.type == "cuda" else "host",
                    dtype)
        logger.info("Markov chains: %d", n_chains)
        if world > 1:
            logger.info("Ranks: %d (%d chain x %d site, backend %s)", world, n_devices,
                        site_devices, torch.distributed.get_backend())
        if par.shard is not None:
            logger.info("Site shard: %d sites per rank; the sampler calls %s", par.shard.B,
                        ("replay CUDA graphs, the site group's NCCL collectives inside them"
                         if device.type == "cuda" else "run segmented")
                        if graphs.graphable(par.shard, device)
                        else "run eagerly: a gloo site group on a card cannot be captured")
        return _run(setup, n_chains, par)
    finally:
        logger.removeHandler(handler)
        handler.close()


def run_rank(device, kwargs: dict, profile: str | None = None) -> dict:
    """One rank of a command-line run: :func:`simulate` on ``device`` with
    ``kwargs``; with ``profile`` under ``torch.profiler`` (CPU and, on the
    card, CUDA activity), its Chrome trace written to
    ``profile/trace.json`` (rank r > 0: ``trace_rank<r>.json``)."""
    device = torch.device(device)
    if not profile:
        return simulate(device=device, **kwargs)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(profile, exist_ok=True)
    with torch_profile(activities=acts) as prof:
        stats = simulate(device=device, **kwargs)
    r = multihost.rank()
    prof.export_chrome_trace(os.path.join(profile, "trace.json" if r == 0
                                          else f"trace_rank{r}.json"))
    return stats


@dataclass(frozen=True)
class _Parallel:
    """This rank's part of the run: a block of chains, a block of sites, or
    both (the 2-D layout); (None, None) on one rank. ``cut_phonons``: the
    phonon field is cut with the sites (Holstein; SSH's bond field is whole
    on every rank of a site group)."""

    chains: ChainBlock | None = None
    shard: SiteShard | None = None
    cut_phonons: bool = True

    def gather_sites(self, x):
        """The chain block's phonon field on the whole lattice (a collective
        of the site group where the field is cut)."""
        if self.shard is not None and self.cut_phonons:
            return self.shard.gather(x)
        return x

    def gather_field(self, x):
        """Every chain's and site's phonon field from the ranks' blocks
        (collectives of the site group, then of the chain group)."""
        x = self.gather_sites(x)
        return self.chains.gather(x) if self.chains is not None else x

    def local_field(self, x):
        """This rank's block of a whole ``[C, Nph, Lτ]`` phonon field."""
        if self.chains is not None:
            x = self.chains.local(x)
        if self.shard is not None and self.cut_phonons:
            x = self.shard.local(x)
        return x

    def local_params(self, params):
        """``params`` of this rank's sites and chains (the site tables and
        per-chain couplings cut)."""
        if self.shard is not None:
            params = shard_params(params, self.shard)
        if self.chains is not None:
            params = chain_params(params, self.chains.lo, self.chains.n)
        return params

    def run(self, update, params, state, *args, generator, draws_dim: int = 0):
        """An update on this rank's part, on its parameters: the whole
        batch's draws cut to the chain block (the sharded update cuts its
        own draws to the site block)."""
        params = self.local_params(params)
        if self.chains is not None:
            return self.chains.wrap(update, draws_dim)(params, state, *args,
                                                       generator=generator)
        return update(params, state, *args, generator)

    def gather_stats(self, obj):
        """Per-chain statistics of every chain (site ranks hold them all)."""
        return self.chains.gather(obj) if self.chains is not None else obj


@dataclass(frozen=True)
class _LangevinUpdate:
    """A Langevin step's statistics in the shape the driver folds: every
    step is accepted."""

    accepted: torch.Tensor
    iters: torch.Tensor
    flag: torch.Tensor


def _langevin_update(ops, setup: SimulationSetup, precond):
    """The Langevin step as a sampler update ``(params, state, generator,
    draws=None) -> (state, stats)``; the momenta of ``state`` ride along
    untouched."""
    lstep = make_langevin_step(ops, setup.fa_Q, setup.langevin_dt, setup.langevin_method,
                               setup.solver_cfg, precond)

    def update(params, state: HMCState, generator=None, draws=None):
        x, stats = lstep(params, state.x, generator, draws)
        return replace(state, x=x), _LangevinUpdate(
            accepted=torch.ones_like(stats.flag, dtype=torch.bool), iters=stats.iters,
            flag=stats.flag)

    update.draw = lstep.draw
    update.workspace = lstep.workspace
    return update


class _Stats:
    """Per-update statistics folded on the device, one accumulator per
    stream, read by the host in one transfer per :meth:`flush`."""

    STREAMS = {"update": ("iters", "acceptance_rate"),
               "reflect": (None, "reflect_acceptance_rate"),
               "swap": (None, "swap_acceptance_rate"),
               "tempering": (None, "tempering_acceptance_rate"),
               "measurement": (None, None)}

    def __init__(self, device):
        self.device = device
        self.acc = {k: self._zero() for k in self.STREAMS}
        self.folds = {k: 0 for k in self.STREAMS}

    def _zero(self):
        z = torch.zeros(7, dtype=torch.float64, device=self.device)
        z[_FIRST] = math.inf
        z[_LAST] = -1.0
        return z

    def fold(self, kind: str, n: int, acc, iters, flag, n_flagged=None):
        """Add one update (or measurement, with ``n_flagged``) to a stream."""
        s = self.acc[kind]
        flag = torch.as_tensor(flag, device=self.device)
        nf = (flag != 0).sum().to(torch.float64) if n_flagged is None else \
            torch.as_tensor(n_flagged, device=self.device).to(torch.float64)
        has = nf > 0
        mean = (lambda a: torch.as_tensor(a, device=self.device).to(torch.float64).mean())
        self.acc[kind] = torch.stack([
            s[_N] + 1.0, s[_ACC] + mean(acc), s[_ITERS] + mean(iters), s[_NFLAG] + nf,
            torch.where(has, torch.clamp(s[_FIRST], max=float(n)), s[_FIRST]),
            torch.where(has, torch.clamp(s[_LAST], min=float(n)), s[_LAST]),
            torch.maximum(s[_FMAX], flag.max().to(torch.float64))])
        self.folds[kind] += 1

    def flush(self, sim_stats: dict) -> bool:
        """Move every touched stream to the host, add it to ``sim_stats`` and
        log the window's solver failures. Returns whether it read the
        device."""
        kinds = [k for k, n in self.folds.items() if n]
        if not kinds:
            return False
        host = torch.stack([self.acc[k] for k in kinds]).cpu().numpy()
        for kind, h in zip(kinds, host):
            self.acc[kind], self.folds[kind] = self._zero(), 0
            it_key, acc_key = self.STREAMS[kind]
            if it_key:
                sim_stats[it_key] += float(h[_ITERS])
            if acc_key:
                sim_stats[acc_key] += float(h[_ACC])
            nf = int(round(h[_NFLAG]))
            if nf:
                sim_stats["solver_failures"] = sim_stats.get("solver_failures", 0) + nf
                logger.warning("solver failure during %s, updates %d..%d: %d flagged "
                               "(max flag %d)", kind, int(h[_FIRST]), int(h[_LAST]), nf,
                               int(h[_FMAX]))
        return True


class _HMCLog:
    """``hmc_sim_log.out``: one row per update per chain (``t = -1``), plus
    one per leapfrog step when verbose. Non-verbose rows wait on the device
    and are written ``LOG_ROWS`` updates at a time."""

    def __init__(self, path: str | None, n_chains: int, device):
        self.f = self.buf = None
        self.ns: list[int] = []
        if path is not None:
            new = not os.path.isfile(path)
            self.f = open(path, "a")
            if new:
                self.f.write("updates accepted timestep tot_energy action kin_energy iters\n")
            self.buf = torch.zeros((LOG_ROWS, 5, n_chains), dtype=torch.float64, device=device)

    def _row(self, n, acc, H, S, K, iters):
        self.f.write(f"{n} {int(acc)} -1 {H:.8f} {S:.8f} {K:.8f} {int(iters)}\n")

    def push(self, n: int, stats) -> None:
        if self.f is None:
            return
        self.buf[len(self.ns)] = torch.stack([stats.accepted.to(torch.float64), stats.H,
                                              stats.S, stats.K, stats.iters.to(torch.float64)])
        self.ns.append(n)
        if len(self.ns) == LOG_ROWS:
            self.drain()

    def drain(self) -> None:
        if not self.ns:
            return
        host = self.buf[:len(self.ns)].cpu().numpy()
        for n, rows in zip(self.ns, host):
            for c in range(rows.shape[1]):
                self._row(n, *rows[:, c])
        self.ns = []

    def write_now(self, n: int, stats) -> None:
        """The verbose rows of one update, read from the device at once."""
        if self.f is None:
            return
        if stats.traj_H is not None:
            tH, tS, tK, tI = (t.cpu().numpy() for t in
                              (stats.traj_H, stats.traj_S, stats.traj_K, stats.traj_iters))
            for c in range(tH.shape[0]):
                for t in range(tH.shape[1]):
                    if np.isfinite(tH[c, t]):
                        self.f.write(f"{n} -1 {t + 1} {tH[c, t]:.8f} {tS[c, t]:.8f} "
                                     f"{tK[c, t]:.8f} {int(tI[c, t])}\n")
        rows = torch.stack([stats.accepted.to(torch.float64), stats.H, stats.S, stats.K,
                            stats.iters.to(torch.float64)]).cpu().numpy()
        for c in range(rows.shape[1]):
            self._row(n, *rows[:, c])

    def close(self) -> None:
        if self.f is not None:
            self.drain()
            self.f.close()
            self.f = None


def _replays(*parts) -> int:
    """The CUDA graph replays of the distinct ``parts`` (updates, moves or a
    measurement step) since their graphs were made."""
    n = 0
    for part in {id(p): p for p in parts if p is not None}.values():
        ws = getattr(part, "workspace", lambda: None)()
        if ws is not None and ws.graphs is not None:
            n += ws.graphs.replays
    return n


def _host_tree(tree):
    """A nested dict of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _run(setup: SimulationSetup, n_chains: int, par: _Parallel = _Parallel()) -> dict:
    # ops_g / params: the whole model (measurement analysis, files); ops: the
    # rank's samplers (a block of sites under site sharding)
    ops_g, params, sp = setup.ops, setup.params, setup.sim_params
    ops = ops_g
    if par.shard is not None:
        ops = make_model_ops(shard_model(ops_g.spec, params, par.shard)[0])
    datafolder = sp.datafolder
    dev, dtype = setup.device, setup.dtype
    mspec = setup.mspec
    primary = multihost.is_primary()
    # rank 0 looks (a rank that looked later could see this run's own
    # first checkpoint)
    resume = bool(multihost.bcast_int(int(primary and ckpt.has_checkpoint(datafolder))))

    tcfg = setup.tempering_cfg
    if tcfg is not None:
        if n_chains < 2:
            raise ValueError("[tempering] needs --chains = K*M (> 1)")
        check_ladder(tcfg, n_chains)
    if setup.nearnull_cfg is not None:
        precond = make_nearnull_precond(ops, setup.kpm_cfg, setup.nearnull_cfg)
    else:
        precond = kpm.make_precond(ops, setup.kpm_cfg) if setup.kpm_cfg is not None else None
    hmc = setup.dynamics_type == "hmc"
    bcfg = setup.hmc_burnin_cfg
    tuned_step = tuner = None
    # on the card, one rank, a chain rank or a site rank of an NCCL site
    # group, under tempering too, the update (leapfrog or 2MN) or Langevin
    # step (Holstein or SSH, real or complex hopping), the reflection and
    # swap moves, the measurement (a site shard's probe solves) and the
    # tempering exchange replay CUDA graphs, with block CG, the deflation
    # basis (made once below and carried in the state), the one
    # preconditioner built above, near-null or KPM with its exact
    # low-frequency blocks included, and BiCGStab / GMRES
    # (dynamics/graphs.py); a site shard of a gloo group on a card runs
    # them eagerly (graphs.graphable)
    if hmc:
        sim_step = make_hmc_step(ops, setup.fa_mass, setup.hmc_cfg, precond)
        burnin_step = (sim_step if bcfg == setup.hmc_cfg
                       else make_hmc_step(ops, setup.fa_mass, bcfg, precond))
        if bcfg.tune_dt and sp.burnin > 0:
            # the burn-in step takes dt from the tuner on the device; the
            # trajectory length Nt stays the configured one until the freeze
            tuned_step = make_hmc_step(ops, setup.fa_mass, bcfg, precond, dynamic_dt=True)
            tuner = dt_tuner_init(bcfg.dt, device=dev)
    else:
        sim_step = burnin_step = _langevin_update(ops, setup, precond)
    # site-only: the estimator stage of the global step runs on the gathered
    # probes; 2-D: the one-card measurement on each chain block's lattice
    mprecond = precond
    if par.shard is not None:
        mprecond = (kpm.make_precond(ops_g, setup.kpm_cfg)
                    if par.chains is not None and setup.kpm_cfg is not None else None)
    mstep = make_measurement_step(ops_g, mspec, setup.solver_cfg, mprecond)
    # site-only: the probe solves on the rank's block of sites
    probe_solve = (make_probe_solve(ops, mspec.nv, setup.solver_cfg, precond)
                   if par.shard is not None and par.chains is None else None)
    reflect = make_reflection_update(ops, setup.reflect_cfg, precond)
    swap = make_swap_update(ops, setup.swap_cfg, precond)

    sim_stats = {"simulation_time": 0.0, "measurement_time": 0.0, "write_time": 0.0,
                 "iters": 0.0, "acceptance_rate": 0.0, "reflect_acceptance_rate": 0.0,
                 "swap_acceptance_rate": 0.0}

    def freeze_tuned_dt(tuned_dt: float) -> None:
        """The sampling step rebuilt with the tuned dt; Nt =
        round(trajectory_time/dt) restores the configured trajectory time."""
        nonlocal sim_step
        cfg2 = replace(setup.hmc_cfg, dt=float(tuned_dt))
        sim_step = make_hmc_step(ops, setup.fa_mass, cfg2, precond)
        sim_stats["tuned_dt"] = float(tuned_dt)
        logger.info("tune_dt: frozen dt=%.6g Nt=%d (configured dt=%.6g Nt=%d, "
                    "target acceptance %.2f)", cfg2.dt, cfg2.Nt, setup.hmc_cfg.dt,
                    setup.hmc_cfg.Nt, bcfg.target_acceptance)

    container = zero_container(ops_g, mspec, dtype, dev)
    tune = setup.tune_density or {}
    mu_tuner = MuTuner(
        active=setup.tune_density is not None, init_mu=float(params.mu.mean()),
        target_N=tune.get("density", 1.0) * ops_g.Nsites, N=ops_g.Nsites, beta=ops_g.beta,
        dtau=ops_g.dtau, forgetful_c=tune.get("memory", 0.75),
        kappa_min=tune.get("kappa_min", 0.1) * ops_g.Nsites,
        logfile=os.path.join(datafolder, "mu_tuner_log.out") if primary else None)
    gen = torch.Generator(device=dev).manual_seed(sp.random_seed)
    burnin_start = sim_start = 0

    if resume:
        st = ckpt.load_checkpoint(datafolder)
        if st["x"].shape[0] != n_chains:
            raise ValueError(f"{datafolder}: the checkpoint holds {st['x'].shape[0]} chains, "
                             f"the run asks for {n_chains}")
        x = par.local_field(torch.as_tensor(st["x"], device=dev).to(dtype))
        v = par.local_field(torch.as_tensor(st["v"], device=dev).to(dtype))
        gen.set_state(torch.as_tensor(st["generator"]))
        container = {group: {k: torch.as_tensor(st["container"].get(group, {}).get(k, z.cpu().numpy()),
                                                device=dev).to(z.dtype)
                             for k, z in zs.items()}
                     for group, zs in container.items()}
        params = replace(params, **{
            k: torch.as_tensor(a, device=dev).to(_param_dtype(params, k, dtype))
            for k, a in st["params"].items()})
        sim_stats.update(st["sim_stats"])
        mu_tuner.load_state_dict(st["mu_tuner"])
        burnin_start = st["counters"]["burnin_start"]
        sim_start = st["counters"]["sim_start"]
        logger.info("resumed from checkpoint: burnin_start=%d sim_start=%d",
                    burnin_start, sim_start)
        # mid-burn-in: the tuner's state; after burn-in: the frozen dt
        saved = st["extras"].get("dt_tuner")
        if tuner is not None and saved is not None:
            tuner = DtTunerState.from_list(saved, dev)
        if hmc and "tuned_dt" in sim_stats and burnin_start >= sp.burnin:
            freeze_tuned_dt(sim_stats["tuned_dt"])
    else:
        if setup.read_phonon_config:
            x0 = torch.as_tensor(out_io.read_phonons(ops_g, setup.read_phonon_config),
                                 device=dev).to(dtype)
            x = par.local_field(x0.expand((n_chains,) + tuple(x0.shape)).contiguous())
        else:
            # every chain's numbers (a site-sharded model draws every site's
            # and keeps its block), then this rank's chains
            p0 = shard_params(params, par.shard) if par.shard is not None else params
            x = init_phonons_half_filled(ops, p0, n_chains, gen)
            x = par.chains.local(x) if par.chains is not None else x
        v = torch.zeros_like(x)
        if primary:
            out_io.init_measurement_folders(datafolder, container, mspec.snapshots)
            out_io.write_key_files(datafolder, ops_g, mspec, container)

    exchange = None
    n_meas_chains = n_chains
    if tcfg is not None:
        # a resumed run loaded the per-chain couplings from its checkpoint
        if not resume:
            params = ladder_params(params, tcfg, n_chains)
        exchange = make_exchange_step(ops, tcfg, n_chains, precond, chains=par.chains)
        n_meas_chains = n_chains // len(tcfg.ladder)
        sim_stats.setdefault("tempering_acceptance_rate", 0.0)
        logger.info("parallel tempering: ladder=%s freq=%d (%d chains/rung)",
                    list(tcfg.ladder), tcfg.freq, n_meas_chains)
    # the deflation basis is a solver aid, not checkpointed: it is drawn
    # anew (from its own seed, leaving the main stream as it is) on resume
    # (the whole model's basis, cut to this rank's chains and sites)
    defl = None
    if hmc and setup.hmc_cfg.deflate_k > 0:
        defl = init_deflation(ops_g, setup.hmc_cfg, n_chains,
                              torch.Generator(device=dev).manual_seed(sp.random_seed + 7919),
                              params=setup.params, device=dev)
        if par.chains is not None:
            defl = par.chains.local(defl)
        if par.shard is not None:
            defl = deflation.cut(defl, par.shard.local)
    state = HMCState(x=x, v=v, defl=defl)

    stats_acc = _Stats(dev)
    hmc_table = setup.config.get("hmc", {})
    hmc_log = _HMCLog(os.path.join(datafolder, "hmc_sim_log.out")
                      if hmc_table.get("log", False) and primary else None, n_chains, dev)
    # verbose rows are per leapfrog step: read them (and the stats) every update
    stats_sync = hmc_log.f is not None and bool(hmc_table.get("verbose", False))
    npairs = mspec.nv * (mspec.nv - 1) // 2
    t_ckpt = time.time()

    def flush_stats():
        t0 = time.time()
        hmc_log.drain()
        if stats_acc.flush(sim_stats):
            # the read waits on the outstanding device work of the window
            sim_stats["simulation_time"] += time.time() - t0

    def maybe_checkpoint(bstart, sstart, force=False, min_interval=None):
        nonlocal t_ckpt
        interval = sp.chckpnt_freq_s if min_interval is None else min_interval
        # rank 0's clock decides for every rank: the gathers below are collectives
        due = force or bool(multihost.bcast_int(int((time.time() - t_ckpt) > interval)))
        if not due:
            return
        flush_stats()  # the checkpointed sim_stats include the window
        t0 = time.time()
        extras = {}
        if tuner is not None and bstart < sp.burnin:
            extras["dt_tuner"] = tuner.as_list()
        x_all, v_all = par.gather_field(state.x), par.gather_field(state.v)
        if primary:
            ckpt.save_checkpoint(datafolder, x=x_all, v=v_all, generator_state=gen.get_state(),
                                 params=params, container=container,
                                 counters={"burnin_start": bstart, "sim_start": sstart},
                                 sim_stats=sim_stats, mu_tuner_state=mu_tuner.state_dict(),
                                 extras=extras)
        sim_stats["write_time"] += time.time() - t0
        t_ckpt = time.time()

    def apply_mu(params, new_mu):
        return replace(params, mu=params.mu + (new_mu - float(params.mu.mean())))

    def record_update(kind_label, n, n_log, stats):
        if stats_sync:
            sim_stats["iters"] += float(stats.iters.double().mean())
            sim_stats["acceptance_rate"] += float(stats.accepted.double().mean())
            flags = stats.flag.cpu().numpy()
            nf = int(np.sum(flags != 0))
            if nf:
                sim_stats["solver_failures"] = sim_stats.get("solver_failures", 0) + nf
                logger.warning("solver failure during %s update %d: %d/%d chains flagged "
                               "(flags=%s)", kind_label, n, nf, flags.size,
                               np.unique(flags[flags != 0]).tolist())
            hmc_log.write_now(n_log, stats)
        else:
            stats_acc.fold("update", n, stats.accepted, stats.iters, stats.flag)
            hmc_log.push(n_log, stats)

    def do_special(state, n):
        for upd, cfg_, kind in ((reflect, setup.reflect_cfg, "reflect"),
                                (swap, setup.swap_cfg, "swap")):
            if cfg_.n_moves and cfg_.freq and n % cfg_.freq == 0:
                t0 = _clock(dev)
                xn, rate = par.run(upd, params, state.x, generator=gen, draws_dim=1)
                rate = par.gather_stats(rate)
                state = replace(state, x=xn)
                sim_stats["simulation_time"] += _clock(dev) - t0
                stats_acc.fold(kind, n, rate, 0.0, 0)
        return state

    def do_exchange(state, n):
        """A tempering exchange attempt every ``freq`` updates, the pair
        parity alternating."""
        if exchange is None or n % tcfg.freq:
            return state
        t0 = _clock(dev)
        xn, vn, rate, _, flag = exchange(par.local_params(params), state.x, state.v,
                                         (n // tcfg.freq) % 2, gen)
        state = replace(state, x=xn, v=vn)
        sim_stats["simulation_time"] += _clock(dev) - t0
        stats_acc.fold("tempering", n, rate, 0.0, flag)
        return state

    def measure():
        # under tempering only the rung-0 chains (physical couplings) are
        # measured: the other rungs' bins would be discarded
        mparams = rung_params(params)
        if par.shard is not None and par.chains is None:
            # the probe solves on the site blocks, the estimators on the
            # gathered probes, solutions and fields
            x = state.x[:n_meas_chains]
            gd = probe_solve(shard_params(mparams, par.shard), x, gen)
            gd = replace(gd, R=par.shard.gather(gd.R), MinvR=par.shard.gather(gd.MinvR))
            inc, mstats, snaps = mstep.analyze(mparams, par.gather_sites(x), gd)
        else:
            # the chain block's whole lattice (2-D layout: a site-group gather)
            x = par.gather_sites(state.x)
            cb = par.chains
            if cb is None:
                inc, mstats, snaps = mstep(mparams, x[:n_meas_chains], gen)
            elif exchange is not None:
                # rung 0 may sit on one chain rank: every rank measures the
                # gathered rung-0 chains, as the one-rank run does
                inc, mstats, snaps = mstep(mparams, cb.gather(x)[:n_meas_chains], gen)
            else:
                R = trace_noise((cb.total, mspec.nv, global_sites(ops), ops.Ltau),
                                field_dtype(mparams, x.dtype), x.device, gen)
                inc, mstats, snaps = cb.gather(mstep(mparams, x, R=cb.local(R)))
        inc, snaps = mean_over_chains(inc, snaps, mstats["flag"])
        return inc, (mstats["flag"] != 0).sum(), snaps

    def tune_mu(params, inc):
        Nm = float(inc["global"]["density"]) / npairs * ops_g.Nsites
        N2m = float(inc["global"]["Nsqr"]) / npairs
        return apply_mu(params, mu_tuner.update(Nm, N2m))

    try:
        # ---- thermalization
        for n in range(burnin_start, sp.burnin):
            maybe_checkpoint(n, 0)
            t0 = _clock(dev)
            if tuner is not None:
                state, stats = par.run(tuned_step, params, state, torch.exp(tuner.log_dt),
                                       generator=gen)
                stats = par.gather_stats(stats)
                # a flagged (auto-rejected) or non-finite update counts as 0
                p = torch.clamp(torch.exp(-stats.delta_H), max=1.0)
                p = torch.where(torch.isfinite(p) & (stats.flag == 0), p, torch.zeros_like(p))
                tuner = dt_tuner_update(tuner, p.mean(), bcfg.target_acceptance)
            else:
                state, stats = par.run(burnin_step, params, state, generator=gen)
                stats = par.gather_stats(stats)
            sim_stats["simulation_time"] += _clock(dev) - t0
            record_update("burnin", n + 1, n + 1, stats)
            state = do_special(state, n + 1)
            state = do_exchange(state, n + 1)
            if mu_tuner.active and (n + 1) % max(sp.meas_freq, 1) == 0:
                t0 = _clock(dev)
                inc, _, _ = measure()
                params = tune_mu(params, inc)
                sim_stats["simulation_time"] += _clock(dev) - t0
        if tuner is not None and "tuned_dt" not in sim_stats:
            freeze_tuned_dt(float(torch.exp(tuner.log_dt_avg)))

        # ---- sampling and measurements
        for n in range(sim_start, sp.nsteps):
            maybe_checkpoint(sp.burnin, n)
            t0 = _clock(dev)
            state, stats = par.run(sim_step, params, state, generator=gen)
            stats = par.gather_stats(stats)
            sim_stats["simulation_time"] += _clock(dev) - t0
            record_update("simulation", n + 1, sp.burnin + n + 1, stats)
            state = do_special(state, n + 1)
            state = do_exchange(state, n + 1)
            if (n + 1) % sp.meas_freq:
                continue
            nmeas = (n + 1) // sp.meas_freq
            t0 = _clock(dev)
            inc, n_flagged, snaps = measure()
            for group, vals in container.items():
                for k, a in vals.items():
                    a.add_(inc[group][k])
            sim_stats["measurement_time"] += _clock(dev) - t0
            stats_acc.fold("measurement", nmeas, 0.0, 0.0, 0, n_flagged=n_flagged)
            if mu_tuner.active:
                params = tune_mu(params, inc)
            if snaps and primary:
                t0 = time.time()
                for sname, svals in _host_tree(snaps).items():
                    out_io.write_snapshot(datafolder, sname, svals, nmeas)
                sim_stats["write_time"] += time.time() - t0
            if nmeas % sp.bin_size == 0:
                flush_stats()  # the window's deferred stats and warnings
                if primary:
                    t0 = _clock(dev)
                    processed = _host_tree(process_bin(ops_g, mspec, container, sp.bin_size))
                    sim_stats["measurement_time"] += _clock(dev) - t0
                    t0 = time.time()
                    out_io.write_bin(datafolder, processed, nmeas // sp.bin_size, ops_g)
                    sim_stats["write_time"] += time.time() - t0
                container = zero_container(ops_g, mspec, dtype, dev)
                maybe_checkpoint(sp.burnin, n + 1, min_interval=min(10.0, sp.chckpnt_freq_s))

        # ---- finalize. The last checkpoint holds the raw counters: a resume
        # of a finished run re-enters the normalization below.
        flush_stats()
        maybe_checkpoint(sp.burnin, sp.nsteps, force=True)
    finally:
        hmc_log.close()

    # CUDA graph replays by part (0 where a part ran eager or on the CPU)
    sim_stats["graph_replays"] = {"update": _replays(sim_step, burnin_step, tuned_step),
                                  "reflect": _replays(reflect), "swap": _replays(swap),
                                  "measurement": _replays(mstep, probe_solve)}
    if exchange is not None:
        sim_stats["graph_replays"]["exchange"] = _replays(exchange)
    total = sp.burnin + sp.nsteps
    sim_stats["iters"] /= max(total, 1)
    sim_stats["acceptance_rate"] /= max(total, 1)
    for kname, scfg in (("reflect_acceptance_rate", setup.reflect_cfg),
                        ("swap_acceptance_rate", setup.swap_cfg)):
        if scfg.n_moves and scfg.freq:
            sim_stats[kname] /= max(sp.burnin // scfg.freq + sp.nsteps // scfg.freq, 1)
    if tcfg is not None:
        sim_stats["tempering_acceptance_rate"] /= max(
            sp.burnin // tcfg.freq + sp.nsteps // tcfg.freq, 1)
    for k in ("simulation_time", "measurement_time", "write_time"):
        sim_stats[k + "_min"] = sim_stats[k] / 60.0

    x_final = par.gather_field(state.x)[0]
    mu_tuner.estimate_mu()
    if primary:
        out_io.write_phonons(ops_g, x_final, os.path.join(datafolder, "final_phonon_config.out"))
        if sp.write_M_matrix:
            out_io.write_M_matrix(ops_g, rung_params(params), x_final,
                                  os.path.join(datafolder, "M_matrix.out"))
        write_summary(setup, sim_stats, mu_tuner)
    logger.info("simulation complete: %s", sim_stats)
    return sim_stats


def _param_dtype(params, name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a checkpointed parameter goes back to: the built one's
    (complex under complex hopping), else ``dtype``."""
    cur = getattr(params, name, None)
    return cur.dtype if torch.is_tensor(cur) else dtype


def load_model(datafolder: str, device="cuda", dtype: torch.dtype = torch.float64):
    """Rebuild a finished or checkpointed run: ``(setup, params, x)`` with
    the checkpoint's parameters and ``[C, N, Lτ]`` fields, on ``device``."""
    device = require_device(device)
    with open(os.path.join(datafolder, "config.json")) as f:
        cfg = json.load(f)
    setup = build_setup(cfg, datafolder, device, dtype)
    st = ckpt.load_checkpoint(datafolder)
    params = replace(setup.params, **{
        f.name: torch.as_tensor(st["params"][f.name], device=setup.device).to(
            _param_dtype(setup.params, f.name, dtype))
        for f in fields(setup.params) if f.name in st["params"]})
    return setup, params, torch.as_tensor(st["x"], device=setup.device).to(dtype)
