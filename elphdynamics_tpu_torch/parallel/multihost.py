"""Multi-process execution: one process per rank over ``torch.distributed``.

Counterpart of ``elphdynamics_tpu/parallel/multihost.py``. The JAX package
joins hosts with ``jax.distributed`` and runs one SPMD program over the
global device mesh; here every rank is a process of its own, joined in one
process group:

* NCCL between cards, one card per rank (``cuda:LOCAL_RANK``);
* gloo on the CPU (every rank on the CPU), or on one card shared by several
  ranks, with every message staged through host memory
  (:mod:`.comm`): NCCL refuses two ranks on one card.

A run over several hosts is started by ``torchrun`` (or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK``) and joins through :func:`init_from_env` (``env://``); the
ranks of one host that this package spawns itself (:func:`launch`) join
through a ``file://`` store in a fresh temporary directory.

Collective discipline: :func:`fetch`, :func:`fetch_tree` and the broadcasts
are collectives, so every rank must reach them the same number of times.
The driver keeps this true by gating only the writes on rank 0, never the
fetches, and by taking every host decision from values that are equal on
every rank (all-reduced, gathered or broadcast).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from elphdynamics_tpu_torch.parallel.comm import _staged
from elphdynamics_tpu_torch.utils.device import require_device

__all__ = ["init", "init_from_env", "backend_for", "rank", "world", "is_primary",
           "rank_device", "layout_groups", "fetch", "fetch_tree", "bcast_int", "bcast_str",
           "launch"]

# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device) -> str:
    """NCCL for a CUDA ``device``, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(backend: str, init_method: str, world_size: int, rank_: int,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (a no-op when this process has joined one)."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join through ``env://``: a launcher such as ``torchrun`` set
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs the launcher's environment: {missing} unset "
                           "(start every process with torchrun or set them yourself)")
    if backend == "nccl":
        # NCCL's point-to-point ops hang unless the rank's card is current
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    init(backend, "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), timeout_s)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under NCCL (one card per
    rank); under gloo ``device`` itself (every rank on the CPU, or every
    rank on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank()))
        return torch.device("cuda", local)
    return device


def layout_groups(n_chain: int, n_site: int):
    """The process groups of the 2-D chain × site layout, for this rank:
    ``(site_group, chain_group)``. Rank r is chain block ``r // n_site``
    and site block ``r % n_site``; its site group holds the ``n_site``
    ranks of its chain block, its chain group the ``n_chain`` ranks of its
    site block. A group that spans every rank is None (the default group).
    ``dist.new_group`` is a collective of every rank, so every rank builds
    every group, site groups first, in one order."""
    if n_chain * n_site != world():
        raise ValueError(f"{n_chain} chain x {n_site} site ranks need a process group of "
                         f"{n_chain * n_site}, this one has {world()}")
    if n_chain == 1 or n_site == 1:
        return None, None
    r = rank()
    site = [dist.new_group([b * n_site + s for s in range(n_site)]) for b in range(n_chain)]
    chain = [dist.new_group([b * n_site + s for b in range(n_chain)]) for s in range(n_site)]
    return site[r // n_site], chain[r % n_site]


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The tensors (equal shapes) of the ranks of ``group`` (None: every
    rank) concatenated along ``dim`` in rank order, on ``t``'s device (a
    collective of the group)."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return t
    src = t.detach().contiguous()
    staged = _staged(src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def fetch(t, dim: int = 0) -> np.ndarray:
    """``t`` on the host with every rank's block along ``dim`` (a
    collective: every rank must call it at the same point)."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    return all_gather(t, dim).cpu().numpy()


def fetch_tree(tree, dim: int = 0):
    """:func:`fetch` over a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: fetch_tree(v, dim) for k, v in tree.items()}
    return fetch(tree, dim)


def _bcast_host(buf: np.ndarray) -> np.ndarray:
    t = torch.as_tensor(buf)
    if dist.get_backend() == "nccl":
        t = t.to(rank_device("cuda"))
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def bcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank (a collective)."""
    if world() == 1:
        return int(value)
    return int(_bcast_host(np.asarray([value], dtype=np.int64))[0])


def bcast_str(value: str, maxlen: int = 1024) -> str:
    """Rank 0's string on every rank (a collective)."""
    if world() == 1:
        return value
    raw = value.encode()
    if len(raw) > maxlen:
        raise ValueError(f"string longer than {maxlen} bytes")
    buf = np.zeros(maxlen, dtype=np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    out = _bcast_host(buf)
    return bytes(out[out != 0]).decode()


def _rank_entry(fn, rank_: int, world_size: int, backend: str, device: str, store: str,
                threads, args, results) -> None:
    """One spawned rank: join, run ``fn(device, *args)``, report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            os.environ.setdefault("LOCAL_RANK", str(rank_))
            torch.cuda.set_device(rank_)
        init(backend, f"file://{store}", world_size, rank_)
        # plain pickle: a tensor travels by value (the queue's own pickler
        # would share its memory with a process that is about to exit)
        out = pickle.dumps(fn(rank_device(device), *args))
        results.put((rank_, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank_, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, backend: str, device="cuda", args=(), *,
           timeout_s: float = DEFAULT_TIMEOUT_S, threads: int | None = None,
           store_dir: str | None = None) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` spawned ranks joined in
    one ``backend`` process group and return the ranks' results in rank
    order. ``fn`` and the results are pickled (``fn`` by its import path);
    CUDA cannot be forked, so the ranks are spawned. ``device`` is every
    rank's device under gloo (a card that the ranks share, or ``"cpu"``);
    under NCCL rank r takes ``cuda:r``; without a card a CUDA ``device``
    raises. ``threads`` sets each
    rank's torch threads. A rank that fails raises ``RuntimeError`` here
    with its traceback; ranks that outlive ``timeout_s`` are terminated
    and ``TimeoutError`` is raised."""
    import multiprocessing as mp

    require_device(device)
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} NCCL ranks need {world_size} CUDA devices, "
                           f"found {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world_size, backend, str(device), store, threads,
                                   args, results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict[int, tuple] = {}
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
        try:
            # drain the queue before joining: a rank blocks on a full pipe
            while len(got) < world_size:
                left = (deadline - datetime.datetime.now()).total_seconds()
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks did not finish within "
                                       f"{timeout_s:.0f} s (ranks done: {sorted(got)})")
                try:
                    r, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if i not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} died with exit code "
                                           f"{[procs[i].exitcode for i in dead]}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} failed:\n{out}")
                got[r] = (ok, pickle.loads(out))
            for p in procs:
                p.join(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [got[r][1] for r in range(world_size)]
