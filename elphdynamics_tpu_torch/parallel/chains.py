"""Chain sharding: the Markov chains of a run split over ranks.

Counterpart of ``elphdynamics_tpu/parallel/chains.py``. Each rank owns
``n_chains / world`` contiguous chains and runs the ordinary one-card
update on them: the chains are independent, so no rank waits on another
inside an update. Random numbers are drawn for the whole batch from the
generator every rank holds in the same state, and each rank keeps its
block (:meth:`ChainBlock.wrap`), so a chain's trajectory is the one-rank
run's bit for bit. The wrapped update is the one-card one, graphed or
eager: a chain rank's update holds no collective, so its CUDA graphs are
the one-rank graphs at the block's shape. Per-chain statistics,
measurement increments and the fields are gathered
(:meth:`ChainBlock.gather`) where the driver needs every chain: the logs,
the bins, the checkpoint.
"""

from __future__ import annotations

import dataclasses

import torch

from elphdynamics_tpu_torch.parallel.multihost import all_gather


def _map_fields(obj, fn):
    """``obj`` with ``fn`` applied to every tensor: the fields of a
    dataclass, the values of a dict, the items of a tuple."""
    if torch.is_tensor(obj):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_fields(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_fields(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_map_fields(v, fn) for v in obj)
    return obj


@dataclasses.dataclass(frozen=True)
class ChainBlock:
    """Chains ``[lo, lo + n)`` of ``total``: this rank's block. ``group``
    is the process group of the chain ranks (None: every rank; under the
    2-D layout the ranks that hold this rank's block of sites)."""

    total: int
    lo: int
    n: int
    group: object = dataclasses.field(default=None, compare=False)

    @classmethod
    def of(cls, n_chains: int, world: int, rank: int, group=None) -> "ChainBlock":
        """Block ``rank`` of ``world`` chain blocks."""
        if n_chains % world:
            raise ValueError(f"n_chains={n_chains} must be a multiple of n_devices={world}")
        n = n_chains // world
        return cls(total=n_chains, lo=rank * n, n=n, group=group)

    def local(self, obj, dim: int = 0):
        """This rank's block of every tensor of ``obj`` along ``dim``."""
        return _map_fields(obj, lambda t: t.narrow(dim, self.lo, self.n))

    def gather(self, obj, dim: int = 0):
        """Every chain rank's block of every tensor of ``obj`` concatenated
        along ``dim`` (a collective of the chain group)."""
        return _map_fields(obj, lambda t: all_gather(t, dim, self.group))

    def wrap(self, update, draws_dim: int = 0):
        """``update(params, state, *args, generator=None, draws=None)`` run
        on this rank's chains with the draws of the whole batch
        (``update.draw(params, x, n_chains, generator)``) cut to its block
        along ``draws_dim`` (the chain axis of the draws)."""

        def run(params, state, *args, generator=None):
            x = state.x if hasattr(state, "x") else state
            draws = update.draw(params, x, self.total, generator)
            return update(params, state, *args, draws=self.local(draws, draws_dim))

        # a graphed update stays inspectable through the wrapper
        for name in ("segmented", "workspace"):
            if hasattr(update, name):
                setattr(run, name, getattr(update, name))
        return run
