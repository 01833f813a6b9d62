"""Counters that stay counts of what ran on the card under CUDA graphs.

A CUDA graph's capture runs nothing on the card, and each replay runs
everything the capture recorded. So a counter that the port keeps on the
host (the kernels' launches, ``ops/ckb_cuda.py``; a site shard's folds,
halo messages and all-reduces, ``parallel/lattice_shard.py``) adds through
:func:`count`: outside a capture the count goes to the counter at once;
inside one (:func:`recording`, ``dynamics/graphs.UpdateGraphs``) it goes
to the graph's :class:`Record` instead, and every replay of the graph adds
it again (:meth:`Record.replayed`).

Work that a call does only once per shape or device (a geometry tuning, a
table upload from host memory) has to run before a capture, in the call's
warm-up: :func:`refuse` raises where a capture reaches it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import torch

_recording: list = []         # the Records of the CUDA graphs being captured


@dataclass
class Record:
    """What was counted while one CUDA graph was captured: per (adder,
    key), the amount. :meth:`replayed` hands each to its adder once per
    replay."""

    adds: dict = field(default_factory=dict)

    def replayed(self) -> None:
        for (add, key), n in self.adds.items():
            add(key, n)

    def per_replay(self, key) -> int:
        """The amount one replay adds under ``key``, over every adder."""
        return sum(n for (_, k), n in self.adds.items() if k == key)


def count(add: Callable, key, n: int = 1) -> None:
    """``add(key, n)``, or, during a capture, ``n`` under ``(add, key)`` in
    the records of the graphs being captured."""
    if not _recording:
        add(key, n)
        return
    for rec in _recording:
        rec.adds[(add, key)] = rec.adds.get((add, key), 0) + n


@contextlib.contextmanager
def recording():
    """Collect the counts made inside the block (a graph's capture) in a
    :class:`Record` instead of their counters."""
    rec = Record()
    _recording.append(rec)
    try:
        yield rec
    finally:
        _recording.remove(rec)


def refuse(device, what: str) -> None:
    """Raise where a capture on CUDA ``device`` reaches ``what``, work that
    a call does once before its graphs are captured."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} during a CUDA graph capture: the call's warm-up, before "
                           "the capture, has to do it")
