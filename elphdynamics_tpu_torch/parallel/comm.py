"""The two collectives of a site-sharded solve.

* :func:`allreduce_sum`: the float64 partial sums of the CG dots, the
  energies and the KPM power-iteration norms, summed over the ranks of a
  site group (and SSH's fermionic force over the bond field), and block
  CG's Grams (complex128 on complex fields: ``dist.all_reduce`` sums a
  complex tensor as its real view, one message, under gloo and NCCL);
* :func:`halo_exchange`: one boundary-crossing checkerboard group's halo
  rows, sent to both ring neighbours and received from both in one
  ``dist.batch_isend_irecv``.

Both take a process ``group`` (None: every rank). Under the 2-D chain ×
site layout a site group holds one chain block's site ranks
(:func:`..multihost.layout_groups`); the halo peers are global ranks of
that group, and no collective of one site group involves another, so each
group's solve may stop at its own iteration count.

Under gloo a CUDA tensor is staged through host memory explicitly (gloo's
point-to-point ops take CPU tensors, and NCCL refuses two ranks on one
card): that is how several ranks share one card. Under NCCL the card's
tensors go as they are.

With two ranks the previous and the next neighbour are the same rank. The
two messages then travel between the same pair, so they carry distinct
tags (gloo matches by tag) and are posted in a fixed order, the message
to the next rank first (NCCL matches a pair's messages in order).

Inside a CUDA graph (a segmented sampler call on an NCCL site group,
``dynamics/graphs.py``) both collectives are captured as they are: the
all-reduce and the halo's ``dist.batch_isend_irecv``. Under torch 2.11
with NCCL on two H100s a captured halo delivers the eager exchange's rows
bit for bit, and at ``SSH_64X64``'s halo (320 KB a message) an eager
exchange takes 0.38-0.40 ms (``chip_smoke.phase_halo``, ``PERF.md``).
A CUDA site group under gloo stages through host memory and cannot be
captured: its calls run eagerly (``dynamics/graphs.graphable``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# tags of the two halo directions
_TO_NEXT, _TO_PREV = 0, 1


def _staged(t: torch.Tensor) -> bool:
    """A CUDA tensor under gloo goes through host memory."""
    return t.is_cuda and dist.get_backend() == "gloo"


def allreduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, as a new tensor on
    ``t``'s device (every rank gets the same bits)."""
    staged = _staged(t)
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def halo_exchange(send_next: torch.Tensor | None, send_prev: torch.Tensor | None,
                  next_rank: int, prev_rank: int, group=None):
    """Send ``send_next`` to ``next_rank`` and ``send_prev`` to
    ``prev_rank`` (global ranks of ``group``); return ``(from_prev,
    from_next)``: the previous rank's
    ``send_next`` (this rank's previous halo, shaped like ``send_next``)
    and the next rank's ``send_prev`` (shaped like ``send_prev``). Either
    direction may be None (no rows cross that way); every rank passes the
    same Nones, since the halo plan is the same on every rank."""
    present = [t for t in (send_next, send_prev) if t is not None]
    if not present:
        return None, None
    device = present[0].device
    staged = _staged(present[0])
    wire = torch.device("cpu") if staged else device
    ops, outs = [], []
    for t, peer, tag in ((send_next, next_rank, _TO_NEXT), (send_prev, prev_rank, _TO_PREV)):
        if t is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous().to(wire), peer, group, tag=tag))
    for like, peer, tag in ((send_next, prev_rank, _TO_NEXT), (send_prev, next_rank, _TO_PREV)):
        buf = None
        if like is not None:
            buf = torch.empty(like.shape, dtype=like.dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag=tag))
        outs.append(buf)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return tuple(None if o is None else o.to(device) for o in outs)
