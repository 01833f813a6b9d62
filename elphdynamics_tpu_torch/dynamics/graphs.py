"""CUDA graphs of a sampler call: the port's counterpart of the JAX
package's compiled update, Langevin step, special updates and measurement
step (``jax.jit`` over ``lax.while_loop`` and ``lax.scan`` bodies).

Graphed, with CG, BiCGStab or GMRES, on one rank or on a chain rank's
block of chains (with CG and block CG also on a rank's block of sites, a
site shard, :func:`graphable`), on a real field or under complex hopping
(the twisted ensemble's packed complex pseudofermions ``[C, 1, N, Lτ]``),
with shared or per-chain (tempering
ladder) couplings: the HMC update, leapfrog or 2MN (``dynamics/hmc.py``),
the Langevin step (``dynamics/langevin.py``), the reflection and swap
moves (``dynamics/special_updates.py``), the measurement step
(``measure/measurements.py``) and the tempering exchange
(``dynamics/tempering.py``), with the CG solver aids: block CG, slow-mode
deflation, the near-null preconditioner and the KPM's exact low-frequency
blocks. A call is split into
segments, each a function over one :class:`Workspace` of tensors that keep
their addresses from one call to the next. Its CG and block CG solves are
the segments of :class:`CGSolve`, shared by all five, its BiCGStab and
GMRES solves (the update's, the Langevin step's and the measurement's;
the moves and the exchange solve by CG) those of :class:`NonsymSolve`. A
call on chain ranks may stop
between two replays for an eager collective (the exchange's gathers,
:meth:`Workspace.collective`; gloo cannot be captured) and resume in the
same workspace: it replays host reads + 1 graphs per run of segments
between two such steps. A call on a site shard's block of sites holds
its site group's collectives (the all-reduces of the dots, energies and
Grams, the halo exchanges of the fold, SSH's force sum) inside its
segments: on NCCL ranks, one card each, they are captured into the graphs
(every rank of the group replays the same graphs in the same order, since
every host read is of an all-reduced value); a site group under gloo on a
card (ranks sharing one card, messages staged through host memory) cannot
be captured, and its calls run eagerly (:func:`graphable` reads the
backend). On a CUDA device every segment is
captured once into a ``torch.cuda.CUDAGraph``, all of one call's graphs in
one memory pool and in the order they first replay, and then replayed; the
host keeps only the loop control between replays (``any(active)`` before a
CG or BiCGStab block, GMRES's ``any(~done_all)`` before a restart cycle and
``any(~done)`` before a block of Arnoldi steps, ``any(bad)`` after a
verification) and the copies of a call's inputs into the workspace. On the CPU each segment is called directly, so
the tier-1 tests run the same code the graphs hold.

Before its capture every segment runs once eagerly on the capture stream
(the warm-up): first-use work that a capture cannot hold happens there, such
as the kernels' launch-geometry tuning and bond-plan uploads
(``ops/ckb_cuda.py``), the KPM constant tables (``ops/kpm.py``), the mass
operator's circulants, the bf16 operand of exp(−Δτ·K), the τ↔ω phase Θ of
the complex KPM pipeline (``ops/timefreqfft.py``), the near-null test
vectors (``ops/nearnull.py``) and the cuFFT plans of its
full-spectrum FFTs. A capture that
reaches such work raises, as does any other failed capture or replay: there
is no fallback to the eager call.

Only workspace tensors cross a segment boundary. They are allocated outside
the pool during the warm-up, so a graph's intermediates, which the pool
shares between graphs, never hold a value another graph reads.
"""

from __future__ import annotations

import time
from dataclasses import fields, is_dataclass, replace

import torch

from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.dynamics.solve import (
    SolverConfig, _cg_operators, base_solver, nonsym_retry, precond_applies, site_reduce)
from elphdynamics_tpu_torch.utils import capture, spans
from elphdynamics_tpu_torch.utils.dtypes import field_dtype

# a workspace's start vectors before its first put_start (None is a value)
_NO_START = object()

# parameters a graph holds a value derived from: Holstein's exp(−Δτ·K) and
# its inverse (the bf16 operand of the in-loop MᵀM); a change needs a new
# workspace and new graphs
REBUILD = ("expK", "expK_inv")


def graphable(shard, device: torch.device) -> bool:
    """Whether a segmented call of a model with site shard ``shard`` (None
    on one rank or a chain rank) on ``device`` runs segmented: always
    without a shard; with one on the CPU (the segments called directly,
    the gloo collectives inside them) or on an NCCL site group (the
    collectives captured). A site group under gloo on a card runs the
    eager call: gloo cannot be captured. A builder's ``.segmented`` says
    whether its configuration takes the segmented call; on a site shard
    each call reads this gate too."""
    return shard is None or torch.device(device).type != "cuda" or shard.backend() == "nccl"


def capturing(device: torch.device) -> bool:
    """Whether the current stream of a CUDA ``device`` is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def made_once(cache: dict, device: torch.device, make, what: str):
    """``make()`` (tensors on ``device`` built from host data), kept in
    ``cache`` per device and made on first use there: a segmented call's
    warm-up. Making it during a CUDA graph capture raises."""
    if device not in cache:
        if capturing(device):
            raise RuntimeError(f"{what} made during a CUDA graph capture: the warm-up "
                               "must make it")
        cache[device] = make()
    return cache[device]


class Workspace:
    """Named tensors that outlive a segment. :meth:`put` copies a value (a
    tensor or a NamedTuple of tensors) into the kept value of that name
    (made on the first put, which must not happen during a capture);
    attribute access reads it. :meth:`load` does the same for a dataclass of
    tensors, field by field. The parameters the segments read are a kept
    copy (:meth:`keep_params`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._t: dict = {}

    def __getattr__(self, name):
        try:
            return self.__dict__["_t"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __contains__(self, name: str) -> bool:
        return name in self._t

    def keep(self, name: str, value):
        """Keep ``value`` (a tensor or a dataclass of tensors) under
        ``name`` as it is; the warm-up makes every such value, a capture
        never does."""
        if capturing(self.device):
            raise RuntimeError(f"workspace value {name!r} made during a CUDA graph capture: "
                               "the warm-up must make it")
        self._t[name] = value
        return value

    def put(self, name: str, value):
        """Copy ``value``, a tensor, a NamedTuple of tensors (SSH's derived
        state ``SSHDerived(cosh, sinh)``) or a dataclass of tensors (a
        deflation basis), into the kept value of that name, each tensor in
        place; the first put keeps a clone, so that no segment ever writes
        into a tensor the caller holds."""
        buf = self._t.get(name)
        if torch.is_tensor(value):
            if buf is None:
                return self.keep(name, value.clone())
            return buf.copy_(value)
        if is_dataclass(value):
            if buf is None:
                return self.keep(name, replace(value, **{
                    f.name: getattr(value, f.name).clone() for f in fields(value)}))
            for f in fields(value):
                getattr(buf, f.name).copy_(getattr(value, f.name))
            return buf
        if buf is None:
            return self.keep(name, value._make(t.clone() for t in value))
        for dst, src in zip(buf, value):
            dst.copy_(src)
        return buf

    def keep_params(self, params, rebuild=()) -> bool:
        """Keep ``self.params``, a copy of the parameter dataclass ``params``
        that the segments read: a clone on the first call, later ``params``'
        changed tensors copied into it when ``params`` is another object.
        False, and nothing copied, where a changed field differs in shape,
        dtype or device, or is one of ``rebuild`` (a tensor a graph holds a
        value derived from): the caller then needs a new workspace."""
        src = self.__dict__.get("_params_src")
        if src is params:
            return True
        if src is None:
            self.params = replace(params, **{f.name: getattr(params, f.name).clone()
                                             for f in fields(params)
                                             if torch.is_tensor(getattr(params, f.name))})
            self._params_src = params
            return True
        changed = []
        for f in fields(params):
            new, kept = getattr(params, f.name), getattr(self.params, f.name)
            if new is getattr(src, f.name):
                continue
            if (f.name in rebuild or not (torch.is_tensor(new) and torch.is_tensor(kept))
                    or (new.shape, new.dtype, new.device) != (kept.shape, kept.dtype,
                                                              kept.device)):
                return False
            changed.append((kept, new))
        for kept, new in changed:
            kept.copy_(new)
        self._params_src = params
        return True

    def load(self, name: str, value):
        """Keep a dataclass of tensors (a preconditioner state, a
        verification's result), or a tuple of them (the near-null
        preconditioner's ``(KPMState, NearNullState)``): the first value is
        kept as it is (its tensors are fresh or constants), a later one
        copied into it field by field, skipping the fields that are the
        kept tensors themselves (the constants)."""
        kept = self._t.get(name)
        if kept is None:
            return self.keep(name, value)
        for src_dc, dst_dc in (zip(value, kept) if isinstance(value, tuple)
                               else ((value, kept),)):
            for f in fields(src_dc):
                src, dst = getattr(src_dc, f.name), getattr(dst_dc, f.name)
                if src is dst:
                    continue
                if not torch.is_tensor(src):
                    raise ValueError(f"{name}.{f.name}: {src!r} where the kept state has "
                                     f"{dst!r}")
                dst.copy_(src)
        return kept

    def put_start(self, src) -> None:
        """Keep the preconditioner's power-iteration start vectors ``src``
        (a tuple of tensors) on the device as ``self.kpm_start``, copied in
        only when ``src`` is another tuple than the last one; None (a
        preconditioner that carries none) passes None to its setup."""
        if self.__dict__.get("start_src", _NO_START) is not src:
            self.kpm_start = None if src is None else tuple(
                self.put(f"kpm_start{i}", s.to(self.device)) for i, s in enumerate(src))
            self.start_src = src

    def collective(self, fn) -> None:
        """An eager step between two replays of a segmented call, such as a
        gather of the chain ranks: ``fn()`` on the current stream, which
        orders it after the replays before it and before those after it
        (a replay runs on the current stream). It is never captured: gloo
        cannot be, and a collective issued while a stream captures fails.
        In a segment list it stands as :func:`between`'s entry."""
        global collectives
        fn()
        collectives += 1

    def capture_once(self, segments) -> None:
        """On a CUDA device, the first time: warm up and capture the
        ``(name, fn)`` pairs that ``segments()`` lists."""
        if self.graphs is not None and not self.graphs.graphs:
            seq = segments()
            self.graphs.warm_up(seq)
            self.graphs.capture(seq)

    def run(self, name: str, fn) -> None:
        """Segment ``name``: its graph replayed on a CUDA device, ``fn``
        called on the CPU."""
        if self.graphs is None:
            fn()
        else:
            self.graphs.replay(name)


# eager steps between replays (Workspace.collective) since the last reset: a
# segmented call replays host reads + 1 graphs per run of segments between
# two of them
collectives = 0


def between(fn) -> tuple:
    """The segment-list entry of an eager step between two segments
    (:meth:`Workspace.collective`): the warm-up runs it in its place, on the
    current stream after the capture stream's work so far; the capture
    skips it."""
    return (None, fn)


def step_workspace(box: dict, params, x) -> Workspace:
    """The workspace kept in ``box`` for fields like ``x`` under parameters
    like ``params``, its parameters brought to ``params``; a new one (new
    graphs) where the device, dtype or shape differ, where the hopping turns
    complex or real (a real workspace never serves a complex call, nor the
    reverse: the fermion fields' dtype differs), or where a parameter of
    :data:`REBUILD` changed. A graph derives nothing else from the
    parameters: it reads the kept copy on every replay."""
    ws = box.get("ws")
    key = (x.device, x.dtype, tuple(x.shape), field_dtype(params, x.dtype))
    if ws is not None and ws.key == key and ws.keep_params(params, REBUILD):
        return ws
    ws = box["ws"] = Workspace(x.device)
    ws.key = key
    ws.keep_params(params)
    ws.graphs = UpdateGraphs(x.device) if x.device.type == "cuda" else None
    ws.retries = 0
    # the host reads of the eager retries, which no replay follows
    ws.retry_reads = 0
    ws.put("tol", torch.zeros((), dtype=torch.float64, device=x.device))
    return ws


class CGSolve:
    """The CG solve of MᵀM·z = ``ws.<rhs>`` (preconditioned or plain) as
    segments over a workspace (the derived state ``ws.env``, stacked by
    ``ops.stack`` where ``stacked``; the tolerance ``ws.tol``; the
    preconditioner state ``ws.kpm``): its start (:meth:`start`), blocks of
    ``solvers.CG_SYNC_EVERY`` masked iterations (:meth:`block_step`), the
    verification (:meth:`verify`) and its rare retry (:meth:`retry`, run
    eagerly), each doing :func:`..solvers.solve_checked`'s arithmetic, or
    with ``block`` :func:`..solvers.block_solve_checked`'s (block CG over
    the axis before the field axes: the two spins of a trajectory solve, the
    nᵥ probes of a measurement). The state is ``ws.cg``, or ``ws.bcg`` for
    block CG (:meth:`state`), so an update that runs both kinds keeps both;
    their graphs are ``cg_block`` and ``verify``, and ``bcg_block`` and
    ``bcg_verify`` (``_block_loop`` where the in-loop operator is the
    cheaper one). With ``deflate`` the
    start is projected onto the workspace's deflation basis ``ws.defl``
    twice (``solvers.cg_init(deflate=)``).

    :meth:`solve` keeps the eager solve's host reads: ``any(active)``
    before each block, and ``any(bad)`` after the verification where a
    retry is possible (a preconditioner, or block CG). On a replayed call a
    preconditioner's deferred check (``precond.check``, the near-null
    factorisations) runs before the first read. Under complex hopping the
    systems are the packed complex fields (``[C, 1, N, Lτ]`` for a
    trajectory solve, ``[C, nᵥ, N, Lτ]`` for the probes), their dots the
    float64 Re(a†b) of :func:`..utils.dtypes.fdot` and block CG's Grams
    Hermitian. On a site shard every dot, norm and Gram is summed over the
    site group (``reduce``, :func:`..dynamics.solve.site_reduce`), as in
    the eager solve, so every rank reads the same ``any(active)`` and
    ``any(bad)``."""

    def __init__(self, ops, precond, maxiter: int, kappa_max: float, loop_precision,
                 rhs: str, stacked: bool, block: bool = False, deflate: bool = False):
        self.ops, self.precond = ops, precond
        self.reduce = site_reduce(ops)
        self.maxiter, self.kappa_max, self.loop_precision = maxiter, kappa_max, loop_precision
        self.rhs, self.stacked = rhs, stacked
        self.block, self.deflate = block, deflate
        self.name = "bcg" if block else "cg"
        # graph names are per kind: an update that runs both keeps both
        self.verify_name = "bcg_verify" if block else "verify"

    def state(self, ws):
        """The solve's :class:`..solvers.CGState` (block CG's
        :class:`..solvers.BlockCGState`) in the workspace."""
        return getattr(ws, self.name)

    def _hot(self, ws, tol):
        """The in-loop MᵀM of a solve at ``tol`` on the workspace's field
        (dynamics/solve._cg_operators)."""
        return self._operators(ws, SolverConfig(tol=tol, loop_precision=self.loop_precision))

    def _full(self, ws):
        """The verification's (and the retry's) operator: the full MᵀM."""
        return self._operators(ws, SolverConfig(loop_precision=None))

    def _operators(self, ws, scfg):
        env = self.ops.stack(ws.env) if self.stacked else ws.env
        return _cg_operators(self.ops, ws.params, env, scfg)[0]

    def kind(self, tol) -> str:
        """The CG block graph of a solve at ``tol``: one graph serves every
        solve whose in-loop operator is the full one."""
        loop = _cg_operators(self.ops, None, None, SolverConfig(
            tol=tol, loop_precision=self.loop_precision))[1] is not None
        return f"{self.name}_block_loop" if loop else f"{self.name}_block"

    def _P(self, ws):
        if self.precond is None:
            return None
        return spans.marked("kpm.apply", precond_applies(self.precond, ws.kpm).symmetric)

    def start(self, ws, tol: float, guess=None) -> None:
        """The solve's start at ``tol`` from ``guess`` (zero for None)."""
        ws.tol.fill_(tol)
        rhs = getattr(ws, self.rhs)
        if self.block:
            st = solvers.block_cg_init(self._hot(ws, tol), rhs, guess, apply_P=self._P(ws),
                                       tol=ws.tol, reduce=self.reduce)
        else:
            st = solvers.cg_init(self._hot(ws, tol), rhs, guess, apply_P=self._P(ws), tol=ws.tol,
                                 deflate=ws.defl if self.deflate else None, reduce=self.reduce)
        if self.name in ws:
            self.state(ws).load_(st)
        else:
            ws.keep(self.name, st.clone())

    def block_step(self, ws, tol) -> None:
        step = solvers.block_cg_block if self.block else solvers.cg_block
        step(self._hot(ws, tol), self.state(ws), apply_P=self._P(ws), tol=ws.tol,
             maxiter=self.maxiter, kappa_max=self.kappa_max, reduce=self.reduce)

    def verify(self, ws) -> None:
        st = self.state(ws)
        ws.load("verdict", solvers.cg_verify(self._full(ws), getattr(ws, self.rhs), st.x,
                                             st.iters, ws.tol, self.maxiter, self.reduce))

    def retry(self, ws) -> None:
        """The verification's retry, eager (it runs only when a system
        failed), through the same kernels; its result goes into the
        workspace."""
        st, reads = self.state(ws), solvers.host_reads
        res = solvers.cg_retry(self._full(ws), getattr(ws, self.rhs), st.x, st.iters,
                               ws.verdict, ws.tol, self.maxiter, self.kappa_max, self.reduce)
        ws.retry_reads += solvers.host_reads - reads
        st.x.copy_(res.x)
        st.iters.copy_(res.iters)
        ws.verdict.flag.copy_(res.flag)
        ws.verdict.residual.copy_(res.residual)
        ws.retries += 1

    def segments(self, ws, tol) -> list:
        """The solve's segments in capture order: one CG block, the
        verification."""
        return [(self.kind(tol), lambda: self.block_step(ws, tol)),
                (self.verify_name, lambda: self.verify(ws))]

    def solve(self, ws, tol) -> None:
        """The host loop of a started solve: blocks while any system is
        active, the verification, and the retry where a system failed (the
        span ``solve``, with ``solve.block``, ``solve.verify`` and
        ``solve.retry`` inside it)."""
        with spans.span("solve"):
            if ws.graphs is not None and self.precond is not None and self.precond.check:
                self.precond.check(ws.kpm)
            st = self.state(ws)
            j = 0
            while j < self.maxiter and solvers.host_any(st.active):
                with spans.span("solve.block"):
                    ws.run(self.kind(tol), lambda: self.block_step(ws, tol))
                j += solvers.CG_SYNC_EVERY
            with spans.span("solve.verify"):
                ws.run(self.verify_name, lambda: self.verify(ws))
            if (self.block or self.precond is not None) and solvers.host_any(ws.verdict.bad):
                with spans.span("solve.retry"):
                    self.retry(ws)

    def result(self, ws):
        """The finished solve's (solution, per-system iterations, flags)."""
        st = self.state(ws)
        return st.x, st.iters, ws.verdict.flag


class NonsymSolve:
    """The BiCGStab or GMRES solve (``kind``) of
    :func:`..dynamics.solve.solve_minv`, M·x = ``ws.<rhs>`` with the left
    apply, or with ``oinv`` the two stages of
    :func:`..dynamics.solve.solve_oinv`: Mᵀ·y = ``ws.<rhs>`` with the right
    apply (stage ``T``), then M·z = y with the left one (stage ``M``), y the
    first stage's solution after its retry (``ws.ns_y``). Each stage does
    ``dynamics/solve._checked_nonsym``'s arithmetic as segments over a
    workspace (the derived state ``ws.env``, stacked by ``ops.stack`` where
    ``stacked``; the tolerance ``ws.tol``; the preconditioner state
    ``ws.kpm``), with :class:`CGSolve`'s interface, so that a sampler call
    runs either.

    BiCGStab's state is ``ws.bicg`` (:class:`..solvers.BiCGStabState`), its
    blocks of ``solvers.CG_SYNC_EVERY`` iterations the graphs
    ``bicg_block_{stage}``. GMRES's is ``ws.gmres``
    (:class:`..solvers.GMRESState`, its Krylov basis kept from one call to
    the next), in graphs ``gmres_cycle_{stage}`` (a restart cycle's start),
    ``gmres_arnoldi_{stage}_{i0}`` (the Arnoldi steps i0 … i0 + 3, on fixed
    slices of the basis; the last block also closes the cycle, since it
    ends at the restart length) and ``gmres_close_{stage}_{n}`` (the close of
    a cycle left after n steps, one graph for each n a host read can stop
    at: the multiples of ``CG_SYNC_EVERY`` below the restart length). Then
    ``nonsym_verify_{stage}`` (:func:`..solvers.cg_verify`) and, rarely,
    the eager retry (:func:`..dynamics.solve.nonsym_retry`); between the
    stages ``nonsym_next`` keeps the first stage's solution, iterations and
    flags and starts the second. The two stages share the state, and no
    name is a :class:`CGSolve` graph's.

    :meth:`solve` keeps the eager solve's host reads: BiCGStab's
    ``any(active)`` before each block, GMRES's ``any(~done_all)`` before
    each cycle and ``any(~done)`` before each block of Arnoldi steps, and
    ``any(bad)`` after a verification where the stage has a
    preconditioner. The result (:meth:`result`) sums the two stages'
    iterations and takes the larger flag, as ``solve_oinv`` does."""

    def __init__(self, ops, precond, kind: str, maxiter: int, restart: int, rhs: str,
                 stacked: bool, oinv: bool):
        self.ops, self.precond = ops, precond
        self.kind, self.maxiter, self.restart = kind, maxiter, restart
        self.rhs, self.stacked = rhs, stacked
        self.name = "bicg" if kind == "bicgstab" else "gmres"
        self.stages = ("T", "M") if oinv else ("M",)
        self.base = base_solver(SolverConfig(kind=kind, restart=restart))

    def state(self, ws):
        """The solve's :class:`..solvers.BiCGStabState` or
        :class:`..solvers.GMRESState` in the workspace."""
        return getattr(ws, self.name)

    def _A(self, ws, stage: str):
        env = self.ops.stack(ws.env) if self.stacked else ws.env
        mul = self.ops.mulMT if stage == "T" else self.ops.mulM
        return lambda v: mul(ws.params, env, v)

    def _has_P(self, stage: str) -> bool:
        side = "right" if stage == "T" else "left"
        return self.precond is not None and getattr(self.precond, side) is not None

    def _P(self, ws, stage: str):
        if not self._has_P(stage):
            return None
        pa = precond_applies(self.precond, ws.kpm)
        return spans.marked("kpm.apply", pa.right if stage == "T" else pa.left)

    def _b(self, ws, stage: str):
        return ws.ns_y if stage == "M" and len(self.stages) == 2 else getattr(ws, self.rhs)

    def _init(self, ws, stage: str) -> None:
        """The stage's start from zero at ``ws.tol``."""
        b = self._b(ws, stage)
        if self.kind == "bicgstab":
            st = solvers.bicgstab_init(self._A(ws, stage), b, tol=ws.tol)
            if self.name in ws:
                self.state(ws).load_(st)
            else:
                ws.keep(self.name, st.clone())
            return
        if self.name not in ws:
            ws.keep(self.name, solvers.gmres_state(b, self.restart))
        solvers.gmres_init(self.state(ws), b, apply_P=self._P(ws, stage))

    def start(self, ws, tol: float, guess=None) -> None:
        """The solve's start at ``tol``, from zero: callers pass no
        ``guess`` (no warm start, as in the JAX package)."""
        ws.tol.fill_(tol)
        self._init(ws, self.stages[0])

    def _kw(self, ws, stage: str) -> dict:
        return dict(apply_P=self._P(ws, stage), tol=ws.tol)

    def _bicg_block(self, ws, stage: str) -> None:
        solvers.bicgstab_block(self._A(ws, stage), self.state(ws), maxiter=self.maxiter,
                               **self._kw(ws, stage))

    def _cycle(self, ws, stage: str) -> None:
        solvers.gmres_cycle_start(self._A(ws, stage), self._b(ws, stage), self.state(ws),
                                  **self._kw(ws, stage))

    def _arnoldi(self, ws, stage: str, i0: int) -> None:
        solvers.gmres_arnoldi_block(self._A(ws, stage), self.state(ws), i0,
                                    **self._kw(ws, stage))
        if i0 + solvers.CG_SYNC_EVERY >= self.restart:
            self._close(ws, stage, self.restart)

    def _close(self, ws, stage: str, n: int) -> None:
        solvers.gmres_cycle_close(self.state(ws), n, apply_P=self._P(ws, stage))

    def verify(self, ws, stage: str) -> None:
        st = self.state(ws)
        ws.load("verdict", solvers.cg_verify(self._A(ws, stage), self._b(ws, stage), st.x,
                                             st.iters, ws.tol, self.maxiter))

    def retry(self, ws, stage: str) -> None:
        """The verification's retry, eager (it runs only when a system
        failed), through the same kernels; its result goes into the
        workspace."""
        st, reads = self.state(ws), solvers.host_reads
        res = nonsym_retry(self._A(ws, stage), self._b(ws, stage), st.x, st.iters, ws.verdict,
                           self.base, ws.tol, self.maxiter)
        ws.retry_reads += solvers.host_reads - reads
        st.x.copy_(res.x)
        st.iters.copy_(res.iters)
        ws.verdict.flag.copy_(res.flag)
        ws.verdict.residual.copy_(res.residual)
        ws.retries += 1

    def next_stage(self, ws) -> None:
        """Between the stages: the first one's solution (the second one's
        right-hand side), iterations and flags kept, the second one
        started."""
        st = self.state(ws)
        ws.put("ns_y", st.x)
        ws.put("ns_iters", st.iters)
        ws.put("ns_flag", ws.verdict.flag)
        self._init(ws, "M")

    def _steps(self, ws, stage: str) -> list:
        """The stage's iteration segments in capture order."""
        if self.kind == "bicgstab":
            return [(f"bicg_block_{stage}", lambda: self._bicg_block(ws, stage))]
        every = solvers.CG_SYNC_EVERY
        starts = range(0, self.restart, every)
        return ([(f"gmres_cycle_{stage}", lambda: self._cycle(ws, stage))]
                + [(f"gmres_arnoldi_{stage}_{i0}", lambda i0=i0: self._arnoldi(ws, stage, i0))
                   for i0 in starts]
                + [(f"gmres_close_{stage}_{n}", lambda n=n: self._close(ws, stage, n))
                   for n in starts])

    def segments(self, ws, tol) -> list:
        """The solve's segments in capture order: per stage its iteration
        segments and its verification, ``nonsym_next`` between the
        stages."""
        seq = []
        for k, stage in enumerate(self.stages):
            if k:
                seq.append(("nonsym_next", lambda: self.next_stage(ws)))
            seq += self._steps(ws, stage)
            seq.append((f"nonsym_verify_{stage}", lambda s=stage: self.verify(ws, s)))
        return seq

    def _iterate(self, ws, stage: str) -> None:
        """The host loop of a started stage up to its verification."""
        st, every = self.state(ws), solvers.CG_SYNC_EVERY
        if self.kind == "bicgstab":
            j = 0
            while j < self.maxiter and solvers.host_any(st.active):
                with spans.span("solve.block"):
                    ws.run(f"bicg_block_{stage}", lambda: self._bicg_block(ws, stage))
                j += every
            return
        m = self.restart
        for _ in range(solvers.gmres_cycles(self.maxiter, m)):
            if not solvers.host_any(~st.done_all):
                break
            with spans.span("solve.block"):
                ws.run(f"gmres_cycle_{stage}", lambda: self._cycle(ws, stage))
            n = 0
            for i0 in range(0, m, every):
                if not solvers.host_any(~st.done):
                    break
                with spans.span("solve.block"):
                    ws.run(f"gmres_arnoldi_{stage}_{i0}",
                           lambda i0=i0: self._arnoldi(ws, stage, i0))
                n = min(i0 + every, m)
            if n < m:
                with spans.span("solve.block"):
                    ws.run(f"gmres_close_{stage}_{n}", lambda n=n: self._close(ws, stage, n))

    def solve(self, ws, tol) -> None:
        """The host loop of a started solve: each stage's iterations, its
        verification and its retry where a system failed (the spans as
        :meth:`CGSolve.solve`'s; a GMRES cycle's start and close are
        ``solve.block`` too)."""
        with spans.span("solve"):
            if ws.graphs is not None and self.precond is not None and self.precond.check:
                self.precond.check(ws.kpm)
            for k, stage in enumerate(self.stages):
                if k:
                    ws.run("nonsym_next", lambda: self.next_stage(ws))
                self._iterate(ws, stage)
                with spans.span("solve.verify"):
                    ws.run(f"nonsym_verify_{stage}", lambda s=stage: self.verify(ws, s))
                if self._has_P(stage) and solvers.host_any(ws.verdict.bad):
                    with spans.span("solve.retry"):
                        self.retry(ws, stage)

    def result(self, ws):
        """The finished solve's (solution, per-system iterations, flags):
        with two stages the second one's solution, the iterations summed and
        the larger flag."""
        st = self.state(ws)
        if len(self.stages) == 1:
            return st.x, st.iters, ws.verdict.flag
        return st.x, ws.ns_iters + st.iters, torch.maximum(ws.ns_flag, ws.verdict.flag)


def make_solve(ops, precond, scfg: SolverConfig, rhs: str, stacked: bool, block: bool = False):
    """The segmented solve for M⁻¹ of ``scfg``'s kind (the Langevin force's,
    the probes'): :class:`CGSolve` on MᵀM for CG (block CG with ``block``),
    else :class:`NonsymSolve` on M."""
    if scfg.kind == "cg":
        return CGSolve(ops, precond, scfg.maxiter, scfg.kappa_max, scfg.loop_precision, rhs=rhs,
                       stacked=stacked, block=block)
    return NonsymSolve(ops, precond, scfg.kind, scfg.maxiter, scfg.restart, rhs=rhs,
                       stacked=stacked, oinv=False)


# one capture stream per device for every graph set: cuBLAS allocates a
# workspace (32 MiB on an H100) for each stream it first runs a product on
# and keeps it until the process ends, and torch.cuda.Stream hands out up
# to 32 pooled streams, so a stream per graph set left up to 32 of them
_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which every graph set of ``device`` warms up and
    captures."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class UpdateGraphs:
    """The captured segments of one sampler call on one CUDA device: one graph
    per segment name, one memory pool, the device's capture stream
    (:func:`capture_stream`). Each graph keeps what was counted during its
    capture (:class:`..utils.capture.Record`: the kernel launches, a site
    shard's folds, halo messages and all-reduces), and every replay counts
    it again, so the counts stay counts of what ran on the card. Each graph
    also holds its timing marks (:class:`..utils.spans.Marks`: its begin
    and end, and the ``kpm.apply``, ``kpm.setup``, ``kpm.refresh`` and
    ``force`` marks its segment reached), which a replay's ``graph.replay``
    span hands to the spans' record while spans record."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = capture_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self.marks: dict = {}     # per graph: its spans.Marks
        self.replays = 0          # replays since the graphs were made
        self.capture_s = 0.0      # seconds spent capturing
        self.pool_bytes = 0       # device memory the pool holds after the captures

    def warm_up(self, segments) -> None:
        """Run ``segments`` (``(name, fn)`` pairs) once each, in order,
        eagerly on the capture stream; an entry of :func:`between` (name
        None) on the current stream, joined to the capture stream on both
        sides."""
        with spans.span("graphs.warm_up"):
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            for name, fn in segments:
                if name is None:
                    current.wait_stream(self.stream)
                    fn()
                    self.stream.wait_stream(current)
                    continue
                with torch.cuda.stream(self.stream):
                    fn()
            current.wait_stream(self.stream)
            torch.cuda.synchronize(self.device)

    def capture(self, segments) -> None:
        """Capture each not yet captured segment of ``segments``, in order
        (the eager steps of :func:`between` are not captured)."""
        t0 = time.perf_counter()
        with spans.span("graphs.capture"):
            for name, fn in segments:
                if name is None or name in self.graphs:
                    continue
                graph = torch.cuda.CUDAGraph()
                with capture.recording() as rec:
                    with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                        with spans.marking() as marks:
                            fn()
                self.graphs[name] = (graph, rec)
                self.marks[name] = marks
            torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                              if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))

    def replay(self, name: str) -> None:
        graph, rec = self.graphs[name]
        with spans.span("graph.replay", name, self.marks[name]):
            graph.replay()
        rec.replayed()
        self.replays += 1
