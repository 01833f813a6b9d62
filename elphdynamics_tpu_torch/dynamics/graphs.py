"""CUDA graphs of an update: the port's counterpart of the JAX package's
compiled update (``jax.jit`` over ``lax.while_loop`` bodies).

An update is split into segments, each a function over one
:class:`Workspace` of tensors that keep their addresses from one update to
the next. On a CUDA device every segment is captured once into a
``torch.cuda.CUDAGraph``, all of one update's graphs in one memory pool and
in the order they first replay, and then replayed; the host keeps only the
loop control between replays (``any(active)`` before a CG block, ``any(bad)``
after a verification). On the CPU each segment is called directly, so the
tier-1 tests run the same code the graphs hold.

Before its capture every segment runs once eagerly on the capture stream
(the warm-up): first-use work that a capture cannot hold happens there, such
as the kernels' launch-geometry tuning and bond-plan uploads
(``ops/ckb_cuda.py``), the KPM constant tables (``ops/kpm.py``), the mass
operator's circulants and the bf16 operand of exp(−Δτ·K). A capture that
reaches such work raises, as does any other failed capture or replay: there
is no fallback to the eager update.

Only workspace tensors cross a segment boundary. They are allocated outside
the pool during the warm-up, so a graph's intermediates, which the pool
shares between graphs, never hold a value another graph reads.
"""

from __future__ import annotations

import time
from dataclasses import fields, replace

import torch

from elphdynamics_tpu_torch.ops import ckb_cuda


def capturing(device: torch.device) -> bool:
    """Whether the current stream of a CUDA ``device`` is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


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
        """Copy ``value``, a tensor or a NamedTuple of tensors (SSH's derived
        state ``SSHDerived(cosh, sinh)``), into the kept value of that name,
        each tensor in place; the first put keeps a clone."""
        buf = self._t.get(name)
        if torch.is_tensor(value):
            if buf is None:
                return self.keep(name, value.clone())
            return buf.copy_(value)
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
        verification's result): the first value is kept as it is (its
        tensors are fresh or constants), a later one copied into it field
        by field, skipping the fields that are the kept tensors themselves
        (the constants)."""
        kept = self._t.get(name)
        if kept is None:
            return self.keep(name, value)
        for f in fields(value):
            src, dst = getattr(value, f.name), getattr(kept, f.name)
            if src is dst:
                continue
            if not torch.is_tensor(src):
                raise ValueError(f"{name}.{f.name}: {src!r} where the kept state has {dst!r}")
            dst.copy_(src)
        return kept


class UpdateGraphs:
    """The captured segments of one update on one CUDA device: one graph
    per segment name, one memory pool, one capture stream. Each graph keeps
    the kernel launches counted during its capture
    (:class:`..ops.ckb_cuda.LaunchRecord`), and every replay counts them
    again, so the kernels' launch counts stay counts of launches on the
    card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self.replays = 0          # replays since the graphs were made
        self.capture_s = 0.0      # seconds spent capturing
        self.pool_bytes = 0       # device memory the pool holds after the captures

    def warm_up(self, segments) -> None:
        """Run ``segments`` (``(name, fn)`` pairs) once each, in order,
        eagerly on the capture stream."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _, fn in segments:
                fn()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        torch.cuda.synchronize(self.device)

    def capture(self, segments) -> None:
        """Capture each not yet captured segment of ``segments``, in order."""
        t0 = time.perf_counter()
        for name, fn in segments:
            if name in self.graphs:
                continue
            graph = torch.cuda.CUDAGraph()
            with ckb_cuda.recording() as rec:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    fn()
            self.graphs[name] = (graph, rec)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                              if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))

    def replay(self, name: str) -> None:
        graph, rec = self.graphs[name]
        graph.replay()
        rec.replayed()
        self.replays += 1
