"""Spans: named intervals of the port's host work, with the device time
under them, and marks: device intervals inside a CUDA graph.

A span (:func:`span`) costs one check of two flags while nothing records:
it then opens no profiler range, reads no clock and records no event.
Spans record while ``torch.profiler`` records (``torch.profiler.profile``
sets ``torch.autograd.profiler._is_profiler_enabled``) or inside
:func:`recording` (tests, and a measure of what the spans cost). Then each
span

* opens a ``record_function`` range of its name, so that the port's names
  stand on the host row of a profiler trace (and, through the profiler's
  device-side annotations, on the device row);
* stamps its host start and end on the profiler's clock (Unix ns, as the
  trace's events);
* under a root (:func:`root`) on a CUDA device, records a timing
  ``torch.cuda.Event`` on the current stream at its entry and at its exit:
  eager events, between graph replays (spans stand in the host's loops,
  never inside a captured segment);
* records its parent, the innermost span open at its entry.

Every span under one root shares the root's index. At the root's exit the
device is synchronised once and each span's device seconds read; the
root's :class:`Record` (per span name: count, host and device seconds and
their self parts, a span's time less what its children cover) is kept
until the next root of that name closes, :func:`last` returns it.

A CUDA graph hides its work from host spans. ``dynamics/graphs.py``'s
``UpdateGraphs`` captures each segment inside :func:`marking`, which
brackets the captured work with a begin and an end event, and every :func:`mark`
reached during the capture records a pair of its own (each call its own
pair: the four KPM applies of a CG block are four pairs). Captured, the
events are event-record nodes of the graph (``external=True``), recorded
on every replay, so each pair holds its graph's last replay; a
``graph.replay`` span that carries the graph's :class:`Marks` has them read
at the root's exit. Outside a capture (the CPU, eager calls, the warm-up) a mark
does nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _profiler

_recording = 0            # open recording() blocks
_frame = None             # the open root's _Frame
_last: dict = {}          # root name -> the Record of its last closed root
_index = itertools.count()
_marks = None             # the Marks of the segment being captured
_OFF = contextlib.nullcontext()   # every span and mark while nothing records


def enabled() -> bool:
    """Whether spans record now."""
    return bool(_recording or _profiler._is_profiler_enabled)


class recording:
    """Spans record inside the block, with no profiler running."""

    def __enter__(self):
        global _recording
        _recording += 1
        return self

    def __exit__(self, *exc):
        global _recording
        _recording -= 1
        return False


def span(name: str, key: str | None = None, marks: Marks | None = None):
    """The span ``name`` around a block (``with spans.span(name):``);
    ``key`` splits its record (a graph's name), ``marks`` are the marks of
    the graph it replays."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, key, marks, None)


def root(name: str, device):
    """The root span ``name``: every span opened inside it is recorded
    under its index, with device seconds on a CUDA ``device``; its record
    is :func:`last` (``name``) after it closes. Inside another root it is
    that root's child."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, None, None, torch.device(device))


def last(name: str) -> Record | None:
    """The record of the last closed root ``name`` (None before one)."""
    return _last.get(name)


# --- the profiler's range and clock, reached only while spans record

def _range_enter(name: str):
    return torch.ops.profiler._record_function_enter_new(name, None)


def _range_exit(handle) -> None:
    torch.ops.profiler._record_function_exit._RecordFunction(handle)


def _now() -> int:
    """Unix ns, the clock of the profiler's host events."""
    return time.time_ns()


def _timing_event(external: bool = False):
    return torch.cuda.Event(enable_timing=True, external=external)


# --- what a root records

@dataclass
class Stat:
    """The spans of one name (or one name and key) under a root."""

    count: int = 0
    host_s: float = 0.0
    self_host_s: float = 0.0
    device_s: float | None = None        # None where the root had no CUDA device
    self_device_s: float | None = None


@dataclass
class Event:
    """One span under a root: name, key, parent (index into the root's
    events, -1 for the root), host start and end (Unix ns) and device
    seconds."""

    name: str
    key: str | None
    parent: int
    start_ns: int
    end_ns: int = 0
    device_s: float | None = None


@dataclass
class Record:
    """A closed root: its ``name``, its ``index`` (the identifier every span
    under it shares), the ``device`` type it timed on (None: no device
    seconds), its events in the order they opened, per span name
    (``spans``) and per (name, key) (``keys``) their :class:`Stat`, and per
    graph replayed under it the device seconds of its last replay
    (``replay_s``, its begin mark to its end mark) and of each mark label
    in that replay (``marks``)."""

    name: str
    index: int
    device: str | None
    events: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    keys: dict = field(default_factory=dict)
    replay_s: dict = field(default_factory=dict)
    marks: dict = field(default_factory=dict)


class _Frame:
    """An open root: its events with their device event pairs and marks."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.index = name, next(_index)
        self.timed = device.type == "cuda"
        self.device = device
        self.events: list[Event] = []
        self.pairs: list = []          # per event: (start, end) CUDA events or None
        self.marks: dict = {}          # graph name -> its Marks
        self.open: list[int] = []      # indices of the open spans, innermost last


class _Span:
    __slots__ = ("name", "key", "marks", "device", "handle", "at", "frame")

    def __init__(self, name, key, marks, device):
        self.name, self.key, self.marks, self.device = name, key, marks, device
        self.at = self.frame = None

    def __enter__(self):
        global _frame
        t0 = _now()
        self.handle = _range_enter(self.name)
        if _frame is None and self.device is not None:
            _frame = self.frame = _Frame(self.name, self.device)
        f = _frame
        if f is None:
            return self
        self.at = len(f.events)
        f.events.append(Event(self.name, self.key, f.open[-1] if f.open else -1, t0))
        pair = None
        if f.timed:
            pair = (_timing_event(), _timing_event())
            pair[0].record()
        f.pairs.append(pair)
        if self.marks is not None:
            f.marks[self.key] = self.marks
        f.open.append(self.at)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _frame
        f = _frame
        if self.at is not None and f is not None:
            pair = f.pairs[self.at]
            if pair is not None:
                pair[1].record()
            f.open.pop()
        _range_exit(self.handle)
        if self.at is not None and f is not None:
            f.events[self.at].end_ns = _now()
        if self.frame is not None:
            _frame = None
            if exc_type is None:
                _last[self.name] = _close(self.frame)
        return False


def _close(f: _Frame) -> Record:
    """The record of the closed root ``f``: one synchronise, then every
    span's device seconds and every replayed graph's marks."""
    if f.timed:
        torch.cuda.synchronize(f.device)
    ev = f.events
    for e, pair in zip(ev, f.pairs):
        if pair is not None:
            e.device_s = pair[0].elapsed_time(pair[1]) / 1e3
    child_host = [0.0] * len(ev)
    child_dev = [0.0] * len(ev)
    for e in ev:
        if e.parent >= 0:
            child_host[e.parent] += (e.end_ns - e.start_ns) / 1e9
            child_dev[e.parent] += e.device_s or 0.0
    rec = Record(f.name, f.index, f.device.type if f.timed else None, ev)
    for i, e in enumerate(ev):
        host = (e.end_ns - e.start_ns) / 1e9
        for table, k in ((rec.spans, e.name), (rec.keys, (e.name, e.key))):
            if table is rec.keys and e.key is None:
                continue
            s = table.setdefault(k, Stat())
            s.count += 1
            s.host_s += host
            s.self_host_s += host - child_host[i]
            if e.device_s is not None:
                s.device_s = (s.device_s or 0.0) + e.device_s
                s.self_device_s = (s.self_device_s or 0.0) + e.device_s - child_dev[i]
    for g, m in f.marks.items():
        rec.replay_s[g], rec.marks[g] = m.seconds()
    return rec


# --- marks inside a CUDA graph

class Marks:
    """The timing events one captured segment records on each replay: its
    begin and end, and each mark's pair with its label."""

    def __init__(self):
        self.begin, self.end = _timing_event(True), _timing_event(True)
        self.pairs: list = []

    def seconds(self) -> tuple[float, dict]:
        """(device seconds of the last replay, {label: device seconds of
        its marks in that replay}); the events must have completed."""
        labels: dict = {}
        for label, a, b in self.pairs:
            labels[label] = labels.get(label, 0.0) + a.elapsed_time(b) / 1e3
        return self.begin.elapsed_time(self.end) / 1e3, labels


class marking:
    """Inside a CUDA graph's capture: the begin and end events of the
    captured work, and the marks reached in it; ``as`` gives the
    :class:`Marks`."""

    def __enter__(self):
        global _marks
        self.marks, self.outer = Marks(), _marks
        self.marks.begin.record()
        _marks = self.marks
        return self.marks

    def __exit__(self, *exc):
        global _marks
        _marks = self.outer
        self.marks.end.record()
        return False


class _Mark:
    __slots__ = ("into", "label", "start")

    def __init__(self, into: Marks, label: str):
        self.into, self.label = into, label

    def __enter__(self):
        self.start = _timing_event(True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = _timing_event(True)
        end.record()
        self.into.pairs.append((self.label, self.start, end))
        return False


def mark(label: str):
    """The mark ``label`` around captured work (``with spans.mark(label):``);
    nothing outside a :func:`marking` capture."""
    if _marks is None:
        return _OFF
    return _Mark(_marks, label)


def marked(label: str, fn):
    """``fn`` with each call inside :func:`mark` (``label``) during a
    :func:`marking` capture; ``fn`` itself otherwise."""
    if _marks is None or fn is None:
        return fn

    def call(*args, **kwargs):
        with mark(label):
            return fn(*args, **kwargs)

    return call
