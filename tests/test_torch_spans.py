"""The port's spans and marks (``elphdynamics_tpu_torch/utils/spans.py``)
and the kernels' launch counts per shape (``ops/ckb_cuda.py``).

On the CPU:

* with spans off a span opens no profiler range, reads no clock and
  records no event, through a whole graphed update;
* :func:`spans.recording` nests spans under a root and records counts and
  host seconds (no device seconds on the CPU), with self times;
* under a CPU ``torch.profiler`` run each span's host stamps lie within
  50 µs of its ``record_function`` range;
* a 4×4 Holstein graphed-path update (its segments called directly) gives
  Nt + 2 ``solve`` spans and as many ``host_read`` spans as
  ``solvers.host_reads`` rose by, its marks doing nothing, and the same
  outputs as with spans off;
* a stand-in capture counts each launch shape once per replay.

On a card (``-m cuda``; the file imports no JAX, so
``python -m pytest tests/test_torch_spans.py --noconftest -q -m cuda`` runs
it there): the graphed update with marks in its graphs gives the eager
update's outputs bit for bit, every mark reads a positive time, and the
device seconds of the root's children add up to no more than the root's.
"""

import gc
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.bench import build_bench_step
from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step
from elphdynamics_tpu_torch.ops import ckb_cuda, kpm
from elphdynamics_tpu_torch.utils import capture, spans

torch.set_num_threads(1)


def _refuse(*args, **kwargs):
    raise AssertionError("reached while spans are off")


def _update(device="cpu", **kw):
    """A 2-chain float64 4×4 Holstein bench model at β = 1 (Nt = 4), its
    graphed step, its eager twin and one update's draws."""
    b = build_bench_step(4, 1.0, 0.1, 0.05, 2, device, torch.float64, trajectory_time=0.2,
                         **kw)
    pre = kpm.make_precond(b.ops, b.kpm_cfg)
    seg = make_hmc_step(b.ops, b.mass, b.hmc_cfg, pre)
    eager = make_hmc_step(b.ops, b.mass, b.hmc_cfg, pre, eager=True)
    gen = torch.Generator(device=device).manual_seed(7)
    return b, seg, eager, seg.draw(b.params, b.state.x, 2, gen)


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_last", {})
    for name in ("_range_enter", "_range_exit", "_now", "_timing_event"):
        monkeypatch.setattr(spans, name, _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert not spans.enabled()
    assert spans.span("solve") is spans.root("hmc.update", "cpu") is spans.mark("force")
    b, seg, _, draws = _update()
    seg(b.params, b.state, draws=draws)
    assert spans.last("hmc.update") is None and spans._frame is None


def test_recording_nests_spans(monkeypatch):
    monkeypatch.setattr(spans, "_last", {})
    with spans.recording():
        assert spans.enabled()
        with spans.span("outside"):      # no root open: nothing kept
            pass
        assert spans.last("outside") is None
        with spans.root("r", "cpu"):
            with spans.span("a"):
                time.sleep(0.002)
                for _ in range(2):
                    with spans.span("b", key="k"):
                        time.sleep(0.001)
            with spans.span("b"):
                pass
        first = spans.last("r")
        with spans.root("r", "cpu"):
            pass
    assert not spans.enabled()
    second = spans.last("r")
    assert second.index > first.index and first.device is None
    assert [(e.name, e.key, e.parent) for e in first.events] == [
        ("r", None, -1), ("a", None, 0), ("b", "k", 1), ("b", "k", 1), ("b", None, 0)]
    assert all(e.end_ns >= e.start_ns and e.device_s is None for e in first.events)
    r, a, b = first.spans["r"], first.spans["a"], first.spans["b"]
    assert (r.count, a.count, b.count) == (1, 1, 3)
    assert first.keys[("b", "k")].count == 2 and ("b", None) not in first.keys
    assert a.host_s >= 0.004 and first.keys[("b", "k")].host_s >= 0.002
    k_s = first.keys[("b", "k")].host_s
    assert a.self_host_s == pytest.approx(a.host_s - k_s, abs=1e-12)
    assert r.self_host_s == pytest.approx(r.host_s - a.host_s - (b.host_s - k_s), abs=1e-12)
    assert r.device_s is None and r.self_device_s is None
    assert first.replay_s == {} and first.marks == {}


def _profiled_offsets() -> list:
    """One CPU profiler session of a root with nested spans: per span, the
    gaps (ns) between its host stamps and its ``record_function`` range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.enabled()
        for _ in range(2):                   # the profiler's first ranges cost more
            with spans.span("warm"):
                pass
        gc.disable()                         # no collection between a stamp and its range
        try:
            with spans.root("r", "cpu"):
                for _ in range(3):
                    with spans.span("a"):
                        with spans.span("b"):
                            time.sleep(0.0005)
        finally:
            gc.enable()
    assert not spans.enabled()
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("r", "a", "b"):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    mine: dict = {}
    for e in spans.last("r").events:
        mine.setdefault(e.name, []).append((e.start_ns, e.end_ns))
    assert {n: len(v) for n, v in mine.items()} == {"r": 1, "a": 3, "b": 3}
    return [(name, s - rs, e - re) for name, spans_of in mine.items()
            for (s, e), (rs, re) in zip(spans_of, sorted(ranges[name]))]


def test_spans_lie_on_their_profiler_ranges(monkeypatch):
    """Every span's host stamps lie within 50 µs of its range in a session:
    the stamps share the profiler's clock and bracket the range. The OS may
    suspend the process between a stamp and its range; a session is made
    again, up to three, where that put one past 50 µs."""
    monkeypatch.setattr(spans, "_last", {})
    sessions = []
    for _ in range(3):
        offsets = _profiled_offsets()
        sessions.append(offsets)
        if all(abs(a) <= 50_000 and abs(b) <= 50_000 for _, a, b in offsets):
            break
    else:
        raise AssertionError(f"a span off its range by more than 50 µs in every session: "
                             f"{sessions}")


def test_graphed_update_spans_on_cpu(monkeypatch):
    monkeypatch.setattr(spans, "_last", {})
    b, seg, _, draws = _update()
    off, off_stats = seg(b.params, b.state, draws=draws)
    reads = solvers.host_reads
    with spans.recording():
        on, on_stats = seg(b.params, b.state, draws=draws)
    rec = spans.last("hmc.update")
    Nt = b.hmc_cfg.Nt
    assert Nt > 1 and rec.spans["solve"].count == Nt + 2
    assert rec.spans["host_read"].count == solvers.host_reads - reads > 0
    assert {n: rec.spans[f"hmc.seg.{n}"].count for n in ("start", "first", "step", "last",
                                                         "end")} == dict(
        start=1, first=1, step=Nt - 1, last=1, end=1)
    assert rec.spans["solve.verify"].count == Nt + 2 and rec.spans["solve.block"].count > 0
    assert rec.spans["hmc.inputs"].count == rec.spans["hmc.outputs"].count == 1
    assert "graph.replay" not in rec.spans and rec.device is None
    assert rec.replay_s == {} and rec.marks == {} and spans._marks is None
    for e in rec.events:
        if e.name == "solve" or e.name.startswith("hmc.seg."):
            assert e.parent == 0, e
        elif e.name.startswith("solve."):
            assert rec.events[e.parent].name == "solve", e
    assert torch.equal(off.x, on.x) and torch.equal(off.v, on.v)
    assert torch.equal(off_stats.delta_H, on_stats.delta_H)


def test_launch_counts_per_shape_under_a_stand_in_capture():
    """Each replay of a graph counts each of its launch shapes as often as
    the capture launched it; the counts per shape add up to the form's."""
    ckb_cuda.reset_counts()
    shared = torch.zeros(8)
    a, b = torch.zeros((16, 64, 10)), torch.zeros((16, 2, 64, 10))
    ckb_cuda._count("fold", shared, a)
    with capture.recording() as rec:
        for _ in range(2):
            ckb_cuda._count("fold", shared, a)
        ckb_cuda._count("fold", shared, b)
    for _ in range(3):
        rec.replayed()
    assert ckb_cuda.launch_shapes == {("fold/shared", (16, 64, 10), torch.float32): 7,
                                      ("fold/shared", (16, 2, 64, 10), torch.float32): 3}
    assert sum(ckb_cuda.launch_shapes.values()) == ckb_cuda.table_launches["fold/shared"] == 10
    ckb_cuda.reset_counts()
    assert ckb_cuda.launch_shapes == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and the fold kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_update_with_marks_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(spans, "_last", {})
    b, seg, eager, draws = _update(cuda, dense_threshold=0, pallas_threshold=0)
    state = b.state
    for _ in range(2):                   # the first call captures, the second replays
        with spans.recording():
            out, stats = seg(b.params, state, draws=draws)
        want, want_stats = eager(b.params, state, draws=draws)
        assert torch.equal(out.x, want.x) and torch.equal(out.v, want.v)
        for f in ("accepted", "iters", "flag", "delta_H", "H", "S", "K"):
            assert torch.equal(getattr(stats, f), getattr(want_stats, f)), f
        state = out
    rec = spans.last("hmc.update")
    assert rec.device == "cuda" and "graphs.capture" not in rec.spans
    graphs = seg.workspace().graphs
    assert set(rec.replay_s) == set(graphs.graphs)
    assert rec.spans["graph.replay"].count == sum(
        s.count for k, s in rec.keys.items() if k[0] == "graph.replay")
    labels = {label for m in rec.marks.values() for label in m}
    assert labels == {"kpm.apply", "kpm.setup", "kpm.refresh", "force"}
    for g, replay_s in rec.replay_s.items():
        assert replay_s > 0, g
        assert all(s > 0 for s in rec.marks[g].values()), g
        assert sum(rec.marks[g].values()) <= replay_s * (1 + 1e-6), g
    root = rec.events[0]
    children = sum(e.device_s for e in rec.events if e.parent == 0)
    assert 0 < children <= root.device_s * (1 + 1e-6)
    assert all(e.device_s is not None and e.device_s >= 0 for e in rec.events)
