"""The readers of the port's spans and per-shape launch counts, on records
built by hand: each gives the number its docstring defines, and nothing
without a traced update, without device seconds (the CPU), with spans off
or from a port that has neither spans nor counts per shape."""

import copy
import sys
from types import SimpleNamespace

import pytest
import torch

from counts import ops
from harness import device as dev
from harness import spec
from harness.kernels import roofline
from reference.models import Model

from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.utils import spans

SPAN_METRICS = ("launch_s.hmc", "read_wait_s.hmc", "solve_s.hmc", "kpm_apply_s.hmc",
                "kpm_setup_s.hmc", "force_s.hmc")


def _stat(count, host_s, device_s):
    return spans.Stat(count=count, host_s=host_s, self_host_s=host_s, device_s=device_s,
                      self_device_s=device_s)


def _update_record(device="cuda"):
    """The record of an update that replayed its start segment, a CG block
    graph 10 times inside a solve, and its step segment."""
    timed = device is not None
    d = (lambda s: s) if timed else (lambda s: None)
    E = spans.Event
    events = [E("hmc.update", None, -1, 0, 30, d(2.9)),
              E("hmc.seg.start", None, 0, 1, 2, d(0.2)),
              E("graph.replay", "start", 1, 1, 2, d(0.15)),
              E("solve", None, 0, 3, 20, d(2.4))]
    events += [E("graph.replay", "cg_block", 3, 4 + i, 5 + i, d(0.2)) for i in range(10)]
    events += [E("hmc.seg.step", None, 0, 21, 22, d(0.06)),
               E("graph.replay", "step", len(events), 21, 22, d(0.05))]
    return spans.Record(
        name="hmc.update", index=4, device=device, events=events,
        spans={"hmc.update": _stat(1, 3.0, d(2.9)), "graph.replay": _stat(12, 0.5, d(2.2)),
               "host_read": _stat(11, 0.25, d(0.3)), "solve": _stat(1, 2.0, d(2.4)),
               "hmc.seg.start": _stat(1, 0.1, d(0.2))},
        keys={("graph.replay", "cg_block"): _stat(10, 0.4, d(2.0)),
              ("graph.replay", "start"): _stat(1, 0.05, d(0.15)),
              ("graph.replay", "step"): _stat(1, 0.05, d(0.05))},
        replay_s={"cg_block": 0.18, "start": 0.1, "step": 0.04} if timed else {},
        marks={"cg_block": {"kpm.apply": 0.09},
               "start": {"kpm.setup": 0.05, "kpm.refresh": 0.01, "kpm.apply": 0.02},
               "step": {"force": 0.01, "kpm.refresh": 0.01, "kpm.apply": 0.01}}
        if timed else {})


WANT = {"launch_s.hmc": 0.5, "read_wait_s.hmc": 0.25, "solve_s.hmc": 2.4,
        "kpm_apply_s.hmc": 0.09 / 0.18 * 2.0,     # the block graph's replays in the solve
        "kpm_setup_s.hmc": 0.06 / 0.1 * 0.15 + 0.01 / 0.04 * 0.05,
        "force_s.hmc": 0.01 / 0.04 * 0.05}


def _run(trace=True):
    return SimpleNamespace(trace=SimpleNamespace(ops={}) if trace else None,
                           device=torch.device("cuda"))


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers(metric, monkeypatch):
    read = spec.load_reader(metric).read
    monkeypatch.setattr(spans, "_last", {"hmc.update": _update_record()})
    assert read(_run()) == pytest.approx(WANT[metric], rel=1e-12)
    assert read(_run(trace=False)) is None
    # the CPU: no device seconds
    monkeypatch.setattr(spans, "_last", {"hmc.update": _update_record(None)})
    assert read(_run()) is None
    # spans off: no record
    monkeypatch.setattr(spans, "_last", {})
    assert read(_run()) is None
    # a port without spans
    monkeypatch.delattr(sys.modules["elphdynamics_tpu_torch.utils"], "spans")
    monkeypatch.setitem(sys.modules, "elphdynamics_tpu_torch.utils.spans", None)
    monkeypatch.setattr(spans, "_last", {"hmc.update": _update_record()})
    assert read(_run()) is None


def _model():
    cfg = spec.load_config("holstein_64", overrides={"lattice.L": 4, "holstein.beta": 0.6})
    return Model(copy.deepcopy(cfg.run), "cpu", torch.float64)


def test_k1_roofline_by_shape(monkeypatch):
    """Holstein's one form at two shapes: the bound summed per shape; where
    each form has one shape, ``k1_roofline.hmc``'s number; nothing from
    counts that do not add up, from a port that keeps shapes only, or
    without a trace."""
    read = spec.load_reader("k1_roofline_by_shape.hmc").read
    m = _model()
    nb = m.bonds.pairs.shape[1]
    f32 = torch.float32
    a, b = (32, m.N, 40), (32, 2, m.N, 40)
    counts = {("fold/shared", a, f32): 30, ("fold/shared", b, f32): 10,
              ("fused/shared", (16, 10, m.N, 40), f32): 50}
    launched = {"fold/shared": 40, "fold/chain": 0, "fused/shared": 50}
    seen = {"void ckb_fold_kernel<float, 4, false>(float const*)": [4e-3, 40],
            "void ckb_fold_fused_kernel<float, 4>(float const*)": [5e-3, 50]}
    rec = SimpleNamespace(model=m, trace=SimpleNamespace(ops=seen),
                          trace_counts={"table_launches": launched,
                                        "launch_shapes": set(counts)})
    monkeypatch.setattr(ckb_cuda, "launch_shapes", counts)
    bound = sum(n * dev.bound_s(ops.k1_bytes(s, "shared", nb, 4), ops.k1_flops(s, nb, m.N))
                for (f, s, _), n in counts.items() if f.startswith("fold/"))
    assert read(rec) == pytest.approx(100.0 * bound / 4e-3, rel=1e-12)
    assert roofline(rec, "fold") is None           # the old reader: two shapes, one form
    one = {k: n for k, n in counts.items() if k[1] != b}
    one[("fold/shared", a, f32)] = 40
    monkeypatch.setattr(ckb_cuda, "launch_shapes", one)
    rec.trace_counts["launch_shapes"] = set(one)
    assert read(rec) == pytest.approx(roofline(rec, "fold"), rel=1e-12)
    monkeypatch.setattr(ckb_cuda, "launch_shapes", {**one, ("fold/shared", a, f32): 39})
    assert read(rec) is None
    monkeypatch.setattr(ckb_cuda, "launch_shapes", set(one))
    assert read(rec) is None
    monkeypatch.setattr(ckb_cuda, "launch_shapes", one)
    rec.trace = None
    assert read(rec) is None
