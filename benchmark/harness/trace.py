"""Device time from a ``torch.profiler`` trace of a few steps.

``busy_s`` is the union of the device activities' intervals (kernels,
copies, sets) inside the traced window, ``window_s`` the window's length by
the host clock (it ends in a synchronise). ``breakdown`` names the ten
device operations with the most time and the ten longest idle gaps, each
labelled by the innermost host operation running at its middle. ``ops``
keeps every device operation's seconds and count inside the window (the
kernel readers take a kernel's time from it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


WINDOW = "benchmark.traced_window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)    # [[name, seconds], ...]
    idle_gaps: list = field(default_factory=list)
    ops: dict = field(default_factory=dict)           # {name: [seconds, count]}


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host intervals) of a
    finished profile."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if not str(e.device_type()).endswith("CUDA"):
            host.append((start, start + dur, e.name()))
        elif not e.is_user_annotation():      # ranges, not device work
            dev.append((start, start + dur, e.name()))
    return dev, host


def _union(intervals, lo: int, hi: int) -> tuple[int, list]:
    """Total covered ns inside [lo, hi] and the gaps between covered runs."""
    covered, gaps, end = 0, [], lo
    for s, e, _ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        if e > end:
            covered += e - max(s, end)
            end = e
    if hi > end:
        gaps.append((end, hi))
    return covered, gaps


def traced(run_steps, device: torch.device) -> Trace | None:
    """Run ``run_steps()`` under the profiler; None where it recorded no
    device activity (the caller then reports no device metric)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_steps()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    dev, host = _events(prof)
    marks = [h for h in host if h[2] == WINDOW]
    if not dev or not marks:
        return None
    lo, hi = marks[0][0], marks[0][1]
    busy, gaps = _union(dev, lo, hi)
    by_name: dict = {}
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            ns, n = by_name.get(name, (0, 0))
            by_name[name] = (ns + (e - s), n + 1)
    ops = sorted(((n, v[0]) for n, v in by_name.items()), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    inner_ops = [h for h in host if h[2] != WINDOW]
    labelled = []
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        inner = [h for h in inner_ops if h[0] <= mid <= h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "(no host op)"
        labelled.append([label[:120], (ge - gs) / 1e9])
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                 device_ops=[[n[:120], ns / 1e9] for n, ns in ops], idle_gaps=labelled,
                 ops={n: [v[0] / 1e9, v[1]] for n, v in by_name.items()})
