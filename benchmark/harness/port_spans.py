"""The port's spans of the traced update (``elphdynamics_tpu_torch/utils/
spans.py``), for the span metrics' readers.

The profiler that traces the mix's ``trace_steps`` turns the port's spans
on, so the record of the port's root span ``hmc.update`` after the trace
is that of the traced update (the mix's ``trace_steps`` is 1). A port
without spans, a run without a trace and a record without device seconds
(the CPU) give nothing to read.
"""

from __future__ import annotations

ROOT = "hmc.update"


def update_record(record):
    """The port's span record of the traced update, or None."""
    if record.trace is None:
        return None
    try:
        from elphdynamics_tpu_torch.utils import spans
    except ImportError:
        return None
    rec = spans.last(ROOT)
    if rec is None or rec.device != "cuda":
        return None
    return rec


def host_s(record, name: str) -> float | None:
    """Host seconds of the spans ``name`` in the traced update (0 where
    none ran)."""
    rec = update_record(record)
    if rec is None:
        return None
    stat = rec.spans.get(name)
    return 0.0 if stat is None else stat.host_s


def device_s(record, name: str) -> float | None:
    """Device seconds of the spans ``name`` in the traced update (0 where
    none ran)."""
    rec = update_record(record)
    if rec is None:
        return None
    stat = rec.spans.get(name)
    return 0.0 if stat is None or stat.device_s is None else stat.device_s


def _replays_under(rec, name: str) -> dict:
    """Per graph, the device seconds of its ``graph.replay`` spans that lie
    inside a span ``name``."""
    inside = []
    out: dict = {}
    for e in rec.events:
        inside.append(e.name == name or (e.parent >= 0 and inside[e.parent]))
        if e.name == "graph.replay" and inside[-1] and e.device_s is not None:
            out[e.key] = out.get(e.key, 0.0) + e.device_s
    return out


def marked_s(record, labels, under: str | None = None) -> float | None:
    """Device seconds of the marks ``labels`` in the traced update: for each
    graph replayed in it (with ``under``, each graph replayed inside a span
    of that name), the marks' share of its last replay (begin mark to end
    mark) times the device seconds of its ``graph.replay`` spans (there).
    None where no graph held marks (a port or card without them)."""
    rec = update_record(record)
    if rec is None or not rec.replay_s:
        return None
    if under is None:
        replayed = {key: s.device_s for (name, key), s in rec.keys.items()
                    if name == "graph.replay" and s.device_s is not None}
    else:
        replayed = _replays_under(rec, under)
    total = 0.0
    for graph, secs in replayed.items():
        replay_s = rec.replay_s.get(graph, 0.0)
        if replay_s > 0:
            total += sum(rec.marks[graph].get(label, 0.0) for label in labels) / replay_s * secs
    return total
