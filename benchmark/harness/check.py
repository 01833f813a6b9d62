"""Whether what the timed path produced is correct.

Each part of the mix (``parts/<part>.py``) keeps one step of the window,
drawn from the seed uniformly over all its steps
(:meth:`..traffic.Traffic.keeps`), as the port produced it; once the port's
objects are freed, the part's ``compare`` runs the plain reference
(``benchmark/reference``) over that step, with its draws made again from the
seed, and gives the numbers compared. Each number has a limit
(``benchmark/limits/<cell>.json``); a number that is not finite, or that no
part gave, fails.
"""

from __future__ import annotations

import math

from harness.traffic import WINDOW


def compare(parts: dict, snaps: dict, traffic, run_cfg: dict, device) -> tuple[dict, dict]:
    """(numbers, notes): the numbers compared of every part with a kept
    step, and each part's other readings (its step, the reference's time)."""
    numbers, notes = {}, {}
    for name, part in parts.items():
        snap = snaps.get(name)
        if snap is None:
            continue
        out = part.compare(run_cfg, snap, part.draws(traffic, WINDOW, snap["step"]), device)
        numbers.update({k: out[k] for k in part.NUMBERS})
        notes[name] = {k: v for k, v in out.items() if k not in part.NUMBERS}
    return numbers, notes


def judge(numbers: dict, names, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) for the numbers ``names`` against
    their limits; without limits nothing is correct."""
    checks, ok = {}, limits is not None
    for name in names:
        value = numbers.get(name, math.inf)
        limit = None if limits is None else limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
