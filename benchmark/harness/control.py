"""The lower-precision control, and the faults the check has to catch.

``Control`` puts the plain reference in the port's place: each part runs
its ``control`` (``parts/<part>.py``), the reference computed in the
precision below the configuration's (bfloat16 for float32: the update's hot
path has no matrix product, so TF32 would change nothing). The check must
find it not correct.

``Faulty`` wraps the port with one planted fault in every part's step:

* ``unchanged``: the step returns the state it was given (with the stats
  of the real step);
* ``half``: the step runs on the first half of the chains; the rest keep
  their state and take the first half's stats;
* ``altered``: one element of the last chain's new field is moved by 1.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from harness import spec
from harness.program import Program


class Control:
    def __init__(self, entry: str, run_cfg: dict, chains: int, dtype: str, device, seed: int,
                 here=spec.HERE):
        self.run_cfg, self.device = run_cfg, torch.device(device)
        self.dtype = torch.float32
        self._cache = {}

    def cached(self, key: str, make):
        """The part's reference objects, made once."""
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def state(self, x):
        return SimpleNamespace(x=x, v=torch.zeros_like(x))

    def step(self, part, state, d):
        return part.control(self, state, d)

    def retries(self) -> int:
        return 0

    def close(self) -> None:
        self._cache = {}


def _fields(obj) -> dict:
    return dict(vars(obj))


class Faulty(Program):
    """The port with the fault ``kind`` planted in each step."""

    def __init__(self, kind: str, *args, **kw):
        super().__init__(*args, **kw)
        self.kind = kind

    def step(self, part, state, d):
        kept = {k: v.clone() if torch.is_tensor(v) else v for k, v in _fields(state).items()}
        new, stats = super().step(part, state, d)
        if self.kind == "unchanged":
            return type(new)(**kept), stats
        if self.kind == "half":
            C = kept["x"].shape[0]
            h = max(1, C // 2)
            fields = {k: torch.cat([v[:h], kept[k][h:]]) if torch.is_tensor(v) else v
                      for k, v in _fields(new).items()}
            idx = torch.arange(C, device=kept["x"].device) % h
            stats = SimpleNamespace(**{n: v.index_select(0, idx)
                                       for n, v in _fields(stats).items()
                                       if torch.is_tensor(v) and v.dim() and v.shape[0] == C})
            return type(new)(**fields), stats
        if self.kind == "altered":
            fields = _fields(new)
            fields["x"] = fields["x"].clone()
            fields["x"][-1, 0, 0] += 1.0
            return type(new)(**fields), stats
        raise ValueError(f"unknown fault {self.kind!r}")


def faulty(kind: str):
    """A ``make_program`` for :func:`harness.main.run_cell` with ``kind`` planted."""
    return lambda *args, **kw: Faulty(kind, *args, **kw)
