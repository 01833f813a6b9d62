"""The inputs of a run, made from a seed on the device.

Every stream has its own generator, seeded from ``(seed, stream, step,
…)`` through numpy's ``SeedSequence``, so a step's draws do not depend on
how many steps ran before it and the reference can make them again. What a
step draws is its part's (``parts/<part>.py``: ``draws``); here are:

* the initial phonon field: flat worldlines of the quantum-oscillator
  width σ = 1/√(2ω·tanh(βω/2)), Holstein sites offset by (λ/ω²)·u with u
  uniform on {−1, 0, 1} (sites prepared near density 0, 1 or 2), SSH bonds
  by −2α/ω²;
* the generators of the parts' draws, per stream (set-up or window) and
  step;
* which of the window's steps the check follows, per part.
"""

from __future__ import annotations

import numpy as np
import torch

INIT, WARMUP, WINDOW, CHECK = 0, 1, 2, 3


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for ``(seed, *path)``; any whole ``seed``, however large."""
    entropy = [int(seed) & (2 ** 64 - 1), int(seed) >> 64, *map(int, path)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


class Traffic:
    """The draws of one cell for one seed (``model``: the reference's
    description of the configuration, which gives the shapes and the
    couplings of the initial field; ``dtype``: the served dtype)."""

    def __init__(self, seed: int, model, chains: int, device, dtype):
        self.seed, self.model, self.C = int(seed), model, chains
        self.device, self.dtype = torch.device(device), dtype
        self._check_rng = {}

    def generator(self, *path: int) -> torch.Generator:
        """The device generator of ``(seed, *path)``."""
        return torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, *path))

    def initial_field(self) -> torch.Tensor:
        m, C = self.model, self.C
        g = self.generator(INIT)
        normals = torch.randn((C, m.Nph), generator=g, dtype=torch.float64, device=self.device)
        ints = torch.randint(-1, 2, (C, m.Nph), generator=g, device=self.device)
        om = torch.as_tensor(m.omega_ph, dtype=torch.float64, device=self.device)
        beta = m.Lt * m.dtau
        sigma = 1.0 / torch.sqrt(2.0 * om * torch.tanh(beta * om / 2.0))
        if m.holstein:
            offset = (m.lam / om ** 2) * ints
        else:
            alpha = torch.as_tensor(m.alpha_ph, dtype=torch.float64, device=self.device)
            offset = -2.0 * alpha / om ** 2
        x = sigma * normals + offset
        return x[:, :, None].expand(-1, -1, m.Lt).to(self.dtype).contiguous()

    def keeps(self, part: int, step: int) -> bool:
        """Whether the check takes over ``step`` as the window's checked
        step of the mix's part ``part``: a one-slot reservoir drawn from the
        seed (step k replaces the kept one with probability 1/(k+1)), so
        the step checked is uniform over all the window's steps, whatever
        their number."""
        if step == 0:
            self._check_rng[part] = np.random.default_rng(np.random.SeedSequence(
                [self.seed & (2 ** 64 - 1), self.seed >> 64, CHECK, part]))
        return bool(self._check_rng[part].random() * (step + 1) < 1.0)
