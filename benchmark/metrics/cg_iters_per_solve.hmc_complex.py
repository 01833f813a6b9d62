"""Mean CG iterations per solve over the window's chain-updates, from the
complex update's ``stats.iters`` (each chain's mean over its Nt + 2
Hermitian CG solves)."""

import torch


def read(record):
    return float(torch.stack([s["complex_update"]["iters"] for s in record.steps])
                 .double().mean())
