"""Share (%) of the window's chain-updates that were accepted, from the
complex update's ``stats.accepted`` (``parts/complex_update.py``)."""

import torch


def read(record):
    acc = torch.stack([s["complex_update"]["accepted"] for s in record.steps]).double()
    return 100.0 * float(acc.mean())
