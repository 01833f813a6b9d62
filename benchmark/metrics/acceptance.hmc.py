"""Share (%) of the window's chain-updates that were accepted, from the
update's ``stats.accepted``."""

import torch


def read(record):
    acc = torch.stack([s["update"]["accepted"] for s in record.steps]).double()
    return 100.0 * float(acc.mean())
