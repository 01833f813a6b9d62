"""Checkpoint / resume.

Counterpart of ``elphdynamics_tpu/io/checkpoint.py``: a checkpoint is an
``.npz`` of the fields, the random-generator state, the parameters and the
bin accumulators, plus a JSON sidecar of the loop counters, the run
statistics, the μ-tuner history and ``extras`` (the burn-in dt tuner's
state while it runs); a run resumes when its datafolder holds both. The
port stores its ``torch.Generator`` state as a uint8 array under
``generator``; a JAX checkpoint stores a PRNG key under ``key``. Neither
package reads the other's checkpoints.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_checkpoint(datafolder: str, *, x, v, generator_state: torch.Tensor, params,
                    container: dict, counters: dict, sim_stats: dict,
                    mu_tuner_state: dict, extras: dict | None = None) -> None:
    arrays = {"x": _host(x), "v": _host(v), "generator": _host(generator_state)}
    arrays.update({f"params/{f.name}": _host(getattr(params, f.name)) for f in fields(params)
                   if getattr(params, f.name) is not None})
    arrays.update({f"container/{group}/{k}": _host(a)
                   for group, vals in container.items() for k, a in vals.items()})
    tmp = os.path.join(datafolder, "checkpoint_tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(datafolder, "checkpoint.npz"))
    meta = {"counters": counters, "sim_stats": sim_stats, "mu_tuner": mu_tuner_state,
            "extras": extras or {}}
    tmp = os.path.join(datafolder, "checkpoint.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(datafolder, "checkpoint.json"))


def has_checkpoint(datafolder: str) -> bool:
    return (os.path.isfile(os.path.join(datafolder, "checkpoint.npz"))
            and os.path.isfile(os.path.join(datafolder, "checkpoint.json")))


def load_checkpoint(datafolder: str) -> dict:
    """The saved state as numpy arrays and plain values."""
    with np.load(os.path.join(datafolder, "checkpoint.npz")) as data:
        flat = {k: data[k] for k in data.files}
    if "generator" not in flat:
        raise ValueError(
            f"{datafolder}: the checkpoint holds no torch generator state (one written "
            "by the JAX package stores a PRNG key); the two packages' checkpoints are "
            "not interchangeable")
    with open(os.path.join(datafolder, "checkpoint.json")) as f:
        meta = json.load(f)
    container: dict = {}
    for k, a in flat.items():
        if k.startswith("container/"):
            _, group, name = k.split("/")
            container.setdefault(group, {})[name] = a
    return {"x": flat["x"], "v": flat["v"], "generator": flat["generator"],
            "params": {k[len("params/"):]: a for k, a in flat.items()
                       if k.startswith("params/")},
            "container": container, "counters": meta["counters"],
            "sim_stats": meta["sim_stats"], "mu_tuner": meta["mu_tuner"],
            "extras": meta.get("extras", {})}
