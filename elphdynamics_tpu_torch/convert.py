"""Carry model parameters across from the JAX package.

Both packages build the checkerboard spec from the same lattice inputs, so
only the parameter arrays travel, as numpy arrays (the port never imports
JAX): ``{name: np.asarray(getattr(jax_params, name))}`` for the fields of a
JAX ``HolsteinParams``.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from elphdynamics_tpu_torch.models.holstein import HolsteinParams
from elphdynamics_tpu_torch.utils.device import require_device


def params_from_jax(np_params: dict, device="cuda",
                    dtype: torch.dtype = torch.float64) -> HolsteinParams:
    """The port's :class:`HolsteinParams` on ``device`` from a dict of numpy
    arrays named like the JAX ``HolsteinParams`` fields. ``t``, ``expK`` and
    ``expK_inv`` may be absent or None; complex arrays (complex hopping) are
    refused."""
    device = require_device(device)
    out = {}
    for f in fields(HolsteinParams):
        a = np_params.get(f.name)
        if a is None:
            if f.default is not None:
                raise KeyError(f"missing Holstein parameter {f.name!r}")
            out[f.name] = None
            continue
        a = np.asarray(a)
        if np.iscomplexobj(a):
            raise NotImplementedError(f"complex {f.name!r}: complex hopping is ROADMAP slice F")
        out[f.name] = torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
    return HolsteinParams(**out)


def params_to_numpy(params: HolsteinParams) -> dict:
    """The inverse of :func:`params_from_jax`: a dict of numpy arrays."""
    return {f.name: (None if getattr(params, f.name) is None
                     else getattr(params, f.name).detach().cpu().numpy())
            for f in fields(HolsteinParams)}
