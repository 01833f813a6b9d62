"""Carry model parameters across from the JAX package.

Both packages build the checkerboard spec from the same lattice inputs, so
only the parameter arrays travel, as numpy arrays (the port never imports
JAX): ``{name: np.asarray(getattr(jax_params, name))}`` for the fields of a
JAX ``HolsteinParams`` or ``SSHParams`` (told apart by SSH's ``alpha``).
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from elphdynamics_tpu_torch.models.holstein import HolsteinParams
from elphdynamics_tpu_torch.models.ssh import SSHParams
from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import complex_of


def params_from_jax(np_params: dict, device="cuda",
                    dtype: torch.dtype = torch.float64) -> HolsteinParams | SSHParams:
    """The port's :class:`HolsteinParams`, or :class:`SSHParams` where the
    dict has an ``alpha``, on ``device`` from a dict of numpy arrays named
    like the JAX parameter fields. Holstein's ``t``, ``expK`` and
    ``expK_inv`` may be absent or None, as may SSH's ``t_phase``. Complex
    arrays (complex hopping: Holstein's ``t``, ``cosht``, ``sinht``,
    ``expK``, ``expK_inv``; SSH's ``t_phase``) become the complex type of
    ``dtype``."""
    device = require_device(device)
    cls = SSHParams if "alpha" in np_params else HolsteinParams
    out = {}
    for f in fields(cls):
        a = np_params.get(f.name)
        if a is None:
            if f.default is not None:
                raise KeyError(f"missing {cls.__name__} field {f.name!r}")
            out[f.name] = None
            continue
        a = np.asarray(a)
        if np.iscomplexobj(a):
            out[f.name] = torch.as_tensor(a.astype(np.complex128), device=device).to(
                complex_of(dtype))
        else:
            out[f.name] = torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
    return cls(**out)


def params_to_numpy(params: HolsteinParams | SSHParams) -> dict:
    """The inverse of :func:`params_from_jax`: a dict of numpy arrays."""
    return {f.name: (None if getattr(params, f.name) is None
                     else getattr(params, f.name).detach().cpu().numpy())
            for f in fields(params)}
