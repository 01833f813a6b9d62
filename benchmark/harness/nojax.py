"""The run loads neither JAX nor the JAX package.

Module names are compared by their top-level part (before the first dot),
whole: ``elphdynamics_tpu_torch`` is the port and passes, though its name
begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "elphdynamics_tpu"})


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
