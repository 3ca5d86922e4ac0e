"""The modules a run of the port may not hold: JAX and the JAX package.
Compared by whole top-level name, so ``sessionrec_tpu_torch`` (the port)
is not ``sessionrec_tpu`` (the JAX package)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sessionrec_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (module names; by
    default every module loaded in this process)."""
    names = list(sys.modules) if names is None else names
    tops = {n.split(".")[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))
