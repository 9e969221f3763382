"""The modules a run must not hold: JAX, and the JAX package this port was
made from. Compared by whole top-level names, the part before the first
dot, since the port's own name, ``circuits_halo2_tpu_torch``, begins with
the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "circuits_halo2_tpu"})


def forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
