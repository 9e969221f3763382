"""Mesh policy: when does the prover shard over ranks?
(``circuits_halo2_tpu/parallel/auto.py`` on ``torch.distributed``.)

Every rank of a ``torch.distributed`` world runs the same program on
replicated inputs (SPMD). Only the MSM, NTT and tree seams split their work
by rank, when a mesh is active, and gather their results, so every rank
ends with the same values and the same proof bytes.

Policy (env ``CIRCUITS_TPU_SHARD``), over the initialised default group:

- ``1``    -- always shard over it;
- ``0``    -- never shard;
- ``auto`` -- shard only when it spans more than one rank over NCCL, that
              is real GPUs (the default). A gloo world shards only when
              asked to (``1`` or ``set_mesh``), as the JAX package's virtual
              CPU devices are opt-in.

``set_mesh`` overrides the policy (``None``: no sharding, whatever the
env says); ``clear_mesh`` hands the decision back to it; ``suspended()``
turns sharding off for a block and restores what was set.
"""

from __future__ import annotations

import contextlib
import os

import torch.distributed as dist

from .sharding import make_mesh

_POLICY = object()  # no override: the env policy decides
_override = _POLICY
_auto_mesh = None


def set_mesh(mesh) -> None:
    """Shard over ``mesh`` (a ``sharding.Mesh``; None: never), whatever
    ``CIRCUITS_TPU_SHARD`` says."""
    global _override
    _override = mesh


def clear_mesh() -> None:
    """Drop the override: ``CIRCUITS_TPU_SHARD`` decides again."""
    global _override
    _override = _POLICY


@contextlib.contextmanager
def suspended():
    """No sharding inside the block; the override (or its absence) comes
    back after it."""
    global _override
    saved = _override
    _override = None
    try:
        yield
    finally:
        _override = saved


def shards(mode: str, size: int, backend: str) -> bool:
    """Whether the policy ``mode`` shards over a default group of ``size``
    ranks on ``backend``."""
    if mode == "1":
        return True
    if mode == "auto":
        return size > 1 and backend == "nccl"
    if mode == "0":
        return False
    raise ValueError(f"CIRCUITS_TPU_SHARD must be 0, 1 or auto, not {mode!r}")


def get_mesh():
    """The active mesh, or None for single-device execution."""
    global _auto_mesh
    if _override is not _POLICY:
        return _override
    mode = os.environ.get("CIRCUITS_TPU_SHARD", "auto")
    if mode == "0" or not (dist.is_available() and dist.is_initialized()):
        return None
    if not shards(mode, dist.get_world_size(), dist.get_backend()):
        return None
    if _auto_mesh is None or _auto_mesh.group is not dist.group.WORLD:
        _auto_mesh = make_mesh()
    return _auto_mesh


def ndev() -> int:
    mesh = get_mesh()
    return mesh.size if mesh is not None else 1
