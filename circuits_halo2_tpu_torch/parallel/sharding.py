"""The rank mesh and its collectives, and the sharded Merkle-sum tree
(``circuits_halo2_tpu/parallel/sharding.py`` on ``torch.distributed``).

A ``Mesh`` is a process group seen from one rank: its rank, size, backend
and the rank's device. Every rank holds the whole input (SPMD); a sharded
function computes the rank's contiguous block of the work and gathers the
blocks, so each rank returns the whole result:

- ``sharded_hash_batch``: each rank hashes its slice of the messages with
  K1 (``ops/poseidon_kernel.hash_batch``), then the slices are gathered;
- ``sharded_tree_step``: one level, each rank pairing its own nodes;
- ``sharded_tree_reduce``: each rank reduces its block of leaves to one
  node (``tree_reduce_levels``, K1 per level), the ``ndev`` nodes and sums
  are gathered, and every rank hashes the top log2(ndev) levels itself.

Hashes are ``(16, N)`` and balances ``(16, C, N)`` Montgomery limbs, as in
the JAX package; balances add as field elements.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..ops import field_torch as FT
from ..ops import poseidon_kernel as PK


def default_device(rank: int) -> torch.device:
    """The card of ``rank``: ``cuda:{rank % torch.cuda.device_count()}``."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device for the mesh: pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % count)


@dataclass
class CollectiveStats:
    """What this rank's collectives did: calls per kind, the bytes of their
    outputs on this rank, and their wall seconds (host staging included)."""

    calls: dict = field(default_factory=dict)
    nbytes: int = 0
    seconds: float = 0.0

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.nbytes += nbytes
        self.seconds += seconds


@dataclass(eq=False)
class Mesh:
    """One rank's view of a process group. ``sharded`` counts the calls of
    each sharded function (``msm``, ``ntt``, ``hash``, ``tree``)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    sharded: dict = field(default_factory=dict)

    def block(self, n: int) -> tuple[int, int]:
        """This rank's contiguous block [lo, hi) of n items (n % size == 0)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def count(self, what: str) -> None:
        self.sharded[what] = self.sharded.get(what, 0) + 1

    def _collective(self, kind: str, x: torch.Tensor, run) -> torch.Tensor:
        """``run(x)`` -> output on x's device, timed (a CUDA result is
        synchronised first) and counted.

        gloo's all_gather and all_to_all take host tensors only, and NCCL
        refuses two ranks on one card, so a gloo mesh over CUDA tensors (a
        multi-rank world on one card) copies through host memory, here and
        nowhere else."""
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and x.is_cuda
        out = run(x.cpu() if staged else x)
        if staged:
            out = out.to(x.device)
        elif x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.stats.add(kind, out.numel() * out.element_size(), time.perf_counter() - t0)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""

        def run(t):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            return torch.stack(parts)

        return self._collective("all_gather", x, run)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all: block d of ``split_dim`` goes to rank d, and the
        blocks received are concatenated along ``concat_dim`` in rank order.
        ``dist.all_to_all_single`` splits dimension 0 only, so the split
        axis moves to the front first."""

        def run(t):
            front = t.movedim(split_dim, 0).contiguous()
            out = torch.empty_like(front)
            dist.all_to_all_single(out, front, group=self.group)
            blocks = out.reshape((self.size, -1) + front.shape[1:])
            return torch.cat([b.movedim(0, split_dim) for b in blocks], dim=concat_dim)

        return self._collective("all_to_all", x, run)


def make_mesh(n_devices: int | None = None, group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the initialised default group) on
    ``device`` (default: this rank's card, ``default_device``).
    ``n_devices``, if given, must be the group's size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices not in (None, size):
        raise ValueError(f"the group has {size} ranks, not {n_devices}")
    device = torch.device(device) if device is not None else default_device(dist.get_rank())
    return Mesh(group, dist.get_rank(group), size, device, dist.get_backend(group))


def sharded_hash_batch(mesh: Mesh, inputs: torch.Tensor) -> torch.Tensor:
    """(L, 16, N) Montgomery messages, N divisible by the mesh size ->
    (16, N) digests; each rank hashes its slice through K1."""
    mesh.count("hash")
    lo, hi = mesh.block(inputs.shape[-1])
    part = PK.hash_batch(inputs[..., lo:hi].contiguous())
    return mesh.all_gather(part).movedim(0, 1).reshape(FT.NLIMBS, -1)


def _level(hashes: torch.Tensor, balances: torch.Tensor):
    """One Merkle-sum level: pair adjacent nodes, add their balances, hash
    (sums..., left, right)."""
    left_b, right_b = balances[..., 0::2], balances[..., 1::2]
    sums = FT.add_mod(left_b, right_b)
    pre = torch.cat([sums.movedim(1, 0), hashes[None, :, 0::2], hashes[None, :, 1::2]])
    return PK.hash_batch(pre.contiguous()), sums


def sharded_tree_step(mesh: Mesh, hashes: torch.Tensor, balances: torch.Tensor):
    """One level over the mesh: hashes (16, N), balances (16, C, N), N/size
    even -> ((16, N/2), (16, C, N/2)); each rank pairs its own nodes."""
    mesh.count("tree")
    lo, hi = mesh.block(hashes.shape[-1])
    if (hi - lo) % 2:
        raise ValueError("each rank's block must hold whole pairs")
    h, b = _level(hashes[:, lo:hi], balances[..., lo:hi])
    gh, gb = mesh.all_gather(h), mesh.all_gather(b)
    return (gh.movedim(0, 1).reshape(FT.NLIMBS, -1),
            gb.movedim(0, 2).reshape(FT.NLIMBS, balances.shape[1], -1))


def tree_reduce_levels(hashes: torch.Tensor, balances: torch.Tensor):
    """Log-depth Merkle-sum reduction on one device: hashes (16, N),
    balances (16, C, N), N a power of two -> ((16, 1), (16, C, 1))."""
    n = hashes.shape[-1]
    if n & (n - 1):
        raise ValueError(f"leaf count {n} is not a power of two")
    while hashes.shape[-1] > 1:
        hashes, balances = _level(hashes, balances)
    return hashes, balances


def sharded_tree_reduce(mesh: Mesh, leaf_hashes: torch.Tensor, leaf_balances: torch.Tensor):
    """The root of a Merkle-sum tree over the mesh: each rank reduces its
    block of leaves to one node, the nodes are gathered, and every rank
    reduces the top log2(size) levels. Returns ((16, 1), (16, C, 1))."""
    mesh.count("tree")
    lo, hi = mesh.block(leaf_hashes.shape[-1])
    h, b = tree_reduce_levels(leaf_hashes[:, lo:hi], leaf_balances[..., lo:hi])
    gh, gb = mesh.all_gather(h[:, 0]), mesh.all_gather(b[..., 0])
    return tree_reduce_levels(gh.T.contiguous(), gb.permute(1, 2, 0).contiguous())
