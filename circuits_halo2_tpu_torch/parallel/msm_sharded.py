"""Multi-scalar multiplication over the rank mesh
(``circuits_halo2_tpu/parallel/msm_sharded.py`` on ``torch.distributed``).

The lanes (points and their scalars) split into one contiguous block per
rank. Each rank runs the single-device bucket stage
(``ops/msm._pippenger_windows``, K3 on the card) on its block of the cached
bases -- views, no new upload -- and the ``(16, B, NWIN, 2·SPLIT)``
Jacobian window partials are all-gathered and summed over ranks with
``jac_add``. The host window combine (``ops/msm._combine_windows_host``)
then runs once, as on one device. The JAX package Horner-folds each
shard's windows on the device before its gather; the port stops at the
window partials because its single-device path does, and the point is the
same.
"""

from __future__ import annotations

import torch

from ..ops import field_torch as FT
from ..ops import msm as M
from .sharding import Mesh


def _sum_over_ranks(mesh: Mesh, part):
    """All-gather a Jacobian triple and sum it over the ranks."""
    g = mesh.all_gather(torch.stack(part))  # (size, 3, 16, ...)
    width = 1 << (mesh.size - 1).bit_length()
    if width > mesh.size:  # pad to a power of two with points at infinity
        g = torch.cat([g, torch.zeros((width - mesh.size,) + g.shape[1:], dtype=g.dtype,
                                      device=g.device)])
    return tuple(c[..., 0] for c in M._tree_sum_last(tuple(g.movedim(0, -1))))


def msm_sharded_device(mesh: Mesh, xs, ys, valid, digits):
    """xs, ys (16, n); valid (n,); digits (B, NWIN, n), n divisible by the
    mesh size. Returns the (16, B, NWIN, 2·SPLIT) window partials of the
    whole MSM (the same on every rank)."""
    mesh.count("msm")
    lo, hi = mesh.block(xs.shape[1])
    part = M._pippenger_windows(xs[:, lo:hi], ys[:, lo:hi], valid[lo:hi], digits[..., lo:hi])
    return _sum_over_ranks(mesh, part)


def commit_sharded_device(mesh: Mesh, xs, ys, valid, scal_mont):
    """xs, ys (16, n); valid (n,); scal_mont (16, B, m <= n) Montgomery
    scalar columns, lanes past m zero; n divisible by the mesh size. Each
    rank extracts the digits of its own lanes only. Returns the window
    partials, as ``msm_sharded_device``."""
    mesh.count("msm")
    lo, hi = mesh.block(xs.shape[1])
    m = scal_mont.shape[2]
    digits = torch.zeros((scal_mont.shape[1], M.NWIN, hi - lo), dtype=torch.int64,
                         device=scal_mont.device)
    if lo < m:
        digits[..., : min(hi, m) - lo] = M.digits_from_mont(scal_mont[..., lo:hi])
    part = M._pippenger_windows(xs[:, lo:hi], ys[:, lo:hi], valid[lo:hi], digits)
    return _sum_over_ranks(mesh, part)


def msm_sharded(mesh: Mesh, points, scalar_rows) -> list:
    """B MSMs of host-int scalar rows over one host affine base list,
    across the mesh. The lanes are padded to max(n, 256·size), divisible by
    the size, so every rank keeps the chunked scan's 256-lane minimum.
    Returns B host affine points (None for infinity)."""
    xs, ys, valid = M.precompute_bases(points, mesh.device)
    n = int(xs.shape[1])
    target = max(n, 256 * mesh.size)
    target += -target % mesh.size
    if target > n:
        zeros = torch.zeros((FT.NLIMBS, target - n), dtype=xs.dtype, device=xs.device)
        xs, ys = torch.cat([xs, zeros], dim=1), torch.cat([ys, zeros], dim=1)
        valid = torch.cat([valid, torch.zeros(target - n, dtype=torch.bool, device=xs.device)])
    m = max(len(r) for r in scalar_rows)
    flat = [v for r in scalar_rows for v in list(r) + [0] * (m - len(r))]
    scal = torch.as_tensor(FT.to_mont_limbs(flat).reshape(FT.NLIMBS, len(scalar_rows), m),
                           device=mesh.device)
    return M._combine_windows_host(commit_sharded_device(mesh, xs, ys, valid, scal))
