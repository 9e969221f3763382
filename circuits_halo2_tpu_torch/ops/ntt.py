"""Number-theoretic transform over Fr -- host reference and batched torch path.

Counterpart of ``circuits_halo2_tpu/ops/ntt.py``: ``ntt(a, omega)`` computes
out[i] = sum_j a[j]·omega^(i·j) along the last axis of a ``(16, *batch, n)``
Montgomery limb tensor; ``intt`` is ``ntt(a, omega^-1)`` scaled by n^-1.
The device form is iterative radix-2 DIT: one bit-reversal gather, then
log2(n) butterfly stages. On a CUDA tensor the stages are X1
(``csrc/field_ops.cu``, ``dit_stages``): one launch a stage, one thread a
butterfly, in place on the gathered copy against a table of every stage's
twiddles. On a CPU tensor ``ntt_ref`` runs them as plain torch, each stage a
reshape plus one batched mont_mul against that stage's twiddle table and
the add and subtract; the limbs are the same.

With a mesh active (``parallel/auto``) a transform of n >= 2^12 points
(and n >= size^2) runs as the four-step ``parallel/ntt_sharded``, the JAX
package's routing; the result is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import build
from . import field as F
from . import field_torch as FT
from ..parallel import auto


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt_host(a: list[int], omega: int) -> list[int]:
    """Iterative radix-2 DIT NTT on Python ints (reference path)."""
    n = len(a)
    p = F.FR_MOD
    rev = bit_reverse_indices(n)
    out = [a[rev[i]] for i in range(n)]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        for start in range(0, n, 2 * half):
            w = 1
            for j in range(half):
                u = out[start + j]
                v = out[start + half + j] * w % p
                out[start + j] = (u + v) % p
                out[start + half + j] = (u - v) % p
                w = w * step % p
    return out


def intt_host(a: list[int], omega: int) -> list[int]:
    n_inv = F.fr_inv(len(a))
    return [x * n_inv % F.FR_MOD for x in ntt_host(a, F.fr_inv(omega))]


def omega_for_k(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (halo2 domain omega)."""
    return F.fr_pow(F.FR_ROOT_OF_UNITY, 1 << (F.FR_TWO_ADICITY - k))


@functools.lru_cache(maxsize=64)
def _tables(n: int, omega: int, device: str):
    """Bit-reversal permutation, and every stage's Montgomery twiddles in one
    (16, n - 1) table, stage s (half = 2^s) at columns half - 1 .. 2 half - 2
    (what X1 reads), with the per-stage (16, half) views of it."""
    rev = torch.as_tensor(bit_reverse_indices(n), device=device)
    ws = []
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        stage = [1] * half
        for j in range(1, half):
            stage[j] = stage[j - 1] * step % F.FR_MOD
        ws += stage
    flat = torch.as_tensor(FT.to_mont_limbs(ws), device=device)
    tws = [flat[:, (1 << s) - 1 : (2 << s) - 1] for s in range(n.bit_length() - 1)]
    return rev, flat, tws


# The JAX package's threshold, so that the same transforms shard: below it
# the all-to-all and the gathers are judged to cost more than one device
# doing the whole transform (not measured on the port).
SHARD_THRESHOLD = 1 << 12


def _shard_mesh(n: int):
    """The mesh to shard an n-point transform over, or None: none is
    active, n is below ``SHARD_THRESHOLD``, or the four-step blocks do not
    split over its ranks (which needs n >= size^2)."""
    mesh = auto.get_mesh()
    if mesh is None or n < SHARD_THRESHOLD:
        return None
    from ..parallel import ntt_sharded

    return mesh if ntt_sharded.split(n, mesh.size) is not None else None


def ntt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """NTT along the last axis of a (16, *batch, n) Montgomery limb tensor;
    over the active mesh when ``_shard_mesh`` gives one."""
    mesh = _shard_mesh(int(a.shape[-1]))
    if mesh is not None:
        from ..parallel import ntt_sharded

        return ntt_sharded.ntt_sharded_batched(mesh, a, omega)
    return _ntt_device(a, omega)


def _ntt_device(a: torch.Tensor, omega: int) -> torch.Tensor:
    """The single-device transform (the body of ``ntt``): X1 on a CUDA
    tensor, ``ntt_ref`` on a CPU tensor."""
    if not FT.on_card(a):
        return ntt_ref(a, omega)
    n = int(a.shape[-1])
    if a.dtype != FT.DTYPE or a.dim() < 2 or a.shape[0] != FT.NLIMBS or n & (n - 1) or n < 1:
        raise ValueError("ntt: a must be (16, ..., n) int64 limbs, n a power of two")
    build.cuda_library()
    rev, flat, _ = _tables(n, omega, str(a.device))
    x = a.index_select(-1, rev)
    if n > 1 and x.numel():
        dit_stages(x, flat)
    return x


@FT.plain_version
def ntt_ref(a: torch.Tensor, omega: int) -> torch.Tensor:
    """The plain torch single-device transform, on any device."""
    n = int(a.shape[-1])
    rev, _, tws = _tables(n, omega, str(a.device))
    x = a.index_select(-1, rev)
    lead = x.shape[:-1]
    for s, tw in enumerate(tws):
        half = 1 << s
        xg = x.reshape(lead + (n // (2 * half), 2, half))
        u = xg[..., 0, :]
        v = FT.mont_mul(xg[..., 1, :], tw.reshape((FT.NLIMBS,) + (1,) * (u.dim() - 2) + (half,)))
        x = torch.stack([FT.add_mod(u, v), FT.sub_mod(u, v)], dim=-2).reshape(lead + (n,))
    return x


def dit_stages(x: torch.Tensor, tw: torch.Tensor) -> None:
    """X1: every radix-2 DIT stage of the bit-reversed rows of the contiguous
    (16, *lead, n) ``x``, in place on the card, one launch a stage;
    ``tw`` is ``_tables``' (16, n - 1) table."""
    n = int(x.shape[-1])
    logn = n.bit_length() - 1
    if not x.is_contiguous() or tw.shape != (FT.NLIMBS, n - 1) or not tw.is_contiguous():
        raise ValueError("dit_stages: x and tw must be contiguous, tw (16, n - 1)")
    lib = build.cuda_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dit_stages.launches += logn
    build.check(lib.ntt_stages_cuda(x.data_ptr(), tw.data_ptr(), x[0].numel() // n, logn, stream),
                "ntt_stages_cuda")


dit_stages.launches = 0


def intt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """Inverse NTT (includes the n^-1 scale)."""
    n = int(a.shape[-1])
    res = ntt(a, F.fr_inv(omega))
    return FT.mont_mul(res, FT.const_tensor(FT.FR.const(F.fr_inv(n)), a.device, res.dim()))
