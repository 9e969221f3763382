"""Number-theoretic transform over Fr -- host reference and batched torch path.

Counterpart of ``circuits_halo2_tpu/ops/ntt.py``: ``ntt(a, omega)`` computes
out[i] = sum_j a[j]·omega^(i·j) along the last axis of a ``(16, *batch, n)``
Montgomery limb tensor; ``intt`` is ``ntt(a, omega^-1)`` scaled by n^-1.
The device form is iterative radix-2 DIT: one bit-reversal gather, then
log2(n) butterfly stages, each a reshape plus one batched mont_mul against
that stage's twiddle table. The JAX NTT is XLA (not Pallas), so this stays
plain torch here; a hand kernel is later work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import field_torch as FT


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
    """Bit-reversal permutation and per-stage Montgomery twiddles (16, half)."""
    rev = torch.as_tensor(bit_reverse_indices(n), device=device)
    tws = []
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        ws = [1] * half
        for j in range(1, half):
            ws[j] = ws[j - 1] * step % F.FR_MOD
        tws.append(torch.as_tensor(FT.to_mont_limbs(ws), device=device))
    return rev, tws


def ntt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """NTT along the last axis of a (16, *batch, n) Montgomery limb tensor."""
    n = int(a.shape[-1])
    rev, tws = _tables(n, omega, str(a.device))
    x = a.index_select(-1, rev)
    lead = x.shape[:-1]
    for s, tw in enumerate(tws):
        half = 1 << s
        xg = x.reshape(lead + (n // (2 * half), 2, half))
        u = xg[..., 0, :]
        v = FT.mont_mul(xg[..., 1, :], tw.reshape((FT.NLIMBS,) + (1,) * (u.dim() - 2) + (half,)))
        x = torch.stack([FT.add_mod(u, v), FT.sub_mod(u, v)], dim=-2).reshape(lead + (n,))
    return x


def intt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """Inverse NTT (includes the n^-1 scale)."""
    n = int(a.shape[-1])
    res = ntt(a, F.fr_inv(omega))
    return FT.mont_mul(res, FT.const_tensor(FT.FR.const(F.fr_inv(n)), a.device, res.dim()))
