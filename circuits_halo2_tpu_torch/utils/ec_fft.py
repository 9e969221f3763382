"""Elliptic-curve FFT over G1: the Lagrange bases of a downsized SRS
(``utils/ec_fft.py`` of the JAX package).

halo2's ``ParamsKZG::downsize`` truncates the monomial SRS and derives the
Lagrange commitments by an FFT over group elements: each butterfly
multiplies a point by its twiddle and adds. Two paths:

- host (``ec_fft``): Python Jacobian math on ``ops/curve``;
- device (``ec_fft_device``): the butterflies of X4
  (``ops/ec_fft_kernel.ec_fft``) on the device the caller names -- the CUDA
  kernel on a GPU, its plain torch version (``ec_fft_ref``) on the CPU.

``g_to_lagrange`` takes the device path on a GPU from ``DEVICE_MIN`` points
up, as the reference routes by size, and the host path otherwise: on the
CPU the plain torch version's 254 x (log n + 1) serial steps cost far more
than the host loop.

Points come back as canonical affine tuples (None is infinity), normalised
with one batch inversion, so both paths give the same lists.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curve as C
from ..ops import ec_fft_kernel as EK
from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import ntt as NTT

# Below this size the host loop costs less than a device dispatch; above it
# the host loop's Python group operations dominate.
DEVICE_MIN = 1 << 8


def ec_fft(points: list, omega: int) -> list:
    """DFT over G1: out[i] = sum_j omega^(ij) P_j (host Jacobian math)."""
    n = len(points)
    if n < 1 or n & (n - 1):
        raise ValueError(f"ec_fft: {n} points is not a power of two")
    rev = NTT.bit_reverse_indices(n)
    jac = [None if points[r] is None else (points[r][0], points[r][1], 1) for r in rev]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        for start in range(0, n, 2 * half):
            w = 1
            for j in range(half):
                u = jac[start + j]
                v = _jac_scalar_mul(jac[start + half + j], w)
                jac[start + j] = C._jac_add(u, v)
                jac[start + half + j] = C._jac_add(u, _jac_neg(v))
                w = w * step % F.FR_MOD
    return [C._jac_to_affine(p) for p in jac]


def _jac_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % C.Q, p[2])


def _jac_scalar_mul(p, k: int):
    k %= F.FR_MOD
    if p is None or k == 0:
        return None
    result = None
    addend = p
    while k:
        if k & 1:
            result = C._jac_add(result, addend)
        addend = C._jac_double(addend)
        k >>= 1
    return result


def transform_inputs(points: list, transforms: list[tuple[int, int]], device):
    """Host affine points and B (omega, scale) pairs -> the arguments of
    ``ops/ec_fft_kernel.ec_fft`` on ``device``: the points bit-reversed as
    (16, B, n) Montgomery Jacobian coordinates (Z = 1, or 0 for None), the
    (16, B, n - 1) twiddles and the (16, B) scales (None when all are 1)."""
    n, nb = len(points), len(transforms)
    if n < 2 or n & (n - 1):
        raise ValueError(f"ec_fft: {n} points is not a power of two >= 2")
    pts = [points[r] for r in NTT.bit_reverse_indices(n)]
    valid = np.array([p is not None for p in pts])
    cols = [FT.to_mont_limbs([0 if p is None else p[i] for p in pts], FT.FQ) for i in (0, 1)]
    cols.append(np.where(valid[None, :], FT.FQ.one_mont.reshape(FT.NLIMBS, 1), 0))
    x, y, z = (torch.as_tensor(c, device=device).unsqueeze(1).expand(FT.NLIMBS, nb, n)
               .contiguous() for c in cols)
    tw = torch.as_tensor(np.stack([EK.twiddle_table(n, om % F.FR_MOD) for om, _ in transforms],
                                  axis=1), device=device)
    scales = [sc % F.FR_MOD for _, sc in transforms]
    scale = None
    if any(sc != 1 for sc in scales):
        scale = torch.as_tensor(FT.ints_to_limbs(scales), device=device)
    return x, y, z, tw, scale


def jacobian_to_affine(x, y, z) -> list[list]:
    """(16, B, n) Montgomery Jacobian tensors -> B lists of n canonical
    affine points (None = infinity), with one batch inversion."""
    q = F.FQ_MOD
    nb, n = x.shape[1], x.shape[2]
    xi, yi, zi = (FT.from_mont_ints(c.reshape(FT.NLIMBS, -1), FT.FQ) for c in (x, y, z))
    zinv = F.batch_inv(zi, q)
    out = []
    for xv, yv, zv in zip(xi, yi, zinv):
        if zv == 0:
            out.append(None)
            continue
        z2 = zv * zv % q
        out.append((xv * z2 % q, yv * z2 % q * zv % q))
    return [out[b * n : (b + 1) * n] for b in range(nb)]


def ec_fft_device(points: list, omega: int, scale: int = 1, device="cuda:0") -> list:
    """``ec_fft`` times a constant ``scale``, through X4 on ``device``."""
    return jacobian_to_affine(*EK.ec_fft(*transform_inputs(points, [(omega, scale)], device)))[0]


def g_to_lagrange(g_monomial: list, k: int, device="cuda:0") -> list:
    """[s^i]G for i < 2^k  ->  [L_i(s)]G (inverse EC-FFT with the n^-1 scale)."""
    n = 1 << k
    if len(g_monomial) != n:
        raise ValueError(f"g_to_lagrange: {len(g_monomial)} points for k = {k}")
    omega_inv = F.fr_inv(NTT.omega_for_k(k))
    n_inv = F.fr_inv(n)
    if n >= DEVICE_MIN and torch.device(device).type != "cpu":
        return ec_fft_device(g_monomial, omega_inv, scale=n_inv, device=device)
    transformed = ec_fft(g_monomial, omega_inv)
    return [None if p is None else C._jac_to_affine(_jac_scalar_mul((p[0], p[1], 1), n_inv))
            for p in transformed]
