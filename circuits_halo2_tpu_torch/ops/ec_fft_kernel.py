"""X4: the EC-FFT over BN254 G1 -- hand-written CUDA kernel and its plain
torch version.

Counterpart of ``utils/ec_fft.py::ec_fft_device`` and its stage scan
``_ec_fft_core`` in the JAX package, which are XLA (no Pallas kernel): the
butterflies of B transforms of n Jacobian points. Each coordinate is a
``(16, B, n)`` int64 canonical Montgomery Fq tensor (``ops/field_torch``),
Z = 0 the point at infinity, the points in bit-reversed order. Stage s pairs
positions q and q + 2^s of each block of 2^(s+1), multiplies the second by
its plain (not Montgomery) twiddle with an LSB-first double-and-add, and
writes u + V and u - V by complete Jacobian additions (``ops/msm.jac_add``);
a last pass multiplies every point by its transform's plain ``scale``.

``twiddle_table(n, omega)`` gives the ``(16, n - 1)`` plain twiddle limbs,
stage s at columns [2^s - 1, 2^(s+1) - 1). ``ec_fft(x, y, z, tw, scale)``
takes ``tw`` as ``(16, B, n - 1)`` and ``scale`` as ``(16, B)`` plain limbs
or None (no scaling). A CPU tensor runs ``ec_fft_ref``; a CUDA tensor
launches ``csrc/ec_fft.cu`` (or raises): one launch a stage and one for the
scale, each counted in ``ec_fft.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import field_torch as FT
from . import msm as M
from .. import build

FQ = FT.FQ


@functools.lru_cache(maxsize=16)
def twiddle_table(n: int, omega: int) -> np.ndarray:
    """(16, n - 1) int64 plain limbs: omega_s^j for stage s (omega_s =
    omega^(n / 2^(s+1))) and j < 2^s, stage after stage."""
    ws = []
    for s in range(n.bit_length() - 1):
        step = F.fr_pow(omega, n >> (s + 1))
        w = 1
        for _ in range(1 << s):
            ws.append(w)
            w = w * step % F.FR_MOD
    table = FT.ints_to_limbs(ws)
    table.setflags(write=False)  # cached: shared by every caller
    return table


def _top_bit(k: torch.Tensor) -> int:
    """Index of the highest set bit over all lanes of plain limbs k (-1 for 0)."""
    return max(FT.limbs_to_ints(k.reshape(FT.NLIMBS, -1)), default=0).bit_length() - 1


def scalar_mul_ref(p, k: torch.Tensor):
    """k·P per lane: P a Jacobian triple of (16, *batch) tensors, k (16, ...)
    plain limbs broadcasting to the batch. LSB first: R starts at infinity,
    A at P; for each bit, R = R + A where the bit is set, then A = 2A (up to
    the highest bit any lane has)."""
    top = _top_bit(k)
    res = tuple(torch.zeros_like(c) for c in p)
    add = p
    for i in range(top + 1):
        bit = ((k[i // FT.LIMB_BITS] >> (i % FT.LIMB_BITS)) & 1) != 0
        summed = M.jac_add(res, add)
        res = tuple(FT.select(bit, s, r) for s, r in zip(summed, res))
        if i < top:
            add = M.jac_double(add)
    return res


def ec_fft_ref(x, y, z, tw, scale=None):
    """Plain torch version of the whole transform (see the module docstring)."""
    lead, n = x.shape[:-1], x.shape[-1]
    p = (x, y, z)
    for s in range(n.bit_length() - 1):
        half = 1 << s
        grouped = tuple(c.reshape(lead + (n // (2 * half), 2, half)) for c in p)
        u = tuple(c[..., 0, :] for c in grouped)
        v = scalar_mul_ref(tuple(c[..., 1, :] for c in grouped),
                           tw[..., half - 1 : 2 * half - 1].unsqueeze(-2))
        top = M.jac_add(u, v)
        bot = M.jac_add(u, (v[0], FT.neg_mod(v[1], FQ), v[2]))
        p = tuple(torch.stack([t, b], dim=-2).reshape(lead + (n,)) for t, b in zip(top, bot))
    if scale is not None:
        p = scalar_mul_ref(p, scale.unsqueeze(-1))
    return p


def ec_fft(x, y, z, tw, scale=None):
    """The transform; see the module docstring."""
    shape = tuple(x.shape)
    if len(shape) != 3 or shape[0] != FT.NLIMBS or x.dtype != FT.DTYPE:
        raise ValueError("ec_fft: coordinates must be (16, B, n) int64")
    n, nb = shape[2], shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"ec_fft: n = {n} is not a power of two >= 2")
    if tuple(y.shape) != shape or tuple(z.shape) != shape or tuple(tw.shape) != (FT.NLIMBS, nb, n - 1):
        raise ValueError("ec_fft: mismatched shapes")
    if scale is not None and tuple(scale.shape) != (FT.NLIMBS, nb):
        raise ValueError("ec_fft: scale must be (16, B)")
    if x.device.type == "cpu":
        return ec_fft_ref(x, y, z, tw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"ec_fft: unsupported device {x.device}")
    lib = build.cuda_library()
    state = torch.stack([FT.limbs_to_words(c, 0) for c in (x, y, z)]).contiguous()
    twiddles = FT.limbs_to_words(tw, 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for s in range(n.bit_length() - 1):
        ec_fft.launches += 1
        build.check(lib.ec_fft_stage_cuda(state.data_ptr(), twiddles.data_ptr(), n, nb, s, stream),
                    "ec_fft_stage_cuda")
    if scale is not None:
        words = FT.limbs_to_words(scale, 0)
        ec_fft.launches += 1
        build.check(lib.ec_fft_scale_cuda(state.data_ptr(), words.data_ptr(), n, nb, stream),
                    "ec_fft_scale_cuda")
    return tuple(FT.words_to_limbs(state[c], 0) for c in range(3))


ec_fft.launches = 0
