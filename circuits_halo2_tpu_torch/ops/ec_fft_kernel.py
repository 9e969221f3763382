"""X4: the EC-FFT over BN254 G1 -- hand-written CUDA kernel and its plain
torch version.

Counterpart of ``utils/ec_fft.py::ec_fft_device`` and its stage scan
``_ec_fft_core`` in the JAX package, which are XLA (no Pallas kernel): the
butterflies of B transforms of n Jacobian points. Each coordinate is a
``(16, B, n)`` int64 canonical Montgomery Fq tensor (``ops/field_torch``),
Z = 0 the point at infinity, the points in bit-reversed order. Stage s pairs
positions q and q + 2^s of each block of 2^(s+1), multiplies the second by
its twiddle and writes u + V and u - V by complete Jacobian additions
(``ops/msm.jac_add``); a last pass multiplies every point by its transform's
scale.

Every multiply is a GLV one (Gallant, Lambert and Vanstone 2001): BN254 G1
has the endomorphism phi(x, y) = (BETA x, y) = [LAMBDA] P, so a scalar k
splits as k = k1 + LAMBDA k2 (mod r) with both halves below 2^126
(``glv_split``), and kP = k1 P + k2 phi(P). Each half is recoded into
``DIGITS`` signed 4-bit digits in [-8, 8] (``signed_digits``; a negative
half has its digits negated, i.e. its table entries' Y negated) and
multiplied MSB first: a table T_m = mP (m <= 8), then, from the top nonzero
digit down, four doublings and a complete add of +-T_|d| per nonzero digit
(``window_mul_ref``). The two halves' products are summed by one complete
add, R_0 + R_1.

``twiddle_digits(n, omega)`` gives the ``(n - 1, 2, DIGITS)`` int8 digits of
the twiddles (stage s at rows [2^s - 1, 2^(s+1) - 1)) and ``scalar_digits``
those of any scalars. ``ec_fft(x, y, z, digits, scale)`` takes ``digits`` as
``(B, n - 1, 2, DIGITS)`` and ``scale`` as ``(B, 2, DIGITS)`` int8 or None (no
scaling). A CPU tensor runs ``ec_fft_ref``; a CUDA tensor launches
``csrc/ec_fft.cu`` (or raises), two threads a butterfly: one launch a stage
and one for the scale, each counted in ``ec_fft.launches``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import curve as C
from . import field as F
from . import field_torch as FT
from . import msm as M
from .. import build

FQ = FT.FQ
WINDOW = 4  # bits a digit
TABLE = 1 << (WINDOW - 1)  # the largest |digit|: T_1 .. T_8


def _cube_root_of_unity(p: int) -> int:
    """A primitive cube root of unity mod the prime p (p = 1 mod 3)."""
    for base in range(2, 100):
        root = pow(base, (p - 1) // 3, p)
        if root != 1:
            return root
    raise ValueError("no cube root of unity found")


def _glv_constants():
    """LAMBDA (mod r) and BETA (mod q) with phi(G) = (BETA x, y) = [LAMBDA] G,
    and the short basis of the lattice {(a, b) : a + LAMBDA b = 0 mod r} from
    the extended Euclid on (r, LAMBDA) (GLV 2001, section 4)."""
    r, q = F.FR_MOD, F.FQ_MOD
    lam = _cube_root_of_unity(r)
    beta0 = _cube_root_of_unity(q)
    want = C.g1_mul(C.G1_GEN, lam)
    betas = [b for b in (beta0, beta0 * beta0 % q)
             if (b * C.G1_GEN[0] % q, C.G1_GEN[1]) == want]
    if len(betas) != 1:
        raise ValueError("no cube root of unity in Fq acts as LAMBDA on G1")
    rows = [(r, 0), (lam, 1)]  # r_i = s_i r + t_i lam: (r_i, t_i)
    while rows[-1][0]:
        quo = rows[-2][0] // rows[-1][0]
        rows.append((rows[-2][0] - quo * rows[-1][0], rows[-2][1] - quo * rows[-1][1]))
    m = max(i for i, (ri, _) in enumerate(rows) if ri >= math.isqrt(r))
    v1 = (rows[m + 1][0], -rows[m + 1][1])
    v2 = min(((rows[m][0], -rows[m][1]), (rows[m + 2][0], -rows[m + 2][1])),
             key=lambda v: v[0] ** 2 + v[1] ** 2)
    for a, b in (v1, v2):
        if (a + lam * b) % r:
            raise ValueError("GLV basis vector not in the lattice")
    return lam, betas[0], v1, v2


LAMBDA, BETA, _V1, _V2 = _glv_constants()
_DET = _V1[0] * _V2[1] - _V1[1] * _V2[0]  # +-r
# Babai's rounding leaves each half within half the basis' summed entries.
HALF_BOUND = max((abs(_V1[0]) + abs(_V2[0]) + 1) // 2, (abs(_V1[1]) + abs(_V2[1]) + 1) // 2)
HALF_BITS = HALF_BOUND.bit_length()  # |k1|, |k2| < 2^HALF_BITS
# a half's digits; the recoding's carry can add one above its top nibble
DIGITS = -(-(HALF_BITS + 1) // WINDOW)


def _round_div(a: int, d: int) -> int:
    """a / d rounded to the nearest integer (halves up)."""
    if d < 0:
        a, d = -a, -d
    return (2 * a + d) // (2 * d)


def glv_split(k: int) -> tuple[int, int]:
    """(k1, k2) with k1 + LAMBDA k2 = k (mod r) and |k1|, |k2| <= HALF_BOUND:
    (k, 0) less the lattice vector nearest to it by Babai rounding."""
    k %= F.FR_MOD
    c1 = _round_div(k * _V2[1], _DET)
    c2 = _round_div(-k * _V1[1], _DET)
    return k - c1 * _V1[0] - c2 * _V2[0], -c1 * _V1[1] - c2 * _V2[1]


def signed_digits(values) -> np.ndarray:
    """Ints with |v| < 2^HALF_BITS -> (len, DIGITS) int8 signed 4-bit digits
    in [-8, 8], least significant first, sum d_i 16^i = v: |v|'s nibbles, each
    above 8 less 16 with a carry into the next, then negated where v < 0."""
    nbytes = -(-DIGITS // 2)
    raw = np.frombuffer(b"".join(abs(v).to_bytes(nbytes, "little") for v in values),
                        np.uint8).reshape(len(values), nbytes).astype(np.int16)
    nib = np.stack([raw & 15, raw >> 4], axis=-1).reshape(len(values), 2 * nbytes)[:, :DIGITS]
    out = np.empty_like(nib)
    carry = np.zeros(len(values), np.int16)
    for i in range(DIGITS):
        d = nib[:, i] + carry
        carry = (d > TABLE).astype(np.int16)
        out[:, i] = d - 16 * carry
    if carry.any():
        raise ValueError("signed_digits: a value needs more than DIGITS digits")
    sign = np.array([-1 if v < 0 else 1 for v in values], np.int16)
    return (out * sign[:, None]).astype(np.int8)


def scalar_digits(scalars) -> np.ndarray:
    """Scalars mod r -> (len, 2, DIGITS) int8: the signed digits of the two
    GLV halves of each."""
    halves = [glv_split(k) for k in scalars]
    return np.stack([signed_digits([h[0] for h in halves]),
                     signed_digits([h[1] for h in halves])], axis=1)


def twiddles(n: int, omega: int) -> list[int]:
    """The transform's twiddles: omega_s^j for stage s (omega_s =
    omega^(n / 2^(s+1))) and j < 2^s, stage after stage (n - 1 in all)."""
    ws = []
    for s in range(n.bit_length() - 1):
        step = F.fr_pow(omega, n >> (s + 1))
        w = 1
        for _ in range(1 << s):
            ws.append(w)
            w = w * step % F.FR_MOD
    return ws


@functools.lru_cache(maxsize=16)
def twiddle_digits(n: int, omega: int) -> np.ndarray:
    """(n - 1, 2, DIGITS) int8: ``scalar_digits`` of the twiddles."""
    table = scalar_digits(twiddles(n, omega)).reshape(n - 1, 2, DIGITS)
    table.setflags(write=False)  # cached: shared by every caller
    return table


def phi(p):
    """The endomorphism on a Jacobian triple: (BETA X, Y, Z) = [LAMBDA] P."""
    x, y, z = p
    return FT.mont_mul(x, FT.const_tensor(FQ.const(BETA), x.device, x.dim()), FQ), y, z


@FT.plain_version
def window_mul_ref(p, digits: torch.Tensor):
    """[k] P per lane for k = sum_i digits[..., i] 16^i: P a Jacobian triple
    of (16, *lanes) tensors, digits (*lanes, DIGITS). The table T_m = mP
    (T_2m = 2 T_m, T_2m+1 = T_2m + T_1) up to the largest |digit|; from the
    top nonzero digit of each lane down, four doublings and a complete add
    of +-T_|d| where d != 0; a lane of zero digits gives infinity (all limbs
    0)."""
    digits = digits.to(torch.int64)
    table = [p]
    for m in range(2, int(digits.abs().max()) + 1):  # as far as any lane needs
        table.append(M.jac_double(table[m // 2 - 1]) if m % 2 == 0
                     else M.jac_add(table[m - 2], table[0]))
    table = torch.stack([torch.stack(t) for t in table])  # (m, 3, 16, *lanes)
    pos = torch.arange(digits.shape[-1], device=digits.device)
    top = torch.where(digits != 0, pos, -1).amax(-1)
    acc = tuple(torch.zeros_like(c) for c in p)
    for w in range(int(top.max()), -1, -1):
        d = digits[..., w]
        index = (d.abs() - 1).clamp(min=0).unsqueeze(0).unsqueeze(0)
        x, y, z = torch.gather(table, 0, index.expand((1,) + table.shape[1:]))[0]
        entry = (x, FT.select(d < 0, FT.neg_mod(y, FQ), y), z)
        below = top > w
        step = acc
        if bool(below.any()):
            for _ in range(WINDOW):
                step = M.jac_double(step)
            added = M.jac_add(step, entry)
            step = tuple(FT.select(d != 0, a, s) for a, s in zip(added, step))
        acc = tuple(FT.select(top == w, e, FT.select(below, s, a))
                    for e, s, a in zip(entry, step, acc))
    return acc


@FT.plain_version
def glv_mul_ref(p, digits: torch.Tensor):
    """[k] P per lane, k given by its (*lanes, 2, DIGITS) GLV digits: the
    two halves' products R_0 = [k1] P, R_1 = [k2] phi(P), then R_0 + R_1."""
    halves = tuple(torch.stack([a, b], dim=-1) for a, b in zip(p, phi(p)))
    r = window_mul_ref(halves, digits)
    return M.jac_add(tuple(c[..., 0] for c in r), tuple(c[..., 1] for c in r))


@FT.plain_version
def ec_fft_ref(x, y, z, digits, scale=None):
    """Plain torch version of the whole transform (see the module docstring)."""
    lead, n = x.shape[:-1], x.shape[-1]
    p = (x, y, z)
    for s in range(n.bit_length() - 1):
        half = 1 << s
        groups = n // (2 * half)
        grouped = tuple(c.reshape(lead + (groups, 2, half)) for c in p)
        u = tuple(c[..., 0, :] for c in grouped)
        stage = digits[..., half - 1 : 2 * half - 1, :, :].unsqueeze(-4)
        v = glv_mul_ref(tuple(c[..., 1, :] for c in grouped),
                        stage.expand(lead[1:] + (groups, half, 2, DIGITS)))
        top = M.jac_add(u, v)
        bot = M.jac_add(u, (v[0], FT.neg_mod(v[1], FQ), v[2]))
        p = tuple(torch.stack([t, b], dim=-2).reshape(lead + (n,)) for t, b in zip(top, bot))
    if scale is not None:
        p = glv_mul_ref(p, scale.unsqueeze(-3).expand(lead[1:] + (n, 2, DIGITS)))
    return p


def ec_fft(x, y, z, digits, scale=None):
    """The transform; see the module docstring."""
    shape = tuple(x.shape)
    if len(shape) != 3 or shape[0] != FT.NLIMBS or x.dtype != FT.DTYPE:
        raise ValueError("ec_fft: coordinates must be (16, B, n) int64")
    n, nb = shape[2], shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"ec_fft: n = {n} is not a power of two >= 2")
    if tuple(y.shape) != shape or tuple(z.shape) != shape:
        raise ValueError("ec_fft: mismatched shapes")
    if digits.dtype != torch.int8 or tuple(digits.shape) != (nb, n - 1, 2, DIGITS):
        raise ValueError(f"ec_fft: digits must be ({nb}, {n - 1}, 2, {DIGITS}) int8")
    if scale is not None and (scale.dtype != torch.int8 or tuple(scale.shape) != (nb, 2, DIGITS)):
        raise ValueError(f"ec_fft: scale must be ({nb}, 2, {DIGITS}) int8")
    if x.device.type == "cpu":
        return ec_fft_ref(x, y, z, digits, scale)
    if x.device.type != "cuda":
        raise ValueError(f"ec_fft: unsupported device {x.device}")
    lib = build.cuda_library()
    for t in (digits,) if scale is None else (digits, scale):  # the kernel's table holds T_1..T_8
        if bool(((t > TABLE) | (t < -TABLE)).any()):
            raise ValueError(f"ec_fft: a digit outside [-{TABLE}, {TABLE}]")
    state = torch.stack([FT.limbs_to_words(c, 0) for c in (x, y, z)]).contiguous()
    beta = FT.limbs_to_words(FT.const_tensor(FQ.const(BETA), x.device, 2), 0)
    digits = digits.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for s in range(n.bit_length() - 1):
        ec_fft.launches += 1
        build.check(lib.ec_fft_stage_cuda(state.data_ptr(), digits.data_ptr(), beta.data_ptr(),
                                          n, nb, s, DIGITS, stream), "ec_fft_stage_cuda")
    if scale is not None:
        scale = scale.contiguous()
        ec_fft.launches += 1
        build.check(lib.ec_fft_scale_cuda(state.data_ptr(), scale.data_ptr(), beta.data_ptr(),
                                          n, nb, DIGITS, stream), "ec_fft_scale_cuda")
    return tuple(FT.words_to_limbs(state[c], 0) for c in range(3))


ec_fft.launches = 0
