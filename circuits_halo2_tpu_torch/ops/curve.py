"""BN254 (alt_bn128) elliptic curve — host-side reference implementation.

G1: y^2 = x^3 + 3 over Fq;  G2: y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1).

Serialization matches halo2curves "raw" format used by the ParamsKZG files:
uncompressed affine, little-endian 32-byte coordinates (G1: x||y = 64 bytes,
G2: x.c0||x.c1||y.c0||y.c1 = 128 bytes), identity encoded as all zeros.

The batched device path (Jacobian add/double over limb tensors, Pippenger
MSM) lives in ``msm.py``; this module is the correctness anchor and handles
small host-side computations (verifier-side MSMs are tiny).
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import FQ_MOD, FR_MOD

Q = FQ_MOD

G1_GEN = (1, 2)
B_G1 = 3

# Fq2 = Fq[u]/(u^2 + 1); elements (c0, c1) = c0 + c1*u.
# G2 curve constant b2 = 3 / (9 + u).
def _fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)


def _fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def _fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def _fq2_sqr(a):
    return _fq2_mul(a, a)


def _fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % Q
    inv = pow(norm, -1, Q)
    return (a0 * inv % Q, (-a1) * inv % Q)


def _fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


B_G2 = _fq2_mul((3, 0), _fq2_inv((9, 1)))

G2_GEN = (
    (
        0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
        0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2,
    ),
    (
        0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
        0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B,
    ),
)


# ---------------------------------------------------------------------------
# G1 (ints; None = point at infinity)
# ---------------------------------------------------------------------------

def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B_G1) % Q == 0


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return g1_double(p)
    lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, -1, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    y3 = (lam * (x - x3) - y) % Q
    return (x3, y3)


def g1_mul(p, k: int):
    k %= FR_MOD
    result = None
    addend = p
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_double(addend)
        k >>= 1
    return result


def g1_msm(points, scalars):
    """Naive host MSM (correctness reference; device path is msm.py)."""
    acc = None
    for p, s in zip(points, scalars):
        if s % FR_MOD == 0 or p is None:
            continue
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# -- host Jacobian helpers (fast path for medium MSMs on the host) ----------

def _jac_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 % Q * z2z2 % Q
    s2 = y2 * z1 % Q * z1z1 % Q
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) % Q * h % Q
    return (x3, y3, z3)


def _jac_double(p):
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _jac_to_affine(p):
    if p is None or p[2] == 0:
        return None
    zinv = pow(p[2], -1, Q)
    zi2 = zinv * zinv % Q
    return (p[0] * zi2 % Q, p[1] * zi2 % Q * zinv % Q)


def g1_msm_pippenger(points, scalars, window: int = 8):
    """Host Pippenger MSM (windowed buckets, Jacobian accumulation)."""
    pairs = [
        (p, s % FR_MOD)
        for p, s in zip(points, scalars)
        if p is not None and s % FR_MOD != 0
    ]
    if not pairs:
        return None
    nwin = (254 + window - 1) // window
    acc = None
    mask = (1 << window) - 1
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(window):
                acc = _jac_double(acc)
        buckets = [None] * (1 << window)
        shift = w * window
        for p, s in pairs:
            digit = (s >> shift) & mask
            if digit:
                buckets[digit] = _jac_add(buckets[digit], (p[0], p[1], 1))
        running = None
        total = None
        for b in range(len(buckets) - 1, 0, -1):
            running = _jac_add(running, buckets[b])
            total = _jac_add(total, running)
        acc = _jac_add(acc, total)
    return _jac_to_affine(acc)


def g1_to_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")


def g1_from_bytes(b: bytes):
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:64], "little")
    if x == 0 and y == 0:
        return None
    return (x, y)


# halo2curves `SerdeObject` raw format stores the internal Montgomery limbs.
_R_INV_Q = pow(1 << 256, -1, Q)
_R_Q = (1 << 256) % Q


def g1_from_raw_bytes(b: bytes):
    x = int.from_bytes(b[:32], "little") * _R_INV_Q % Q
    y = int.from_bytes(b[32:64], "little") * _R_INV_Q % Q
    if x == 0 and y == 0:
        return None
    return (x, y)


def g1_to_raw_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return (p[0] * _R_Q % Q).to_bytes(32, "little") + (p[1] * _R_Q % Q).to_bytes(
        32, "little"
    )


def g2_from_raw_bytes(b: bytes):
    c = [
        int.from_bytes(b[32 * i : 32 * (i + 1)], "little") * _R_INV_Q % Q
        for i in range(4)
    ]
    if all(v == 0 for v in c):
        return None
    return ((c[0], c[1]), (c[2], c[3]))


def g2_to_raw_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    x, y = p
    return b"".join(
        (c * _R_Q % Q).to_bytes(32, "little") for c in (x[0], x[1], y[0], y[1])
    )


# ---------------------------------------------------------------------------
# G2 (pairs of Fq2; None = infinity)
# ---------------------------------------------------------------------------

def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = _fq2_sqr(y)
    rhs = _fq2_add(_fq2_mul(_fq2_sqr(x), x), B_G2)
    return lhs == rhs


def g2_neg(p):
    if p is None:
        return None
    x, y = p
    return (x, ((-y[0]) % Q, (-y[1]) % Q))


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if _fq2_add(y1, y2) == (0, 0):
            return None
        return g2_double(p)
    lam = _fq2_mul(_fq2_sub(y2, y1), _fq2_inv(_fq2_sub(x2, x1)))
    x3 = _fq2_sub(_fq2_sub(_fq2_sqr(lam), x1), x2)
    y3 = _fq2_sub(_fq2_mul(lam, _fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_double(p):
    if p is None:
        return None
    x, y = p
    if y == (0, 0):
        return None
    lam = _fq2_mul(_fq2_scalar(_fq2_sqr(x), 3), _fq2_inv(_fq2_scalar(y, 2)))
    x3 = _fq2_sub(_fq2_sqr(lam), _fq2_scalar(x, 2))
    y3 = _fq2_sub(_fq2_mul(lam, _fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_mul(p, k: int):
    k %= FR_MOD
    result = None
    addend = p
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_double(addend)
        k >>= 1
    return result


def g2_to_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    x, y = p
    return b"".join(c.to_bytes(32, "little") for c in (x[0], x[1], y[0], y[1]))


def g2_from_bytes(b: bytes):
    c = [int.from_bytes(b[32 * i : 32 * (i + 1)], "little") for i in range(4)]
    if all(v == 0 for v in c):
        return None
    return ((c[0], c[1]), (c[2], c[3]))
