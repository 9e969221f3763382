"""Grumpkin curve — the BN254 2-cycle partner (host arithmetic).

Grumpkin is the short-Weierstrass curve y² = x³ − 17 defined over BN254's
SCALAR field Fr, with group order equal to BN254's BASE field modulus q:
the two curves form a cycle (each one's base field is the other's scalar
field). Nova-style IVC uses the cycle so that each curve's fold verifier
operates on commitments whose coordinates are native to its circuit field
(reference: `zk_prover/examples/nova_incremental_verifier.rs:170-198`,
which instantiates nova-snark over provider::bn256_grumpkin).

Points are affine (x, y) int tuples, None = identity. Perf-noncritical:
these ops run host-side inside the IVC driver and the final verifier; the
heavy in-circuit work is R1CS constraints, not host group ops.
"""

from __future__ import annotations

from .field import FQ_MOD, FR_MOD

# Grumpkin: base field = Fr (BN254 scalar field), scalar field = Fq
P = FR_MOD          # coordinate field modulus
ORDER = FQ_MOD      # group order
B = (-17) % P       # curve constant: y² = x³ − 17

# generator: x = 1, y = sqrt(1 + b) = sqrt(-16) = 4i … use the standard
# grumpkin generator (1, sqrt(-16)); −16 is a QR mod r and the canonical
# generator in arkworks/halo2curves is (1, 17^{1/2}·…) — derive directly:
_y2 = (1 + B) % P


def _sqrt(a: int) -> int | None:
    """Tonelli–Shanks for Fr (r ≡ 1 mod 2^28)."""
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # find q, s with p-1 = q·2^s
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5  # known non-residue for BN254 Fr
    while pow(z, (P - 1) // 2, P) == 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t, r = t * c % P, r * b % P
    return r


_gy = _sqrt(_y2)
assert _gy is not None
GEN = (1, min(_gy, P - _gy))


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B)) % P == 0


def neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def double(pt):
    return add(pt, pt)


def mul(pt, k: int):
    k %= ORDER
    acc = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def msm(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, mul(pt, s))
    return acc


def hash_to_point(seed: bytes):
    """Try-and-increment hash-to-curve (independent Pedersen bases whose
    discrete logs nobody knows)."""
    from .keccak import keccak256

    ctr = 0
    while True:
        x = int.from_bytes(keccak256(seed + ctr.to_bytes(4, "big")), "big") % P
        y2 = (x * x * x + B) % P
        y = _sqrt(y2)
        if y is not None:
            return (x, min(y, P - y))
        ctr += 1
