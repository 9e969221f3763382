"""BN254 optimal-ate pairing — host-side, used by the KZG verifier.

The verifier needs only a pairing *check* e(A, G2) == e(B, sG2), i.e.
e(A, G2)·e(-B, sG2) == 1, a handful of pairings per proof — host Python is
fine (the reference's verifier is likewise CPU-side; SURVEY.md §2b).

Implementation: Fq12 as Fq[w]/(w^12 - 18w^6 + 82) (the standard BN254
tower flattening), G2 points twisted into E(Fq12), Miller loop with the
binary ate loop count, final exponentiation by (q^12-1)/r.
"""

from __future__ import annotations

from .field import FQ_MOD, FR_MOD
from . import curve as C

Q = FQ_MOD

# BN254 ate pairing loop count: 6t + 2 with t = 4965661367192848881.
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

# Fq12 modulus polynomial: w^12 - 18·w^6 + 82  (so w^6 = 9 + u with u^2 = -1).
_FQ12_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


class FQ12:
    """Element of Fq12 as a degree-<12 polynomial over Fq."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == 12
        self.c = tuple(x % Q for x in coeffs)

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * 11)

    @classmethod
    def zero(cls):
        return cls((0,) * 12)

    def __eq__(self, other):
        return self.c == other.c

    def __add__(self, other):
        return FQ12([a + b for a, b in zip(self.c, other.c)])

    def __sub__(self, other):
        return FQ12([a - b for a, b in zip(self.c, other.c)])

    def __neg__(self):
        return FQ12([-a for a in self.c])

    def __mul__(self, other):
        if isinstance(other, int):
            return FQ12([a * other for a in self.c])
        prod = [0] * 23
        a, b = self.c, other.c
        for i in range(12):
            ai = a[i]
            if ai:
                for j in range(12):
                    prod[i + j] += ai * b[j]
        # reduce degree using w^12 = 18w^6 - 82
        for d in range(22, 11, -1):
            top = prod[d]
            if top:
                prod[d - 6] += top * 18
                prod[d - 12] -= top * 82
            prod[d] = 0
        return FQ12(prod[:12])

    def square(self):
        return self * self

    def inv(self):
        """Extended Euclid over Fq[x] against w^12 - 18w^6 + 82."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [c % Q for c in _FQ12_MOD_COEFFS] + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_l0 = pow(low[0], -1, Q)
        return FQ12([x * inv_l0 % Q for x in lm[:12]])

    def __pow__(self, e: int):
        result = FQ12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result


def _deg(p):
    d = len(p) - 1
    while d and p[d] % Q == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = [x for x in a]
    out = [0] * (dega - degb + 1)
    binv = pow(b[degb], -1, Q)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % Q
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % Q
    return out


# ---------------------------------------------------------------------------
# Curve over Fq12 and the twist embedding
# ---------------------------------------------------------------------------

_W2 = FQ12([0, 0, 1] + [0] * 9)
_W3 = FQ12([0, 0, 0, 1] + [0] * 8)


def twist(pt):
    """G2 point ((x0,x1),(y0,y1)) over Fq2 → point on E(Fq12)."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    # Map Fq2 = Fq[u]/(u²+1) into Fq12 where u = w^6 - 9.
    nx = FQ12([(x0 - 9 * x1) % Q] + [0] * 5 + [x1] + [0] * 5)
    ny = FQ12([(y0 - 9 * y1) % Q] + [0] * 5 + [y1] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _double(pt):
    x, y = pt
    lam = x.square() * 3 * (y * 2).inv()
    nx = lam.square() - x * 2
    ny = lam * (x - nx) - y
    return (nx, ny)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    nx = lam.square() - x1 - x2
    ny = lam * (x1 - nx) - y1
    return (nx, ny)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at point t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = x1.square() * 3 * (y1 * 2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_pt, p_pt) -> FQ12:
    if q_pt is None or p_pt is None:
        return FQ12.one()
    r = q_pt
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r, r, p_pt)
        r = _double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q_pt, p_pt)
            r = _add(r, q_pt)
    q1 = (q_pt[0] ** Q, q_pt[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r, q1, p_pt)
    r = _add(r, q1)
    f = f * _linefunc(r, nq2, p_pt)
    return f


_FINAL_EXP = (Q**12 - 1) // FR_MOD


def pairing(g2_pt, g1_pt) -> FQ12:
    """Full pairing e(P, Q) with P ∈ G1, Q ∈ G2 (host ints)."""
    return miller_loop(twist(g2_pt), cast_g1(g1_pt)) ** _FINAL_EXP


def pairing_check(pairs) -> bool:
    """∏ e(P_i, Q_i) == 1 for [(g1_pt, g2_pt), ...] — one final exp."""
    f = FQ12.one()
    for g1_pt, g2_pt in pairs:
        if g1_pt is None or g2_pt is None:
            continue
        f = f * miller_loop(twist(g2_pt), cast_g1(g1_pt))
    return f ** _FINAL_EXP == FQ12.one()
