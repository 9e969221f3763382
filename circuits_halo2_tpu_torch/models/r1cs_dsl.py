"""Field-generic R1CS builder + gadget library for the Nova curve cycle.

The circom-step synthesizer (`merkle/circom_r1cs.py`) is pinned to Fr and
to circomlib template shapes. The Nova augmented circuits (see
`models/nova_cycle.py`) need the same machinery over BOTH cycle fields —
Fr for the primary circuit and Fq for the secondary — plus gadgets circom
never needed natively: complete elliptic-curve point ops over the circuit
field (the cycle partner's points have native coordinates) and non-native
("bignum-limb") arithmetic for folding the partner field's scalars.

Everything here is host-side synthesis/witness generation (plain ints);
constraints are rank-1 rows (a·b = c) over LC dicts {wire: coeff}.
Reference structural target: the nova-snark augmented circuit consumed by
`zk_prover/examples/nova_incremental_verifier.rs:170-198`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# LC = {wire_index: coeff}; wire 0 is the constant 1.
LC = dict


@dataclass
class R1CSSystem:
    modulus: int
    constraints: list  # [(A, B, C)] with A·B = C per row
    num_wires: int
    num_public: int  # wires 1..num_public are public IO

    def check(self, witness: list[int]) -> list[int]:
        """Indices of violated constraints (empty = satisfied)."""
        p = self.modulus

        def ev(lc):
            return sum(witness[w] * c for w, c in lc.items()) % p

        bad = []
        for i, (a, b, c) in enumerate(self.constraints):
            if ev(a) * ev(b) % p != ev(c):
                bad.append(i)
        return bad


class Builder:
    """Rank-1 constraint builder over an arbitrary prime field."""

    def __init__(self, modulus: int):
        self.p = modulus
        self.values: list[int] = [1]
        self.constraints: list[tuple[LC, LC, LC]] = []
        self.public: list[int] = []  # wire indices exposed as public IO

    # -- wires ---------------------------------------------------------

    def new_wire(self, value: int) -> LC:
        self.values.append(value % self.p)
        return {len(self.values) - 1: 1}

    def const(self, v: int) -> LC:
        return {0: v % self.p} if v % self.p else {}

    def expose(self, lc: LC) -> None:
        """Pin an LC into a fresh public-IO wire."""
        w = self.new_wire(self.eval(lc))
        self.assert_eq(w, lc)
        self.public.append(next(iter(w)))

    # -- LC algebra ----------------------------------------------------

    def add(self, a: LC, b: LC) -> LC:
        out = dict(a)
        for w, c in b.items():
            v = (out.get(w, 0) + c) % self.p
            if v:
                out[w] = v
            else:
                out.pop(w, None)
        return out

    def sub(self, a: LC, b: LC) -> LC:
        return self.add(a, self.scale(b, -1))

    def scale(self, a: LC, k: int) -> LC:
        k %= self.p
        if not k:
            return {}
        return {w: c * k % self.p for w, c in a.items()}

    def sum(self, lcs) -> LC:
        out: LC = {}
        for lc in lcs:
            out = self.add(out, lc)
        return out

    def eval(self, lc: LC) -> int:
        return sum(self.values[w] * c for w, c in lc.items()) % self.p

    # -- constraints ---------------------------------------------------

    def mul(self, a: LC, b: LC) -> LC:
        out = self.new_wire(self.eval(a) * self.eval(b))
        self.constraints.append((a, b, out))
        return out

    def assert_eq(self, a: LC, b: LC) -> None:
        self.constraints.append((self.sub(a, b), {0: 1}, {}))

    def assert_mul(self, a: LC, b: LC, c: LC) -> None:
        self.constraints.append((a, b, c))

    def assert_bool(self, s: LC) -> None:
        self.constraints.append((s, self.sub(self.const(1), s), {}))

    def assert_zero(self, a: LC) -> None:
        self.constraints.append((a, {0: 1}, {}))

    # -- gadgets -------------------------------------------------------

    def bits_of(self, lc: LC, nbits: int) -> list[LC]:
        """Decompose into nbits boolean wires + recomposition equality."""
        v = self.eval(lc)
        assert v < (1 << nbits), f"{v} >= 2^{nbits}"
        bits = []
        acc: LC = {}
        for i in range(nbits):
            bit = self.new_wire((v >> i) & 1)
            self.assert_bool(bit)
            bits.append(bit)
            acc = self.add(acc, self.scale(bit, 1 << i))
        self.assert_eq(acc, lc)
        return bits

    def select(self, s: LC, a: LC, b: LC) -> LC:
        """s ? a : b (s boolean; one constraint)."""
        return self.add(self.mul(self.sub(a, b), s), b)

    def is_zero(self, a: LC) -> LC:
        """Boolean wire: 1 iff a == 0. Witness-inverse trick:
        z = 1 − a·inv(a); a·z = 0."""
        v = self.eval(a)
        inv = self.new_wire(pow(v, -1, self.p) if v else 0)
        z = self.sub(self.const(1), self.mul(a, inv))
        zw = self.new_wire(self.eval(z))
        self.assert_eq(zw, z)
        self.assert_mul(a, zw, {})
        return zw

    def inverse_or_zero(self, a: LC) -> LC:
        """Wire holding a^{-1} (or 0 when a == 0), with a·inv = 1 − is_zero."""
        v = self.eval(a)
        inv = self.new_wire(pow(v, -1, self.p) if v else 0)
        iz = self.is_zero(a)
        self.assert_mul(a, inv, self.sub(self.const(1), iz))
        return inv

    def finish(self, num_public: int | None = None) -> tuple[R1CSSystem, list[int]]:
        """Freeze into (R1CSSystem, witness). Public wires must have been
        allocated FIRST (wires 1..num_public) or exposed via expose()."""
        npub = num_public if num_public is not None else len(self.public)
        return (
            R1CSSystem(self.p, list(self.constraints), len(self.values), npub),
            list(self.values),
        )


# ---------------------------------------------------------------------------
# Poseidon over an arbitrary field (for the in-circuit random oracle)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PoseidonParams:
    modulus: int
    t: int
    r_f: int
    r_p: int
    rc: tuple  # (r_f + r_p) × t round constants
    mds: tuple  # t × t


def poseidon_params(modulus: int, t: int, r_f: int, r_p: int) -> PoseidonParams:
    from ..ops.grain import generate_poseidon_params

    rc, mds, _ = generate_poseidon_params(t=t, r_f=r_f, r_p=r_p, modulus=modulus)
    return PoseidonParams(
        modulus, t, r_f, r_p,
        tuple(tuple(r) for r in rc), tuple(tuple(r) for r in mds),
    )


def poseidon_permute_host(pp: PoseidonParams, state: list[int]) -> list[int]:
    p, t = pp.modulus, pp.t

    def sbox(x):
        x2 = x * x % p
        return x2 * x2 % p * x % p

    ri = 0
    s = list(state)
    for phase, rounds in ((1, pp.r_f // 2), (0, pp.r_p), (1, pp.r_f // 2)):
        for _ in range(rounds):
            s = [(x + pp.rc[ri][i]) % p for i, x in enumerate(s)]
            s = [sbox(x) for x in s] if phase else [sbox(s[0])] + s[1:]
            s = [
                sum(pp.mds[i][j] * s[j] for j in range(t)) % p
                for i in range(t)
            ]
            ri += 1
    return s


def poseidon_sponge_host(pp: PoseidonParams, inputs: list[int]) -> int:
    """Fixed-rate absorb (rate = t−1), squeeze one element."""
    rate = pp.t - 1
    state = [0] * pp.t
    msg = list(inputs)
    if len(msg) % rate:
        msg += [0] * (rate - len(msg) % rate)
    for i in range(0, len(msg), rate):
        for j in range(rate):
            state[1 + j] = (state[1 + j] + msg[i + j]) % pp.modulus
        state = poseidon_permute_host(pp, state)
    return state[1]


def poseidon_sponge_circuit(b: Builder, pp: PoseidonParams, inputs: list[LC]) -> LC:
    """In-circuit version of poseidon_sponge_host (bit-identical)."""
    rate = pp.t - 1
    t = pp.t

    def sbox(x: LC) -> LC:
        x2 = b.mul(x, x)
        x4 = b.mul(x2, x2)
        return b.mul(x4, x)

    def permute(state: list[LC]) -> list[LC]:
        ri = 0
        s = list(state)
        for phase, rounds in ((1, pp.r_f // 2), (0, pp.r_p), (1, pp.r_f // 2)):
            for _ in range(rounds):
                s = [b.add(x, b.const(pp.rc[ri][i])) for i, x in enumerate(s)]
                s = [sbox(x) for x in s] if phase else [sbox(s[0])] + s[1:]
                s = [
                    b.sum(b.scale(s[j], pp.mds[i][j]) for j in range(t))
                    for i in range(t)
                ]
                ri += 1
        return s

    msg = list(inputs)
    if len(msg) % rate:
        msg += [b.const(0)] * (rate - len(msg) % rate)
    state: list[LC] = [b.const(0)] * t
    for i in range(0, len(msg), rate):
        state = [state[0]] + [
            b.add(state[1 + j], msg[i + j]) for j in range(rate)
        ]
        state = permute(state)
    return state[1]


# ---------------------------------------------------------------------------
# Elliptic-curve gadgets (curve y² = x³ + B over the circuit field)
# ---------------------------------------------------------------------------


@dataclass
class PointVar:
    """Affine point with explicit infinity flag (complete arithmetic)."""

    x: LC
    y: LC
    inf: LC  # boolean: 1 = identity

    @staticmethod
    def alloc(b: Builder, pt) -> "PointVar":
        if pt is None:
            return PointVar(b.new_wire(0), b.new_wire(0), b.new_wire(1))
        return PointVar(b.new_wire(pt[0]), b.new_wire(pt[1]), b.new_wire(0))

    def value(self, b: Builder):
        if b.eval(self.inf):
            return None
        return (b.eval(self.x), b.eval(self.y))


def ec_assert_on_curve(b: Builder, curve_b: int, p: PointVar) -> None:
    """(1−inf)·(y² − x³ − B) = 0."""
    y2 = b.mul(p.y, p.y)
    x2 = b.mul(p.x, p.x)
    x3 = b.mul(x2, p.x)
    expr = b.sub(y2, b.add(x3, b.const(curve_b)))
    b.assert_mul(b.sub(b.const(1), p.inf), expr, {})


def ec_double(b: Builder, p: PointVar) -> PointVar:
    """Complete doubling: identity→identity; y=0 never occurs on odd-order
    curves except at infinity (guarded by inf flag)."""
    two_y = b.scale(p.y, 2)
    inv = b.inverse_or_zero(two_y)
    x2 = b.mul(p.x, p.x)
    lam = b.mul(b.scale(x2, 3), inv)
    x3 = b.sub(b.sub(b.mul(lam, lam), p.x), p.x)
    y3 = b.sub(b.mul(lam, b.sub(p.x, x3)), p.y)
    # identity in → identity out
    return PointVar(
        b.select(p.inf, p.x, x3), b.select(p.inf, p.y, y3), p.inf
    )


def ec_add(b: Builder, p: PointVar, q: PointVar) -> PointVar:
    """Complete addition covering identity and equal/opposite-x cases."""
    dx = b.sub(q.x, p.x)
    dy = b.sub(q.y, p.y)
    x_eq = b.is_zero(dx)
    y_eq = b.is_zero(dy)
    inv_dx = b.inverse_or_zero(dx)
    lam_add = b.mul(dy, inv_dx)

    two_y = b.scale(p.y, 2)
    inv_2y = b.inverse_or_zero(two_y)
    x2 = b.mul(p.x, p.x)
    lam_dbl = b.mul(b.scale(x2, 3), inv_2y)

    use_dbl = b.mul(x_eq, y_eq)  # same point → tangent slope
    lam = b.select(use_dbl, lam_dbl, lam_add)

    x3 = b.sub(b.sub(b.mul(lam, lam), p.x), q.x)
    y3 = b.sub(b.mul(lam, b.sub(p.x, x3)), p.y)

    # opposite points (x_eq ∧ ¬y_eq) → identity
    opp = b.mul(x_eq, b.sub(b.const(1), y_eq))
    both = b.mul(p.inf, q.inf)
    some_inf = b.sub(b.add(p.inf, q.inf), both)  # p.inf ∨ q.inf
    res_inf_val = (
        b.eval(both)
        or (b.eval(opp) and not b.eval(some_inf))
    )
    # inf_out = both ∨ (opp ∧ ¬some_inf)
    opp_live = b.mul(opp, b.sub(b.const(1), some_inf))
    inf_out = b.sub(b.add(both, opp_live), b.mul(both, opp_live))
    assert b.eval(inf_out) in (0, 1) and bool(b.eval(inf_out)) == bool(res_inf_val)

    # p identity → q; q identity → p; else computed
    x_sel = b.select(p.inf, q.x, b.select(q.inf, p.x, x3))
    y_sel = b.select(p.inf, q.y, b.select(q.inf, p.y, y3))
    return PointVar(x_sel, y_sel, inf_out)


def ec_select(b: Builder, s: LC, p: PointVar, q: PointVar) -> PointVar:
    return PointVar(
        b.select(s, p.x, q.x), b.select(s, p.y, q.y), b.select(s, p.inf, q.inf)
    )


def ec_scalar_mul(b: Builder, bits: list[LC], p: PointVar) -> PointVar:
    """bits LSB-first (boolean wires) → [Σ bits_i 2^i]·p, double-and-add
    with complete formulas (~30 constraints/bit)."""
    acc = PointVar(b.new_wire(0), b.new_wire(0), b.new_wire(1))
    base = p
    for i, bit in enumerate(bits):
        added = ec_add(b, acc, base)
        acc = ec_select(b, bit, added, acc)
        if i + 1 < len(bits):
            base = ec_double(b, base)
    return acc


# ---------------------------------------------------------------------------
# Non-native ("foreign-field") scalar folding: out = (x1 + r·x2) mod m
# ---------------------------------------------------------------------------
#
# The cycle's two moduli differ by < 2^127, so a canonical element of the
# larger field need not fit the smaller circuit field: foreign values are
# carried as THREE base-2^85 limbs. All column sums below stay < 2^212,
# far from the ≥ 2^253 circuit modulus, so limb-carry identities checked
# mod p pin the exact integer identity (no wrap-around ambiguity).

FLIMB = 85
FMASK = (1 << FLIMB) - 1


def alloc_foreign(b: Builder, v: int, m: int):
    """Foreign value v ∈ [0, m) as 3 range-checked 85-bit limbs, plus a
    canonicality proof out ≤ m−1 (allocate d = m−1−v with ranged limbs
    and boolean borrows such that v + d = m−1 exactly)."""
    assert 0 <= v < m
    limbs = _alloc_limbs3(b, v)
    _assert_lt_const(b, limbs, v, m)
    return limbs


def _alloc_limbs3(b: Builder, v: int):
    ls = []
    for i in range(3):
        li = (v >> (FLIMB * i)) & FMASK
        w = b.new_wire(li)
        b.bits_of(w, FLIMB)
        ls.append(w)
    return tuple(ls)


def _assert_lt_const(b: Builder, limbs, v: int, m: int) -> None:
    """limbs (ranged, value v) satisfy v ≤ m−1: allocate d = m−1−v ≥ 0
    with ranged limbs and chain per-column equalities with boolean
    carries: v.i + d.i + c_{i-1} = (m−1).i + c_i·2^85."""
    d = m - 1 - v
    assert d >= 0
    dl = _alloc_limbs3(b, d)
    t = m - 1
    carry_prev: LC = {}
    for i in range(3):
        ti = (t >> (FLIMB * i)) & FMASK
        col_val = (
            b.eval(limbs[i]) + b.eval(dl[i]) + b.eval(carry_prev)
        )
        c_i = (col_val - ti) >> FLIMB
        assert c_i in (0, 1)
        if i < 2:
            cw = b.new_wire(c_i)
            b.assert_bool(cw)
        else:
            cw = {}
            assert c_i == 0
        lhs = b.add(b.add(limbs[i], dl[i]), carry_prev)
        rhs = b.add(b.const(ti), b.scale(cw, 1 << FLIMB))
        b.assert_eq(lhs, rhs)
        carry_prev = cw


def foreign_value(b: Builder, limbs) -> int:
    return sum(b.eval(l) << (FLIMB * i) for i, l in enumerate(limbs))


def foreign_zero(b: Builder):
    return (b.const(0), b.const(0), b.const(0))


def foreign_const(b: Builder, v: int):
    return tuple(b.const((v >> (FLIMB * i)) & FMASK) for i in range(3))


def foreign_select(b: Builder, s: LC, a, c):
    return tuple(b.select(s, a[i], c[i]) for i in range(3))


def foreign_assert_eq(b: Builder, a, c) -> None:
    for i in range(3):
        b.assert_eq(a[i], c[i])


def foreign_fold(b: Builder, m: int, x1, x2, r_lc: LC, r_val: int):
    """out = (x1 + r·x2) mod m over 3-limb foreign values; r is a native
    scalar < 2^125 (the truncated Fiat–Shamir challenge).

    Integer identity x1 + r·x2 = k·m + out checked in base-2^85 columns
    with range-checked signed carries; out is allocated canonical
    (< m, see alloc_foreign). Quotient k < 2^126 (2 limbs: 85 + 41)."""
    assert 0 <= r_val < (1 << 125)
    x1v = foreign_value(b, x1)
    x2v = foreign_value(b, x2)
    total = x1v + r_val * x2v
    k_v, out_v = divmod(total, m)
    assert k_v < (1 << 126)

    out = alloc_foreign(b, out_v, m)
    k0_v, k1_v = k_v & FMASK, k_v >> FLIMB
    k0 = b.new_wire(k0_v)
    b.bits_of(k0, FLIMB)
    k1 = b.new_wire(k1_v)
    b.bits_of(k1, 41)

    m_l = [(m >> (FLIMB * i)) & FMASK for i in range(3)]

    # signed column deficits D_i; Σ D_i·2^{85i} = 0 over ℤ
    rx = [b.mul(r_lc, x2[i]) for i in range(3)]  # < 2^210 each
    D = [
        b.sub(b.add(x1[0], rx[0]),
              b.add(b.scale(k0, m_l[0]), out[0])),
        b.sub(b.add(x1[1], rx[1]),
              b.add(b.add(b.scale(k0, m_l[1]), b.scale(k1, m_l[0])), out[1])),
        b.sub(b.add(x1[2], rx[2]),
              b.add(b.add(b.scale(k0, m_l[2]), b.scale(k1, m_l[1])), out[2])),
        b.scale(b.scale(k1, m_l[2]), -1),
    ]
    # carry chain: D_i + c_{i-1} = c_i·2^85, final column exact zero.
    # |c_i| < 2^130 → offset-encode and range check 132 bits.
    OFF = 1 << 131
    carry_prev: LC = {}
    int_vals = [x1v, r_val, x2v]  # (debug anchor)
    # host-side integer columns for witness carries
    cols = [
        (x1v & FMASK) + r_val * (x2v & FMASK)
        - k0_v * m_l[0] - (out_v & FMASK),
        ((x1v >> FLIMB) & FMASK) + r_val * ((x2v >> FLIMB) & FMASK)
        - k0_v * m_l[1] - k1_v * m_l[0] - ((out_v >> FLIMB) & FMASK),
        ((x1v >> (2 * FLIMB)) & FMASK) + r_val * ((x2v >> (2 * FLIMB)) & FMASK)
        - k0_v * m_l[2] - k1_v * m_l[1] - ((out_v >> (2 * FLIMB)) & FMASK),
        -k1_v * m_l[2],
    ]
    c_int = 0
    for i in range(4):
        c_int = (cols[i] + c_int) >> FLIMB if i < 3 else cols[i] + c_int
        if i < 3:
            assert abs(c_int) < (1 << 131)
            cw = b.new_wire(c_int + OFF)
            b.bits_of(cw, 132)
            c_lc = b.sub(cw, b.const(OFF))
            b.assert_eq(
                b.add(D[i], carry_prev), b.scale(c_lc, 1 << FLIMB)
            )
            carry_prev = c_lc
        else:
            assert c_int == 0
            b.assert_eq(b.add(D[i], carry_prev), {})
    return out
