"""Nova IVC with the fold verifier IN-CIRCUIT over the BN254/grumpkin cycle.

This completes the recursion the reference gets from the nova-snark crate
(`zk_prover/examples/nova_incremental_verifier.rs:170-198`): every step's
augmented circuit embeds the NIFS fold verifier, so the chain carries ONE
pair of running accumulators and the final proof size and verification
time are independent of the number of steps N — unlike `models/nova_fold`,
whose chain verifier replays N instance folds.

Construction (the Nova paper's two-circuit cycle, concretely):

- Primary R1CS over F1 = Fr. Witness vectors over Fr are Pedersen-
  committed on E1 = BN254 G1 (scalar field Fr); commitment coordinates
  live in Fq — native to the SECONDARY circuit.
- Secondary R1CS over F2 = Fq. Witnesses committed on E2 = grumpkin
  (scalar field Fq); coordinates live in Fr — native to the PRIMARY
  circuit.
- The primary augmented circuit C1 folds secondary instances (native
  grumpkin point ops + 3-limb foreign folds of the Fq scalar parts),
  runs the application step F (the incremental MST-inclusion step,
  `zk_prover/src/circom/incremental_mst_inclusion.circom:36-77`), and
  outputs the chain hash h1 = H1(pp, i, z0, z_i, U2_i, h2_{i-1}).
- The secondary augmented circuit C2 folds primary instances (native
  BN254 point ops over Fq + foreign folds of the Fr scalars) and outputs
  h2 = H2(pp, i, U1_i, h1_i).
- Cross-field hash binding: each circuit checks that the fresh partner
  instance's public IO equals the hash value it carries (h values are
  produced in the partner's field but all hashes are < min(r, q) by
  canonical 250-bit truncation, so they embed in both fields).

Final verification (O(|C|), N-independent): recompute both chain hashes,
check both running relaxed instances against their full witnesses and the
last fresh secondary instance strictly, and verify all Pedersen
commitments. Challenges are 125-bit truncated Poseidon outputs with
CANONICAL in-circuit bit decomposition (a non-canonical decomposition of
a field element would let a prover flip the truncated challenge).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import curve as C1ops
from ..ops import grumpkin as C2ops
from ..ops.field import FQ_MOD, FR_MOD
from . import r1cs_dsl as D
from .r1cs_dsl import LC, Builder, PointVar, R1CSSystem

F1 = FR_MOD  # primary circuit field (= grumpkin coordinate field)
F2 = FQ_MOD  # secondary circuit field (= BN254 G1 coordinate field)

CHALLENGE_BITS = 125
HASH_BITS = 250  # chain hashes truncated to fit both fields

# Poseidon RO instances (t=3, rate 2) over each field
_PP1 = None
_PP2 = None


def _ro_params():
    global _PP1, _PP2
    if _PP1 is None:
        _PP1 = D.poseidon_params(F1, 3, 8, 57)
        _PP2 = D.poseidon_params(F2, 3, 8, 57)
    return _PP1, _PP2


# ---------------------------------------------------------------------------
# Generic host-side curve adapters
# ---------------------------------------------------------------------------


class _E1:
    """BN254 G1 (affine int tuples, None = identity)."""

    add = staticmethod(C1ops.g1_add)
    mul = staticmethod(C1ops.g1_mul)
    field = F2  # coordinate field

    @staticmethod
    def msm(points, scalars):
        return C1ops.g1_msm_pippenger(points, scalars)


class _E2:
    add = staticmethod(C2ops.add)
    mul = staticmethod(C2ops.mul)
    field = F1

    @staticmethod
    def msm(points, scalars):
        return _pippenger(C2ops, points, scalars)


def _pippenger(ops, points, scalars, window: int = 8):
    pairs = [
        (p, s % ops.ORDER)
        for p, s in zip(points, scalars)
        if p is not None and s % ops.ORDER
    ]
    if not pairs:
        return None
    nbits = max(ops.ORDER.bit_length(), 1)
    nwin = (nbits + window - 1) // window
    mask = (1 << window) - 1
    acc = None
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(window):
                acc = ops.double(acc)
        buckets = [None] * (1 << window)
        shift = w * window
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = ops.add(buckets[d], p)
        running = None
        total = None
        for bi in range(len(buckets) - 1, 0, -1):
            running = ops.add(running, buckets[bi])
            total = ops.add(total, running)
        acc = ops.add(acc, total)
    return acc


def pedersen_bases_e1(n: int):
    from .nova_fold import pedersen_bases

    return pedersen_bases(n)


def pedersen_bases_e2(n: int):
    return [
        C2ops.hash_to_point(b"nova-cycle-e2" + i.to_bytes(8, "big"))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# Relaxed R1CS instances over the DSL's R1CSSystem
# ---------------------------------------------------------------------------


@dataclass
class Instance:
    com_w: object  # point on the committing curve (None = identity)
    com_e: object
    u: int        # scalar in the R1CS field
    x: list       # public IO (length 1 here: the chain hash)


@dataclass
class Witness:
    w: list  # private wires (full wire vector minus [1] and public IO)
    e: list  # error vector (len = #constraints)


def default_instance() -> Instance:
    return Instance(None, None, 0, [0])


def _z_vec(inst: Instance, w: list) -> list:
    return [inst.u] + list(inst.x) + list(w)


def _matvecs(sys: R1CSSystem, z: list):
    p = sys.modulus

    def ev(lc):
        return sum(z[wi] * c for wi, c in lc.items()) % p

    az = [ev(a) for a, _, _ in sys.constraints]
    bz = [ev(b) for _, b, _ in sys.constraints]
    cz = [ev(c) for _, _, c in sys.constraints]
    return az, bz, cz


def relaxed_satisfied(sys: R1CSSystem, inst: Instance, wit: Witness,
                      bases_w, bases_e, curve) -> bool:
    p = sys.modulus
    az, bz, cz = _matvecs(sys, _z_vec(inst, wit.w))
    for i in range(len(az)):
        if az[i] * bz[i] % p != (inst.u * cz[i] + wit.e[i]) % p:
            return False
    if curve.msm(bases_w[: len(wit.w)], wit.w) != inst.com_w:
        return False
    if curve.msm(bases_e[: len(wit.e)], wit.e) != inst.com_e:
        return False
    return True


def strict_satisfied(sys: R1CSSystem, inst: Instance, wit: Witness,
                     bases_w, bases_e, curve) -> bool:
    return (
        inst.u == 1
        and inst.com_e is None
        and all(v == 0 for v in wit.e)
        and relaxed_satisfied(sys, inst, wit, bases_w, bases_e, curve)
    )


def make_strict(sys: R1CSSystem, witness_full: list, bases_w, curve):
    """Full wire vector → (Instance, Witness) strict pair."""
    npub = sys.num_public
    x = witness_full[1 : 1 + npub]
    w = witness_full[1 + npub :]
    com_w = curve.msm(bases_w[: len(w)], w)
    return (
        Instance(com_w, None, 1, x),
        Witness(w, [0] * len(sys.constraints)),
    )


# ---------------------------------------------------------------------------
# Host NIFS (must match the in-circuit fold bit-for-bit)
# ---------------------------------------------------------------------------


def _cross_term(sys: R1CSSystem, i1: Instance, w1: Witness,
                i2: Instance, w2: Witness) -> list:
    p = sys.modulus
    z1 = _z_vec(i1, w1.w)
    z2 = _z_vec(i2, w2.w)
    a1, b1, c1 = _matvecs(sys, z1)
    a2, b2, c2 = _matvecs(sys, z2)
    return [
        (a1[i] * b2[i] + a2[i] * b1[i] - i1.u * c2[i] - i2.u * c1[i]) % p
        for i in range(len(a1))
    ]


def _ro_absorb_instance(inst: Instance, coord_field: int) -> list[int]:
    """Flatten an instance for the RO over the circuit field the fold runs
    in: point coords are native; u and x (partner-field scalars) go in as
    3×85-bit limbs. Must match the circuit's absorb order exactly."""

    def pt(pp):
        if pp is None:
            return [0, 0, 1]
        return [pp[0], pp[1], 0]

    def limbs(v):
        return [(v >> (D.FLIMB * i)) & D.FMASK for i in range(3)]

    return (
        pt(inst.com_w) + pt(inst.com_e) + limbs(inst.u) + limbs(inst.x[0])
    )


def _fold_challenge(field: int, pp_digest: int, U: Instance, u: Instance,
                    com_t) -> int:
    pp1, pp2 = _ro_params()
    ro = pp1 if field == F1 else pp2

    def pt(p):
        return [0, 0, 1] if p is None else [p[0], p[1], 0]

    msg = (
        [pp_digest]
        + _ro_absorb_instance(U, field)
        + _ro_absorb_instance(u, field)
        + pt(com_t)
    )
    h = D.poseidon_sponge_host(ro, msg)
    return h & ((1 << CHALLENGE_BITS) - 1)


def nifs_fold_host(sys: R1CSSystem, bases_e, curve, pp_digest: int,
                   U: Instance, W: Witness, u: Instance, w: Witness):
    """Fold strict (u, w) into running (U, W); returns (U', W', com_T, r)."""
    p = sys.modulus
    t_vec = _cross_term(sys, U, W, u, w)
    com_t = curve.msm(bases_e[: len(t_vec)], t_vec)
    r = _fold_challenge(curve.field, pp_digest, U, u, com_t)
    U2 = Instance(
        curve.add(U.com_w, curve.mul(u.com_w, r)),
        curve.add(U.com_e, curve.mul(com_t, r)),
        (U.u + r * u.u) % p,
        [(U.x[i] + r * u.x[i]) % p for i in range(len(U.x))],
    )
    W2 = Witness(
        [(W.w[i] + r * w.w[i]) % p for i in range(len(W.w))],
        [(W.e[i] + r * t_vec[i]) % p for i in range(len(W.e))],
    )
    return U2, W2, com_t, r


# ---------------------------------------------------------------------------
# In-circuit gadget: canonical bit decomposition + truncation
# ---------------------------------------------------------------------------


def canonical_bits(b: Builder, lc: LC, nbits: int = 254) -> list[LC]:
    """Bit-decompose with a canonicality proof (value-as-bits < field
    modulus), so the decomposition — and any truncation of it — is unique.
    Without this, elements < 2^254 − p admit two decompositions and a
    malicious prover could flip truncated challenge/hash bits."""
    bits = b.bits_of(lc, nbits)
    # recompose into 3×85 limb LCs and compare against p−1
    limbs = []
    for li in range(3):
        seg = bits[li * D.FLIMB : (li + 1) * D.FLIMB]
        limbs.append(b.sum(b.scale(bit, 1 << j) for j, bit in enumerate(seg)))
    v = b.eval(lc)
    D._assert_lt_const(b, tuple(limbs), v, b.p)
    return bits


def _recompose(b: Builder, bits: list[LC]) -> LC:
    return b.sum(b.scale(bit, 1 << i) for i, bit in enumerate(bits))


# ---------------------------------------------------------------------------
# In-circuit NIFS fold verifier
# ---------------------------------------------------------------------------


@dataclass
class InstanceVar:
    com_w: PointVar
    com_e: PointVar
    u: tuple  # 3-limb foreign
    x: tuple  # 3-limb foreign (single public IO)

    @staticmethod
    def alloc(b: Builder, inst: Instance, m: int) -> "InstanceVar":
        return InstanceVar(
            PointVar.alloc(b, inst.com_w),
            PointVar.alloc(b, inst.com_e),
            D.alloc_foreign(b, inst.u, m),
            D.alloc_foreign(b, inst.x[0], m),
        )

    def absorb(self, b: Builder) -> list[LC]:
        return (
            [self.com_w.x, self.com_w.y, self.com_w.inf,
             self.com_e.x, self.com_e.y, self.com_e.inf]
            + list(self.u) + list(self.x)
        )


def nifs_fold_circuit(
    b: Builder,
    ro: D.PoseidonParams,
    m_foreign: int,
    pp_digest: LC,
    U: InstanceVar,
    u: InstanceVar,
    com_t: PointVar,
) -> tuple[InstanceVar, LC]:
    """Verify one fold natively: derive r from the in-circuit RO, combine
    commitments by EC scalar mul, fold the foreign scalars by limb
    arithmetic. Returns (U', r)."""
    msg = [pp_digest] + U.absorb(b) + u.absorb(b) + [
        com_t.x, com_t.y, com_t.inf
    ]
    h = D.poseidon_sponge_circuit(b, ro, msg)
    hbits = canonical_bits(b, h)
    rbits = hbits[:CHALLENGE_BITS]
    r_lc = _recompose(b, rbits)
    r_val = b.eval(r_lc)

    com_w2 = D.ec_add(b, U.com_w, D.ec_scalar_mul(b, rbits, u.com_w))
    com_e2 = D.ec_add(b, U.com_e, D.ec_scalar_mul(b, rbits, com_t))
    u2 = D.foreign_fold(b, m_foreign, U.u, u.u, r_lc, r_val)
    x2 = D.foreign_fold(b, m_foreign, U.x, u.x, r_lc, r_val)
    return InstanceVar(com_w2, com_e2, u2, x2), r_lc


# ---------------------------------------------------------------------------
# Application step F — the incremental MST-inclusion step over F1
# (`zk_prover/src/circom/incremental_mst_inclusion.circom:36-77`)
# ---------------------------------------------------------------------------


def _circom_poseidon(b: Builder, inputs: list[LC]) -> LC:
    """circomlib Poseidon(nInputs) on the DSL builder — bit-identical to
    ops.poseidon_circom.hash_n (state [0, inputs...], output state[0])."""
    from ..ops import poseidon_circom as PC

    t = len(inputs) + 1
    rc, mds = PC.params(t)
    r_p = PC.N_ROUNDS_P[t - 2]

    def ark(state, r):
        return [b.add(s, b.const(rc[r][i])) for i, s in enumerate(state)]

    def mix(state):
        return [
            b.sum(b.scale(state[j], mds[i][j]) for j in range(t))
            for i in range(t)
        ]

    def sbox(x):
        x2 = b.mul(x, x)
        x4 = b.mul(x2, x2)
        return b.mul(x4, x)

    state: list[LC] = [b.const(0)] + list(inputs)
    ri = 0
    for _ in range(PC.R_F // 2):
        state = mix([sbox(s) for s in ark(state, ri)])
        ri += 1
    for _ in range(r_p):
        s = ark(state, ri)
        state = mix([sbox(s[0])] + s[1:])
        ri += 1
    for _ in range(PC.R_F // 2):
        state = mix([sbox(s) for s in ark(state, ri)])
        ri += 1
    return state[0]


def _step_mst(b: Builder, step_in: list[LC], proof, n_bytes: int = 14):
    """In-circuit incremental step: verify the circom MST inclusion and
    advance (user_state, liab_state). Returns [user_state', liab_state']."""
    from ..merkle import circom_mst as CM

    levels = len(proof.path_indices)
    ncur = len(proof.user_balances)

    username = b.new_wire(CM.big_intify_username(proof.username))
    user_bals = [b.new_wire(v) for v in proof.user_balances]
    path_hashes = [b.new_wire(v) for v in proof.path_element_hashes]
    path_bals = [
        [b.new_wire(v) for v in row] for row in proof.path_element_balances
    ]
    path_bits = [b.new_wire(v) for v in proof.path_indices]

    leaf_hash = _circom_poseidon(b, [username] + user_bals)
    user_state_next = _circom_poseidon(b, [step_in[0], leaf_hash])

    cur_hash, cur_bals = leaf_hash, list(user_bals)
    for i in range(levels):
        summed = []
        for j in range(ncur):
            b.bits_of(cur_bals[j], 8 * n_bytes)
            b.bits_of(path_bals[i][j], 8 * n_bytes)
            summed.append(b.add(cur_bals[j], path_bals[i][j]))
        s = path_bits[i]
        b.assert_bool(s)
        left_hash = b.select(s, path_hashes[i], cur_hash)
        right_hash = b.select(s, cur_hash, path_hashes[i])
        left_bals = [
            b.select(s, path_bals[i][j], cur_bals[j]) for j in range(ncur)
        ]
        right_bals = [
            b.select(s, cur_bals[j], path_bals[i][j]) for j in range(ncur)
        ]
        cur_hash = _circom_poseidon(
            b, [left_hash] + left_bals + [right_hash] + right_bals
        )
        cur_bals = summed
    for j in range(ncur):
        b.bits_of(cur_bals[j], 8 * n_bytes)

    liab_state_next = _circom_poseidon(b, [step_in[1], cur_hash])
    return [user_state_next, liab_state_next]


# ---------------------------------------------------------------------------
# Chain hashes (host side; circuits compute the identical values)
# ---------------------------------------------------------------------------


def _truncate(h: int) -> int:
    return h & ((1 << HASH_BITS) - 1)


def chain_hash1(ppd: int, i: int, z0, z_i, U2: Instance, h2_prev: int) -> int:
    pp1, _ = _ro_params()
    msg = (
        [ppd, i] + list(z0) + list(z_i)
        + _ro_absorb_instance(U2, F1) + [h2_prev]
    )
    return _truncate(D.poseidon_sponge_host(pp1, msg))


def chain_hash2(ppd: int, i: int, U1: Instance, h1_i: int) -> int:
    _, pp2 = _ro_params()
    msg = [ppd, i] + _ro_absorb_instance(U1, F2) + [h1_i]
    return _truncate(D.poseidon_sponge_host(pp2, msg))


def _trunc_circuit(b: Builder, h: LC) -> LC:
    bits = canonical_bits(b, h)
    return _recompose(b, bits[:HASH_BITS])


def _check_x_equals(b: Builder, xvar, h_lc: LC, gate: LC | None = None):
    """Assert the foreign public-IO limbs equal the native hash value
    (h < 2^250): decompose h into 250 bits, recompose per-limb, compare.
    Limb equality also pins the foreign value < 2^250 (top limb < 2^80).
    If `gate` given, the check is enforced only when gate == 1."""
    hbits = b.bits_of(h_lc, HASH_BITS)
    for li in range(3):
        seg = hbits[li * D.FLIMB : (li + 1) * D.FLIMB]
        want = b.sum(b.scale(bit, 1 << j) for j, bit in enumerate(seg))
        diff = b.sub(xvar[li], want)
        if gate is None:
            b.assert_zero(diff)
        else:
            b.assert_mul(gate, diff, {})


def _assert_default_when(b: Builder, gate: LC, inst: InstanceVar):
    """gate == 1 ⇒ inst is the default instance (identity coms, u=x=0)."""
    for pt in (inst.com_w, inst.com_e):
        b.assert_mul(gate, b.sub(b.const(1), pt.inf), {})
    for limb in list(inst.u) + list(inst.x):
        b.assert_mul(gate, limb, {})


# ---------------------------------------------------------------------------
# Augmented circuits
# ---------------------------------------------------------------------------

E1_B = 3             # BN254: y² = x³ + 3 (over F2)
E2_B = (-17) % F1    # grumpkin: y² = x³ − 17 (over F1)


def synthesize_primary(
    ppd: int,
    i: int,
    z0,
    z_prev,
    step_proof,
    U2_prev: Instance,
    u2_prev: Instance,
    com_t2,
    h2_prev: int,
):
    """C1 over F1: fold (U2_prev, u2_prev) → U2_i, run F, output h1_i.
    Returns (R1CSSystem, witness_full, U2_i_value, h1_i, z_i)."""
    pp1, _ = _ro_params()
    b = Builder(F1)
    out_w = b.new_wire(0)  # public X[0] = h1_i, patched at the end
    b.public.append(1)

    i_w = b.new_wire(i)
    z0_w = [b.new_wire(v) for v in z0]
    zp_w = [b.new_wire(v) for v in z_prev]
    base = b.is_zero(b.sub(i_w, b.const(1)))
    for j in range(2):
        b.assert_mul(base, b.sub(zp_w[j], z0_w[j]), {})

    U2v = InstanceVar.alloc(b, U2_prev, F2)
    u2v = InstanceVar.alloc(b, u2_prev, F2)
    Tv = PointVar.alloc(b, com_t2)
    for pt in (u2v.com_w, Tv):
        D.ec_assert_on_curve(b, E2_B, pt)
    _assert_default_when(b, base, U2v)
    _assert_default_when(b, base, u2v)
    b.assert_mul(base, b.sub(b.const(1), Tv.inf), {})

    h2_w = b.new_wire(h2_prev)
    b.assert_mul(base, h2_w, {})  # base ⇒ h2_prev = 0
    _check_x_equals(b, u2v.x, h2_w)

    ppd_w = b.new_wire(ppd)
    U2n, _r = nifs_fold_circuit(b, pp1, F2, ppd_w, U2v, u2v, Tv)

    z_out = _step_mst(b, zp_w, step_proof)

    msg = (
        [ppd_w, i_w] + z0_w + z_out + U2n.absorb(b) + [h2_w]
    )
    h1_full = D.poseidon_sponge_circuit(b, pp1, msg)
    h1_t = _trunc_circuit(b, h1_full)
    b.values[1] = b.eval(h1_t)
    b.assert_eq({1: 1}, h1_t)

    sys_, wit = b.finish()
    U2_val = Instance(
        U2n.com_w.value(b), U2n.com_e.value(b),
        D.foreign_value(b, U2n.u), [D.foreign_value(b, U2n.x)],
    )
    return sys_, wit, U2_val, b.eval(h1_t), [b.eval(z) for z in z_out]


def synthesize_secondary(
    ppd: int,
    i: int,
    U1_prev: Instance,
    u1: Instance,
    com_t1,
    h1_i: int,
):
    """C2 over F2: fold (U1_prev, u1) → U1_i, output h2_i.
    Returns (R1CSSystem, witness_full, U1_i_value, h2_i)."""
    _, pp2 = _ro_params()
    b = Builder(F2)
    out_w = b.new_wire(0)
    b.public.append(1)

    i_w = b.new_wire(i)
    base = b.is_zero(b.sub(i_w, b.const(1)))

    U1v = InstanceVar.alloc(b, U1_prev, F1)
    u1v = InstanceVar.alloc(b, u1, F1)
    Tv = PointVar.alloc(b, com_t1)
    for pt in (u1v.com_w, Tv):
        D.ec_assert_on_curve(b, E1_B, pt)
    _assert_default_when(b, base, U1v)

    h1_w = b.new_wire(h1_i)
    _check_x_equals(b, u1v.x, h1_w)

    ppd_w = b.new_wire(ppd)
    U1n, _r = nifs_fold_circuit(b, pp2, F1, ppd_w, U1v, u1v, Tv)

    msg = [ppd_w, i_w] + U1n.absorb(b) + [h1_w]
    h2_full = D.poseidon_sponge_circuit(b, pp2, msg)
    h2_t = _trunc_circuit(b, h2_full)
    b.values[1] = b.eval(h2_t)
    b.assert_eq({1: 1}, h2_t)

    sys_, wit = b.finish()
    U1_val = Instance(
        U1n.com_w.value(b), U1n.com_e.value(b),
        D.foreign_value(b, U1n.u), [D.foreign_value(b, U1n.x)],
    )
    return sys_, wit, U1_val, b.eval(h2_t)


# ---------------------------------------------------------------------------
# IVC driver + final verifier
# ---------------------------------------------------------------------------


@dataclass
class IVCParams:
    ppd: int
    sys1: R1CSSystem
    sys2: R1CSSystem
    bases_w1: list
    bases_e1: list
    bases_w2: list
    bases_e2: list


@dataclass
class IVCProof:
    """O(1)-size (in N) chain proof: two running accumulators with full
    witnesses + the last fresh instances + one carried chain hash."""

    n: int
    z0: list
    z_n: list
    U1: Instance
    W1: Witness
    U2: Instance
    W2: Witness
    u1: Instance
    u2: Instance
    w2: Witness
    h2_prev: int  # h2_{N-1}, absorbed by C1 at step N


class NovaCycleIVC:
    """Drive the chain: one (C1, C2) pair per step, both running
    accumulators folded in-circuit."""

    def __init__(self, params: IVCParams):
        self.p = params

    @staticmethod
    def setup(sample_step_proof, z0, ppd: int = 0x6e6f7661) -> "IVCParams":
        """Synthesize both circuits once on sample data to size the
        Pedersen bases (shapes are witness-independent)."""
        d2 = default_instance()
        sys1, wit1, _, h1, z1 = synthesize_primary(
            ppd, 1, z0, z0, sample_step_proof, d2, d2, None, 0
        )
        u1 = Instance(None, None, 1, [h1])
        w1 = Witness(wit1[2:], [0] * len(sys1.constraints))
        sys2, wit2, _, _ = synthesize_secondary(
            ppd, 1, default_instance(), u1, None, h1
        )
        nb1 = max(len(wit1), len(sys1.constraints)) + 1
        nb2 = max(len(wit2), len(sys2.constraints)) + 1
        return IVCParams(
            ppd, sys1, sys2,
            pedersen_bases_e1(nb1), pedersen_bases_e1(nb1),
            pedersen_bases_e2(nb2), pedersen_bases_e2(nb2),
        )

    def prove_chain(self, z0, step_proofs) -> IVCProof:
        p = self.p
        U1, W1 = default_instance(), Witness(
            [0] * (p.sys1.num_wires - 2), [0] * len(p.sys1.constraints)
        )
        U2, W2 = default_instance(), Witness(
            [0] * (p.sys2.num_wires - 2), [0] * len(p.sys2.constraints)
        )
        u2, w2 = default_instance(), Witness(
            [0] * (p.sys2.num_wires - 2), [0] * len(p.sys2.constraints)
        )
        h2_prev_for_c1 = 0  # h2_{i-1} value C1 carries
        h2_prev_out = 0     # value to expose in the final proof
        z_prev = list(z0)
        u1 = None

        for idx, sp in enumerate(step_proofs):
            i = idx + 1
            # cross term for the secondary fold C1 will verify
            t2 = _cross_term(p.sys2, U2, W2, u2, w2)
            com_t2 = _E2.msm(p.bases_e2[: len(t2)], t2)

            sys1, wit1, U2_new, h1_i, z_i = synthesize_primary(
                p.ppd, i, z0, z_prev, sp, U2, u2, com_t2, h2_prev_for_c1
            )
            assert len(sys1.constraints) == len(p.sys1.constraints), (
                "primary circuit shape drifted between steps"
            )
            u1_i, w1_i = make_strict(sys1, wit1, p.bases_w1, _E1)

            # host-side secondary fold must land exactly on the circuit's
            U2_host, W2_host, _, _ = nifs_fold_host(
                p.sys2, p.bases_e2, _E2, p.ppd, U2, W2, u2, w2
            )
            assert (U2_host.com_w, U2_host.com_e, U2_host.u, U2_host.x) == (
                U2_new.com_w, U2_new.com_e, U2_new.u, U2_new.x
            ), "host/circuit secondary fold mismatch"
            U2, W2 = U2_host, W2_host

            # primary fold (verified by C2)
            t1 = _cross_term(p.sys1, U1, W1, u1_i, w1_i)
            com_t1 = _E1.msm(p.bases_e1[: len(t1)], t1)
            sys2, wit2, U1_new, h2_i = synthesize_secondary(
                p.ppd, i, U1, u1_i, com_t1, h1_i
            )
            assert len(sys2.constraints) == len(p.sys2.constraints), (
                "secondary circuit shape drifted between steps"
            )
            u2_i, w2_i = make_strict(sys2, wit2, p.bases_w2, _E2)

            U1_host, W1_host, _, _ = nifs_fold_host(
                p.sys1, p.bases_e1, _E1, p.ppd, U1, W1, u1_i, w1_i
            )
            assert (U1_host.com_w, U1_host.com_e, U1_host.u, U1_host.x) == (
                U1_new.com_w, U1_new.com_e, U1_new.u, U1_new.x
            ), "host/circuit primary fold mismatch"
            U1, W1 = U1_host, W1_host

            h2_prev_out = h2_prev_for_c1
            h2_prev_for_c1 = h2_i
            u1, u2, w2 = u1_i, u2_i, w2_i
            z_prev = z_i

        return IVCProof(
            len(step_proofs), list(z0), z_prev,
            U1, W1, U2, W2, u1, u2, w2, h2_prev_out,
        )

    def verify_chain(self, proof: IVCProof) -> bool:
        p = self.p
        if proof.n < 1:
            return False
        # 1. chain-hash bindings
        h1_n = chain_hash1(
            p.ppd, proof.n, proof.z0, proof.z_n, proof.U2, proof.h2_prev
        )
        if proof.u1.x[0] != h1_n:
            return False
        h2_n = chain_hash2(p.ppd, proof.n, proof.U1, h1_n)
        if proof.u2.x[0] != h2_n:
            return False
        # 2. accumulator satisfaction (O(|C|), independent of N)
        if not relaxed_satisfied(
            p.sys1, proof.U1, proof.W1, p.bases_w1, p.bases_e1, _E1
        ):
            return False
        if not relaxed_satisfied(
            p.sys2, proof.U2, proof.W2, p.bases_w2, p.bases_e2, _E2
        ):
            return False
        # 3. the last secondary step (which folded u1 into U1) — strict
        if not strict_satisfied(
            p.sys2, proof.u2, proof.w2, p.bases_w2, p.bases_e2, _E2
        ):
            return False
        return True


# ---------------------------------------------------------------------------
# CompressedSNARK over the cycle's final accumulators (Spartan + IPA-PC)
#
# The reference compresses its RecursiveSNARK with
# ``CompressedSNARK::prove`` — Spartan relaxed-R1CS SNARKs over BOTH sides
# of the cycle (`zk_prover/examples/nova_incremental_verifier.rs:199-226`,
# nova-snark's (S1, S2) type parameters). Here the generic machinery of
# ``models/spartan`` is instantiated twice: Fr/BN254-G1 for the primary
# accumulator and Fq/grumpkin for the secondary + last fresh secondary —
# replacing ``IVCProof``'s three O(|C|) witness reveals with three
# O(log|C|) proofs. Chain-hash bindings are unchanged from verify_chain.
# ---------------------------------------------------------------------------


def _spartan_view(sys: R1CSSystem):
    """circom_r1cs.R1CS-shaped adapter over a DSL system (the input shape
    ``models/spartan`` consumes): public wires 1..num_public as outputs."""
    from types import SimpleNamespace

    return SimpleNamespace(
        constraints=sys.constraints,
        n_wires=sys.num_wires,
        n_pub_out=sys.num_public,
        n_pub_in=0,
    )


def spartan_ctx_e1():
    """Fr-field Spartan with Pedersen commitments on BN254 G1."""
    from . import spartan as SP
    from .nova_fold import _hash_to_g1, _pt_bytes

    return SP.SpartanCtx(
        F1, _E1.add, _E1.mul, SP._msm, _pt_bytes,
        lambda: _hash_to_g1(b"nova-cycle-ipa-q1"),
    )


def spartan_ctx_e2():
    """Fq-field Spartan with Pedersen commitments on grumpkin."""
    from . import spartan as SP
    from .nova_fold import _pt_bytes

    return SP.SpartanCtx(
        F2, _E2.add, _E2.mul, _E2.msm, _pt_bytes,
        lambda: C2ops.hash_to_point(b"nova-cycle-ipa-q2"),
    )


_bases_cache: dict = {}


def _ipa_bases(side: int, n: int) -> list:
    """Deterministic Pedersen base prefix of length n for curve E<side>.

    The IPA pads vectors to the next power of two, which can exceed the
    base count sized at setup; bases are generated per index from the same
    seeds (``pedersen_bases_e1/e2``), so any prefix is consistent with the
    commitments already formed."""
    key = (side, n)
    hit = _bases_cache.get(key)
    if hit is None:
        hit = pedersen_bases_e1(n) if side == 1 else pedersen_bases_e2(n)
        _bases_cache[key] = hit
    return hit


def _pad_len(sys: R1CSSystem) -> int:
    from . import spartan as SP

    n_w = sys.num_wires - 1 - sys.num_public
    return max(SP._next_pow2(n_w), SP._next_pow2(len(sys.constraints)))


@dataclass
class CompressedIVCProof:
    """Chain proof with Spartan-compressed accumulators: no witness vector
    travels; size is O(log|C|), independent of N."""

    n: int
    z0: list
    z_n: list
    U1: Instance
    U2: Instance
    u1: Instance
    u2: Instance
    h2_prev: int
    pf1: object   # spartan.CompressedProof over (sys1, Fr, E1)
    pf2: object   # spartan.CompressedProof over (sys2, Fq, E2)
    pf_u2: object  # strict last secondary step, same instantiation

    def size_bytes(self) -> int:
        inst = 4 * (64 * 2 + 32 * 2)  # com_w/com_e + u + one x scalar
        return inst + 32 * 3 + sum(
            p.size_bytes() for p in (self.pf1, self.pf2, self.pf_u2)
        )


def compress_ivc(params: IVCParams, proof: IVCProof) -> CompressedIVCProof:
    """Replace the IVCProof's three witness reveals with Spartan proofs."""
    from . import spartan as SP

    c1, c2 = spartan_ctx_e1(), spartan_ctx_e2()
    v1, v2 = _spartan_view(params.sys1), _spartan_view(params.sys2)
    b1 = _ipa_bases(1, _pad_len(params.sys1))
    b2 = _ipa_bases(2, _pad_len(params.sys2))
    pf1 = SP.compress(v1, proof.U1, SP.RelaxedWitness(proof.W1.w, proof.W1.e),
                      b1, c1)
    pf2 = SP.compress(v2, proof.U2, SP.RelaxedWitness(proof.W2.w, proof.W2.e),
                      b2, c2)
    pf_u2 = SP.compress(v2, proof.u2,
                        SP.RelaxedWitness(proof.w2.w, proof.w2.e), b2, c2)
    return CompressedIVCProof(
        proof.n, list(proof.z0), list(proof.z_n),
        proof.U1, proof.U2, proof.u1, proof.u2, proof.h2_prev,
        pf1, pf2, pf_u2,
    )


def verify_ivc_compressed(params: IVCParams, cp: CompressedIVCProof) -> bool:
    """``verify_chain`` with the O(|C|) witness checks replaced by the three
    compressed relaxed-SAT proofs. Work: O(nnz + n) group/field ops,
    independent of the chain length N."""
    from . import spartan as SP

    if cp.n < 1:
        return False
    # 1. chain-hash bindings (identical to verify_chain)
    h1_n = chain_hash1(params.ppd, cp.n, cp.z0, cp.z_n, cp.U2, cp.h2_prev)
    if cp.u1.x[:1] != [h1_n]:
        return False
    h2_n = chain_hash2(params.ppd, cp.n, cp.U1, h1_n)
    if cp.u2.x[:1] != [h2_n]:
        return False
    c1, c2 = spartan_ctx_e1(), spartan_ctx_e2()
    v1, v2 = _spartan_view(params.sys1), _spartan_view(params.sys2)
    b1 = _ipa_bases(1, _pad_len(params.sys1))
    b2 = _ipa_bases(2, _pad_len(params.sys2))
    nw1 = params.sys1.num_wires - 1 - params.sys1.num_public
    nw2 = params.sys2.num_wires - 1 - params.sys2.num_public
    # 2. accumulator satisfaction, compressed
    if not SP.verify_compressed(v1, cp.U1, cp.pf1, b1, n_w=nw1, ctx=c1):
        return False
    if not SP.verify_compressed(v2, cp.U2, cp.pf2, b2, n_w=nw2, ctx=c2):
        return False
    # 3. the last secondary step must be STRICT: u = 1 and com_e = identity
    # (Pedersen binding forces E = 0, so the relaxed identity degenerates
    # to plain R1CS satisfaction)
    if cp.u2.u != 1 or cp.u2.com_e is not None:
        return False
    return SP.verify_compressed(v2, cp.u2, cp.pf_u2, b2, n_w=nw2, ctx=c2)
