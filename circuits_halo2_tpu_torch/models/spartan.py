"""CompressedSNARK over the folded Nova accumulator — Spartan + IPA-PC.

The reference finishes its IVC chain with a ``CompressedSNARK`` whose
concrete instantiation is Spartan's sumcheck-based R1CS SNARK with the
Bulletproofs inner-product argument as polynomial commitment
(`zk_prover/examples/nova_incremental_verifier.rs:199-226`, nova-snark's
``RelaxedR1CSSNARK<G, EvaluationEngine>``). This module is the native
equivalent over the committed *relaxed* R1CS of ``models/nova_fold``:

after ``fold_chain`` collapses N step proofs into one relaxed accumulator
(com_W, com_E, u, x), ``compress`` replaces the O(|C|)-size witness reveal
(``relaxed_check``) with an O(log|C|)-size proof:

1. **Sumcheck #1** (degree 3/var): 0 = Σ_i eq(τ,i)·(Az·Bz − u·Cz − E)(i)
   — the relaxed-R1CS satisfaction identity batched by a random τ.
2. **Sumcheck #2** (degree 2/var): the matrix-vector reduction — the
   claimed Ã(r_x), B̃(r_x), C̃(r_x) evaluations collapse (batched by
   rA, rB, rC) to one claim  M̃(r_x, r_y)·z̃(r_y), where the verifier
   evaluates the sparse matrix MLE M̃ itself (O(nnz), N-independent).
3. **IPA openings**: z̃(r_y)'s private part ⟨W, eq-slice⟩ and Ẽ(r_x) =
   ⟨E, eq(r_x,·)⟩ are proven against the Pedersen commitments com_W /
   com_E with the log-round Bulletproofs argument (2·log n points + 1
   scalar each) — commitments never open.

Proof size: O(log|C|) field/group elements. Verify cost: O(nnz + n) —
one-time per circuit, independent of the chain length N. Together with
``verify_chain``'s O(1)-group-op instance folds this gives the
CompressedSNARK surface of the reference (the remaining delta from full
Nova — the fold verifier inside an augmented circuit over a curve cycle —
is documented in models/nova_fold.py).

Fiat–Shamir is keccak over a labelled running transcript; all vectors are
zero-padded to power-of-two hypercubes (padding rows satisfy the identity
trivially, padding wires contribute nothing to commitments).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..merkle.circom_r1cs import R1CS, P
from ..ops import curve as C
from ..ops.keccak import keccak256
from .nova_fold import RelaxedInstance, RelaxedWitness, _hash_to_g1, _pt_bytes


# ---------------------------------------------------------------------------
# Field/group context — the whole argument is generic over (scalar field,
# commitment group); the default instantiation is BN254 Fr with Pedersen
# commitments on G1 (the primary side of the reference's cycle). The
# grumpkin/Fq instantiation for the Nova cycle's secondary accumulator
# lives in models/nova_cycle (reference: nova-snark's generic `G: Group`
# parameter, `nova_incremental_verifier.rs:199-226`).
# ---------------------------------------------------------------------------


class SpartanCtx:
    """Scalar field + commitment group for one Spartan instantiation."""

    def __init__(self, p, g_add, g_mul, g_msm, pt_bytes, q_base):
        self.p = p                # scalar field modulus
        self.g_add = g_add        # group add (None = identity)
        self.g_mul = g_mul        # scalar mul
        self.g_msm = g_msm        # multi-scalar mul
        self.pt_bytes = pt_bytes  # 64-byte transcript encoding
        self._q_base = q_base     # thunk -> IPA cross-term base Q

    def q_base(self):
        q = self._q_base
        return q() if callable(q) else q


def _default_ctx() -> SpartanCtx:
    return SpartanCtx(
        P, C.g1_add, C.g1_mul, _msm, _pt_bytes, _q_base
    )


# ---------------------------------------------------------------------------
# Multilinear helpers (vectors indexed by {0,1}^k, little-endian bit order:
# index i's bit 0 is variable 0)
# ---------------------------------------------------------------------------

def _pow2_pad(v: list[int], n: int) -> list[int]:
    return list(v) + [0] * (n - len(v))


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def eq_point(r: list[int], s: list[int], p: int = P) -> int:
    """eq(r, s) = Π_j (r_j·s_j + (1−r_j)(1−s_j))."""
    acc = 1
    for rj, sj in zip(r, s):
        acc = acc * ((rj * sj + (1 - rj) * (1 - sj)) % p) % p
    return acc


def eq_evals_le(r: list[int], p: int = P) -> list[int]:
    """eq(r, ·) evals with little-endian index bits (bit j ↔ r[j]):
    out[i] = Π_j (r_j if bit_j(i) else 1−r_j). Block doubling keeps the
    already-processed variables in the LOW bits."""
    out = [1]
    for rj in r:
        nrj = (1 - rj) % p
        lo = [v * nrj % p for v in out]
        hi = [v * rj % p for v in out]
        out = lo + hi
    return out


def mle_eval(vec: list[int], r: list[int], p: int = P) -> int:
    """Evaluate the MLE of ``vec`` (length 2^len(r)) at point r.
    Folds variable 0 (the low index bit) first."""
    cur = [v % p for v in vec]
    for rj in r:
        half = len(cur) // 2
        cur = [
            (cur[2 * i] + rj * (cur[2 * i + 1] - cur[2 * i])) % p
            for i in range(half)
        ]
    return cur[0]


def _fold_once(vec: list[int], rj: int, p: int = P) -> list[int]:
    half = len(vec) // 2
    return [
        (vec[2 * i] + rj * (vec[2 * i + 1] - vec[2 * i])) % p
        for i in range(half)
    ]


def _lagrange_uni(evals: list[int], x: int, p: int = P) -> int:
    """Evaluate the degree-(len−1) polynomial through (i, evals[i]) at x."""
    d = len(evals)
    acc = 0
    for i in range(d):
        num, den = 1, 1
        for j in range(d):
            if j != i:
                num = num * ((x - j) % p) % p
                den = den * ((i - j) % p) % p
        acc = (acc + evals[i] * num % p * pow(den, -1, p)) % p
    return acc


# ---------------------------------------------------------------------------
# Fiat–Shamir transcript
# ---------------------------------------------------------------------------

class _FS:
    def __init__(self, label: bytes, p: int = P):
        self.p = p
        self.state = keccak256(b"spartan-relaxed" + label)

    def absorb(self, data: bytes):
        self.state = keccak256(self.state + data)

    def absorb_scalars(self, vals):
        self.absorb(b"".join((v % self.p).to_bytes(32, "big") for v in vals))

    def absorb_point(self, pt, pt_bytes=_pt_bytes):
        self.absorb(pt_bytes(pt))

    def challenge(self) -> int:
        self.state = keccak256(self.state + b"chal")
        return int.from_bytes(self.state, "big") % self.p


def _instance_digest(r1cs: R1CS, inst: RelaxedInstance,
                     ctx: SpartanCtx | None = None) -> bytes:
    ctx = ctx or _default_ctx()
    return keccak256(
        len(r1cs.constraints).to_bytes(8, "big")
        + r1cs.n_wires.to_bytes(8, "big")
        + ctx.pt_bytes(inst.com_w)
        + ctx.pt_bytes(inst.com_e)
        + (inst.u % ctx.p).to_bytes(32, "big")
        + b"".join((v % ctx.p).to_bytes(32, "big") for v in inst.x)
    )


# ---------------------------------------------------------------------------
# Bulletproofs inner-product argument (non-ZK, Fiat–Shamir)
# ---------------------------------------------------------------------------

_Q_BASE = None


def _q_base():
    global _Q_BASE
    if _Q_BASE is None:
        _Q_BASE = _hash_to_g1(b"spartan-ipa-q")
    return _Q_BASE


@dataclass
class IpaProof:
    lr: list  # [(L_i, R_i)] per round
    a_final: int


def _msm(points, scalars):
    """Host MSM via the port's native C++ Pippenger (``native.g1_msm``),
    built with g++ on first use."""
    from .. import native

    return native.g1_msm(points, [s % P for s in scalars])


def ipa_prove(fs: _FS, a: list[int], b: list[int], bases: list, value: int,
              ctx: SpartanCtx | None = None) -> IpaProof:
    """Prove ⟨a, b⟩ = value where com = Σ a_i·bases_i is already absorbed
    by the caller's transcript. a, b, bases: power-of-two length.

    The generator vector is never folded pointwise: round j's folded
    g-vector satisfies g_i = Σ_{k ≡ i (mod h)} w_k·G_k with per-base
    weights w_k = Π_t x_t^{±1}, so every L/R is ONE n-size MSM over the
    ORIGINAL bases — log n native MSMs instead of O(n) Python point muls."""
    ctx = ctx or _default_ctx()
    P_, add, mul, msm = ctx.p, ctx.g_add, ctx.g_mul, ctx.g_msm
    n = len(a)
    assert n == len(b) == len(bases) and n & (n - 1) == 0
    fs.absorb_scalars([value, n])
    q = ctx.q_base()
    a = [v % P_ for v in a]
    b = [v % P_ for v in b]
    w = [1] * n
    logn = n.bit_length() - 1
    lr = []
    for j in range(logn):
        h = len(a) // 2
        a_lo, a_hi = a[:h], a[h:]
        b_lo, b_hi = b[:h], b[h:]
        cl = sum(x * y for x, y in zip(a_lo, b_hi)) % P_
        cr = sum(x * y for x, y in zip(a_hi, b_lo)) % P_
        bit = logn - 1 - j
        # hi half of the current (folded) g = original indices with bit set
        v_l = [
            w[k] * a_lo[k & (h - 1)] % P_ if (k >> bit) & 1 else 0
            for k in range(n)
        ]
        v_r = [
            0 if (k >> bit) & 1 else w[k] * a_hi[k & (h - 1)] % P_
            for k in range(n)
        ]
        L = add(msm(bases, v_l), mul(q, cl))
        R = add(msm(bases, v_r), mul(q, cr))
        fs.absorb_point(L, ctx.pt_bytes)
        fs.absorb_point(R, ctx.pt_bytes)
        x = fs.challenge()
        xi = pow(x, -1, P_)
        a = [(lo * x + hi * xi) % P_ for lo, hi in zip(a_lo, a_hi)]
        b = [(lo * xi + hi * x) % P_ for lo, hi in zip(b_lo, b_hi)]
        w = [w[k] * (x if (k >> bit) & 1 else xi) % P_ for k in range(n)]
        lr.append((L, R))
    return IpaProof(lr, a[0])


def ipa_verify(fs: _FS, com, b: list[int], bases: list, value: int,
               proof: IpaProof, ctx: SpartanCtx | None = None) -> bool:
    """Verify ⟨a, b⟩ = value against com = Σ a_i·bases_i (com may be None =
    infinity, e.g. an all-zero committed vector)."""
    ctx = ctx or _default_ctx()
    P_, add, mul, msm = ctx.p, ctx.g_add, ctx.g_mul, ctx.g_msm
    n = len(b)
    if n & (n - 1) or n != len(bases) or len(proof.lr) != n.bit_length() - 1:
        return False
    fs.absorb_scalars([value, n])
    q = ctx.q_base()
    p_acc = add(com, mul(q, value % P_))
    xs = []
    for L, R in proof.lr:
        fs.absorb_point(L, ctx.pt_bytes)
        fs.absorb_point(R, ctx.pt_bytes)
        x = fs.challenge()
        xs.append(x)
        x2 = x * x % P_
        x2i = pow(x2, -1, P_)
        p_acc = add(p_acc, add(mul(L, x2), mul(R, x2i)))
    # s_i = Π_j x_j^{±1}: + if bit (log n − 1 − j) of i is set
    logn = n.bit_length() - 1
    xinvs = [pow(x, -1, P_) for x in xs]
    s = [1] * n
    for j in range(logn):
        bit = logn - 1 - j
        for i in range(n):
            s[i] = s[i] * (xs[j] if (i >> bit) & 1 else xinvs[j]) % P_
    b_final = sum(si * bi for si, bi in zip(s, b)) % P_
    g_final = msm(bases, s)
    a = proof.a_final % P_
    expect = add(mul(g_final, a), mul(q, a * b_final % P_))
    return expect == p_acc


# ---------------------------------------------------------------------------
# The compressed SNARK
# ---------------------------------------------------------------------------

@dataclass
class CompressedProof:
    sc1_polys: list          # per round: 4 evals (degree 3)
    v_a: int
    v_b: int
    v_c: int
    v_e: int
    sc2_polys: list          # per round: 3 evals (degree 2)
    w_eval: int              # ⟨W, eq-slice⟩ at r_y
    ipa_w: IpaProof
    ipa_e: IpaProof

    def size_bytes(self) -> int:
        pts = sum(len(p.lr) * 2 for p in (self.ipa_w, self.ipa_e))
        scalars = (
            sum(len(r) for r in self.sc1_polys)
            + sum(len(r) for r in self.sc2_polys)
            + 7
        )
        return pts * 64 + scalars * 32


def _matvecs_padded(r1cs: R1CS, z: list[int], m_pad: int, p: int = P):
    def ev(lc):
        return sum(z[wi] * c for wi, c in lc.items()) % p

    az = [ev(a) for a, _, _ in r1cs.constraints]
    bz = [ev(b) for _, b, _ in r1cs.constraints]
    cz = [ev(c) for _, _, c in r1cs.constraints]
    return (_pow2_pad(az, m_pad), _pow2_pad(bz, m_pad), _pow2_pad(cz, m_pad))


def _sumcheck_prove(fs: _FS, vecs: list[list[int]], combine, degree: int,
                    p: int = P):
    """Generic sumcheck prover over ``vecs`` (equal pow2 length), where the
    summand at index i is ``combine(*[v[i] for v in vecs])`` (degree ≤
    ``degree`` in each variable). Returns (round_polys, challenges, bound
    final values of each vec)."""
    cur = [list(v) for v in vecs]
    polys = []
    rs = []
    while len(cur[0]) > 1:
        half = len(cur[0]) // 2
        evals = []
        for t in range(degree + 1):
            acc = 0
            for i in range(half):
                pt = [
                    (v[2 * i] + t * (v[2 * i + 1] - v[2 * i])) % p
                    for v in cur
                ]
                acc = (acc + combine(*pt)) % p
            evals.append(acc)
        fs.absorb_scalars(evals)
        r = fs.challenge()
        rs.append(r)
        cur = [_fold_once(v, r, p) for v in cur]
        polys.append(evals)
    return polys, rs, [v[0] for v in cur]


def _sumcheck_verify(fs: _FS, claim: int, polys: list, degree: int,
                     p: int = P):
    """Replay a sumcheck transcript. Returns (final_claim, challenges) or
    (None, None) on failure."""
    rs = []
    e = claim % p
    for evals in polys:
        if len(evals) != degree + 1:
            return None, None
        if (evals[0] + evals[1]) % p != e:
            return None, None
        fs.absorb_scalars(evals)
        r = fs.challenge()
        rs.append(r)
        e = _lagrange_uni(evals, r, p)
    return e, rs


def _z_vector(r1cs: R1CS, inst: RelaxedInstance, w: list[int],
              p: int = P) -> list[int]:
    return [inst.u % p] + [v % p for v in inst.x] + [v % p for v in w]


def _matrix_mle_eval(r1cs: R1CS, eq_rx: list[int], eq_ry: list[int],
                     r_abc: tuple[int, int, int], p: int = P) -> int:
    """Σ over nonzero entries: (rA·A + rB·B + rC·C)[i][j] · eq_rx[i] ·
    eq_ry[j] — the verifier's O(nnz) sparse matrix-MLE evaluation."""
    ra, rb, rc = r_abc
    acc = 0
    for i, (a, b, c) in enumerate(r1cs.constraints):
        wi = eq_rx[i]
        row = 0
        for j, v in a.items():
            row = (row + ra * v % p * eq_ry[j]) % p
        for j, v in b.items():
            row = (row + rb * v % p * eq_ry[j]) % p
        for j, v in c.items():
            row = (row + rc * v % p * eq_ry[j]) % p
        acc = (acc + wi * row) % p
    return acc


def compress(
    r1cs: R1CS,
    inst: RelaxedInstance,
    wit: RelaxedWitness,
    bases: list,
    ctx: SpartanCtx | None = None,
) -> CompressedProof:
    """Produce the O(log|C|) proof that ``inst`` is a satisfiable committed
    relaxed R1CS instance (replaces shipping ``wit`` to the verifier).

    NOT zero-knowledge: the sumcheck round polynomials, ``w_eval``, and the
    IPA's final scalars reveal linear functions of the witness (user
    balances/hashes in the proof-of-solvency setting). This matches the
    reference's non-hiding nova-snark default (CompressedSNARK with
    Spartan+IPA-PC, `nova_incremental_verifier.rs:199-226`), but callers
    must not assume the compressed proof hides the witness; blinding the
    IPA would be required for a private deployment."""
    ctx = ctx or _default_ctx()
    p = ctx.p
    m_pad = _next_pow2(len(r1cs.constraints))
    mu = m_pad.bit_length() - 1
    z = _z_vector(r1cs, inst, wit.w, p)
    nz_pad = _next_pow2(len(z))
    nu = nz_pad.bit_length() - 1

    fs = _FS(_instance_digest(r1cs, inst, ctx), p)
    tau = [fs.challenge() for _ in range(mu)]

    az, bz, cz = _matvecs_padded(r1cs, z, m_pad, p)
    e_vec = _pow2_pad(wit.e, m_pad)
    eqt = eq_evals_le(tau, p)
    u = inst.u % p

    def comb1(eq_v, a_v, b_v, c_v, e_v):
        return eq_v * ((a_v * b_v - u * c_v - e_v) % p) % p

    sc1_polys, r_x, finals = _sumcheck_prove(
        fs, [eqt, az, bz, cz, e_vec], comb1, 3, p
    )
    _, v_a, v_b, v_c, v_e = finals
    fs.absorb_scalars([v_a, v_b, v_c, v_e])
    ra, rb, rc = fs.challenge(), fs.challenge(), fs.challenge()

    # phase 2: mv(y) = Σ_i eq(r_x, i)·(rA·A + rB·B + rC·C)[i][y]
    eq_rx = eq_evals_le(r_x, p)
    mv = [0] * nz_pad
    for i, (a, b, c) in enumerate(r1cs.constraints):
        wgt = eq_rx[i]
        for lc, rr in ((a, ra), (b, rb), (c, rc)):
            wr = wgt * rr % p
            for j, v in lc.items():
                mv[j] = (mv[j] + wr * v) % p
    zv = _pow2_pad(z, nz_pad)

    sc2_polys, r_y, finals2 = _sumcheck_prove(
        fs, [mv, zv], lambda m_v, z_v: m_v * z_v % p, 2, p
    )

    # openings: z̃(r_y) private part and Ẽ(r_x)
    eq_ry = eq_evals_le(r_y, p)
    npub = r1cs.n_pub_out + r1cs.n_pub_in
    w_pad_len = _next_pow2(len(wit.w))
    b_w = _pow2_pad(eq_ry[1 + npub : 1 + npub + len(wit.w)], w_pad_len)
    w_padded = _pow2_pad([v % p for v in wit.w], w_pad_len)
    w_eval = sum(a * b for a, b in zip(w_padded, b_w)) % p
    fs.absorb_scalars([w_eval])
    ipa_w = ipa_prove(fs, w_padded, b_w, bases[:w_pad_len], w_eval, ctx)

    e_pad_len = _next_pow2(len(wit.e))
    eq_rx_e = _pow2_pad(eq_rx[: len(wit.e)], e_pad_len)
    e_padded = _pow2_pad([v % p for v in wit.e], e_pad_len)
    # v_e is Ẽ(r_x) over the m_pad cube; restricted to the first len(e)
    # lanes it equals ⟨E, eq(r_x,·)⟩ because padding lanes are zero
    ipa_e = ipa_prove(fs, e_padded, eq_rx_e, bases[:e_pad_len], v_e, ctx)

    return CompressedProof(
        sc1_polys, v_a, v_b, v_c, v_e, sc2_polys, w_eval, ipa_w, ipa_e
    )


def verify_compressed(
    r1cs: R1CS,
    inst: RelaxedInstance,
    proof: CompressedProof,
    bases: list,
    n_w: int | None = None,
    ctx: SpartanCtx | None = None,
) -> bool:
    """Verify a compressed relaxed-SAT proof. O(nnz + n) work, independent
    of the chain length; the witness never travels."""
    ctx = ctx or _default_ctx()
    p = ctx.p
    m_pad = _next_pow2(len(r1cs.constraints))
    mu = m_pad.bit_length() - 1
    npub = r1cs.n_pub_out + r1cs.n_pub_in
    if n_w is None:
        n_w = r1cs.n_wires - 1 - npub
    nz_pad = _next_pow2(1 + npub + n_w)

    fs = _FS(_instance_digest(r1cs, inst, ctx), p)
    tau = [fs.challenge() for _ in range(mu)]

    e1, r_x = _sumcheck_verify(fs, 0, proof.sc1_polys, 3, p)
    if e1 is None or len(r_x) != mu:
        return False
    eq_tau_rx = eq_point(tau, r_x, p)
    u = inst.u % p
    expect1 = (
        eq_tau_rx
        * ((proof.v_a * proof.v_b - u * proof.v_c - proof.v_e) % p)
    ) % p
    if e1 != expect1:
        return False
    fs.absorb_scalars([proof.v_a, proof.v_b, proof.v_c, proof.v_e])
    ra, rb, rc = fs.challenge(), fs.challenge(), fs.challenge()

    claim2 = (ra * proof.v_a + rb * proof.v_b + rc * proof.v_c) % p
    e2, r_y = _sumcheck_verify(fs, claim2, proof.sc2_polys, 2, p)
    if e2 is None or len(r_y) != nz_pad.bit_length() - 1:
        return False

    eq_rx = eq_evals_le(r_x, p)
    eq_ry = eq_evals_le(r_y, p)
    m_eval = _matrix_mle_eval(r1cs, eq_rx, eq_ry, (ra, rb, rc), p)

    # z̃(r_y) = u·eq[0] + Σ x_k·eq[1+k] + ⟨W, eq-slice⟩
    z_pub = u * eq_ry[0] % p
    for k, xv in enumerate(inst.x):
        z_pub = (z_pub + (xv % p) * eq_ry[1 + k]) % p
    z_eval = (z_pub + proof.w_eval) % p
    if e2 != m_eval * z_eval % p:
        return False

    fs.absorb_scalars([proof.w_eval])
    w_pad_len = _next_pow2(n_w)
    b_w = _pow2_pad(eq_ry[1 + npub : 1 + npub + n_w], w_pad_len)
    if not ipa_verify(fs, inst.com_w, b_w, bases[:w_pad_len],
                      proof.w_eval, proof.ipa_w, ctx):
        return False

    e_pad_len = _next_pow2(len(r1cs.constraints))
    b_e = _pow2_pad(eq_rx[: len(r1cs.constraints)], e_pad_len)
    return ipa_verify(fs, inst.com_e, b_e, bases[:e_pad_len],
                      proof.v_e, proof.ipa_e, ctx)


def verify_chain_compressed(
    r1cs: R1CS,
    steps: list,
    acc_inst: RelaxedInstance,
    proof: CompressedProof,
    bases: list,
    n_w: int,
    z0: list[int] | None = None,
    zn: list[int] | None = None,
) -> bool:
    """Chain verification with the compressed final proof: the strictness/
    linkage checks and N·O(1) instance folds of ``nova_fold.verify_chain``,
    but the final relaxed-SAT check is the O(log)-size SNARK instead of the
    O(|C|) witness reveal."""
    from .nova_fold import nifs_verify

    no, ni = r1cs.n_pub_out, r1cs.n_pub_in
    for si, _ in steps:
        if si.u != 1 or si.com_e is not None:
            return False
    for prev, (si, _) in zip([s for s, _ in steps], steps[1:]):
        if si.x[no : no + ni] != prev.x[:no]:
            return False
    if z0 is not None and steps[0][0].x[no : no + ni] != list(z0):
        return False
    if zn is not None and steps[-1][0].x[:no] != list(zn):
        return False
    acc = steps[0][0]
    for si, com_t in steps[1:]:
        acc = nifs_verify(acc, si, com_t)
    if (acc.com_w, acc.com_e, acc.u, acc.x) != (
        acc_inst.com_w, acc_inst.com_e, acc_inst.u, acc_inst.x,
    ):
        return False
    return verify_compressed(r1cs, acc_inst, proof, bases, n_w=n_w)
