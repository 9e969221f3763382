"""Nova folding scheme (NIFS) over the circom step R1CS.

The reference's Nova example folds every IVC step into ONE running
RecursiveSNARK instance (`zk_prover/examples/nova_incremental_verifier.rs:
170-198`, via the nova-snark crate). This module implements the core of
that machinery — the non-interactive folding scheme of the Nova paper —
natively over the R1CS synthesized in ``merkle/circom_r1cs.py``:

- *Committed relaxed R1CS*: an instance is (com(W), com(E), u, x) with
  satisfaction  AZ ∘ BZ = u·CZ + E,  Z = (u | x | W)  (the constant-1
  column plays the role of u, so a strict instance is (u=1, E=0)).
  Commitments are Pedersen vector commitments over BN254 G1 — binding and
  additively homomorphic, which is exactly what folding consumes.
- *NIFS.P / NIFS.V*: folding two instances computes the cross term
  T = AZ₁∘BZ₂ + AZ₂∘BZ₁ − u₁·CZ₂ − u₂·CZ₁, commits it, derives the
  challenge r by Fiat–Shamir over (com_T, both instances), and outputs
    E' = E₁ + r·T + r²·E₂   u' = u₁ + r·u₂   x' = x₁ + r·x₂
    W' = W₁ + r·W₂          com' side computed homomorphically.
- *Chain accumulation*: N step proofs fold into one accumulator; the
  verifier replays N O(1)-group-op instance folds and performs ONE
  relaxed-SAT check — the expensive O(|C|) work is independent of N.

Honest divergence from full Nova: the folding verifier is NOT embedded in
an augmented step circuit (no verifier-in-circuit recursion), so the
chain's succinct-proof form remains the ChainedMstInclusionCircuit SNARK
(`models/incremental.py`); this module provides the accumulation scheme
itself, bit-faithful to the Nova algebra.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..merkle.circom_r1cs import LC, P, R1CS
from ..ops import curve as C
from ..ops.keccak import keccak256


# ---------------------------------------------------------------------------
# Pedersen commitment over G1
# ---------------------------------------------------------------------------

def pedersen_bases(n: int, points: list | None = None) -> list:
    """n independent G1 bases. Pass an SRS ``.g`` slice to reuse a
    powers-of-tau ceremony; without one, derive bases by hash-to-curve
    (try-and-increment), whose discrete logs are unknown to everyone —
    required for the commitment to be binding."""
    if points is not None:
        assert len(points) >= n
        return points[:n]
    return [_hash_to_g1(b"nova-pedersen" + i.to_bytes(8, "big")) for i in range(n)]


_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _hash_to_g1(seed: bytes):
    """Try-and-increment hash-to-curve on BN254 G1 (y² = x³ + 3). Nobody
    knows the discrete log of the output w.r.t. any fixed generator."""
    ctr = 0
    while True:
        x = int.from_bytes(keccak256(seed + ctr.to_bytes(4, "big")), "big") % _FQ
        y2 = (x * x % _FQ * x + 3) % _FQ
        y = pow(y2, (_FQ + 1) // 4, _FQ)  # q ≡ 3 (mod 4)
        if y * y % _FQ == y2:
            return (x, min(y, _FQ - y))
        ctr += 1


def commit(vec: list[int], bases: list):
    return C.g1_msm_pippenger(bases[: len(vec)], [v % P for v in vec])


def _pt_fold(p, q, r: int):
    """p + r·q on G1 (None = infinity)."""
    rq = C.g1_mul(q, r) if q is not None else None
    if p is None:
        return rq
    return p if rq is None else C.g1_add(p, rq)


# ---------------------------------------------------------------------------
# Committed relaxed R1CS
# ---------------------------------------------------------------------------

@dataclass
class RelaxedInstance:
    com_w: tuple | None
    com_e: tuple | None
    u: int
    x: list[int]  # public wires (outputs then inputs, circom order)


@dataclass
class RelaxedWitness:
    w: list[int]  # private wires
    e: list[int]  # error vector, one entry per constraint


def _z(r1cs: R1CS, inst_u: int, x: list[int], w: list[int]) -> list[int]:
    return [inst_u % P] + [v % P for v in x] + [v % P for v in w]


def _matvecs(r1cs: R1CS, z: list[int]):
    def ev(lc: LC) -> int:
        return sum(z[wi] * c for wi, c in lc.items()) % P

    az = [ev(a) for a, _, _ in r1cs.constraints]
    bz = [ev(b) for _, b, _ in r1cs.constraints]
    cz = [ev(c) for _, _, c in r1cs.constraints]
    return az, bz, cz


def strict_instance(
    r1cs: R1CS, witness: list[int], bases: list
) -> tuple[RelaxedInstance, RelaxedWitness]:
    """Wrap a satisfying strict witness (from build_incremental_mst_
    inclusion) as a relaxed instance with u=1, E=0."""
    npub = r1cs.n_pub_out + r1cs.n_pub_in
    x, w = witness[1 : 1 + npub], witness[1 + npub :]
    e = [0] * len(r1cs.constraints)
    return (
        RelaxedInstance(commit(w, bases), None, 1, list(x)),
        RelaxedWitness(list(w), e),
    )


def relaxed_check(
    r1cs: R1CS, inst: RelaxedInstance, wit: RelaxedWitness, bases: list
) -> bool:
    """Full relaxed-R1CS satisfaction + commitment opening check. This is
    the ONE O(|C|) verification the chain ends with."""
    if commit(wit.w, bases) != inst.com_w:
        return False
    if commit(wit.e, bases) != inst.com_e:  # all-zero E commits to infinity
        return False
    az, bz, cz = _matvecs(r1cs, _z(r1cs, inst.u, inst.x, wit.w))
    return all(
        a * b % P == (inst.u * c + e) % P
        for a, b, c, e in zip(az, bz, cz, wit.e)
    )


# ---------------------------------------------------------------------------
# NIFS
# ---------------------------------------------------------------------------

def _pt_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def _challenge(i1: RelaxedInstance, i2: RelaxedInstance, com_t) -> int:
    h = keccak256(
        b"nova-nifs"
        + _pt_bytes(i1.com_w) + _pt_bytes(i1.com_e)
        + i1.u.to_bytes(32, "big")
        + b"".join(v.to_bytes(32, "big") for v in i1.x)
        + _pt_bytes(i2.com_w) + _pt_bytes(i2.com_e)
        + i2.u.to_bytes(32, "big")
        + b"".join(v.to_bytes(32, "big") for v in i2.x)
        + _pt_bytes(com_t)
    )
    return int.from_bytes(h, "big") % P


def nifs_prove(
    r1cs: R1CS,
    i1: RelaxedInstance, w1: RelaxedWitness,
    i2: RelaxedInstance, w2: RelaxedWitness,
    bases: list,
):
    """NIFS.P: fold (i2, w2) into (i1, w1). Returns (inst', wit', com_T)."""
    z1 = _z(r1cs, i1.u, i1.x, w1.w)
    z2 = _z(r1cs, i2.u, i2.x, w2.w)
    az1, bz1, cz1 = _matvecs(r1cs, z1)
    az2, bz2, cz2 = _matvecs(r1cs, z2)
    t = [
        (a1 * b2 + a2 * b1 - i1.u * c2 - i2.u * c1) % P
        for a1, b1, c1, a2, b2, c2 in zip(az1, bz1, cz1, az2, bz2, cz2)
    ]
    com_t = commit(t, bases)
    r = _challenge(i1, i2, com_t)
    inst = nifs_verify(i1, i2, com_t)
    wit = RelaxedWitness(
        [(a + r * b) % P for a, b in zip(w1.w, w2.w)],
        [(e1 + r * tv + r * r * e2) % P for e1, tv, e2 in zip(w1.e, t, w2.e)],
    )
    return inst, wit, com_t


def nifs_verify(
    i1: RelaxedInstance, i2: RelaxedInstance, com_t
) -> RelaxedInstance:
    """NIFS.V: O(1) group work — fold the instances given com_T."""
    r = _challenge(i1, i2, com_t)
    com_e = _pt_fold(i1.com_e, com_t, r)
    com_e = _pt_fold(com_e, i2.com_e, r * r % P)
    return RelaxedInstance(
        _pt_fold(i1.com_w, i2.com_w, r),
        com_e,
        (i1.u + r * i2.u) % P,
        [(a + r * b) % P for a, b in zip(i1.x, i2.x)],
    )


def fold_chain(
    r1cs: R1CS, witnesses: list[list[int]], bases: list
):
    """Prover side: fold N strict step witnesses into one running
    accumulator. Returns (acc_inst, acc_wit, steps) where ``steps`` is the
    verifier's transcript: [(strict_instance_i, com_T_i), ...]."""
    acc_i, acc_w = strict_instance(r1cs, witnesses[0], bases)
    steps = [(acc_i, None)]
    for wit in witnesses[1:]:
        si, sw = strict_instance(r1cs, wit, bases)
        acc_i, acc_w, com_t = nifs_prove(r1cs, acc_i, acc_w, si, sw, bases)
        steps.append((si, com_t))
    return acc_i, acc_w, steps


def verify_chain(
    r1cs: R1CS,
    steps: list,
    acc_inst: RelaxedInstance,
    acc_wit: RelaxedWitness,
    bases: list,
    z0: list[int] | None = None,
    zn: list[int] | None = None,
) -> bool:
    """Verifier side: N−1 O(1) instance folds (group ops only) + ONE
    relaxed-SAT check on the final accumulator — the O(|C|·N) transcript
    replay of the naive chain collapses to O(|C|) + N·O(1).

    Soundness checks beyond the fold replay:
    - every step instance must be STRICT (u == 1, E = 0): a relaxed step
      would let a prover absorb any false statement into E;
    - IVC linkage: step i's public inputs must equal step i−1's public
      outputs (circom x layout = outputs ‖ inputs), and when (z0, zn) are
      given, the chain is additionally pinned to start at z0 and end at zn.
    """
    no, ni = r1cs.n_pub_out, r1cs.n_pub_in
    for si, _ in steps:
        if si.u != 1 or si.com_e is not None:
            return False  # non-strict step instance: E could hide anything
    for prev, (si, _) in zip([s for s, _ in steps], [s for s in steps[1:]]):
        if si.x[no : no + ni] != prev.x[:no]:
            return False  # broken step-to-step state linkage
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
    return relaxed_check(r1cs, acc, acc_wit, bases)
