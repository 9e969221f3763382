"""Frozen copy of ``circuits_halo2_tpu_torch/models/pinning.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

Port copy of ``circuits_halo2_tpu/models/pinning.py`` (re-pointed to the
port's VerifyingKey; the original imports the JAX keygen).

Pinned verification key rendering — the halo2 ``transcript_repr`` digest.

halo2 v0.2 computes the VK's Fiat–Shamir digest as
``blake2b-512(person=b"Halo2-Verify-Key")(len(s) as u64 LE || s)`` reduced
via from_bytes_wide, where ``s = format!("{:?}", vk.pinned())`` — the Rust
Debug rendering of the full compiled constraint system, domain, fixed and
permutation commitments. This module reproduces that rendering; its output
hashing to the digest hard-coded in the reference's generated verifier
(`contracts/src/InclusionVerifier.sol` vk_digest) is the parity proof.
"""

from __future__ import annotations

import hashlib

from . import expr as E
from .field import FQ_MOD, FR_MOD
from .cs import Column
from .keygen import VerifyingKey


def _hex(v: int) -> str:
    return "0x" + format(v % FR_MOD, "064x")


def _point(p) -> str:
    if p is None:
        return "Infinity"
    return "(0x" + format(p[0], "064x") + ", 0x" + format(p[1], "064x") + ")"


_KIND = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


def _column(c: Column) -> str:
    return f"Column {{ index: {c.index}, column_type: {_KIND[c.kind]} }}"


def _rotation(r: int) -> str:
    return f"Rotation({r})"


def _expr(e: E.Expr) -> str:
    if isinstance(e, E.Const):
        return f"Constant({_hex(e.value)})"
    if isinstance(e, E.FixedQuery):
        return (
            f"Fixed {{ query_index: {e.query_index}, column_index: "
            f"{e.column}, rotation: {_rotation(e.rotation)} }}"
        )
    if isinstance(e, E.AdviceQuery):
        return (
            f"Advice {{ query_index: {e.query_index}, column_index: "
            f"{e.column}, rotation: {_rotation(e.rotation)} }}"
        )
    if isinstance(e, E.InstanceQuery):
        return (
            f"Instance {{ query_index: {e.query_index}, column_index: "
            f"{e.column}, rotation: {_rotation(e.rotation)} }}"
        )
    if isinstance(e, E.Neg):
        return f"Negated({_expr(e.inner)})"
    if isinstance(e, E.Sum):
        return f"Sum({_expr(e.left)}, {_expr(e.right)})"
    if isinstance(e, E.Product):
        return f"Product({_expr(e.left)}, {_expr(e.right)})"
    if isinstance(e, E.Scaled):
        return f"Scaled({_expr(e.inner)}, {_hex(e.scalar)})"
    raise TypeError(e)


def render_pinned(vk: VerifyingKey, extended_k: int | None = None) -> str:
    cs = vk.cs
    k = vk.k
    if extended_k is None:
        # EvaluationDomain::new: smallest extended_k with
        # 2^extended_k >= n * quotient_poly_degree
        quot = cs.degree() - 1
        extended_k = k
        while (1 << extended_k) < (1 << k) * quot:
            extended_k += 1

    gates = ", ".join(
        _expr(p) for gate in cs.gates for p in gate.polys
    )
    adv_q = ", ".join(
        f"({_column(Column('advice', c))}, {_rotation(r)})"
        for c, r in cs.advice_queries
    )
    inst_q = ", ".join(
        f"({_column(Column('instance', c))}, {_rotation(r)})"
        for c, r in cs.instance_queries
    )
    fix_q = ", ".join(
        f"({_column(Column('fixed', c))}, {_rotation(r)})"
        for c, r in cs.fixed_queries
    )
    perm_cols = ", ".join(_column(c) for c in cs.permutation_columns)
    lookups = ", ".join(
        "Argument { input_expressions: ["
        + ", ".join(_expr(e) for e in lk.input_exprs)
        + "], table_expressions: ["
        + ", ".join(_expr(e) for e in lk.table_exprs)
        + "] }"
        for lk in cs.lookups
    )
    constants = ", ".join(_column(c) for c in cs.constants)
    fixed_comms = ", ".join(_point(p) for p in vk.fixed_commitments)
    perm_comms = ", ".join(_point(p) for p in vk.permutation_commitments)

    return (
        "PinnedVerificationKey { "
        f"base_modulus: \"0x{FQ_MOD:064x}\", "
        f"scalar_modulus: \"0x{FR_MOD:064x}\", "
        "domain: PinnedEvaluationDomain { "
        f"k: {k}, extended_k: {extended_k}, omega: {_hex(vk.omega)} }}, "
        "cs: PinnedConstraintSystem { "
        f"num_fixed_columns: {cs.num_fixed}, "
        f"num_advice_columns: {cs.num_advice}, "
        f"num_instance_columns: {cs.num_instance}, "
        f"num_selectors: {cs.num_selectors}, "
        f"gates: [{gates}], "
        f"advice_queries: [{adv_q}], "
        f"instance_queries: [{inst_q}], "
        f"fixed_queries: [{fix_q}], "
        f"permutation: Argument {{ columns: [{perm_cols}] }}, "
        f"lookups: [{lookups}], "
        f"constants: [{constants}], "
        "minimum_degree: None }, "
        f"fixed_commitments: [{fixed_comms}], "
        f"permutation: VerifyingKey {{ commitments: [{perm_comms}] }} }}"
    )


def transcript_repr(vk: VerifyingKey) -> int:
    s = render_pinned(vk)
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    h.update(len(s).to_bytes(8, "little"))
    h.update(s.encode())
    return int.from_bytes(h.digest(), "little") % FR_MOD
