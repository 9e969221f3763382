"""Solidity verifier generation — render a complete EVM verifier from a VK.

Replaces ``halo2_solidity_verifier::SolidityGenerator`` (reference use:
`zk_prover/examples/gen_inclusion_verifier.rs:30-40`, producing
`contracts/src/InclusionVerifier.sol`). The generator is driven entirely by
the compiled ConstraintSystem IR and the VK:

- proof layout (per-phase commitment counts, evaluation order) is derived
  from the CS, identically to the Python verifier (models/verifier.py);
- the quotient-evaluation Yul is code-generated from the gate expression
  trees; permutation / lookup blocks from the argument structure;
- the BDFG21 multiopen sections (barycentric r_j(mu) accumulation with the
  inversion-free normalized-coefficient scheme, pairing LHS assembly) are
  generated from the rotation sets;
- VK constants (including the hard-coded commitments) from keygen output.

The emitted contract is complete and executable: tests run it through the
in-repo Yul interpreter (contracts/yul_vm.py) against both the reference
proof fixture and freshly generated proofs (tests/test_contracts.py),
mirroring the reference's revm harness
(`zk_prover/examples/gen_inclusion_proof.rs:87-92`).

Memory layout scheme (mirrors the reference generator's, derived not copied):
scratch for batch-inverted barycentric coefficients at 0x00.., then rotation
points / mu-diffs / Z_0(mu) / per-set diffs / r_evals / sums, then the VK
block, then challenges, then named intermediates (X_N, L_*, QUOTIENT_*, ...).
"""

from __future__ import annotations

from ..models import expr as E
from ..models.keygen import DELTA, VerifyingKey
from ..models.verifier import num_perm_sets, perm_chunk_len, rotation_sets
from ..ops import curve as CU
from ..ops.field import FQ_MOD, FR_MOD
from ..utils.srs import ParamsKZG


class YulEmitter:
    def __init__(self):
        self.lines: list[str] = []
        self.counter = 0

    def let(self, rhs: str) -> str:
        name = f"var{self.counter}"
        self.counter += 1
        self.lines.append(f"let {name} := {rhs}")
        return name


# Named words that live after the challenge block, in order.
_NAMED_MPTRS = [
    "ACC_LHS_X", "ACC_LHS_Y", "ACC_RHS_X", "ACC_RHS_Y",
    "X_N", "X_N_MINUS_1_INV", "L_LAST", "L_BLIND", "L_0",
    "INSTANCE_EVAL", "QUOTIENT_EVAL", "QUOTIENT_X", "QUOTIENT_Y",
    "R_EVAL", "PAIRING_LHS_X", "PAIRING_LHS_Y",
    "PAIRING_RHS_X", "PAIRING_RHS_Y",
]

_CHALLENGES = ["THETA", "BETA", "GAMMA", "Y", "X", "ZETA", "NU", "MU"]


class SolidityGenerator:
    def __init__(
        self,
        params: ParamsKZG,
        vk: VerifyingKey,
        num_instances: int,
        vk_digest: int | None = None,
    ):
        self.params = params
        self.vk = vk
        self.cs = vk.cs
        self.num_instances = num_instances
        self.vk_digest = (
            vk_digest if vk_digest is not None else vk.transcript_repr
        )
        cs = self.cs
        self.num_h = cs.degree() - 1
        self.nperm = num_perm_sets(cs)
        self.chunk = perm_chunk_len(cs)
        self.blinders = cs.blinding_factors()
        self.sets = rotation_sets(cs)
        assert len(self.sets) >= 2, "degenerate multiopen set structure"

        # ---- proof layout -------------------------------------------------
        self.phase_points = [
            cs.num_advice,
            2 * len(cs.lookups),
            self.nperm + len(cs.lookups) + 1,  # perm z's, lookup z's, random
            self.num_h,
        ]
        self.num_evals = (
            len(cs.advice_queries)
            + len(cs.fixed_queries)
            + 1  # random
            + len(cs.permutation_columns)
            + (3 * self.nperm - 1)
            + 5 * len(cs.lookups)
        )
        self.proof_len = (
            sum(self.phase_points) * 0x40 + self.num_evals * 0x20 + 2 * 0x40
        )

        self.proof_cptr = 0x64
        # calldata offsets of evaluations
        self.eval_cptr = self.proof_cptr + sum(self.phase_points) * 0x40
        self._assign_eval_offsets()
        self._build_vk_entries()
        self._assign_memory_layout()

    # ------------------------------------------------------------------
    def _assign_eval_offsets(self):
        cs = self.cs
        ofs = self.eval_cptr
        self.eval_of: dict[tuple, int] = {}

        def put(key):
            nonlocal ofs
            self.eval_of[key] = ofs
            ofs += 0x20

        for i, (col, rot) in enumerate(cs.advice_queries):
            put(("advice", col, rot))
        for i, (col, rot) in enumerate(cs.fixed_queries):
            put(("fixed", col, rot))
        put(("random", 0, 0))
        for i in range(len(cs.permutation_columns)):
            put(("sigma", i, 0))
        last_rot = -(self.blinders + 1)
        for s in range(self.nperm):
            put(("perm_z", s, 0))
            put(("perm_z", s, 1))
            if s < self.nperm - 1:
                put(("perm_z", s, last_rot))
        for li in range(len(cs.lookups)):
            put(("lookup_z", li, 0))
            put(("lookup_z", li, 1))
            put(("lookup_a", li, 0))
            put(("lookup_a", li, -1))
            put(("lookup_s", li, 0))
        assert ofs == self.eval_cptr + self.num_evals * 0x20

        # commitment calldata offsets
        self.comm_of: dict[tuple, int] = {}
        c = self.proof_cptr
        for i in range(cs.num_advice):
            self.comm_of[("advice", i)] = c
            c += 0x40
        for li in range(len(cs.lookups)):
            self.comm_of[("lookup_a", li)] = c
            c += 0x40
            self.comm_of[("lookup_s", li)] = c
            c += 0x40
        for s in range(self.nperm):
            self.comm_of[("perm_z", s)] = c
            c += 0x40
        for li in range(len(cs.lookups)):
            self.comm_of[("lookup_z", li)] = c
            c += 0x40
        self.comm_of[("random",)] = c
        c += 0x40
        self.first_quotient_cptr = c
        self.last_quotient_cptr = c + (self.num_h - 1) * 0x40
        c += self.num_h * 0x40
        # W and W' sit after the evaluation block, not after the quotient
        # commitments (proof layout: commitments | evals | W | W')
        self.w_cptr = self.eval_cptr + self.num_evals * 0x20
        self.w_prime_cptr = self.w_cptr + 0x40

    # ------------------------------------------------------------------
    def _assign_memory_layout(self):
        """Scratch / VK / challenge / named-word layout (scheme in module
        docstring). All addresses are generated; nothing is hard-coded."""
        points = sorted({r for rots, _ in self.sets for r in rots})
        self.points = points
        npts = len(points)
        nsets = len(self.sets)
        ncoeffs = sum(len(rots) for rots, _ in self.sets)
        self.ncoeffs = ncoeffs

        # batch-invert scratch: diff_0 at 0x00, coefficients at 0x20..
        self.coeff_mptr: dict[tuple, int] = {}
        off = 0x20
        for si, (rots, _) in enumerate(self.sets):
            for i in range(len(rots)):
                self.coeff_mptr[(si, i)] = off
                off += 0x20
        # batch_invert(0, 0x20*(1+ncoeffs)) needs (ncoeffs) product words
        # plus 6 modexp argument words beyond the value region:
        self.point_base = 0x20 * (2 * (1 + ncoeffs) + 6)
        self.point_mptr = {
            rot: self.point_base + 0x20 * i for i, rot in enumerate(points)
        }
        mu_base = self.point_base + 0x20 * npts
        self.mu_minus_mptr = {
            rot: mu_base + 0x20 * i for i, rot in enumerate(points)
        }
        self.s_mptr = mu_base + 0x20 * npts          # Z_0(mu)
        self.diffs_mptr = self.s_mptr + 0x20          # nsets words
        self.r_evals_mptr = self.diffs_mptr + 0x20 * nsets
        self.sums_mptr = self.r_evals_mptr + 0x20 * nsets
        self.vk_mptr = self.sums_mptr + 0x20 * nsets

        self._vk_index = {name: i for i, (name, _) in enumerate(self.vk_entries)}
        self.challenge_mptr = self.vk_mptr + len(self.vk_entries) * 0x20
        self.mptr_of = {
            name: self.challenge_mptr + 0x20 * i
            for i, name in enumerate(_CHALLENGES)
        }
        base = self.challenge_mptr + 0x20 * len(_CHALLENGES)
        for i, name in enumerate(_NAMED_MPTRS):
            self.mptr_of[name] = base + 0x20 * i

    def _build_vk_entries(self):
        vk, params = self.vk, self.params
        from ..ops import field as F

        n = 1 << vk.k
        omega_inv = F.fr_inv(vk.omega)
        neg_s_g2 = CU.g2_neg(params.s_g2)
        e = self.vk_entries = []
        e.append(("vk_digest", self.vk_digest))
        e.append(("k", vk.k))
        e.append(("n_inv", F.fr_inv(n)))
        e.append(("omega", vk.omega))
        e.append(("omega_inv", omega_inv))
        e.append(("omega_inv_to_l", F.fr_pow(omega_inv, self.blinders + 1)))
        e.append(("num_instances", self.num_instances))
        e.append(("has_accumulator", 0))
        e.append(("acc_offset", 0))
        e.append(("num_acc_limbs", 0))
        e.append(("num_acc_limb_bits", 0))
        e.append(("g1_x", params.g[0][0]))
        e.append(("g1_y", params.g[0][1]))
        (x2c0, x2c1), (y2c0, y2c1) = params.g2
        e.append(("g2_x_1", x2c1))
        e.append(("g2_x_2", x2c0))
        e.append(("g2_y_1", y2c1))
        e.append(("g2_y_2", y2c0))
        (nx0, nx1), (ny0, ny1) = neg_s_g2
        e.append(("neg_s_g2_x_1", nx1))
        e.append(("neg_s_g2_x_2", nx0))
        e.append(("neg_s_g2_y_1", ny1))
        e.append(("neg_s_g2_y_2", ny0))
        for i, p in enumerate(vk.fixed_commitments):
            e.append((f"fixed_comms[{i}].x", p[0] if p else 0))
            e.append((f"fixed_comms[{i}].y", p[1] if p else 0))
        for i, p in enumerate(vk.permutation_commitments):
            e.append((f"permutation_comms[{i}].x", p[0] if p else 0))
            e.append((f"permutation_comms[{i}].y", p[1] if p else 0))

    # ------------------------------------------------------------------
    # sources
    # ------------------------------------------------------------------
    def _eval_src(self, poly: tuple, rot: int) -> str:
        kind = poly[0]
        if kind == "quotient":
            return "mload(QUOTIENT_EVAL_MPTR)"
        if kind == "random":
            key = ("random", 0, 0)
        elif kind == "sigma":
            key = ("sigma", poly[1], 0)
        else:
            key = (kind, poly[1], rot)
        return f"calldataload(0x{self.eval_of[key]:04x})"

    def _comm_src(self, poly: tuple) -> tuple[str, str]:
        kind = poly[0]
        if kind == "quotient":
            return ("mload(QUOTIENT_X_MPTR)", "mload(QUOTIENT_Y_MPTR)")
        if kind == "fixed":
            idx = self._vk_index[f"fixed_comms[{poly[1]}].x"]
        elif kind == "sigma":
            idx = self._vk_index[f"permutation_comms[{poly[1]}].x"]
        else:
            key = ("random",) if kind == "random" else (kind, poly[1])
            c = self.comm_of[key]
            return (f"calldataload(0x{c:04x})", f"calldataload(0x{c + 0x20:04x})")
        m = self.vk_mptr + 0x20 * idx
        return (f"mload(0x{m:04x})", f"mload(0x{m + 0x20:04x})")

    # ------------------------------------------------------------------
    # section emitters
    # ------------------------------------------------------------------
    def _emit_expr(self, em: YulEmitter, expr: E.Expr) -> str:
        cs = self.cs
        if isinstance(expr, E.Const):
            return "0x%064x" % expr.value
        if isinstance(expr, E.FixedQuery):
            col, rot = cs.fixed_queries[expr.query_index]
            return f"calldataload(0x{self.eval_of[('fixed', col, rot)]:04x})"
        if isinstance(expr, E.AdviceQuery):
            col, rot = cs.advice_queries[expr.query_index]
            return f"calldataload(0x{self.eval_of[('advice', col, rot)]:04x})"
        if isinstance(expr, E.InstanceQuery):
            return "mload(INSTANCE_EVAL_MPTR)"
        if isinstance(expr, E.Neg):
            inner = self._emit_expr(em, expr.inner)
            return em.let(f"sub(r, {inner})")
        if isinstance(expr, E.Sum):
            a = self._emit_expr(em, expr.left)
            b = self._emit_expr(em, expr.right)
            return em.let(f"addmod({a}, {b}, r)")
        if isinstance(expr, E.Product):
            a = self._emit_expr(em, expr.left)
            b = self._emit_expr(em, expr.right)
            return em.let(f"mulmod({a}, {b}, r)")
        if isinstance(expr, E.Scaled):
            a = self._emit_expr(em, expr.inner)
            return em.let(f"mulmod({a}, 0x{expr.scalar:064x}, r)")
        raise TypeError(expr)

    def _block(self, lines: list[str], indent: int = 16) -> str:
        pad = " " * indent
        inner = ("\n" + pad + "    ").join(lines)
        return f"{pad}{{\n{pad}    {inner}\n{pad}}}"

    def _gate_blocks(self) -> str:
        blocks = []
        first = True
        for gate in self.cs.gates:
            for poly in gate.polys:
                em = YulEmitter()
                result = self._emit_expr(em, poly)
                if first:
                    acc = f"quotient_eval_numer := {result}"
                    first = False
                else:
                    acc = (
                        "quotient_eval_numer := addmod(mulmod("
                        f"quotient_eval_numer, y, r), {result}, r)"
                    )
                blocks.append(self._block(em.lines + [acc]))
        return "\n".join(blocks)

    def _perm_lookup_blocks(self) -> str:
        """Permutation and lookup quotient terms (structural codegen)."""
        cs = self.cs
        ev = self.eval_of
        last_rot = -(self.blinders + 1)
        out = []

        def block(lines):
            out.append(self._block(lines))

        def acc(val):
            return (
                "quotient_eval_numer := addmod(mulmod(quotient_eval_numer, y, r), "
                + val
                + ", r)"
            )

        z0x = f"calldataload(0x{ev[('perm_z', 0, 0)]:04x})"
        block([
            "let l_0 := mload(L_0_MPTR)",
            f"let eval := addmod(l_0, sub(r, mulmod(l_0, {z0x}, r)), r)",
            acc("eval"),
        ])
        zlx = f"calldataload(0x{ev[('perm_z', self.nperm - 1, 0)]:04x})"
        block([
            f"let perm_z_last := {zlx}",
            "let eval := mulmod(mload(L_LAST_MPTR), addmod(mulmod(perm_z_last, "
            "perm_z_last, r), sub(r, perm_z_last), r), r)",
            acc("eval"),
        ])
        for s in range(1, self.nperm):
            cur = f"calldataload(0x{ev[('perm_z', s, 0)]:04x})"
            prev_last = f"calldataload(0x{ev[('perm_z', s - 1, last_rot)]:04x})"
            block([
                f"let eval := mulmod(mload(L_0_MPTR), addmod({cur}, sub(r, "
                f"{prev_last}), r), r)",
                acc("eval"),
            ])

        def col_eval(col):
            if col.kind == "advice":
                return f"calldataload(0x{ev[('advice', col.index, 0)]:04x})"
            if col.kind == "fixed":
                return f"calldataload(0x{ev[('fixed', col.index, 0)]:04x})"
            return "mload(INSTANCE_EVAL_MPTR)"

        col_idx = 0
        for s in range(self.nperm):
            cols = cs.permutation_columns[s * self.chunk : (s + 1) * self.chunk]
            lines = [
                "let gamma := mload(GAMMA_MPTR)",
                "let beta := mload(BETA_MPTR)",
                f"let lhs := calldataload(0x{ev[('perm_z', s, 1)]:04x})",
                f"let rhs := calldataload(0x{ev[('perm_z', s, 0)]:04x})",
            ]
            for i, col in enumerate(cols):
                sig = f"calldataload(0x{ev[('sigma', col_idx + i, 0)]:04x})"
                lines.append(
                    f"lhs := mulmod(lhs, addmod(addmod({col_eval(col)}, "
                    f"mulmod(beta, {sig}, r), r), gamma, r), r)"
                )
            if s == 0:
                lines.append("mstore(0x00, mulmod(beta, mload(X_MPTR), r))")
            for i, col in enumerate(cols):
                lines.append(
                    f"rhs := mulmod(rhs, addmod(addmod({col_eval(col)}, "
                    "mload(0x00), r), gamma, r), r)"
                )
                if s < self.nperm - 1 or i < len(cols) - 1:
                    lines.append("mstore(0x00, mulmod(mload(0x00), delta, r))")
            lines += [
                "let left_sub_right := addmod(lhs, sub(r, rhs), r)",
                "let eval := addmod(left_sub_right, sub(r, mulmod(left_sub_right, "
                "addmod(mload(L_LAST_MPTR), mload(L_BLIND_MPTR), r), r)), r)",
                acc("eval"),
            ]
            block(lines)
            col_idx += len(cols)

        for li, lk in enumerate(cs.lookups):
            zx = f"calldataload(0x{ev[('lookup_z', li, 0)]:04x})"
            zwx = f"calldataload(0x{ev[('lookup_z', li, 1)]:04x})"
            ax = f"calldataload(0x{ev[('lookup_a', li, 0)]:04x})"
            aprev = f"calldataload(0x{ev[('lookup_a', li, -1)]:04x})"
            sx = f"calldataload(0x{ev[('lookup_s', li, 0)]:04x})"
            block([
                "let l_0 := mload(L_0_MPTR)",
                f"let eval := addmod(l_0, mulmod(l_0, sub(r, {zx}), r), r)",
                acc("eval"),
            ])
            block([
                "let l_last := mload(L_LAST_MPTR)",
                f"let eval := mulmod(l_last, addmod(mulmod({zx}, {zx}, r), "
                f"sub(r, {zx}), r), r)",
                acc("eval"),
            ])
            em = YulEmitter()
            input_parts = [self._emit_expr(em, e) for e in lk.input_exprs]
            inp = input_parts[0]
            for part in input_parts[1:]:
                inp = em.let(
                    f"addmod(mulmod({inp}, mload(THETA_MPTR), r), {part}, r)"
                )
            table_parts = [self._emit_expr(em, e) for e in lk.table_exprs]
            tab = table_parts[0]
            for part in table_parts[1:]:
                tab = em.let(
                    f"addmod(mulmod({tab}, mload(THETA_MPTR), r), {part}, r)"
                )
            lines = list(em.lines)
            lines += [
                f"let input := {inp}",
                f"let table := {tab}",
                "let beta := mload(BETA_MPTR)",
                "let gamma := mload(GAMMA_MPTR)",
                f"let lhs := mulmod({zwx}, mulmod(addmod({ax}, beta, r), "
                f"addmod({sx}, gamma, r), r), r)",
                f"let rhs := mulmod({zx}, mulmod(addmod(input, beta, r), "
                "addmod(table, gamma, r), r), r)",
                "let eval := mulmod(addmod(1, sub(r, addmod(mload(L_BLIND_MPTR), "
                "mload(L_LAST_MPTR), r)), r), addmod(lhs, sub(r, rhs), r), r)",
                acc("eval"),
            ]
            block(lines)
            block([
                f"let eval := mulmod(mload(L_0_MPTR), addmod({ax}, sub(r, {sx}), "
                "r), r)",
                acc("eval"),
            ])
            block([
                "let eval := mulmod(addmod(1, sub(r, addmod(mload(L_BLIND_MPTR), "
                "mload(L_LAST_MPTR), r)), r), mulmod(addmod("
                f"{ax}, sub(r, {sx}), r), addmod({ax}, sub(r, {aprev}), r), r), r)",
                acc("eval"),
            ])
        return "\n".join(out)

    # -- multiopen sections -------------------------------------------------
    def _point_block(self) -> str:
        """x·omega^rot for every rotation in the query universe."""
        pts = set(self.points)
        lines = [
            "let x := mload(X_MPTR)",
            "let omega := mload(OMEGA_MPTR)",
            "let omega_inv := mload(OMEGA_INV_MPTR)",
            "let x_pow_of_omega := x",
            f"mstore(0x{self.point_mptr[0]:04x}, x)",
        ]
        maxr = max(self.points)
        minr = min(self.points)
        for rot in range(1, maxr + 1):
            lines.append("x_pow_of_omega := mulmod(x_pow_of_omega, omega, r)")
            if rot in pts:
                lines.append(
                    f"mstore(0x{self.point_mptr[rot]:04x}, x_pow_of_omega)"
                )
        lines.append("x_pow_of_omega := x")
        for rot in range(-1, minr - 1, -1):
            lines.append(
                "x_pow_of_omega := mulmod(x_pow_of_omega, omega_inv, r)"
            )
            if rot in pts:
                lines.append(
                    f"mstore(0x{self.point_mptr[rot]:04x}, x_pow_of_omega)"
                )
        return self._block(lines)

    def _mu_diff_block(self) -> str:
        """mu - point values, Z_0(mu), and per-set diff products."""
        npts = len(self.points)
        mu_base = self.mu_minus_mptr[self.points[0]]
        lines = [
            "let mu := mload(MU_MPTR)",
            "for",
            "    {",
            f"        let mptr := 0x{mu_base:04x}",
            f"        let mptr_end := 0x{mu_base + 0x20 * npts:04x}",
            f"        let point_mptr := 0x{self.point_base:04x}",
            "    }",
            "    lt(mptr, mptr_end)",
            "    {",
            "        mptr := add(mptr, 0x20)",
            "        point_mptr := add(point_mptr, 0x20)",
            "    }",
            "{",
            "    mstore(mptr, addmod(mu, sub(r, mload(point_mptr)), r))",
            "}",
        ]
        # Z_0(mu): product over set-0 rotations
        rots0 = self.sets[0][0]
        lines.append(f"let s := mload(0x{self.mu_minus_mptr[rots0[0]]:04x})")
        for rot in rots0[1:]:
            lines.append(
                f"s := mulmod(s, mload(0x{self.mu_minus_mptr[rot]:04x}), r)"
            )
        lines.append(f"mstore(0x{self.s_mptr:04x}, s)")
        # per-set diffs: product over rotations NOT in the set
        lines.append("let diff")
        for si, (rots, _) in enumerate(self.sets):
            others = [r for r in self.points if r not in rots]
            if not others:
                lines.append("diff := 1")
            else:
                lines.append(
                    f"diff := mload(0x{self.mu_minus_mptr[others[0]]:04x})"
                )
                for rot in others[1:]:
                    lines.append(
                        f"diff := mulmod(diff, "
                        f"mload(0x{self.mu_minus_mptr[rot]:04x}), r)"
                    )
            lines.append(f"mstore(0x{self.diffs_mptr + 0x20 * si:04x}, diff)")
            if si == 0:
                lines.append("mstore(0x00, diff)")
        return self._block(lines)

    def _coeff_blocks(self) -> str:
        """Un-inverted barycentric coefficients per (set, rotation):
        coeff_i = (mu - p_i) * prod_{j != i} (p_i - p_j). After the batch
        inversion these become the Lagrange-basis-at-mu over Z_set."""
        out = []
        for si, (rots, _) in enumerate(self.sets):
            lines = []
            for i, rot in enumerate(rots):
                lines.append(
                    f"let point_{i} := mload(0x{self.point_mptr[rot]:04x})"
                )
            lines.append("let coeff")
            for i, rot in enumerate(rots):
                factors = [
                    f"addmod(point_{i}, sub(r, point_{j}), r)"
                    for j in range(len(rots))
                    if j != i
                ]
                if factors:
                    lines.append(f"coeff := {factors[0]}")
                    for f in factors[1:]:
                        lines.append(f"coeff := mulmod(coeff, {f}, r)")
                    lines.append(
                        f"coeff := mulmod(coeff, "
                        f"mload(0x{self.mu_minus_mptr[rot]:04x}), r)"
                    )
                else:
                    lines.append(
                        f"coeff := mload(0x{self.mu_minus_mptr[rot]:04x})"
                    )
                lines.append(f"mstore(0x{self.coeff_mptr[(si, i)]:04x}, coeff)")
            out.append(self._block(lines))
        return "\n".join(out)

    def _normalize_block(self) -> str:
        """Batch-invert diff_0 + all coefficients; normalize set diffs."""
        nsets = len(self.sets)
        end = 0x20 * (1 + self.ncoeffs)
        lines = [
            f"success := batch_invert(success, 0, 0x{end:04x}, r)",
            "let diff_0_inv := mload(0x00)",
            f"mstore(0x{self.diffs_mptr:04x}, diff_0_inv)",
            "for",
            "    {",
            f"        let mptr := 0x{self.diffs_mptr + 0x20:04x}",
            f"        let mptr_end := 0x{self.diffs_mptr + 0x20 * nsets:04x}",
            "    }",
            "    lt(mptr, mptr_end)",
            "    { mptr := add(mptr, 0x20) }",
            "{",
            "    mstore(mptr, mulmod(mload(mptr), diff_0_inv, r))",
            "}",
        ]
        return self._block(lines)

    def _r_eval_blocks(self) -> str:
        """Per-set r_eval = diff_norm * sum_polys zeta^t sum_i coeff_inv_i
        * eval_i (Horner over polys in reverse order)."""
        out = []
        for si, (rots, polys) in enumerate(self.sets):
            lines = ["let zeta := mload(ZETA_MPTR)", "let r_eval := 0"]
            for pi, poly in enumerate(reversed(polys)):
                if pi:
                    lines.append("r_eval := mulmod(r_eval, zeta, r)")
                for i, rot in enumerate(rots):
                    lines.append(
                        "r_eval := addmod(r_eval, mulmod("
                        f"mload(0x{self.coeff_mptr[(si, i)]:04x}), "
                        f"{self._eval_src(poly, rot)}, r), r)"
                    )
            if si:
                lines.append(
                    "r_eval := mulmod(r_eval, "
                    f"mload(0x{self.diffs_mptr + 0x20 * si:04x}), r)"
                )
            lines.append(f"mstore(0x{self.r_evals_mptr + 0x20 * si:04x}, r_eval)")
            out.append(self._block(lines))
        return "\n".join(out)

    def _sum_blocks(self) -> str:
        """Per-set sums of inverted coefficients (= 1/Z_set(mu))."""
        out = []
        for si, (rots, _) in enumerate(self.sets):
            lines = [f"let sum := mload(0x{self.coeff_mptr[(si, 0)]:04x})"]
            for i in range(1, len(rots)):
                lines.append(
                    f"sum := addmod(sum, "
                    f"mload(0x{self.coeff_mptr[(si, i)]:04x}), r)"
                )
            lines.append(f"mstore(0x{self.sums_mptr + 0x20 * si:04x}, sum)")
            out.append(self._block(lines))
        return "\n".join(out)

    def _r_eval_combine_block(self) -> str:
        """R_EVAL = sum_j nu^j * r_eval_j * Z_j(mu) via a second batch
        inversion of the sums (Horner in nu from the last set down)."""
        nsets = len(self.sets)
        lines = [
            "for",
            "    {",
            "        let mptr := 0x00",
            f"        let mptr_end := 0x{0x20 * nsets:04x}",
            f"        let sum_mptr := 0x{self.sums_mptr:04x}",
            "    }",
            "    lt(mptr, mptr_end)",
            "    {",
            "        mptr := add(mptr, 0x20)",
            "        sum_mptr := add(sum_mptr, 0x20)",
            "    }",
            "{",
            "    mstore(mptr, mload(sum_mptr))",
            "}",
            f"success := batch_invert(success, 0, 0x{0x20 * nsets:04x}, r)",
            (
                f"let r_eval := mulmod(mload(0x{0x20 * (nsets - 1):04x}), "
                f"mload(0x{self.r_evals_mptr + 0x20 * (nsets - 1):04x}), r)"
            ),
            "for",
            "    {",
            f"        let sum_inv_mptr := 0x{0x20 * (nsets - 2):04x}",
            f"        let sum_inv_mptr_end := 0x{0x20 * nsets:04x}",
            (
                f"        let r_eval_mptr := "
                f"0x{self.r_evals_mptr + 0x20 * (nsets - 2):04x}"
            ),
            "    }",
            "    lt(sum_inv_mptr, sum_inv_mptr_end)",
            "    {",
            "        sum_inv_mptr := sub(sum_inv_mptr, 0x20)",
            "        r_eval_mptr := sub(r_eval_mptr, 0x20)",
            "    }",
            "{",
            "    r_eval := mulmod(r_eval, mload(NU_MPTR), r)",
            "    r_eval := addmod(r_eval, mulmod(mload(sum_inv_mptr), "
            "mload(r_eval_mptr), r), r)",
            "}",
            "mstore(R_EVAL_MPTR, r_eval)",
        ]
        return self._block(lines)

    def _pairing_acc_block(self) -> str:
        """Pairing LHS: commitment linear combination mirroring R_EVAL, then
        - r_eval*G1 - Z_0(mu)*W + mu*W'; RHS = W'."""
        L = ["let nu := mload(NU_MPTR)"]
        # set 0 into acc (0x00, 0x20)
        rots, polys = self.sets[0]
        x, y = self._comm_src(polys[-1])
        L.append(f"mstore(0x00, {x})")
        L.append(f"mstore(0x20, {y})")
        for poly in reversed(polys[:-1]):
            L.append("success := ec_mul_acc(success, mload(ZETA_MPTR))")
            x, y = self._comm_src(poly)
            L.append(f"success := ec_add_acc(success, {x}, {y})")
        # sets 1.. into tmp (0x80, 0xa0), folded into acc with nu^j * diff_j
        for si in range(1, len(self.sets)):
            rots, polys = self.sets[si]
            x, y = self._comm_src(polys[-1])
            L.append(f"mstore(0x80, {x})")
            L.append(f"mstore(0xa0, {y})")
            for poly in reversed(polys[:-1]):
                L.append("success := ec_mul_tmp(success, mload(ZETA_MPTR))")
                x, y = self._comm_src(poly)
                L.append(f"success := ec_add_tmp(success, {x}, {y})")
            L.append(
                "success := ec_mul_tmp(success, mulmod(nu, "
                f"mload(0x{self.diffs_mptr + 0x20 * si:04x}), r))"
            )
            L.append("success := ec_add_acc(success, mload(0x80), mload(0xa0))")
            if si < len(self.sets) - 1:
                L.append("nu := mulmod(nu, mload(NU_MPTR), r)")
        L += [
            "mstore(0x80, mload(G1_X_MPTR))",
            "mstore(0xa0, mload(G1_Y_MPTR))",
            "success := ec_mul_tmp(success, sub(r, mload(R_EVAL_MPTR)))",
            "success := ec_add_acc(success, mload(0x80), mload(0xa0))",
            f"mstore(0x80, calldataload(0x{self.w_cptr:04x}))",
            f"mstore(0xa0, calldataload(0x{self.w_cptr + 0x20:04x}))",
            f"success := ec_mul_tmp(success, sub(r, mload(0x{self.s_mptr:04x})))",
            "success := ec_add_acc(success, mload(0x80), mload(0xa0))",
            f"mstore(0x80, calldataload(0x{self.w_prime_cptr:04x}))",
            f"mstore(0xa0, calldataload(0x{self.w_prime_cptr + 0x20:04x}))",
            "success := ec_mul_tmp(success, mload(MU_MPTR))",
            "success := ec_add_acc(success, mload(0x80), mload(0xa0))",
            "mstore(PAIRING_LHS_X_MPTR, mload(0x00))",
            "mstore(PAIRING_LHS_Y_MPTR, mload(0x20))",
            f"mstore(PAIRING_RHS_X_MPTR, calldataload(0x{self.w_prime_cptr:04x}))",
            (
                "mstore(PAIRING_RHS_Y_MPTR, "
                f"calldataload(0x{self.w_prime_cptr + 0x20:04x}))"
            ),
        ]
        return self._block(lines=L)

    # ------------------------------------------------------------------
    def render(self) -> str:
        vk_block = "\n".join(
            f"                mstore(0x{self.vk_mptr + i * 0x20:04x}, "
            f"0x{v % (1 << 256):064x}) // {name}"
            for i, (name, v) in enumerate(self.vk_entries)
        )
        phase_loops = []
        for idx, count in enumerate(self.phase_points):
            phase_loops.append(f"""
                // Phase {idx + 1}
                for
                    {{ let proof_cptr_end := add(proof_cptr, 0x{count * 0x40:02x}) }}
                    lt(proof_cptr, proof_cptr_end)
                    {{}}
                {{
                    success, proof_cptr, hash_mptr := read_ec_point(success, proof_cptr, hash_mptr, q)
                }}

                challenge_mptr, hash_mptr := squeeze_challenge(challenge_mptr, hash_mptr, r)
{"                challenge_mptr := squeeze_challenge_cont(challenge_mptr, r)" if idx == 1 else ""}""")
        num_instance_cptr = self.proof_cptr + self.proof_len

        mptr_constants = "\n".join(
            f"    uint256 internal constant {name + '_MPTR':>22} = "
            f"0x{self.mptr_of[name]:04x};"
            for name in _CHALLENGES + _NAMED_MPTRS
        )
        bp1 = 0x20 * (self.blinders + 1)

        return VERIFIER_TEMPLATE.format(
            proof_len=self.proof_len,
            num_instance_cptr=num_instance_cptr,
            instance_cptr=num_instance_cptr + 0x20,
            first_quotient=self.first_quotient_cptr,
            last_quotient=self.last_quotient_cptr,
            vk_mptr=self.vk_mptr,
            num_instances_mptr=self.vk_mptr + 0x20 * self._vk_index["num_instances"],
            g1_x_mptr=self.vk_mptr + 0x20 * self._vk_index["g1_x"],
            g1_y_mptr=self.vk_mptr + 0x20 * self._vk_index["g1_y"],
            g2_x_1_mptr=self.vk_mptr + 0x20 * self._vk_index["g2_x_1"],
            neg_s_g2_x_1_mptr=self.vk_mptr + 0x20 * self._vk_index["neg_s_g2_x_1"],
            k_mptr=self.vk_mptr + 0x20 * self._vk_index["k"],
            n_inv_mptr=self.vk_mptr + 0x20 * self._vk_index["n_inv"],
            omega_mptr=self.vk_mptr + 0x20 * self._vk_index["omega"],
            omega_inv_mptr=self.vk_mptr + 0x20 * self._vk_index["omega_inv"],
            omega_inv_to_l_mptr=(
                self.vk_mptr + 0x20 * self._vk_index["omega_inv_to_l"]
            ),
            challenge_mptr=self.challenge_mptr,
            mptr_constants=mptr_constants,
            vk_block=vk_block,
            phase_loops="\n".join(phase_loops),
            num_eval_bytes=self.num_evals * 0x20,
            q=FQ_MOD,
            r=FR_MOD,
            delta=DELTA,
            blinders_plus_1=self.blinders + 1,
            bp1=bp1,
            bp1_plus_word=bp1 + 0x20,
            gate_blocks=self._gate_blocks(),
            argument_blocks=self._perm_lookup_blocks(),
            point_block=self._point_block(),
            mu_diff_block=self._mu_diff_block(),
            coeff_blocks=self._coeff_blocks(),
            normalize_block=self._normalize_block(),
            r_eval_blocks=self._r_eval_blocks(),
            sum_blocks=self._sum_blocks(),
            r_eval_combine_block=self._r_eval_combine_block(),
            pairing_acc_block=self._pairing_acc_block(),
        )


VERIFIER_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Generated by circuits_halo2_tpu_torch.contracts.sol_generator

pragma solidity ^0.8.0;

contract Verifier {{
    uint256 internal constant    PROOF_LEN_CPTR = 0x44;
    uint256 internal constant        PROOF_CPTR = 0x64;
    uint256 internal constant NUM_INSTANCE_CPTR = 0x{num_instance_cptr:04x};
    uint256 internal constant     INSTANCE_CPTR = 0x{instance_cptr:04x};

    uint256 internal constant FIRST_QUOTIENT_X_CPTR = 0x{first_quotient:04x};
    uint256 internal constant  LAST_QUOTIENT_X_CPTR = 0x{last_quotient:04x};

    uint256 internal constant                VK_MPTR = 0x{vk_mptr:04x};
    uint256 internal constant         VK_DIGEST_MPTR = 0x{vk_mptr:04x};
    uint256 internal constant                 K_MPTR = 0x{k_mptr:04x};
    uint256 internal constant             N_INV_MPTR = 0x{n_inv_mptr:04x};
    uint256 internal constant             OMEGA_MPTR = 0x{omega_mptr:04x};
    uint256 internal constant         OMEGA_INV_MPTR = 0x{omega_inv_mptr:04x};
    uint256 internal constant    OMEGA_INV_TO_L_MPTR = 0x{omega_inv_to_l_mptr:04x};
    uint256 internal constant     NUM_INSTANCES_MPTR = 0x{num_instances_mptr:04x};
    uint256 internal constant              G1_X_MPTR = 0x{g1_x_mptr:04x};
    uint256 internal constant              G1_Y_MPTR = 0x{g1_y_mptr:04x};
    uint256 internal constant            G2_X_1_MPTR = 0x{g2_x_1_mptr:04x};
    uint256 internal constant      NEG_S_G2_X_1_MPTR = 0x{neg_s_g2_x_1_mptr:04x};
    uint256 internal constant        CHALLENGE_MPTR = 0x{challenge_mptr:04x};

{mptr_constants}

    function verifyProof(
        bytes calldata proof,
        uint256[] calldata instances
    ) public view returns (bool) {{
        assembly {{
            function read_ec_point(success, proof_cptr, hash_mptr, q) -> ret0, ret1, ret2 {{
                let x := calldataload(proof_cptr)
                let y := calldataload(add(proof_cptr, 0x20))
                ret0 := and(success, lt(x, q))
                ret0 := and(ret0, lt(y, q))
                ret0 := and(ret0, eq(mulmod(y, y, q), addmod(mulmod(x, mulmod(x, x, q), q), 3, q)))
                mstore(hash_mptr, x)
                mstore(add(hash_mptr, 0x20), y)
                ret1 := add(proof_cptr, 0x40)
                ret2 := add(hash_mptr, 0x40)
            }}

            function squeeze_challenge(challenge_mptr, hash_mptr, r) -> ret0, ret1 {{
                let hash := keccak256(0x00, hash_mptr)
                mstore(challenge_mptr, mod(hash, r))
                mstore(0x00, hash)
                ret0 := add(challenge_mptr, 0x20)
                ret1 := 0x20
            }}

            function squeeze_challenge_cont(challenge_mptr, r) -> ret {{
                mstore8(0x20, 0x01)
                let hash := keccak256(0x00, 0x21)
                mstore(challenge_mptr, mod(hash, r))
                mstore(0x00, hash)
                ret := add(challenge_mptr, 0x20)
            }}

            // Batch invert values in memory[mptr_start..mptr_end] in place.
            function batch_invert(success, mptr_start, mptr_end, r) -> ret {{
                let gp_mptr := mptr_end
                let gp := mload(mptr_start)
                let mptr := add(mptr_start, 0x20)
                for
                    {{}}
                    lt(mptr, sub(mptr_end, 0x20))
                    {{}}
                {{
                    gp := mulmod(gp, mload(mptr), r)
                    mstore(gp_mptr, gp)
                    mptr := add(mptr, 0x20)
                    gp_mptr := add(gp_mptr, 0x20)
                }}
                gp := mulmod(gp, mload(mptr), r)

                mstore(gp_mptr, 0x20)
                mstore(add(gp_mptr, 0x20), 0x20)
                mstore(add(gp_mptr, 0x40), 0x20)
                mstore(add(gp_mptr, 0x60), gp)
                mstore(add(gp_mptr, 0x80), sub(r, 2))
                mstore(add(gp_mptr, 0xa0), r)
                ret := and(success, staticcall(gas(), 0x05, gp_mptr, 0xc0, gp_mptr, 0x20))
                let all_inv := mload(gp_mptr)

                let first_mptr := mptr_start
                let second_mptr := add(first_mptr, 0x20)
                gp_mptr := sub(gp_mptr, 0x20)
                for
                    {{}}
                    lt(second_mptr, mptr)
                    {{}}
                {{
                    let inv := mulmod(all_inv, mload(gp_mptr), r)
                    all_inv := mulmod(all_inv, mload(mptr), r)
                    mstore(mptr, inv)
                    mptr := sub(mptr, 0x20)
                    gp_mptr := sub(gp_mptr, 0x20)
                }}
                let inv_first := mulmod(all_inv, mload(second_mptr), r)
                let inv_second := mulmod(all_inv, mload(first_mptr), r)
                mstore(first_mptr, inv_first)
                mstore(second_mptr, inv_second)
            }}

            // Add (x, y) into point at (0x00, 0x20). Return updated success.
            function ec_add_acc(success, x, y) -> ret {{
                mstore(0x40, x)
                mstore(0x60, y)
                ret := and(success, staticcall(gas(), 0x06, 0x00, 0x80, 0x00, 0x40))
            }}

            // Scale point at (0x00, 0x20) by scalar.
            function ec_mul_acc(success, scalar) -> ret {{
                mstore(0x40, scalar)
                ret := and(success, staticcall(gas(), 0x07, 0x00, 0x60, 0x00, 0x40))
            }}

            // Add (x, y) into point at (0x80, 0xa0). Return updated success.
            function ec_add_tmp(success, x, y) -> ret {{
                mstore(0xc0, x)
                mstore(0xe0, y)
                ret := and(success, staticcall(gas(), 0x06, 0x80, 0x80, 0x80, 0x40))
            }}

            // Scale point at (0x80, 0xa0) by scalar.
            function ec_mul_tmp(success, scalar) -> ret {{
                mstore(0xc0, scalar)
                ret := and(success, staticcall(gas(), 0x07, 0x80, 0x60, 0x80, 0x40))
            }}

            // Perform pairing check. Return updated success.
            function ec_pairing(success, lhs_x, lhs_y, rhs_x, rhs_y) -> ret {{
                mstore(0x00, lhs_x)
                mstore(0x20, lhs_y)
                mstore(0x40, mload(G2_X_1_MPTR))
                mstore(0x60, mload(add(G2_X_1_MPTR, 0x20)))
                mstore(0x80, mload(add(G2_X_1_MPTR, 0x40)))
                mstore(0xa0, mload(add(G2_X_1_MPTR, 0x60)))
                mstore(0xc0, rhs_x)
                mstore(0xe0, rhs_y)
                mstore(0x100, mload(NEG_S_G2_X_1_MPTR))
                mstore(0x120, mload(add(NEG_S_G2_X_1_MPTR, 0x20)))
                mstore(0x140, mload(add(NEG_S_G2_X_1_MPTR, 0x40)))
                mstore(0x160, mload(add(NEG_S_G2_X_1_MPTR, 0x60)))
                ret := and(success, staticcall(gas(), 0x08, 0x00, 0x180, 0x00, 0x20))
                ret := and(ret, mload(0x00))
            }}

            let q := {q}
            let r := {r}
            let success := true

            {{
                // Load vk into memory
{vk_block}

                // Check valid length of proof
                success := and(success, eq(0x{proof_len:04x}, calldataload(PROOF_LEN_CPTR)))

                // Check valid length of instances
                let num_instances := mload(NUM_INSTANCES_MPTR)
                success := and(success, eq(num_instances, calldataload(NUM_INSTANCE_CPTR)))

                // Absorb vk digest
                mstore(0x00, mload(VK_DIGEST_MPTR))

                // Read instances and witness commitments and generate challenges
                let hash_mptr := 0x20
                let instance_cptr := INSTANCE_CPTR
                for
                    {{ let instance_cptr_end := add(instance_cptr, mul(0x20, num_instances)) }}
                    lt(instance_cptr, instance_cptr_end)
                    {{}}
                {{
                    let instance := calldataload(instance_cptr)
                    success := and(success, lt(instance, r))
                    mstore(hash_mptr, instance)
                    instance_cptr := add(instance_cptr, 0x20)
                    hash_mptr := add(hash_mptr, 0x20)
                }}

                let proof_cptr := PROOF_CPTR
                let challenge_mptr := CHALLENGE_MPTR
{phase_loops}

                // Read evaluations
                for
                    {{ let proof_cptr_end := add(proof_cptr, 0x{num_eval_bytes:04x}) }}
                    lt(proof_cptr, proof_cptr_end)
                    {{}}
                {{
                    let eval := calldataload(proof_cptr)
                    success := and(success, lt(eval, r))
                    mstore(hash_mptr, eval)
                    proof_cptr := add(proof_cptr, 0x20)
                    hash_mptr := add(hash_mptr, 0x20)
                }}

                // Read batch opening proof and generate challenges
                challenge_mptr, hash_mptr := squeeze_challenge(challenge_mptr, hash_mptr, r)       // zeta
                challenge_mptr := squeeze_challenge_cont(challenge_mptr, r)                        // nu
                success, proof_cptr, hash_mptr := read_ec_point(success, proof_cptr, hash_mptr, q) // W
                challenge_mptr, hash_mptr := squeeze_challenge(challenge_mptr, hash_mptr, r)       // mu
                success, proof_cptr, hash_mptr := read_ec_point(success, proof_cptr, hash_mptr, q) // W'
            }}

            // Revert earlier if anything from calldata is invalid
            if iszero(success) {{ revert(0, 0) }}

            // Compute lagrange evaluations and instance evaluation
            {{
                let k := mload(K_MPTR)
                let x := mload(X_MPTR)
                let x_n := x
                for
                    {{ let idx := 0 }}
                    lt(idx, k)
                    {{ idx := add(idx, 1) }}
                {{
                    x_n := mulmod(x_n, x_n, r)
                }}

                let omega := mload(OMEGA_MPTR)

                let mptr := X_N_MPTR
                let mptr_end := add(mptr, mul(0x20, add(mload(NUM_INSTANCES_MPTR), {blinders_plus_1})))
                if iszero(mload(NUM_INSTANCES_MPTR)) {{
                    mptr_end := add(mptr_end, 0x20)
                }}
                for
                    {{ let pow_of_omega := mload(OMEGA_INV_TO_L_MPTR) }}
                    lt(mptr, mptr_end)
                    {{ mptr := add(mptr, 0x20) }}
                {{
                    mstore(mptr, addmod(x, sub(r, pow_of_omega), r))
                    pow_of_omega := mulmod(pow_of_omega, omega, r)
                }}
                let x_n_minus_1 := addmod(x_n, sub(r, 1), r)
                mstore(mptr_end, x_n_minus_1)
                success := batch_invert(success, X_N_MPTR, add(mptr_end, 0x20), r)

                mptr := X_N_MPTR
                let l_i_common := mulmod(x_n_minus_1, mload(N_INV_MPTR), r)
                for
                    {{ let pow_of_omega := mload(OMEGA_INV_TO_L_MPTR) }}
                    lt(mptr, mptr_end)
                    {{ mptr := add(mptr, 0x20) }}
                {{
                    mstore(mptr, mulmod(l_i_common, mulmod(mload(mptr), pow_of_omega, r), r))
                    pow_of_omega := mulmod(pow_of_omega, omega, r)
                }}

                let l_blind := mload(add(X_N_MPTR, 0x20))
                let l_i_cptr := add(X_N_MPTR, 0x40)
                for
                    {{ let l_i_cptr_end := add(X_N_MPTR, 0x{bp1:02x}) }}
                    lt(l_i_cptr, l_i_cptr_end)
                    {{ l_i_cptr := add(l_i_cptr, 0x20) }}
                {{
                    l_blind := addmod(l_blind, mload(l_i_cptr), r)
                }}

                let instance_eval := 0
                for
                    {{
                        let instance_cptr := INSTANCE_CPTR
                        let instance_cptr_end := add(instance_cptr, mul(0x20, mload(NUM_INSTANCES_MPTR)))
                    }}
                    lt(instance_cptr, instance_cptr_end)
                    {{
                        instance_cptr := add(instance_cptr, 0x20)
                        l_i_cptr := add(l_i_cptr, 0x20)
                    }}
                {{
                    instance_eval := addmod(instance_eval, mulmod(mload(l_i_cptr), calldataload(instance_cptr), r), r)
                }}

                let x_n_minus_1_inv := mload(mptr_end)
                let l_last := mload(X_N_MPTR)
                let l_0 := mload(add(X_N_MPTR, 0x{bp1:02x}))

                mstore(X_N_MPTR, x_n)
                mstore(X_N_MINUS_1_INV_MPTR, x_n_minus_1_inv)
                mstore(L_LAST_MPTR, l_last)
                mstore(L_BLIND_MPTR, l_blind)
                mstore(L_0_MPTR, l_0)
                mstore(INSTANCE_EVAL_MPTR, instance_eval)
            }}

            // Compute quotient evaluation
            {{
                let quotient_eval_numer
                let delta := {delta}
                let y := mload(Y_MPTR)
{gate_blocks}
{argument_blocks}

                pop(y)
                pop(delta)

                let quotient_eval := mulmod(quotient_eval_numer, mload(X_N_MINUS_1_INV_MPTR), r)
                mstore(QUOTIENT_EVAL_MPTR, quotient_eval)
            }}

            // Compute quotient commitment
            {{
                mstore(0x00, calldataload(LAST_QUOTIENT_X_CPTR))
                mstore(0x20, calldataload(add(LAST_QUOTIENT_X_CPTR, 0x20)))
                let x_n := mload(X_N_MPTR)
                for
                    {{
                        let cptr := sub(LAST_QUOTIENT_X_CPTR, 0x40)
                        let cptr_end := sub(FIRST_QUOTIENT_X_CPTR, 0x40)
                    }}
                    lt(cptr_end, cptr)
                    {{}}
                {{
                    success := ec_mul_acc(success, x_n)
                    success := ec_add_acc(success, calldataload(cptr), calldataload(add(cptr, 0x20)))
                    cptr := sub(cptr, 0x40)
                }}
                mstore(QUOTIENT_X_MPTR, mload(0x00))
                mstore(QUOTIENT_Y_MPTR, mload(0x20))
            }}

            // Compute pairing lhs and rhs
            {{
{point_block}
{mu_diff_block}
{coeff_blocks}
{normalize_block}
{r_eval_blocks}
{sum_blocks}
{r_eval_combine_block}
{pairing_acc_block}
            }}

            // Perform pairing
            success := ec_pairing(
                success,
                mload(PAIRING_LHS_X_MPTR),
                mload(PAIRING_LHS_Y_MPTR),
                mload(PAIRING_RHS_X_MPTR),
                mload(PAIRING_RHS_Y_MPTR)
            )

            // Revert if anything fails
            if iszero(success) {{ revert(0x00, 0x00) }}

            // Return 1 as result if everything succeeds
            mstore(0x00, 1)
            return(0x00, 0x20)
        }}
    }}
}}
"""
