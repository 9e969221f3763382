"""Frozen copy of ``circuits_halo2_tpu_torch/models/pow5.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

Port copy of ``circuits_halo2_tpu/models/pow5.py`` (host circuit code;
imports re-pointed to the port's jax-free Poseidon constants).

Poseidon hash chip — in-circuit Pow5 gate structure and region layout.

Behavioral parity targets: the reference's PoseidonChip wrapper
(`zk_prover/src/chips/poseidon/hash.rs:26-88`) around the halo2_gadgets
Pow5Chip, with the compiled gate structure pinned by the generated verifier
(`contracts/src/InclusionVerifier.sol` gate blocks):

- full round:    s_full · (Σ_j pow5(state_j + rc_a_j)·M[i][j] − state_i(ω))
- partial round: s_partial · [pow5(cur_0 + rc_a_0) − mid;
                 pow5(mid·M[0][0] + (cur_1+rc_a_1)·M[0][1] + rc_b_0)
                   − (next_0·M⁻¹[0][0] + next_1·M⁻¹[0][1]);
                 mid·M[1][0] + (cur_1+rc_a_1)·M[1][1] + rc_b_1
                   − (next_0·M⁻¹[1][0] + next_1·M⁻¹[1][1])]
                 (two Poseidon rounds per row)
- pad-and-add:   s · (initial_i + input_i − output_i), s · (init_cap − out_cap)

Region layout: permutation region = 37 rows (4 full, 28 double-partial,
4 full, final state row); sponge per ConstantLength<L>: initial-state region
(constants 0 and L<<64), then L × (add-input region [3 rows], permute).
"""

from __future__ import annotations

from . import expr as E
from . import poseidon as P
from .field import FR_MOD
from .assignment import Assignment, Cell, Region
from .cs import Column, ConstraintSystem

WIDTH = 2
RATE = 1
HALF_FULL = P.R_FULL // 2
HALF_PARTIAL = P.R_PARTIAL // 2


def _pow5(v: E.Expr) -> E.Expr:
    v2 = v * v
    v4 = v2 * v2
    return v4 * v


class Pow5Config:
    def __init__(self, state, partial_sbox, rc_a, rc_b, s_full, s_partial, s_pad):
        self.state = state
        self.partial_sbox = partial_sbox
        self.rc_a = rc_a
        self.rc_b = rc_b
        self.s_full = s_full
        self.s_partial = s_partial
        self.s_pad_and_add = s_pad


def configure(
    cs: ConstraintSystem,
    state: list[Column],
    partial_sbox: Column,
    rc_a: list[Column],
    rc_b: list[Column],
) -> Pow5Config:
    # halo2_gadgets Pow5Chip::configure semantics: equality on the state
    # AND all rc_b columns (rc_b doubles as fixed "scratch space"), but
    # enable_constant on rc_b[0] ONLY — the distinction is invisible to
    # keygen output yet pins the `constants` list in the VK digest
    # (PinnedConstraintSystem.constants = [rc_b[0]]).
    for col in state:
        cs.enable_equality(col)
    for col in rc_b:
        cs.enable_equality(col)
    cs.enable_constant(rc_b[0])

    s_full = cs.selector()
    s_partial = cs.selector()
    s_pad_and_add = cs.selector()

    m = P.MDS
    m_inv = P.MDS_INV

    def full_round(meta):
        s = s_full
        constraints = []
        for next_idx in range(WIDTH):
            state_next = meta.query_advice(state[next_idx], 1)
            expr = None
            for idx in range(WIDTH):
                cur = meta.query_advice(state[idx], 0)
                rc = meta.query_fixed(rc_a[idx], 0)
                term = _pow5(cur + rc) * m[next_idx][idx]
                expr = term if expr is None else expr + term
            constraints.append(s * (expr - state_next))
        return constraints

    cs.create_gate("full round", full_round)

    def partial_rounds(meta):
        cur_0 = meta.query_advice(state[0], 0)
        mid_0 = meta.query_advice(partial_sbox, 0)
        rc_a0 = meta.query_fixed(rc_a[0], 0)

        def mid(idx):
            expr = mid_0 * m[idx][0]
            cur_1 = meta.query_advice(state[1], 0)
            rc_a1 = meta.query_fixed(rc_a[1], 0)
            return expr + (cur_1 + rc_a1) * m[idx][1]

        def nxt(idx):
            expr = None
            for next_idx in range(WIDTH):
                nx = meta.query_advice(state[next_idx], 1)
                term = nx * m_inv[idx][next_idx]
                expr = term if expr is None else expr + term
            return expr

        rc_b0 = meta.query_fixed(rc_b[0], 0)
        c0 = _pow5(cur_0 + rc_a0) - mid_0
        c1 = _pow5(mid(0) + rc_b0) - nxt(0)
        rc_b1 = meta.query_fixed(rc_b[1], 0)
        c2 = mid(1) + rc_b1 - nxt(1)
        return [s_partial * c0, s_partial * c1, s_partial * c2]

    cs.create_gate("partial rounds", partial_rounds)

    def pad_and_add(meta):
        initial_rate = meta.query_advice(state[RATE], -1)
        output_rate = meta.query_advice(state[RATE], 1)
        constraints = []
        for idx in range(RATE):
            initial = meta.query_advice(state[idx], -1)
            inp = meta.query_advice(state[idx], 0)
            output = meta.query_advice(state[idx], 1)
            constraints.append(s_pad_and_add * (initial + inp - output))
        constraints.append(s_pad_and_add * (initial_rate - output_rate))
        return constraints

    cs.create_gate("pad-and-add", pad_and_add)

    return Pow5Config(state, partial_sbox, rc_a, rc_b, s_full, s_partial, s_pad_and_add)


class Pow5Chip:
    def __init__(self, config: Pow5Config):
        self.config = config

    # -- synthesis ----------------------------------------------------------

    def initial_state(self, asn: Assignment, length: int) -> list[Cell]:
        cfg = self.config
        cap = (length << 64) % FR_MOD

        def body(region: Region):
            w0 = region.assign_advice_from_constant(cfg.state[0], 0, 0)
            w1 = region.assign_advice_from_constant(cfg.state[1], 0, cap)
            return [w0, w1]

        return asn.assign_region(f"initial state for domain ConstantLength<{length}>", body)

    def add_input(self, asn: Assignment, state: list[Cell], input_word: Cell):
        cfg = self.config

        def body(region: Region):
            region.enable_selector(cfg.s_pad_and_add, 1)
            initial = [
                region.copy_advice(state[i], cfg.state[i], 0) for i in range(WIDTH)
            ]
            inp = region.copy_advice(input_word, cfg.state[0], 1)
            out0 = region.assign_advice(
                cfg.state[0], 2, (initial[0].value + inp.value) % FR_MOD
            )
            out1 = region.assign_advice(cfg.state[1], 2, initial[1].value)
            return [out0, out1]

        return asn.assign_region("add input to poseidon state", body)

    def permute(self, asn: Assignment, state: list[Cell]) -> list[Cell]:
        cfg = self.config
        rc = P.ROUND_CONSTANTS
        m = P.MDS
        p = FR_MOD

        def full_round_values(s, round_idx):
            sboxed = [pow((s[i] + rc[round_idx][i]) % p, 5, p) for i in range(WIDTH)]
            return [
                sum(m[i][j] * sboxed[j] for j in range(WIDTH)) % p for i in range(WIDTH)
            ]

        def partial_round_values(s, round_idx):
            # two rounds: round_idx (sbox word 0 w/ rc_a), round_idx+1 (rc_b)
            r0 = pow((s[0] + rc[round_idx][0]) % p, 5, p)
            r1 = (s[1] + rc[round_idx][1]) % p
            mid = [sum(m[i][j] * [r0, r1][j] for j in range(WIDTH)) % p for i in range(WIDTH)]
            r0b = pow((mid[0] + rc[round_idx + 1][0]) % p, 5, p)
            r1b = (mid[1] + rc[round_idx + 1][1]) % p
            return (
                r0,
                [sum(m[i][j] * [r0b, r1b][j] for j in range(WIDTH)) % p for i in range(WIDTH)],
            )

        def body(region: Region):
            cells = [region.copy_advice(state[i], cfg.state[i], 0) for i in range(WIDTH)]
            vals = [c.value for c in cells]
            offset = 0
            for r in range(HALF_FULL):
                region.enable_selector(cfg.s_full, offset)
                for i in range(WIDTH):
                    region.assign_fixed(cfg.rc_a[i], offset, rc[r][i])
                vals = full_round_values(vals, r)
                cells = [
                    region.assign_advice(cfg.state[i], offset + 1, vals[i])
                    for i in range(WIDTH)
                ]
                offset += 1
            for r in range(HALF_PARTIAL):
                round_idx = HALF_FULL + 2 * r
                region.enable_selector(cfg.s_partial, offset)
                for i in range(WIDTH):
                    region.assign_fixed(cfg.rc_a[i], offset, rc[round_idx][i])
                sbox0, new_vals = partial_round_values(vals, round_idx)
                region.assign_advice(cfg.partial_sbox, offset, sbox0)
                for i in range(WIDTH):
                    region.assign_fixed(cfg.rc_b[i], offset, rc[round_idx + 1][i])
                vals = new_vals
                cells = [
                    region.assign_advice(cfg.state[i], offset + 1, vals[i])
                    for i in range(WIDTH)
                ]
                offset += 1
            for r in range(HALF_FULL):
                round_idx = P.R_FULL // 2 + P.R_PARTIAL + r
                region.enable_selector(cfg.s_full, offset)
                for i in range(WIDTH):
                    region.assign_fixed(cfg.rc_a[i], offset, rc[round_idx][i])
                vals = full_round_values(vals, round_idx)
                cells = [
                    region.assign_advice(cfg.state[i], offset + 1, vals[i])
                    for i in range(WIDTH)
                ]
                offset += 1
            return cells

        return asn.assign_region("permute state", body)

    def hash(self, asn: Assignment, input_cells: list[Cell]) -> Cell:
        """ConstantLength<L> sponge: absorb every word, squeeze state[0]."""
        length = len(input_cells)
        state = self.initial_state(asn, length)
        for word in input_cells:
            state = self.add_input(asn, state, word)
            state = self.permute(asn, state)
        return state[0]
