"""Frozen copy of ``circuits_halo2_tpu_torch/models/chips.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

MerkleSumTree and RangeCheck chips.

Parity targets: `zk_prover/src/chips/merkle_sum_tree.rs:29-228` (bool/swap/
sum gates + 2-row swap and 1-row sum regions) and
`zk_prover/src/chips/range/range_check.rs:24-154` (8-bit running-sum
decomposition with a u8 lookup).
"""

from __future__ import annotations

from .field import FR_MOD
from . import expr as E
from .assignment import Assignment, Cell, Region
from .cs import Column, ConstraintSystem


class MerkleSumTreeChip:
    def __init__(self, advice, bool_and_swap_selector, sum_selector, n_currencies):
        self.advice = advice
        self.bool_and_swap_selector = bool_and_swap_selector
        self.sum_selector = sum_selector
        self.n_currencies = n_currencies

    @classmethod
    def configure(cls, cs: ConstraintSystem, advice, selectors, n_currencies):
        col_a, col_b, col_c = advice
        bool_and_swap_selector, sum_selector = selectors

        def bool_gate(meta):
            s = bool_and_swap_selector
            swap_bit = meta.query_advice(col_c, 0)
            return [s * swap_bit * (E.Const(1) - swap_bit)]

        cs.create_gate("bool constraint", bool_gate)

        def swap_gate(meta):
            s = bool_and_swap_selector
            swap_bit = meta.query_advice(col_c, 0)
            l_cur = meta.query_advice(col_a, 0)
            r_cur = meta.query_advice(col_b, 0)
            l_next = meta.query_advice(col_a, 1)
            r_next = meta.query_advice(col_b, 1)
            c1 = s * ((r_cur - l_cur) * swap_bit + l_cur - l_next)
            c2 = s * ((l_cur - r_cur) * swap_bit + r_cur - r_next)
            return [c1, c2]

        cs.create_gate("swap constraint", swap_gate)

        def sum_gate(meta):
            out = []
            for _ in range(n_currencies):
                left = meta.query_advice(col_a, 0)
                right = meta.query_advice(col_b, 0)
                total = meta.query_advice(col_c, 0)
                out.append(sum_selector * (left + right - total))
            return out

        cs.create_gate("sum constraint", sum_gate)

        return cls(advice, bool_and_swap_selector, sum_selector, n_currencies)

    def swap_hashes_per_level(
        self, asn: Assignment, current_hash: Cell, sibling_hash: Cell, swap_bit: Cell
    ):
        def body(region: Region):
            region.enable_selector(self.bool_and_swap_selector, 0)
            l1 = region.copy_advice(current_hash, self.advice[0], 0)
            r1 = region.copy_advice(sibling_hash, self.advice[1], 0)
            bit = region.copy_advice(swap_bit, self.advice[2], 0)
            l_val, r_val = (
                (l1.value, r1.value) if bit.value == 0 else (r1.value, l1.value)
            )
            left = region.assign_advice(self.advice[0], 1, l_val)
            right = region.assign_advice(self.advice[1], 1, r_val)
            return left, right

        return asn.assign_region("assign nodes hashes per merkle tree level", body)

    def sum_balances_per_level(
        self, asn: Assignment, current_balance: Cell, element_balance: Cell
    ) -> Cell:
        def body(region: Region):
            region.enable_selector(self.sum_selector, 0)
            a = region.copy_advice(current_balance, self.advice[0], 0)
            b = region.copy_advice(element_balance, self.advice[1], 0)
            return region.assign_advice(
                self.advice[2], 0, (a.value + b.value) % FR_MOD
            )

        return asn.assign_region("sum nodes balances per currency", body)


def decompose_fp_to_bytes(value: int, n_bytes: int) -> list[int]:
    """LE byte decomposition, padded/truncated to n_bytes
    (`chips/range/utils.rs:12-34` — truncation warns in the reference)."""
    raw = value.to_bytes((value.bit_length() + 7) // 8 or 1, "little")
    out = list(raw[:n_bytes]) + [0] * max(0, n_bytes - len(raw))
    return out


class RangeCheckChip:
    def __init__(self, z: Column, lookup_enable_selector, n_bytes: int):
        self.z = z
        self.lookup_enable_selector = lookup_enable_selector
        self.n_bytes = n_bytes

    @classmethod
    def configure(
        cls,
        cs: ConstraintSystem,
        z: Column,
        lookup_u8_table: Column,
        lookup_enable_selector,
        n_bytes: int,
    ):
        def lookup(meta):
            z_cur = meta.query_advice(z, 0)
            z_next = meta.query_advice(z, 1)
            sel = lookup_enable_selector
            u8_range = meta.query_fixed(lookup_u8_table, 0)
            # reference builds this as z_next * Expression::Constant(256)
            # (a Product node, not Scaled) — mirrored for VK-digest parity.
            diff = z_cur - E.Product(z_next, E.Const(1 << 8))
            return [(sel * diff, u8_range)]

        cs.lookup_any(
            "range u8 check for difference between each interstitial running sum output",
            lookup,
        )
        return cls(z, lookup_enable_selector, n_bytes)

    def assign(self, asn: Assignment, value: Cell):
        inv256 = pow(1 << 8, -1, FR_MOD)

        def body(region: Region):
            for i in range(self.n_bytes):
                region.enable_selector(self.lookup_enable_selector, i)
            z0 = region.copy_advice(value, self.z, 0)
            bytes_ = decompose_fp_to_bytes(value.value, self.n_bytes)
            zs = [z0]
            z = z0
            for i, byte in enumerate(bytes_):
                z_next_val = (z.value - byte) * inv256 % FR_MOD
                z = region.assign_advice(self.z, i + 1, z_next_val)
                zs.append(z)
            region.constrain_constant(zs[self.n_bytes], 0)

        asn.assign_region("assign value to perform range check", body)
