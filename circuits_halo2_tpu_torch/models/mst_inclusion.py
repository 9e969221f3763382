"""Port copy of ``circuits_halo2_tpu/models/mst_inclusion.py`` (host circuit
code; imports re-pointed to the port's tree and Poseidon).

The MstInclusion circuit — proof of inclusion in a Merkle sum tree.

Parity target: `zk_prover/src/circuits/merkle_sum_tree.rs:31-521`.
Public instances (one column): [leaf_hash, root_hash, root_balances...].

``configure`` builds the constraint system in the reference's exact order
(3 advice, 5 fixed, 2 simple + 1 complex selector, enable_constant on
fixed[2], two shared-column Poseidon configs, merkle chip, range chip,
instance) so that compiled queries/permutation match the reference keygen.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import pow5
from ..merkle.mst import MerkleProof
from ..ops import poseidon
from ..ops.field import FR_MOD
from .assignment import Assignment, Region
from .chips import MerkleSumTreeChip, RangeCheckChip
from .cs import ConstraintSystem


@dataclass
class MstInclusionConfig:
    cs: ConstraintSystem
    advices: list
    fixed_columns: list
    instance: object
    poseidon_entry: pow5.Pow5Config
    poseidon_middle: pow5.Pow5Config
    merkle_chip: MerkleSumTreeChip
    range_chip: RangeCheckChip


class MstInclusionCircuit:
    def __init__(self, levels: int, n_currencies: int, n_bytes: int):
        self.levels = levels
        self.n_currencies = n_currencies
        self.n_bytes = n_bytes
        # witness (None = empty circuit for keygen)
        self.entry_username = 0
        self.entry_balances = [0] * n_currencies
        self.path_indices = [0] * levels
        self.sibling_leaf_node_hash_preimage = [0] * (n_currencies + 1)
        self.sibling_middle_node_hash_preimages = [
            [0] * (n_currencies + 2) for _ in range(levels)
        ]
        self.root_hash = 0
        self.root_balances = [0] * n_currencies

    @classmethod
    def init(cls, levels: int, n_currencies: int, n_bytes: int, proof: MerkleProof):
        assert len(proof.path_indices) == levels
        assert len(proof.sibling_middle_node_hash_preimages) == levels - 1
        c = cls(levels, n_currencies, n_bytes)
        c.entry_username = proof.entry.hashed_username % FR_MOD
        c.entry_balances = [b % FR_MOD for b in proof.entry.balances]
        c.path_indices = list(proof.path_indices)
        c.sibling_leaf_node_hash_preimage = list(proof.sibling_leaf_node_hash_preimage)
        c.sibling_middle_node_hash_preimages = [
            list(p) for p in proof.sibling_middle_node_hash_preimages
        ]
        c.root_hash = proof.root.hash
        c.root_balances = list(proof.root.balances)
        return c

    @classmethod
    def init_empty(cls, levels: int, n_currencies: int, n_bytes: int):
        return cls(levels, n_currencies, n_bytes)

    # -- public inputs ------------------------------------------------------

    def num_instances(self) -> int:
        return 2 + self.n_currencies

    def instances(self) -> list[list[int]]:
        leaf_hash = poseidon.hash_n([self.entry_username] + self.entry_balances)
        return [[leaf_hash, self.root_hash] + list(self.root_balances)]

    # -- configure ----------------------------------------------------------

    def configure(self, cs: ConstraintSystem) -> MstInclusionConfig:
        advices = [cs.advice_column() for _ in range(3)]
        fixed_columns = [cs.fixed_column() for _ in range(5)]
        selectors = [cs.selector() for _ in range(2)]
        enable_lookup_selector = cs.complex_selector()

        cs.enable_constant(fixed_columns[2])

        poseidon_entry = pow5.configure(
            cs, advices[0:2], advices[2], fixed_columns[0:2], fixed_columns[2:4]
        )
        poseidon_middle = pow5.configure(
            cs, advices[0:2], advices[2], fixed_columns[0:2], fixed_columns[2:4]
        )

        for col in advices:
            cs.enable_equality(col)

        merkle_chip = MerkleSumTreeChip.configure(
            cs, advices[0:3], selectors[0:2], self.n_currencies
        )
        range_chip = RangeCheckChip.configure(
            cs, advices[0], fixed_columns[4], enable_lookup_selector, self.n_bytes
        )

        instance = cs.instance_column()
        cs.enable_equality(instance)

        return MstInclusionConfig(
            cs,
            advices,
            fixed_columns,
            instance,
            poseidon_entry,
            poseidon_middle,
            merkle_chip,
            range_chip,
        )

    # -- synthesize ---------------------------------------------------------

    def _assign_value(self, asn: Assignment, value: int, label: str, column):
        return asn.assign_region(
            f"assign {label}", lambda region: region.assign_advice(column, 0, value)
        )

    def _load_u8_table(self, asn: Assignment, column):
        def body(region: Region):
            for i in range(1 << 8):
                region.assign_fixed(column, i, i)

        asn.assign_region("load range check table of 8 bits", body)

    def synthesize(self, config: MstInclusionConfig, asn: Assignment):
        entry_chip = pow5.Pow5Chip(config.poseidon_entry)
        middle_chip = pow5.Pow5Chip(config.poseidon_middle)
        merkle_chip = config.merkle_chip
        range_chip = config.range_chip
        ncur = self.n_currencies

        username = self._assign_value(
            asn, self.entry_username, "entry username", config.advices[0]
        )
        current_balances = [
            self._assign_value(asn, b, "entry balance", config.advices[1])
            for b in self.entry_balances
        ]

        current_hash = entry_chip.hash(asn, [username] + current_balances)
        asn.constrain_instance(current_hash, config.instance, 0)

        self._load_u8_table(asn, config.fixed_columns[4])

        for level in range(self.levels):
            sibling_balances = []
            if level == 0:
                sibling_username = self._assign_value(
                    asn,
                    self.sibling_leaf_node_hash_preimage[0],
                    "sibling leaf node username",
                    config.advices[0],
                )
                for currency in range(ncur):
                    sibling_balances.append(
                        self._assign_value(
                            asn,
                            self.sibling_leaf_node_hash_preimage[currency + 1],
                            "sibling leaf balance",
                            config.advices[1],
                        )
                    )
                sibling_hash = entry_chip.hash(
                    asn, [sibling_username] + sibling_balances
                )
                for currency in range(ncur):
                    range_chip.assign(asn, current_balances[currency])
                    range_chip.assign(asn, sibling_balances[currency])
            else:
                preimage = self.sibling_middle_node_hash_preimages[level - 1]
                for currency in range(ncur):
                    sibling_balances.append(
                        self._assign_value(
                            asn,
                            preimage[currency],
                            "sibling node balance",
                            config.advices[1],
                        )
                    )
                left_hash = self._assign_value(
                    asn, preimage[ncur], "sibling left hash", config.advices[2]
                )
                right_hash = self._assign_value(
                    asn, preimage[ncur + 1], "sibling right hash", config.advices[2]
                )
                sibling_hash = middle_chip.hash(
                    asn, sibling_balances + [left_hash, right_hash]
                )
                for currency in range(ncur):
                    range_chip.assign(asn, sibling_balances[currency])

            swap_bit = self._assign_value(
                asn, self.path_indices[level], "swap bit", config.advices[0]
            )
            hash_left, hash_right = merkle_chip.swap_hashes_per_level(
                asn, current_hash, sibling_hash, swap_bit
            )
            next_balances = []
            for currency in range(ncur):
                next_balances.append(
                    merkle_chip.sum_balances_per_level(
                        asn, current_balances[currency], sibling_balances[currency]
                    )
                )
            current_hash = middle_chip.hash(
                asn, next_balances + [hash_left, hash_right]
            )
            current_balances = next_balances

        asn.constrain_instance(current_hash, config.instance, 1)
        for i, balance in enumerate(current_balances):
            asn.constrain_instance(balance, config.instance, 2 + i)


def compile_circuit(levels: int, n_currencies: int, n_bytes: int, k: int):
    """Configure + keygen-style synthesis (fixed/selectors/copies) for the
    empty circuit; returns (cs, config, assignment) with selectors already
    compressed into fixed columns."""
    n = 1 << k
    circuit = MstInclusionCircuit.init_empty(levels, n_currencies, n_bytes)
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    asn = Assignment(cs, n, [[0] * circuit.num_instances()])
    circuit.synthesize(config, asn)
    new_cols, new_values = cs.compress_selectors(
        [list(act) for act in asn.selectors], n
    )
    for values in new_values:
        asn.fixed.append(list(values))
    return circuit, cs, config, asn
