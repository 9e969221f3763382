"""Incremental inclusion: one user's inclusion across successive rounds as
one verifiable chain (the reference's Nova example,
``zk_prover/examples/nova_incremental_verifier.rs``), in the PLONKish IR.

Each step takes ``[user_state_prev, liabilities_state_prev]``, proves the
round's MST inclusion and outputs

    user_state_cur        = H(user_state_prev, leaf_hash)
    liabilities_state_cur = H(liabilities_state_prev, root_hash)

Two forms: per-round step proofs chained by public-input equality
(``prove_chain`` / ``verify_chain`` / ``verify_chain_compressed``), and one
SNARK over N steps whose state cells chain by copy constraints
(``prove_chain_snark`` / ``verify_chain_snark``). Every round's tree is
built on the artifacts' device (K1 on the card) and every proof goes
through the device prover (K3). The circom-Poseidon witness chain lives in
``merkle/circom_mst.py``; Nova folding and Spartan in ``nova_fold`` and
``spartan``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import pow5
from ..merkle.circom_mst import parse_states_csv
from ..merkle.mst import Cryptocurrency, Entry, MerkleProof, MerkleSumTree
from ..ops import curve as C
from ..ops import pairing as PAIR
from ..ops import poseidon
from ..ops.field import FR_MOD
from .assignment import Assignment
from .cs import ConstraintSystem
from .mst_inclusion import MstInclusionCircuit, MstInclusionConfig
from .verifier import verify as _verify


def _walk_path(asn: Assignment, config: MstInclusionConfig, w: MstInclusionCircuit,
               entry_chip, middle_chip, current_hash, current_balances):
    """Assign witness ``w``'s Merkle path from its leaf (hash cell and
    balance cells) up to the root, with the range checks; returns the root
    hash cell. The same regions, in the same order, as
    ``MstInclusionCircuit.synthesize``."""
    merkle_chip, range_chip = config.merkle_chip, config.range_chip
    ncur = w.n_currencies
    for level in range(w.levels):
        sibling_balances = []
        if level == 0:
            sibling_username = w._assign_value(
                asn, w.sibling_leaf_node_hash_preimage[0], "sibling leaf node username",
                config.advices[0])
            for currency in range(ncur):
                sibling_balances.append(w._assign_value(
                    asn, w.sibling_leaf_node_hash_preimage[currency + 1],
                    "sibling leaf balance", config.advices[1]))
            sibling_hash = entry_chip.hash(asn, [sibling_username] + sibling_balances)
            for currency in range(ncur):
                range_chip.assign(asn, current_balances[currency])
                range_chip.assign(asn, sibling_balances[currency])
        else:
            preimage = w.sibling_middle_node_hash_preimages[level - 1]
            for currency in range(ncur):
                sibling_balances.append(w._assign_value(
                    asn, preimage[currency], "sibling node balance", config.advices[1]))
            left_hash = w._assign_value(asn, preimage[ncur], "sibling left hash",
                                        config.advices[2])
            right_hash = w._assign_value(asn, preimage[ncur + 1], "sibling right hash",
                                         config.advices[2])
            sibling_hash = middle_chip.hash(asn, sibling_balances + [left_hash, right_hash])
            for currency in range(ncur):
                range_chip.assign(asn, sibling_balances[currency])

        swap_bit = w._assign_value(asn, w.path_indices[level], "swap bit", config.advices[0])
        hash_left, hash_right = merkle_chip.swap_hashes_per_level(
            asn, current_hash, sibling_hash, swap_bit)
        next_balances = [
            merkle_chip.sum_balances_per_level(asn, current_balances[c], sibling_balances[c])
            for c in range(ncur)]
        current_hash = middle_chip.hash(asn, next_balances + [hash_left, hash_right])
        current_balances = next_balances
    return current_hash


def _assign_leaf(asn: Assignment, config: MstInclusionConfig, w: MstInclusionCircuit,
                 entry_chip):
    """The entry's username and balance cells and its leaf hash cell."""
    username = w._assign_value(asn, w.entry_username, "entry username", config.advices[0])
    balances = [w._assign_value(asn, b, "entry balance", config.advices[1])
                for b in w.entry_balances]
    return entry_chip.hash(asn, [username] + balances), balances


class IncrementalMstInclusionCircuit(MstInclusionCircuit):
    """One step: MST inclusion and the two state-chain hashes.

    Public instances (one column, 4 rows):
        [user_state_prev, liabilities_state_prev,
         user_state_cur,  liabilities_state_cur]
    """

    def __init__(self, levels: int, n_currencies: int, n_bytes: int):
        super().__init__(levels, n_currencies, n_bytes)
        self.user_state_prev = 0
        self.liab_state_prev = 0

    @classmethod
    def init_step(cls, levels: int, n_currencies: int, n_bytes: int, proof: MerkleProof,
                  user_state_prev: int, liab_state_prev: int) -> "IncrementalMstInclusionCircuit":
        c = cls.init(levels, n_currencies, n_bytes, proof)
        c.user_state_prev = user_state_prev % FR_MOD
        c.liab_state_prev = liab_state_prev % FR_MOD
        return c

    def num_instances(self) -> int:
        return 4

    def leaf_hash(self) -> int:
        return poseidon.hash_n([self.entry_username] + self.entry_balances)

    def instances(self) -> list[list[int]]:
        user_cur = poseidon.hash_n([self.user_state_prev, self.leaf_hash()])
        liab_cur = poseidon.hash_n([self.liab_state_prev, self.root_hash])
        return [[self.user_state_prev, self.liab_state_prev, user_cur, liab_cur]]

    def synthesize(self, config: MstInclusionConfig, asn: Assignment):
        entry_chip = pow5.Pow5Chip(config.poseidon_entry)
        middle_chip = pow5.Pow5Chip(config.poseidon_middle)

        user_state_prev = self._assign_value(asn, self.user_state_prev, "user state prev",
                                             config.advices[0])
        liab_state_prev = self._assign_value(asn, self.liab_state_prev,
                                             "liabilities state prev", config.advices[0])
        asn.constrain_instance(user_state_prev, config.instance, 0)
        asn.constrain_instance(liab_state_prev, config.instance, 1)

        leaf, balances = _assign_leaf(asn, config, self, entry_chip)
        user_state_cur = entry_chip.hash(asn, [user_state_prev, leaf])
        asn.constrain_instance(user_state_cur, config.instance, 2)

        self._load_u8_table(asn, config.fixed_columns[4])
        root = _walk_path(asn, config, self, entry_chip, middle_chip, leaf, balances)
        liab_state_cur = entry_chip.hash(asn, [liab_state_prev, root])
        asn.constrain_instance(liab_state_cur, config.instance, 3)


class ChainedMstInclusionCircuit(IncrementalMstInclusionCircuit):
    """N steps in ONE SNARK: every step's full MST inclusion and range
    checks, with the state cells chained across steps by cell reuse (a
    copy-constraint chain). One proof, and one transcript replay and one
    pairing to verify, independent of N; proving cost is O(N) rows (N
    bounded by 2^k). Public instances: [user_state_0, liab_state_0,
    user_state_N, liab_state_N], the first two always 0."""

    def __init__(self, levels: int, n_currencies: int, n_bytes: int, nsteps: int):
        super().__init__(levels, n_currencies, n_bytes)
        self.nsteps = nsteps
        self.step_witnesses: list[IncrementalMstInclusionCircuit] = [
            IncrementalMstInclusionCircuit(levels, n_currencies, n_bytes) for _ in range(nsteps)]

    @classmethod
    def init_chain(cls, levels: int, n_currencies: int, n_bytes: int,
                   proofs: list[MerkleProof]) -> "ChainedMstInclusionCircuit":
        c = cls(levels, n_currencies, n_bytes, len(proofs))
        us, ls = 0, 0
        for i, mp in enumerate(proofs):
            step = IncrementalMstInclusionCircuit.init_step(levels, n_currencies, n_bytes, mp,
                                                            us, ls)
            c.step_witnesses[i] = step
            us, ls = step.instances()[0][2:]
        return c

    def instances(self) -> list[list[int]]:
        us, ls = 0, 0
        for step in self.step_witnesses:
            inst = step.instances()[0]
            if inst[0] != us or inst[1] != ls:
                raise ValueError("step witnesses are not a valid chain")
            us, ls = inst[2], inst[3]
        return [[0, 0, us, ls]]

    def synthesize(self, config: MstInclusionConfig, asn: Assignment):
        entry_chip = pow5.Pow5Chip(config.poseidon_entry)
        middle_chip = pow5.Pow5Chip(config.poseidon_middle)

        user_state = self._assign_value(asn, 0, "user state 0", config.advices[0])
        liab_state = self._assign_value(asn, 0, "liabilities state 0", config.advices[0])
        asn.constrain_instance(user_state, config.instance, 0)
        asn.constrain_instance(liab_state, config.instance, 1)

        self._load_u8_table(asn, config.fixed_columns[4])  # shared by all steps
        for w in self.step_witnesses:
            leaf, balances = _assign_leaf(asn, config, w, entry_chip)
            # the previous step's output cell feeds the sponge directly
            user_state = entry_chip.hash(asn, [user_state, leaf])
            root = _walk_path(asn, config, w, entry_chip, middle_chip, leaf, balances)
            liab_state = entry_chip.hash(asn, [liab_state, root])

        asn.constrain_instance(user_state, config.instance, 2)
        asn.constrain_instance(liab_state, config.instance, 3)


def _compile(circuit: MstInclusionCircuit, k: int):
    """configure + keygen-style synthesis of an empty circuit, selectors
    compressed into fixed columns."""
    n = 1 << k
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    asn = Assignment(cs, n, [[0] * circuit.num_instances()])
    circuit.synthesize(config, asn)
    _, new_values = cs.compress_selectors([list(act) for act in asn.selectors], n)
    for values in new_values:
        asn.fixed.append(list(values))
    return circuit, cs, config, asn


def compile_incremental_circuit(levels: int, n_currencies: int, n_bytes: int, k: int):
    """(circuit, cs, config, assignment) of the empty step circuit."""
    return _compile(IncrementalMstInclusionCircuit(levels, n_currencies, n_bytes), k)


def compile_chained_circuit(levels: int, n_currencies: int, n_bytes: int, nsteps: int,
                            k: int):
    """(circuit, cs, config, assignment) of the empty N-step chained circuit."""
    return _compile(ChainedMstInclusionCircuit(levels, n_currencies, n_bytes, nsteps), k)


# ---------------------------------------------------------------------------
# Chain driver
# ---------------------------------------------------------------------------


@dataclass
class IncrementalStep:
    proof: bytes
    instances: list[list[int]]


@dataclass
class IncrementalChainProof:
    """Per-round step proofs and the state trajectories; ``user_states[-1]``
    and ``liab_states[-1]`` are the chain's final states."""

    steps: list[IncrementalStep]
    user_states: list[int]
    liab_states: list[int]


def entries_from_states_csv(path: str) -> list[Entry]:
    """``;``-format round CSV -> MST entries (keccak usernames)."""
    return [Entry(u, b) for u, b in parse_states_csv(path)]


def _round_proofs(artifacts, csv_paths: list[str], user_index: int) -> list[MerkleProof]:
    """Each round's tree, built on the artifacts' device, and the user's
    inclusion witness in it."""
    ncur = artifacts.circuit_shape[1]
    cryptos = [Cryptocurrency(f"CUR{i}", "NA") for i in range(ncur)]
    return [MerkleSumTree.from_entries(entries_from_states_csv(path), cryptos,
                                       artifacts.device).generate_proof(user_index)
            for path in csv_paths]


def prove_chain(artifacts, csv_paths: list[str], user_index: int) -> IncrementalChainProof:
    """Prove one user's inclusion in every round, chaining the states.
    ``artifacts`` come from ``pipeline.generate_incremental_artifacts``."""
    from ..utils import pipeline

    levels, ncur, nbytes = artifacts.circuit_shape
    user_states, liab_states, steps = [0], [0], []
    for mp in _round_proofs(artifacts, csv_paths, user_index):
        circuit = IncrementalMstInclusionCircuit.init_step(levels, ncur, nbytes, mp,
                                                           user_states[-1], liab_states[-1])
        inst = circuit.instances()
        steps.append(IncrementalStep(pipeline.full_prover(artifacts, circuit, inst), inst))
        user_states.append(inst[0][2])
        liab_states.append(inst[0][3])
    return IncrementalChainProof(steps, user_states, liab_states)


def prove_chain_snark(artifacts, csv_paths: list[str], user_index: int):
    """ONE proof for the whole N-round chain: ``(proof_bytes, instances)``.
    ``artifacts`` come from ``pipeline.generate_chained_artifacts(k, ...,
    nsteps=len(csv_paths))``."""
    from ..utils import pipeline

    levels, ncur, nbytes = artifacts.circuit_shape
    circuit = ChainedMstInclusionCircuit.init_chain(
        levels, ncur, nbytes, _round_proofs(artifacts, csv_paths, user_index))
    inst = circuit.instances()
    return pipeline.full_prover(artifacts, circuit, inst), inst


def chain_states(values: list[int]) -> int:
    """The final state of ``s_i = H(s_{i-1}, v_i)`` from s_0 = 0."""
    state = 0
    for v in values:
        state = poseidon.hash_n([state, v])
    return state


def verify_chain_snark(artifacts, proof: bytes, instances,
                       expected_roots: list[int] | None = None,
                       expected_leaf_hashes: list[int] | None = None) -> bool:
    """Verify the chained SNARK (one transcript replay, one pairing). Given
    the published per-round roots (and the user's leaf hashes), the final
    states are recomputed from them and must equal the proof's."""
    from ..utils import pipeline

    inst = instances[0]
    if inst[0] != 0 or inst[1] != 0:
        return False
    if expected_roots is not None and chain_states(expected_roots) != inst[3]:
        return False
    if expected_leaf_hashes is not None and chain_states(expected_leaf_hashes) != inst[2]:
        return False
    return pipeline.full_verifier(artifacts, proof, instances)


def verify_chain(artifacts, chain: IncrementalChainProof) -> bool:
    """Verify every step proof and the state chaining between steps (one
    pairing per step)."""
    from ..utils import pipeline

    prev_user, prev_liab = 0, 0
    for step in chain.steps:
        inst = step.instances[0]
        if inst[0] != prev_user or inst[1] != prev_liab:
            return False
        if not pipeline.full_verifier(artifacts, step.proof, step.instances):
            return False
        prev_user, prev_liab = inst[2], inst[3]
    return prev_user == chain.user_states[-1] and prev_liab == chain.liab_states[-1]


def verify_chain_compressed(artifacts, chain: IncrementalChainProof) -> bool:
    """Chain verification with ONE pairing check for all rounds.

    Every step's transcript is replayed on the host to a KZG accumulator
    pair (acc_i, w'_i) with e(acc_i, G2) == e(w'_i, s·G2) iff step i is
    valid; the pairs are combined with Fiat-Shamir randomizers r_i (Blake2b
    over all proofs and instances):

        e(Σ r_i·acc_i, G2) == e(Σ r_i·w'_i, s·G2)

    The chain proof stays O(N) bytes; the pairing becomes O(1).
    """
    from ..utils.transcript import Blake2bTranscript

    params, vk = artifacts.params, artifacts.vk
    h = hashlib.blake2b(b"circuits-halo2-tpu-chain-batch")
    for step in chain.steps:
        h.update(step.proof)
        for col in step.instances:
            for v in col:
                h.update(int(v).to_bytes(32, "little"))
    seed = h.digest()

    prev_user, prev_liab = 0, 0
    acc_total, wp_total = None, None
    for i, step in enumerate(chain.steps):
        inst = step.instances[0]
        if inst[0] != prev_user or inst[1] != prev_liab:
            return False
        try:
            ok, pair = _verify(params, vk, step.instances, step.proof,
                               transcript_cls=Blake2bTranscript, defer_pairing=True)
        except (ValueError, AssertionError, KeyError):
            return False
        if not ok:
            return False
        r = int.from_bytes(hashlib.blake2b(seed + i.to_bytes(8, "little")).digest(),
                           "little") % FR_MOD
        acc_i, wp_i = pair
        acc_total = C.g1_add(acc_total, C.g1_mul(acc_i, r))
        wp_total = C.g1_add(wp_total, C.g1_mul(wp_i, r))
        prev_user, prev_liab = inst[2], inst[3]
    if prev_user != chain.user_states[-1] or prev_liab != chain.liab_states[-1]:
        return False
    return PAIR.pairing_check([(acc_total, params.g2), (C.g1_neg(wp_total), params.s_g2)])
