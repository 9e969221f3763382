"""Circom-compatible Merkle sum tree + IVC state chain (witness side).

Mirrors the self-contained MST builder inside the reference's Nova example
(`zk_prover/examples/nova_incremental_verifier.rs:239-449`), which cannot
reuse the main MST because circom's Poseidon differs from halo2's:

- username: UTF-8 big-endian integer (``big_intify_username``) — NOT
  keccak-hashed (unlike `merkle_sum_tree/entry.rs:21`).
- leaf hash  = PoseidonCircom(username, balances...)
- middle hash = PoseidonCircom(hashL, balsL..., hashR, balsR...)  — note the
  different preimage layout from the halo2 tree (hash-first per child).
- CSV format: ``username;bal0,bal1`` (`csv/states/entry_16_*.csv`).
- Odd levels duplicate the last node (`:350-354`), no zero-entry padding.

State chain (`nova_incremental_verifier.rs:26-40,170-190`):
    user_state_i  = H(user_state_{i-1},  leaf_hash_i)
    liab_state_i  = H(liab_state_{i-1}, root_hash_i)
both starting from 0.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import poseidon_circom as PC
from ..ops.field import FR_MOD


def big_intify_username(username: str) -> int:
    """UTF-8 bytes as a big-endian integer (`operation_helpers.rs:5-8`)."""
    return int.from_bytes(username.encode("utf-8"), "big")


@dataclass
class CircomNode:
    hash: int
    balances: list[int]


@dataclass
class CircomMerkleProof:
    """The witness bundle the Nova step circuit consumes
    (`nova_incremental_verifier.rs:268-276`)."""

    username: str
    user_balances: list[int]
    path_element_hashes: list[int]
    path_element_balances: list[list[int]]
    path_indices: list[int]  # 0 = sibling on the right, 1 = sibling on the left
    root: CircomNode


def parse_states_csv(path: str) -> list[tuple[str, list[int]]]:
    """``username;bal0,bal1,...`` rows (header skipped)."""
    out = []
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            parts = line.split(";")
            if len(parts) != 2:
                continue
            username, balances = parts
            out.append((username, [int(b) for b in balances.split(",")]))
    return out


def leaf_node(username: str, balances: list[int]) -> CircomNode:
    h = PC.hash_n([big_intify_username(username)] + balances)
    return CircomNode(h, list(balances))


def middle_node(left: CircomNode, right: CircomNode) -> CircomNode:
    preimage = [left.hash] + left.balances + [right.hash] + right.balances
    sums = [(a + b) % FR_MOD for a, b in zip(left.balances, right.balances)]
    return CircomNode(PC.hash_n(preimage), sums)


def build_merkle_proof(csv_path: str, user_index: int) -> CircomMerkleProof:
    """CSV → tree → inclusion witness for one user
    (`nova_incremental_verifier.rs:286-395` semantics, incl. odd-level
    last-node duplication)."""
    entries = parse_states_csv(csv_path)
    leaves = [leaf_node(u, b) for u, b in entries]
    username, user_balances = entries[user_index]

    current = list(leaves)
    idx = user_index
    path_element_hashes: list[int] = []
    path_element_balances: list[list[int]] = []
    path_indices: list[int] = []
    while len(current) > 1:
        nxt = []
        for i in range(0, len(current), 2):
            left = current[i]
            right = current[i + 1] if i + 1 < len(current) else current[i]
            if idx == i:
                path_element_hashes.append(right.hash)
                path_element_balances.append(list(right.balances))
                path_indices.append(0)
            elif idx == i + 1:
                path_element_hashes.append(left.hash)
                path_element_balances.append(list(left.balances))
                path_indices.append(1)
            nxt.append(middle_node(left, right))
        current = nxt
        idx //= 2
    return CircomMerkleProof(
        username,
        list(user_balances),
        path_element_hashes,
        path_element_balances,
        path_indices,
        current[0],
    )


def verify_merkle_proof(proof: CircomMerkleProof) -> bool:
    """CPU replay of the circom inclusion statement (Swapper + Hasher chain,
    `zk_prover/src/circom/merkle_sum_tree.circom:30-254`)."""
    node = leaf_node(proof.username, proof.user_balances)
    for h, bals, bit in zip(
        proof.path_element_hashes, proof.path_element_balances, proof.path_indices
    ):
        sibling = CircomNode(h, list(bals))
        if bit == 0:
            node = middle_node(node, sibling)
        elif bit == 1:
            node = middle_node(sibling, node)
        else:
            return False
    return node.hash == proof.root.hash and node.balances == proof.root.balances


# ---------------------------------------------------------------------------
# IVC state chain
# ---------------------------------------------------------------------------

def user_state_next(prev: int, username: str, balances: list[int]) -> int:
    """H(prev, leaf_hash) (`nova_incremental_verifier.rs:427-438`)."""
    return PC.hash_n([prev, leaf_node(username, balances).hash])


def liabilities_state_next(prev: int, root_hash: int) -> int:
    """H(prev, root_hash) (`nova_incremental_verifier.rs:416-424`)."""
    return PC.hash_n([prev, root_hash])


def state_chain(csv_paths: list[str], user_index: int):
    """Walk the rounds: returns (per-round proofs, user_states, liab_states)
    with states[0] = 0 initial values (`nova_incremental_verifier.rs:26-40`)."""
    proofs = []
    user_states = [0]
    liab_states = [0]
    for path in csv_paths:
        proof = build_merkle_proof(path, user_index)
        proofs.append(proof)
        user_states.append(
            user_state_next(user_states[-1], proof.username, proof.user_balances)
        )
        liab_states.append(liabilities_state_next(liab_states[-1], proof.root.hash))
    return proofs, user_states, liab_states
