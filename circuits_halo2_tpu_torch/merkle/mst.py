"""Merkle sum tree -- the witness-side tree of ``circuits_halo2_tpu/merkle/mst.py``.

Hash rules (as the reference):
- leaf hash   = Poseidon(keccak256(username) mod p, balance_0, ..., balance_{N-1})
- middle hash = Poseidon(sumL_0 + sumR_0, ..., hashL, hashR)

Each tree level is one batched Poseidon call through K1
(``ops/poseidon_kernel.hash_batch``) on the device the caller names; single
hashes (proof checks, circuit witnesses) use the native host sponge.
"""

from __future__ import annotations

import csv as _csv
import random
from bisect import bisect_left
from dataclasses import dataclass

import torch

from .. import native
from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import poseidon
from ..ops import poseidon_kernel as PK


def big_intify_username(username: str) -> int:
    """UTF-8 big-endian bytes -> integer."""
    return int.from_bytes(username.encode("utf-8"), "big")


def big_uint_to_fp(x: int) -> int:
    """Arbitrary non-negative integer -> Fr (mod p)."""
    return x % F.FR_MOD


@dataclass(frozen=True)
class Cryptocurrency:
    name: str
    chain: str


class Entry:
    """CEX user record: username + N_CURRENCIES balances. The username is
    keccak256-hashed at construction and reduced into Fr at leaf hashing."""

    __slots__ = ("username", "balances", "hashed_username")

    def __init__(self, username: str, balances: list[int]):
        self.username = username
        self.balances = list(balances)
        self.hashed_username = int.from_bytes(native.keccak256(username.encode("utf-8")), "big")

    @classmethod
    def zero_entry(cls, n_currencies: int) -> "Entry":
        e = cls.__new__(cls)
        e.username = "0"
        e.balances = [0] * n_currencies
        e.hashed_username = 0
        return e

    def is_zero(self) -> bool:
        return self.hashed_username == 0 and all(b == 0 for b in self.balances)

    def compute_leaf(self) -> "Node":
        return Node.leaf(self.hashed_username, self.balances)

    def recompute_leaf(self, updated_balances: list[int]) -> "Node":
        self.balances = list(updated_balances)
        return Node.leaf(self.hashed_username, self.balances)

    def __eq__(self, other):
        return (isinstance(other, Entry) and self.username == other.username
                and self.balances == other.balances)


class Node:
    """MST node: hash plus per-currency balance sums (all Fr ints)."""

    __slots__ = ("hash", "balances")

    def __init__(self, hash_: int, balances: list[int]):
        self.hash = hash_
        self.balances = list(balances)

    @classmethod
    def leaf(cls, hashed_username: int, balances: list[int]) -> "Node":
        preimage = [big_uint_to_fp(hashed_username)] + [big_uint_to_fp(b) for b in balances]
        return cls.leaf_node_from_preimage(preimage)

    @classmethod
    def middle(cls, left: "Node", right: "Node") -> "Node":
        preimage = [(a + b) % F.FR_MOD for a, b in zip(left.balances, right.balances)] + [
            left.hash, right.hash]
        return cls.middle_node_from_preimage(preimage)

    @classmethod
    def leaf_node_from_preimage(cls, preimage: list[int]) -> "Node":
        return cls(poseidon.hash_n(preimage), preimage[1:])

    @classmethod
    def middle_node_from_preimage(cls, preimage: list[int]) -> "Node":
        return cls(poseidon.hash_n(preimage), preimage[:-2])

    @classmethod
    def init_empty(cls, n_currencies: int) -> "Node":
        return cls(0, [0] * n_currencies)

    def __eq__(self, other):
        return (isinstance(other, Node) and self.hash == other.hash
                and self.balances == other.balances)

    def __repr__(self):
        return f"Node(hash={hex(self.hash)}, balances={self.balances})"


@dataclass
class MerkleProof:
    """Witness bundle consumed by the inclusion circuit."""

    entry: Entry
    root: Node
    sibling_leaf_node_hash_preimage: list[int]
    sibling_middle_node_hash_preimages: list[list[int]]
    path_indices: list[int]


def parse_csv_to_entries(path: str) -> tuple[list[Cryptocurrency], list[Entry]]:
    """Header: ``username,balance_<coin>_<chain>,...``; decimal balances."""
    with open(path, newline="") as f:
        reader = _csv.DictReader(f)
        headers = reader.fieldnames or []
        cryptocurrencies: list[Cryptocurrency] = []
        for header in headers[1:]:
            parts = header.split("_")
            if len(parts) != 3 or parts[0] != "balance":
                raise ValueError(f"Invalid header: {header}")
            cryptocurrencies.append(Cryptocurrency(parts[1], parts[2]))
        entries = []
        for record in reader:
            username = record.get("username")
            if username is None:
                raise ValueError("Username not found")
            balances = []
            for c in cryptocurrencies:
                key = f"balance_{c.name}_{c.chain}"
                if record.get(key) is None:
                    raise ValueError(f"Balance for {c.name} on {c.chain} not found")
                balances.append(int(record[key], 10))
            entries.append(Entry(username, balances))
    return cryptocurrencies, entries


def _hash_columns(pre_cols: list[list[int]], device) -> list[int]:
    """Hash N same-length messages given as L canonical-int columns, as one
    K1 call on ``device``."""
    arr = torch.stack([torch.as_tensor(FT.to_mont_limbs(c), device=device) for c in pre_cols])
    return FT.from_mont_ints(PK.hash_batch(arr))


def build_leaves_from_entries(entries: list[Entry], device) -> list[Node]:
    """All leaves in one batched hash."""
    preimages = [[big_uint_to_fp(e.hashed_username)] + [big_uint_to_fp(b) for b in e.balances]
                 for e in entries]
    cols = [list(c) for c in zip(*preimages)]
    hashes = _hash_columns(cols, device)
    return [Node(h, pre[1:]) for h, pre in zip(hashes, preimages)]


def build_merkle_tree_from_leaves(leaves: list[Node], depth: int, device):
    """Level-by-level bottom-up build; each level is one batched hash."""
    if len(leaves) != 1 << depth:
        raise ValueError("leaf layer must be a power of two")
    n_currencies = len(leaves[0].balances)
    tree = [list(leaves)]
    for _ in range(depth):
        below = tree[-1]
        pre_cols: list[list[int]] = [[] for _ in range(n_currencies + 2)]
        sums_all = []
        for i in range(0, len(below), 2):
            l, r = below[i], below[i + 1]
            sums = [(a + b) % F.FR_MOD for a, b in zip(l.balances, r.balances)]
            sums_all.append(sums)
            for c in range(n_currencies):
                pre_cols[c].append(sums[c])
            pre_cols[n_currencies].append(l.hash)
            pre_cols[n_currencies + 1].append(r.hash)
        hashes = _hash_columns(pre_cols, device)
        tree.append([Node(h, b) for h, b in zip(hashes, sums_all)])
    return tree[depth][0], tree


class MerkleSumTree:
    """MST with CSV ingest, zero-entry padding, inclusion proofs and leaf
    updates. A sorted tree holds its entries ordered by username, so
    ``index_of_username`` bisects."""

    def __init__(self, root: Node, nodes: list[list[Node]], depth: int,
                 entries: list[Entry], cryptocurrencies: list[Cryptocurrency],
                 is_sorted: bool = False):
        self.root = root
        self.nodes = nodes
        self.depth = depth
        self.entries = entries
        self.cryptocurrencies = cryptocurrencies
        self.is_sorted = is_sorted

    @classmethod
    def from_csv(cls, path: str, device="cuda:0") -> "MerkleSumTree":
        cryptos, entries = parse_csv_to_entries(path)
        return cls.from_entries(entries, cryptos, device)

    @classmethod
    def from_csv_sorted(cls, path: str, device="cuda:0") -> "MerkleSumTree":
        cryptos, entries = parse_csv_to_entries(path)
        entries.sort(key=lambda e: e.username)
        return cls.from_entries(entries, cryptos, device, is_sorted=True)

    @classmethod
    def from_params(cls, root, nodes, depth, entries, cryptocurrencies,
                    is_sorted) -> "MerkleSumTree":
        return cls(root, nodes, depth, entries, cryptocurrencies, is_sorted)

    @classmethod
    def from_entries(cls, entries: list[Entry], cryptocurrencies, device="cuda:0",
                     is_sorted: bool = False) -> "MerkleSumTree":
        n_currencies = len(entries[0].balances)
        depth = (len(entries) - 1).bit_length() if len(entries) > 1 else 0
        entries = entries + [Entry.zero_entry(n_currencies)
                             for _ in range((1 << depth) - len(entries))]
        leaves = build_leaves_from_entries(entries, device)
        root, nodes = build_merkle_tree_from_leaves(leaves, depth, device)
        return cls(root, nodes, depth, entries, list(cryptocurrencies), is_sorted)

    def leaves(self) -> list[Node]:
        return self.nodes[0]

    def get_entry(self, index: int) -> Entry:
        return self.entries[index]

    def get_leaf_node_hash_preimage(self, index: int) -> list[int]:
        e = self.entries[index]
        return [big_uint_to_fp(e.hashed_username)] + [big_uint_to_fp(b) for b in e.balances]

    def get_middle_node_hash_preimage(self, level: int, index: int) -> list[int]:
        if level == 0 or level > self.depth:
            raise ValueError("Invalid depth")
        left = self.nodes[level - 1][2 * index]
        right = self.nodes[level - 1][2 * index + 1]
        return [(a + b) % F.FR_MOD for a, b in zip(left.balances, right.balances)] + [
            left.hash, right.hash]

    def generate_proof(self, index: int) -> MerkleProof:
        if index >= len(self.nodes[0]):
            raise IndexError("Index out of bounds")
        sibling_leaf_preimage = self.get_leaf_node_hash_preimage(index ^ 1)
        middles = []
        path = []
        current = index
        for level in range(self.depth):
            position = current % 2
            if level > 0:
                middles.append(self.get_middle_node_hash_preimage(level, current ^ 1))
            path.append(position)
            current //= 2
        return MerkleProof(self.entries[index], self.root, sibling_leaf_preimage, middles, path)

    @staticmethod
    def verify_proof(proof: MerkleProof) -> bool:
        node = proof.entry.compute_leaf()
        sibling = Node.leaf_node_from_preimage(proof.sibling_leaf_node_hash_preimage)
        for level, bit in enumerate(proof.path_indices):
            if level > 0:
                sibling = Node.middle_node_from_preimage(
                    proof.sibling_middle_node_hash_preimages[level - 1])
            sums = [(a + b) % F.FR_MOD for a, b in zip(node.balances, sibling.balances)]
            pair = [node.hash, sibling.hash] if bit == 0 else [sibling.hash, node.hash]
            node = Node.middle_node_from_preimage(sums + pair)
        return node.hash == proof.root.hash and node.balances == proof.root.balances

    def update_leaf(self, username: str, new_balances: list[int]) -> Node:
        """Set a user's balances and rehash the O(depth) path above the leaf
        (native host sponge). Returns the new root."""
        index = self.index_of_username(username)
        self.nodes[0][index] = self.entries[index].recompute_leaf(new_balances)
        for level in range(1, self.depth + 1):
            index //= 2
            self.nodes[level][index] = Node.middle(self.nodes[level - 1][2 * index],
                                                   self.nodes[level - 1][2 * index + 1])
        self.root = self.nodes[self.depth][0]
        return self.root

    def index_of_username(self, username: str) -> int:
        """Position of ``username``: a bisection in a sorted tree, a scan
        otherwise; KeyError when it is absent."""
        if not self.is_sorted:
            for i, e in enumerate(self.entries):
                if e.username == username:
                    return i
            raise KeyError("Username not found")
        i = bisect_left(self.entries, username, key=lambda e: e.username)
        if i < len(self.entries) and self.entries[i].username == username:
            return i
        raise KeyError("Username not found")


def synthetic_merkle_proof(levels: int, n_currencies: int, entry: Entry, seed: int = 0,
                           max_balance: int = 1 << 40) -> MerkleProof:
    """A consistent LEVELS-deep MerkleProof without building a 2^LEVELS tree.

    The sibling nodes along the path are drawn bottom-up from
    ``random.Random(seed)`` in the JAX package's order (sibling leaf, then per
    level the sibling middle preimage above level 0 and the path bit), so both
    packages build the same witness; every preimage hashes to the node the
    path consumes. Balances stay below ``max_balance`` so the path sums fit
    the N_BYTES range checks."""
    rng = random.Random(seed)

    def rand_fr() -> int:
        return rng.getrandbits(253) % F.FR_MOD

    def rand_bals() -> list[int]:
        return [rng.randrange(max_balance) for _ in range(n_currencies)]

    node = entry.compute_leaf()
    sibling_leaf_preimage = [rand_fr()] + rand_bals()
    sibling = Node.leaf_node_from_preimage(sibling_leaf_preimage)
    middles: list[list[int]] = []
    path: list[int] = []
    for level in range(levels):
        if level > 0:
            pre = rand_bals() + [rand_fr(), rand_fr()]
            sibling = Node.middle_node_from_preimage(pre)
            middles.append(pre)
        bit = rng.getrandbits(1)
        sums = [(a + b) % F.FR_MOD for a, b in zip(node.balances, sibling.balances)]
        pair = [node.hash, sibling.hash] if bit == 0 else [sibling.hash, node.hash]
        node = Node.middle_node_from_preimage(sums + pair)
        path.append(bit)
    return MerkleProof(entry, node, sibling_leaf_preimage, middles, path)
