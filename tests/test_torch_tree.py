"""The port's Merkle sum trees against the JAX package: host-tree roots of the
CSV fixtures (BASELINE.md:27-30) and per-level parity of the device tree with
JAX ``build_device_tree(use_pallas=False)`` at depth 7, where Montgomery-
resident balance sums would already have left the reference kernel's limb
envelope, and of the sorted build. Tolerance: exact."""

from pathlib import Path

import numpy as np
import pytest
import torch

from circuits_halo2_tpu.merkle import device_tree as JDT
from circuits_halo2_tpu.merkle.mst import MerkleSumTree as JMst
from circuits_halo2_tpu_torch import convert
from circuits_halo2_tpu_torch.merkle import device_tree as TDT
from circuits_halo2_tpu_torch.merkle.mst import Entry, MerkleSumTree
from circuits_halo2_tpu_torch.ops import field_torch as FT

torch.set_num_threads(2)

CSV = Path(__file__).parent / "fixtures_csv"
ROOTS = {
    "entry_16": (0x177BF452AD139F067A64FE09FDC30AAE46144D60ABFA2AD9F0C70928E29A26D1,
                 [556862, 556862]),
    "entry_13": (None, [385969, 459661]),
    "entry_17": (None, [556863, 556863]),
}


@pytest.mark.parametrize("name", sorted(ROOTS))
def test_csv_roots(name):
    tree = MerkleSumTree.from_csv(str(CSV / f"{name}.csv"), "cpu")
    want_hash, want_bals = ROOTS[name]
    ref = JMst.from_csv(str(CSV / f"{name}.csv"))
    assert tree.root.balances == want_bals == ref.root.balances
    assert tree.root.hash == ref.root.hash
    if want_hash is not None:
        assert tree.root.hash == want_hash
    proof = tree.generate_proof(3)
    assert MerkleSumTree.verify_proof(proof)
    want = ref.generate_proof(3)
    assert proof.sibling_middle_node_hash_preimages == want.sibling_middle_node_hash_preimages
    assert proof.sibling_leaf_node_hash_preimage == want.sibling_leaf_node_hash_preimage
    assert proof.path_indices == want.path_indices


@pytest.fixture(scope="module")
def depth7():
    rng = np.random.default_rng(7)
    n = 1 << 7
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(0, 1 << 62, size=(n, 1), dtype=np.uint64)
    balances[:4] = np.iinfo(np.uint64).max  # the largest u64 sums
    jtree = JDT.build_device_tree(digests, balances, use_pallas=False)
    return digests, balances, jtree, TDT.build_device_tree(digests, balances, "cpu")


def test_device_tree_levels_match_jax(depth7):
    _, _, jtree, tree = depth7
    conv = convert.device_mst_from_jax(jtree, "cpu")
    assert tree.depth == conv.depth == 7
    assert torch.equal(tree.user_limbs, conv.user_limbs)
    for level in range(tree.depth + 1):
        assert torch.equal(tree.level_hashes[level], conv.level_hashes[level]), level
        assert torch.equal(tree.level_balances[level], conv.level_balances[level]), level
    assert tree.root() == jtree.root() == conv.root()


def test_device_tree_proof_matches_jax(depth7):
    _, balances, jtree, tree = depth7
    entry = Entry("somebody", [int(balances[37, 0])])
    got = tree.generate_proof(37, entry)
    want = jtree.generate_proof(37, entry)
    assert got.sibling_leaf_node_hash_preimage == want.sibling_leaf_node_hash_preimage
    assert got.sibling_middle_node_hash_preimages == want.sibling_middle_node_hash_preimages
    assert got.path_indices == want.path_indices
    assert (got.root.hash, got.root.balances) == (want.root.hash, want.root.balances)


def test_sorted_device_tree_matches_jax(depth7):
    """``build_device_tree_sorted`` at depth 7 (usernames drawn as the
    criterion bench draws them, one tie): the same order and root as the JAX
    package's, the same root balances as the unsorted tree."""
    digests, balances, jtree, tree = depth7
    usernames = np.random.default_rng(8).integers(0, 256, size=(len(balances), 8),
                                                  dtype=np.uint8).view("S8")[:, 0]
    usernames[5] = usernames[90]
    got, order = TDT.build_device_tree_sorted(usernames, digests, balances, "cpu")
    jgot, jorder = JDT.build_device_tree_sorted(usernames, digests, balances, use_pallas=False)
    assert np.array_equal(order, jorder)
    assert list(usernames[order]) == sorted(usernames)
    assert got.root() == jgot.root()
    assert got.root()[1] == tree.root()[1] and got.root()[0] != tree.root()[0]


def test_limb_conversions():
    vals = np.array([0, 1, (1 << 64) - 1, 123456789], dtype=np.uint64)
    assert FT.limbs_to_ints(TDT.u64_to_limbs16(vals)) == [int(v) for v in vals]
    digests = np.random.default_rng(1).integers(0, 256, size=(5, 32), dtype=np.uint8)
    assert FT.limbs_to_ints(TDT.digests_to_limbs16(digests)) == [
        int.from_bytes(bytes(d), "big") for d in digests]
