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


def _words(values, width=2):
    """Non-negative ints (any shape) -> (..., width) little-endian uint64 words."""
    flat = np.asarray(values, dtype=object).ravel()
    return np.array([[(int(v) >> (64 * i)) & ((1 << 64) - 1) for i in range(width)] for v in flat],
                    dtype=np.uint64).reshape(*np.shape(values), width)


def _wei_csv(path: Path) -> Path:
    """64 users of two currencies, balances floor(2^u) with u uniform on
    [0, 80) (amounts in wei) and [0, 50); users 0 and 1 hold 2^80 - 1."""
    rng = np.random.default_rng(6)
    bals = [[int(2.0 ** u) for u in rng.uniform(0, top, 64)] for top in (80, 50)]
    bals[0][:2] = [(1 << 80) - 1] * 2
    rows = [f"user{i},{a},{b}" for i, (a, b) in enumerate(zip(*bals))]
    path.write_text("username,balance_ETH_ETH,balance_USDT_ETH\n" + "\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("case", ["entry_16_bigints", "wei-depth6", "entry_16"])
def test_device_tree_takes_wide_balances(case, tmp_path):
    """Balances as little-endian uint64 words: entry_16_bigints holds 2^64,
    the wei snapshot balances up to 2^80 - 1. The root and every user's proof
    equal the port's host tree and the JAX package's (for entry_16_bigints)
    or the JAX package's host tree (the wei snapshot). entry_16's balances
    fit uint64: its (N, C) uint64 columns and their words convert to the
    same limbs, so the uint64 input builds what it built before (held to the
    JAX package's levels at depth 7 above)."""
    csv = _wei_csv(tmp_path / "wei.csv") if case == "wei-depth6" else CSV / f"{case}.csv"
    ref = JMst.from_csv(str(csv))
    entries = ref.entries
    balances = np.array([e.balances for e in entries], dtype=object)
    if case == "entry_16":
        narrow = balances.astype(np.uint64)
        for c in range(narrow.shape[1]):
            assert np.array_equal(TDT.u64_to_limbs16(narrow[:, c]),
                                  TDT.u64_to_limbs16(_words(balances[:, c])))
        assert (ref.root.hash, ref.root.balances) == ROOTS[case]
        return
    assert max(balances.ravel()) >= 1 << 64
    digests = np.stack([np.frombuffer(e.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
                        for e in entries])
    tree = TDT.build_device_tree(digests, _words(balances), "cpu")
    wants = [ref]
    if case == "entry_16_bigints":
        wants.append(MerkleSumTree.from_csv(str(csv), "cpu"))
    for want in wants:
        assert tree.root() == (want.root.hash, want.root.balances)
    for u in range(len(entries)):
        got = tree.generate_proof(u, entries[u])
        for want in wants:
            proof = want.generate_proof(u)
            assert got.sibling_leaf_node_hash_preimage == proof.sibling_leaf_node_hash_preimage
            assert got.sibling_middle_node_hash_preimages == proof.sibling_middle_node_hash_preimages
            assert got.path_indices == proof.path_indices


def test_wide_limb_conversions():
    vals = [0, 1, (1 << 64) - 1, 1 << 64, (1 << 112) - 1, 3 << 100]
    words = _words(vals)
    assert FT.limbs_to_ints(TDT.u64_to_limbs16(words)) == vals
    assert np.array_equal(TDT.u64_to_limbs16(words[:3, :1]),
                          TDT.u64_to_limbs16(np.array(vals[:3], dtype=np.uint64)))
    assert FT.limbs_to_ints(TDT.u64_to_limbs16(_words([(1 << 256) - 1], 4))) == [(1 << 256) - 1]
    with pytest.raises(ValueError):
        TDT.u64_to_limbs16(np.zeros((1, 5), dtype=np.uint64))
