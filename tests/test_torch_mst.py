"""The rest of the port's Merkle sum tree against the JAX package
(tests/test_mst.py:82-102 and tests/test_criterion_scale.py:28-32 mirrored):
sorted trees, username lookups, leaf updates, the small node helpers and
the seeded synthetic witness of the criterion and north-star configs (the
sorted device build is held to the JAX package's in test_torch_tree.py).
The criterion witness's instances equal those of the JAX fixture
(tests/fixtures_torch_criterion.json), and a slow case proves it on the CPU
and compares the bytes. Tolerance: exact."""

import copy
import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu.merkle import mst as JM
from circuits_halo2_tpu_torch.merkle import mst as TM
from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
from circuits_halo2_tpu_torch.ops import poseidon

torch.set_num_threads(2)

HERE = Path(__file__).parent
CSV = HERE / "fixtures_csv" / "entry_16.csv"
FIX = json.loads((HERE / "fixtures_torch_criterion.json").read_text())


def _root(tree):
    return tree.root.hash, tree.root.balances


@pytest.fixture(scope="module")
def trees():
    """The port's entry_16 trees on the CPU, unsorted and sorted."""
    return (TM.MerkleSumTree.from_csv(str(CSV), "cpu"),
            TM.MerkleSumTree.from_csv_sorted(str(CSV), "cpu"))


def test_sorted_tree_matches_jax_and_keeps_the_sums(trees):
    unsorted, tree = trees
    want = JM.MerkleSumTree.from_csv_sorted(str(CSV))
    assert tree.is_sorted and not unsorted.is_sorted
    assert _root(tree) == _root(want)
    assert tree.root.balances == unsorted.root.balances
    assert tree.root.hash != unsorted.root.hash
    assert [e.username for e in tree.entries] == [e.username for e in want.entries]


@pytest.mark.parametrize("sort", [False, True])
def test_index_of_username(trees, sort):
    tree = trees[sort]
    want = (JM.MerkleSumTree.from_csv_sorted if sort else JM.MerkleSumTree.from_csv)(str(CSV))
    for e in tree.entries[:16]:
        i = tree.index_of_username(e.username)
        assert tree.entries[i].username == e.username
        assert i == want.index_of_username(e.username)
    idx = tree.index_of_username("dxGaEAii")
    assert tree.entries[idx].balances == [11888, 41163]
    with pytest.raises(KeyError):
        tree.index_of_username("nobody-here")


def test_update_leaf_matches_fresh_build_and_jax(trees):
    """The O(depth) rehash equals a fresh build of the updated entries
    (every level) and the JAX package's ``update_leaf``."""
    tree = copy.deepcopy(trees[0])
    new_root = tree.update_leaf("dxGaEAii", [11988, 41363])
    cryptos, entries = JM.parse_csv_to_entries(str(CSV))
    entries[0] = JM.Entry("dxGaEAii", [11988, 41363])
    fresh = JM.MerkleSumTree.from_entries(entries, cryptos)
    jroot = JM.MerkleSumTree.from_csv(str(CSV)).update_leaf("dxGaEAii", [11988, 41363])
    assert (new_root.hash, new_root.balances) == _root(fresh) == (jroot.hash, jroot.balances)
    assert tree.root is new_root and tree.entries[0].balances == [11988, 41363]
    for level in range(tree.depth + 1):
        assert [(n.hash, n.balances) for n in tree.nodes[level]] == [
            (n.hash, n.balances) for n in fresh.nodes[level]]


def test_node_helpers_match_jax():
    entry, jentry = TM.Entry("alice", [5, 7]), JM.Entry("alice", [5, 7])
    leaf, jleaf = entry.recompute_leaf([9, 11]), jentry.recompute_leaf([9, 11])
    assert entry.balances == [9, 11] and (leaf.hash, leaf.balances) == (jleaf.hash, jleaf.balances)
    other, jother = TM.Entry("bob", [1, 2]).compute_leaf(), JM.Entry("bob", [1, 2]).compute_leaf()
    mid, jmid = TM.Node.middle(leaf, other), JM.Node.middle(jleaf, jother)
    assert (mid.hash, mid.balances) == (jmid.hash, jmid.balances)
    assert mid.hash == poseidon.hash_n([10, 13, leaf.hash, other.hash])
    empty, jempty = TM.Node.init_empty(3), JM.Node.init_empty(3)
    assert (empty.hash, empty.balances) == (jempty.hash, jempty.balances) == (0, [0, 0, 0])
    for name in ["dxGaEAii", "", "\u00fcn\u00efcode"]:
        assert TM.big_intify_username(name) == JM.big_intify_username(name)


def test_from_params_keeps_every_field(trees):
    tree = trees[0]
    again = TM.MerkleSumTree.from_params(tree.root, tree.nodes, tree.depth, tree.entries,
                                         tree.cryptocurrencies, True)
    assert again.is_sorted and again.root is tree.root and again.nodes is tree.nodes
    assert (again.depth, again.entries, again.cryptocurrencies) == (
        tree.depth, tree.entries, tree.cryptocurrencies)


@pytest.mark.parametrize("levels,ncur", [(20, 1), (16, 2), (4, 2)])
def test_synthetic_witness_matches_jax(levels, ncur):
    balances = [11888, 41163][:ncur]
    got = TM.synthetic_merkle_proof(levels, ncur, TM.Entry("dxGaEAii", balances))
    want = JM.synthetic_merkle_proof(levels, ncur, JM.Entry("dxGaEAii", balances))
    assert (got.root.hash, got.root.balances) == (want.root.hash, want.root.balances)
    assert got.sibling_leaf_node_hash_preimage == want.sibling_leaf_node_hash_preimage
    assert got.sibling_middle_node_hash_preimages == want.sibling_middle_node_hash_preimages
    assert got.path_indices == want.path_indices
    assert TM.MerkleSumTree.verify_proof(got)
    other = TM.synthetic_merkle_proof(levels, ncur, TM.Entry("dxGaEAii", balances), seed=1)
    assert other.root.hash != got.root.hash


def _criterion_circuit():
    fix = FIX["criterion"]
    proof = TM.synthetic_merkle_proof(fix["levels"], fix["n_currencies"],
                                      TM.Entry(fix["user"], fix["balances"]), seed=fix["seed"])
    return fix, MstInclusionCircuit.init(fix["levels"], fix["n_currencies"], fix["n_bytes"], proof)


def test_criterion_witness_instances_match_fixture():
    fix, circuit = _criterion_circuit()
    assert [[hex(v) for v in col] for col in circuit.instances()] == fix["instances"]


@pytest.mark.slow
def test_criterion_proofs_equal_jax_bytes_on_cpu():
    """k = 13 keygen and both transcripts' proofs on the CPU (minutes)."""
    from circuits_halo2_tpu_torch.utils import pipeline

    fix, circuit = _criterion_circuit()
    art = pipeline.generate_setup_artifacts(fix["k"], None, fix["levels"], fix["n_currencies"],
                                            fix["n_bytes"], "cpu")
    assert pipeline.gen_proof_solidity_calldata(art, circuit).proof[2:] == fix["keccak_proof"]
    assert pipeline.full_prover(art, circuit, circuit.instances()).hex() == fix["blake2b_proof"]
