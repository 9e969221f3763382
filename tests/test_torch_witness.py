"""Phase 1's advice through the key's witness plan (``models/witness``)
against the layouter: for criterion's (20, 1, 8) and evm-wei's (20, 2, 8)
circuits at k=13 and the flow's entry_16 circuit at k=11, the native fill
equals what ``MstInclusionCircuit.synthesize`` assigns, blinded in the
prover's draw order, limb for limb and int for int; a batch equals each
user alone; circuits that assign their own cells, and mixed batches, take
the layouter; the route's users are counted. Exact; no prove."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from circuits_halo2_tpu_torch.merkle.mst import (
    Entry, MerkleSumTree, Node, parse_csv_to_entries, synthetic_merkle_proof)
from circuits_halo2_tpu_torch.models import witness
from circuits_halo2_tpu_torch.models.assignment import Assignment
from circuits_halo2_tpu_torch.models.incremental import (
    ChainedMstInclusionCircuit, IncrementalMstInclusionCircuit, compile_chained_circuit,
    compile_incremental_circuit)
from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit, compile_circuit
from circuits_halo2_tpu_torch.models.prover import BlindingRng
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.utils import tracing

HERE = Path(__file__).parent
FIX = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
ENTRY16 = (FIX["levels"], FIX["n_currencies"], FIX["n_bytes"], FIX["k"])
CASES = {"criterion": (20, 1, 8, 13), "evm-wei": (20, 2, 8, 13), "entry_16": ENTRY16}


def _key(shape_k):
    """(pk, config): what the prover reads of a key, for the circuit's shape."""
    *shape, k = shape_k
    _, cs, config, _ = compile_circuit(*shape, k)
    return SimpleNamespace(vk=SimpleNamespace(cs=cs, k=k)), config


def _entry16_tree() -> MerkleSumTree:
    """The flow's entry_16 tree, hashed on the host."""
    cryptos, entries = parse_csv_to_entries(str(HERE / FIX["csv"]))
    nodes = [[e.compute_leaf() for e in entries]]
    while len(nodes[-1]) > 1:
        below = nodes[-1]
        nodes.append([Node.middle(below[i], below[i + 1]) for i in range(0, len(below), 2)])
    return MerkleSumTree(nodes[-1][0], nodes, len(nodes) - 1, entries, cryptos)


def _circuits(name):
    """Three users: zero balances, the largest balance N_BYTES allows, and
    a plain one; on the entry_16 tree, or on seeded paths of 20 levels."""
    levels, ncur, nbytes, _ = CASES[name]
    top = (1 << (8 * nbytes)) - 1
    if name == "entry_16":
        tree = _entry16_tree()
        proofs = [tree.generate_proof(u) for u in (0, 5, 14)]
        proofs[0].entry.balances = [0] * ncur
        proofs[1].entry.balances = [top] * ncur
        proofs[1].sibling_leaf_node_hash_preimage[1:] = [top] * ncur
    else:
        entries = [Entry("zero", [0] * ncur), Entry("top", [top] * ncur),
                   Entry("plain", [7 ** (i + 9) for i in range(ncur)])]
        proofs = [synthetic_merkle_proof(levels, ncur, e, seed=s)
                  for s, e in enumerate(entries, start=19)]
    circuits = [MstInclusionCircuit.init(levels, ncur, nbytes, p) for p in proofs]
    assert {b for c in circuits for b in c.path_indices} == {0, 1}
    return circuits


def _rngs(count, tag="witness"):
    return [BlindingRng(f"{tag}:{u}".encode()) for u in range(count)]


def _zeros(circuit):
    """Instances in the instance column's shape (the advice never reads them)."""
    return [[0] * circuit.num_instances()]


def _layouter_limbs(pk, config, circuit, rng, usable):
    """The layouter's advice, blinded as the prover always drew it: every
    column's rows usable..n in turn."""
    cs, n = pk.vk.cs, 1 << pk.vk.k
    asn = Assignment(cs, n, _zeros(circuit))
    circuit.synthesize(config, asn)
    advice = [list(col) for col in asn.advice]
    for col in advice:
        for row in range(usable, n):
            col[row] = rng.next_field()
    return FT.to_mont_limbs([v for col in advice for v in col]).reshape(FT.NLIMBS, -1, n), advice


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    pk, config = _key(CASES[request.param])
    return request.param, pk, config, _circuits(request.param)


def test_plan_fill_equals_the_layouter(case):
    name, pk, config, circuits = case
    cs, n = pk.vk.cs, 1 << pk.vk.k
    usable = cs.usable_rows(n)
    insts = [c.instances() for c in circuits]
    rngs = _rngs(len(circuits))
    batch = witness.advice_limbs(pk, config, circuits, insts, rngs, usable)
    assert batch.shape == (FT.NLIMBS, 3, cs.num_advice, n) and batch.dtype == np.int64
    plan = witness.plan_for(pk, config, circuits)
    assert plan.shape == CASES[name][:3] and plan.index.max() % n < usable
    assert len(set(plan.index.tolist())) == len(plan.index)
    for u, circuit in enumerate(circuits):
        want, advice = _layouter_limbs(pk, config, circuit, _rngs(3)[u], usable)
        assert np.array_equal(batch[:, u], want)
        assert FT.from_mont_ints(batch[:, u].reshape(FT.NLIMBS, -1)) == \
            [v for col in advice for v in col]
        alone = witness.advice_limbs(pk, config, [circuit], [insts[u]], [_rngs(3)[u]], usable)
        assert np.array_equal(alone[:, 0], batch[:, u])
        assert rngs[u].counter == cs.num_advice * (n - usable)  # the draws, and no more


def test_plan_is_built_once_per_key_and_config(case):
    _, pk, config, circuits = case
    plan = witness.plan_for(pk, config, circuits)
    assert witness.plan_for(pk, config, circuits[:1]) is plan
    assert witness.plan_for(pk, SimpleNamespace(**vars(config)), circuits) is not plan


def _route(pk, config, circuits, usable):
    tracing.enable()
    try:
        out = witness.advice_limbs(pk, config, circuits, [_zeros(c) for c in circuits],
                                   _rngs(len(circuits)), usable)
    finally:
        tracing.disable()
        spans, counts = tracing.drain()
    return out, spans, counts


def test_mst_batch_takes_the_plan_and_counts_its_users():
    pk, config = _key(ENTRY16)
    usable = pk.vk.cs.usable_rows(1 << pk.vk.k)
    _, spans, counts = _route(pk, config, _circuits("entry_16"), usable)
    assert counts == {("witness", "plan"): {"users": 3}}
    assert [s.user for s in spans if s.name == "synthesize"] == [None]
    assert sorted(s.user for s in spans if s.name == "blinding_draws") == [0, 1, 2]


@pytest.fixture(scope="module")
def own_cells():
    """Circuits that assign their own cells, and mixed batches, each with
    the (cs, config, k) it runs under."""
    levels, ncur, nbytes, k = ENTRY16
    inc = compile_incremental_circuit(levels, ncur, nbytes, k)[1:3] + (k,)
    chained = compile_chained_circuit(levels, ncur, nbytes, 2, k + 1)[1:3] + (k + 1,)
    plain = MstInclusionCircuit.init_empty(levels, ncur, nbytes)
    step = IncrementalMstInclusionCircuit(levels, ncur, nbytes)
    return {
        "incremental": (inc, [step, IncrementalMstInclusionCircuit(levels, ncur, nbytes)]),
        "chained": (chained, [ChainedMstInclusionCircuit(levels, ncur, nbytes, 2)]),
        "mixed classes": (inc, [plain, step]),
        "mixed shapes": (inc, [plain, MstInclusionCircuit.init_empty(levels - 1, ncur, nbytes)]),
    }


@pytest.mark.parametrize("name", ["incremental", "chained", "mixed classes", "mixed shapes"])
def test_own_cells_and_mixed_batches_take_the_layouter(own_cells, name):
    (cs, config, k), circuits = own_cells[name]
    pk = SimpleNamespace(vk=SimpleNamespace(cs=cs, k=k))
    usable = cs.usable_rows(1 << k)
    assert witness.plan_for(pk, config, circuits) is None
    out, spans, counts = _route(pk, config, circuits, usable)
    assert counts == {("witness", "layouter"): {"users": len(circuits)}}
    assert sorted(s.user for s in spans if s.name == "synthesize") == list(range(len(circuits)))
    for u, circuit in enumerate(circuits):
        want = _layouter_limbs(pk, config, circuit, _rngs(len(circuits))[u], usable)[0]
        assert np.array_equal(out[:, u], want)
