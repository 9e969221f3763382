"""The port's batch prover on the CPU: entry_16 at k=11 with the
hermez-raw-11 SRS. A Keccak batch of users 0 and 1 gives user 0 the JAX
package's bytes (tests/fixtures_torch_proofs.json) and user 1 the port's
single ``prove``'s; a one-user Blake2b batch gives the JAX package's
Blake2b bytes; the proofs verify and a flipped instance is rejected. The
slow case holds the port's batch to the JAX package's ``prove_batch`` run
live. Exact."""

import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
from circuits_halo2_tpu_torch.models.prover import BlindingRng, prove
from circuits_halo2_tpu_torch.models.prover_batch import prove_batch
from circuits_halo2_tpu_torch.models.verifier import verify
from circuits_halo2_tpu_torch.utils import pipeline
from circuits_halo2_tpu_torch.utils import tracing as TR
from circuits_halo2_tpu_torch.utils.transcript import Blake2bTranscript

torch.set_num_threads(2)

HERE = Path(__file__).parent
FIX = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
VK_DIGEST = int(json.loads((HERE / "fixtures_vk_inclusion.json").read_text())["vk_digest"], 16)
SHAPE = (FIX["levels"], FIX["n_currencies"], FIX["n_bytes"])


@pytest.fixture(scope="module")
def setup():
    art = pipeline.generate_setup_artifacts(
        FIX["k"], str(HERE / "fixtures_ptau_hermez-raw-11"), *SHAPE, device="cpu")
    tree = MerkleSumTree.from_csv(str(HERE / FIX["csv"]), "cpu")
    circuits = [MstInclusionCircuit.init(*SHAPE, tree.generate_proof(i)) for i in (0, 1)]
    return art, circuits


@pytest.fixture(scope="module")
def traced_keccak_batch(setup):
    """The Keccak batch of users 0 and 1, proved with ``utils/tracing``
    recording: (proofs, (spans, counts))."""
    art, circuits = setup
    TR.drain()
    TR.enable()
    try:
        proofs = prove_batch(art.params, art.pk, circuits, art.config,
                             [c.instances() for c in circuits], vk_digest=VK_DIGEST, device="cpu")
    finally:
        TR.disable()
    return proofs, TR.drain()


@pytest.fixture(scope="module")
def keccak_batch(traced_keccak_batch):
    return traced_keccak_batch[0]


def _verifies_and_rejects_flipped(art, proof, instances, **kw):
    bad = [list(instances[0])]
    bad[0][2] += 1
    return (verify(art.params, art.vk, instances, proof, **kw)
            and not verify(art.params, art.vk, bad, proof, **kw))


def test_batch_user0_equals_jax_keccak_proof(keccak_batch):
    assert keccak_batch[0].hex() == FIX["keccak_vk_digest_proof"]


PHASES = ["phase1 synth+advice commits", "phase2 lookup permute+commit",
          "phase3 grand products+commits", "phase4 quotient+commit", "phase5 evaluations",
          "phase6a shplonk W", "phase6b shplonk W'"]


def test_traced_batch_has_its_leaf_spans_inside_the_phases(traced_keccak_batch):
    """With tracing on, the proof bytes stay the JAX package's; every span
    but the Domain's first conversions lies inside one of the call's
    phases, the per-user spans carry users 0 and 1, each of phases 1-4
    holds its layers' leaf spans (synthesis one span a call, the witness
    plan's fill, with no user), and the counts are the witness plan's users
    and the window combine's host route."""
    proofs, (spans, counts) = traced_keccak_batch
    assert proofs[0].hex() == FIX["keccak_vk_digest_proof"]
    roots = [s for s in spans if s.parent is None]
    phases = [s for s in roots if s.name in PHASES]
    assert [p.name for p in phases] == PHASES
    assert {s.name for s in roots} - set(PHASES) <= {"to_limbs"}  # the Domain's first build
    assert len({s.call for s in spans}) == 1 and spans[0].call is not None
    by_id = {s.id: s for s in spans}
    parents = {s.parent for s in spans}
    leaves: dict[str, set] = {s.name: set() for s in roots}
    inside: dict[str, set] = {s.name: set() for s in roots}
    for s in spans:
        top = s
        while top.parent is not None:
            parent = by_id[top.parent]
            assert parent.start <= top.start <= top.end <= parent.end
            top = parent
        inside[top.name].add(s.name)
        if s.id not in parents:
            leaves[top.name].add(s.name)
    for name in ("lookup_sort", "blinding_draws"):
        assert {s.user for s in spans if s.name == name} == {0, 1}
    assert [s.user for s in spans if s.name == "synthesize"] == [None]
    assert {"transcript", "synthesize", "blinding_draws", "to_limbs", "msm_combine"} <= \
        leaves[PHASES[0]]
    assert {"from_limbs", "lookup_sort", "blinding_draws", "msm_combine", "transcript"} <= \
        leaves[PHASES[1]]
    assert {"to_limbs", "blinding_draws", "msm_combine", "transcript"} <= leaves[PHASES[2]]
    assert {"to_limbs", "msm_combine", "transcript"} <= leaves[PHASES[3]]
    assert all("dispatch" in inside[p] for p in PHASES)
    # no kernel and no copy on the CPU: the window combines take the host
    # route, 16 commitments a proof of the two users
    assert counts == {("msm_combine", "host"): {"commitments": 32},
                      ("witness", "plan"): {"users": 2}}


def test_batch_user1_equals_single_prove(setup, keccak_batch):
    art, circuits = setup
    single = prove(art.params, art.pk, circuits[1], art.config, circuits[1].instances(), "cpu",
                   vk_digest=VK_DIGEST)
    assert keccak_batch[1] == single


@pytest.mark.parametrize("user", [0, 1])
def test_batch_proofs_verify_and_reject_flipped_instance(setup, keccak_batch, user):
    art, circuits = setup
    assert _verifies_and_rejects_flipped(art, keccak_batch[user], circuits[user].instances(),
                                         vk_digest=VK_DIGEST)


def test_one_user_blake2b_batch_equals_jax_proof(setup):
    art, circuits = setup
    (proof,) = prove_batch(art.params, art.pk, circuits[:1], art.config,
                           [circuits[0].instances()], transcript_cls=Blake2bTranscript,
                           device="cpu")
    assert proof.hex() == FIX["blake2b_proof"]
    assert _verifies_and_rejects_flipped(art, proof, circuits[0].instances(),
                                         transcript_cls=Blake2bTranscript)


def test_prove_batch_needs_one_instance_list_and_rng_per_circuit(setup):
    art, circuits = setup
    instances = [c.instances() for c in circuits]
    for args in ((circuits, instances[:1], None), ([], [], None),
                 (circuits, instances, [BlindingRng()])):
        with pytest.raises(ValueError):
            prove_batch(art.params, art.pk, args[0], art.config, args[1], rngs=args[2],
                        device="cpu")


@pytest.mark.slow
def test_batch_equals_jax_prove_batch(keccak_batch):
    """The JAX package's ``prove_batch`` of the same two users, run live
    (its own keygen, as tests/test_e2e_prove.py does), gives the same bytes."""
    from circuits_halo2_tpu.merkle.mst import MerkleSumTree as JaxTree
    from circuits_halo2_tpu.models.keygen import keygen
    from circuits_halo2_tpu.models.mst_inclusion import MstInclusionCircuit as JaxCircuit
    from circuits_halo2_tpu.models.mst_inclusion import compile_circuit
    from circuits_halo2_tpu.models.prover_batch import prove_batch as jax_prove_batch
    from circuits_halo2_tpu.utils.srs import ParamsKZG

    params = ParamsKZG.read(str(HERE / "fixtures_ptau_hermez-raw-11"))
    _, cs, config, asn = compile_circuit(*SHAPE, FIX["k"])
    _, pk = keygen(params, cs, asn)
    tree = JaxTree.from_csv(str(HERE / FIX["csv"]))
    circuits = [JaxCircuit.init(*SHAPE, tree.generate_proof(i)) for i in (0, 1)]
    theirs = jax_prove_batch(params, pk, circuits, config, [c.instances() for c in circuits],
                             vk_digest=VK_DIGEST)
    assert theirs == keccak_batch
