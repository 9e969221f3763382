"""A proving key made by the JAX package, carried into the port with
``convert.proving_key_from_jax`` beside the port's own constraint system,
gives the port's native-path (Blake2b) proof of entry_16 user 0 at k=11
byte-equal to the JAX package's proof (tests/fixtures_torch_proofs.json);
both verifiers accept it, each with its own package's params, and reject a
flipped instance. Exact."""

import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu.models.keygen import keygen as jax_keygen
from circuits_halo2_tpu.models.mst_inclusion import compile_circuit as jax_compile
from circuits_halo2_tpu.models.verifier import verify as jax_verify
from circuits_halo2_tpu.utils.srs import ParamsKZG as JaxParams
from circuits_halo2_tpu.utils.transcript import Blake2bTranscript as JaxBlake2b
from circuits_halo2_tpu_torch import convert
from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit, compile_circuit
from circuits_halo2_tpu_torch.utils import pipeline
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

torch.set_num_threads(2)

HERE = Path(__file__).parent
SRS = str(HERE / "fixtures_ptau_hermez-raw-11")
FIX = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
SHAPE = (FIX["levels"], FIX["n_currencies"], FIX["n_bytes"])


@pytest.fixture(scope="module")
def run():
    jparams = JaxParams.read(SRS)
    _, jcs, _, jasn = jax_compile(*SHAPE, FIX["k"])
    _, jpk = jax_keygen(jparams, jcs, jasn)
    _, cs, config, _ = compile_circuit(*SHAPE, FIX["k"])
    pk = convert.proving_key_from_jax(jpk, cs)
    params = ParamsKZG.read(SRS)
    art = pipeline.SetupArtifacts(params, pk, pk.vk, cs, config, SHAPE, torch.device("cpu"))
    tree = MerkleSumTree.from_csv(str(HERE / FIX["csv"]), "cpu")
    circuit = MstInclusionCircuit.init(*SHAPE, tree.generate_proof(FIX["user_index"]))
    instances = circuit.instances()
    return art, jpk, jparams, instances, pipeline.full_prover(art, circuit, instances)


def test_converted_key_keeps_vk(run):
    art, jpk, _, _, _ = run
    vk, jvk = art.vk, jpk.vk
    assert vk.cs is art.cs and vk.cs is not jvk.cs
    assert type(vk.cs).__module__.startswith("circuits_halo2_tpu_torch.")
    assert vk.fixed_commitments == jvk.fixed_commitments
    assert vk.permutation_commitments == jvk.permutation_commitments
    assert vk.transcript_repr == jvk.transcript_repr
    assert art.pk.l_active_row == jpk.l_active_row


def test_blake2b_proof_equals_jax_proof(run):
    proof = run[4]
    assert len(proof) == 1632
    assert proof.hex() == FIX["blake2b_proof"]


def test_both_verifiers_accept_and_reject_flipped(run):
    art, jpk, jparams, instances, proof = run
    bad = [list(instances[0])]
    bad[0][2] += 1
    assert pipeline.full_verifier(art, proof, instances)
    assert not pipeline.full_verifier(art, proof, bad)
    assert jax_verify(jparams, jpk.vk, instances, proof, transcript_cls=JaxBlake2b)
    assert not jax_verify(jparams, jpk.vk, bad, proof, transcript_cls=JaxBlake2b)
