"""The port's whole slice on the CPU: CSV -> MerkleSumTree -> keygen ->
Keccak (EVM) proof of entry_16 user 0 at k=11, through the pipeline entry
points. The VK equals tests/fixtures_vk_inclusion.json, the proof equals the
JAX package's byte for byte (tests/fixtures_torch_proofs.json), and both
packages' verifiers accept it and reject a flipped instance. Exact."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu.models.verifier import verify as jax_verify
from circuits_halo2_tpu.utils.srs import ParamsKZG as JaxParams
from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
from circuits_halo2_tpu_torch.models.verifier import verify
from circuits_halo2_tpu_torch.utils import pipeline
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

torch.set_num_threads(2)

HERE = Path(__file__).parent
FIX = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
VK_FIX = json.loads((HERE / "fixtures_vk_inclusion.json").read_text())
VK_DIGEST = int(VK_FIX["vk_digest"], 16)


@pytest.fixture(scope="module")
def slice_run():
    art = pipeline.generate_setup_artifacts(
        FIX["k"], str(HERE / "fixtures_ptau_hermez-raw-11"), FIX["levels"],
        FIX["n_currencies"], FIX["n_bytes"], "cpu")
    tree = MerkleSumTree.from_csv(str(HERE / FIX["csv"]), "cpu")
    circuit = MstInclusionCircuit.init(FIX["levels"], FIX["n_currencies"], FIX["n_bytes"],
                                       tree.generate_proof(FIX["user_index"]))
    calldata = pipeline.gen_proof_solidity_calldata(art, circuit, vk_digest=VK_DIGEST)
    return art, circuit, calldata


def test_keygen_matches_reference_vk(slice_run):
    vk = slice_run[0].vk
    assert vk.fixed_commitments == [(int(x, 16), int(y, 16)) for x, y in VK_FIX["fixed_comms"]]
    assert vk.permutation_commitments == [
        (int(x, 16), int(y, 16)) for x, y in VK_FIX["permutation_comms"]]
    assert vk.transcript_repr == VK_DIGEST


def test_instances_match_fixture(slice_run):
    _, circuit, calldata = slice_run
    assert [[hex(v) for v in col] for col in circuit.instances()] == FIX["instances"]
    assert calldata.public_inputs == FIX["instances"][0]


def test_keccak_proof_equals_jax_proof(slice_run):
    proof = slice_run[2].proof
    assert len(proof) == 2 + 2 * 2144
    assert proof[2:] == FIX["keccak_vk_digest_proof"]


def test_both_verifiers_accept_and_reject_flipped(slice_run):
    art, circuit, calldata = slice_run
    proof = bytes.fromhex(calldata.proof[2:])
    instances = circuit.instances()
    bad = [list(instances[0])]
    bad[0][2] += 1
    for fn in (verify, jax_verify):
        assert fn(art.params, art.vk, instances, proof, vk_digest=VK_DIGEST)
        assert not fn(art.params, art.vk, bad, proof, vk_digest=VK_DIGEST)


def test_unsafe_setup_matches_jax():
    ours, ref = ParamsKZG.setup(5), JaxParams.setup(5)
    assert (ours.g, ours.g_lagrange, ours.g2, ours.s_g2) == (ref.g, ref.g_lagrange, ref.g2, ref.s_g2)


@pytest.mark.slow
def test_fixture_regenerates_from_jax():
    """The JAX package, run live, still produces the fixture's proofs."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", HERE.parent / "scripts" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.make() == FIX
