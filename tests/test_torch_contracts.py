"""The port's contracts layer: its Solidity generator renders, from the
port's entry_16 k=11 VK, the JAX package's verifier source apart from the
header line (held to the sha256 and length in
tests/fixtures_torch_contracts.json); its Yul VM runs that verifier on the
entry_16 Keccak proof (the JAX package's bytes, which the port's proof
equals: tests/test_torch_slice.py) and rejects a corrupted proof or
instance; and the Summa registrar cases of tests/test_summa_behavior.py
hold for the port's simulation and for its Solidity-subset interpreter of
the port's own Summa.sol, both driven through the port's JSON-RPC
transport. Exact."""

import hashlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu_torch.backend.web3_transport import FakeRpcProvider, Web3SummaContract
from circuits_halo2_tpu_torch.contracts.sol_generator import SolidityGenerator
from circuits_halo2_tpu_torch.contracts.summa_sim import (AddressOwnershipProof,
                                                          Cryptocurrency, SummaContractSim)
from circuits_halo2_tpu_torch.contracts.yul_vm import (encode_verify_calldata,
                                                       estimate_code_size, run_verifier,
                                                       run_verifier_gas)
from circuits_halo2_tpu_torch.ops.keccak import keccak256
from circuits_halo2_tpu_torch.utils import pipeline

torch.set_num_threads(2)

HERE = Path(__file__).parent
FIX = json.loads((HERE / "fixtures_torch_contracts.json").read_text())
PROOFS = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
VK_DIGEST = int(json.loads((HERE / "fixtures_vk_inclusion.json").read_text())["vk_digest"], 16)
PORT_HEADER = "// Generated by circuits_halo2_tpu_torch.contracts.sol_generator"


@pytest.fixture(scope="module")
def artifacts():
    return pipeline.generate_setup_artifacts(
        FIX["k"], str(HERE / "fixtures_ptau_hermez-raw-11"), FIX["levels"], FIX["n_currencies"],
        FIX["n_bytes"], device="cpu")


@pytest.fixture(scope="module")
def source(artifacts):
    return SolidityGenerator(artifacts.params, artifacts.vk, FIX["num_instances"]).render()


def test_generated_verifier_equals_jax_source_apart_from_header(artifacts, source):
    assert hex(artifacts.vk.transcript_repr) == FIX["transcript_repr"]
    lines = source.splitlines(keepends=True)
    header = [i for i, line in enumerate(lines) if line.startswith("// Generated by ")]
    assert len(header) == 1 and lines[header[0]].rstrip("\n") == PORT_HEADER
    lines[header[0]] = FIX["header_line"] + "\n"
    theirs = "".join(lines)
    assert len(theirs) == FIX["verifier_length"]
    assert hashlib.sha256(theirs.encode()).hexdigest() == FIX["verifier_sha256"]


@pytest.fixture(scope="module")
def keyed_source(artifacts):
    """The verifier keyed by the fixture digest the entry_16 Keccak proof uses."""
    return SolidityGenerator(artifacts.params, artifacts.vk, FIX["num_instances"],
                             vk_digest=VK_DIGEST).render()


def _proof_and_instances():
    return (bytes.fromhex(PROOFS["keccak_vk_digest_proof"]),
            [int(v, 16) for v in PROOFS["instances"][0]])


def test_yul_vm_accepts_the_entry16_keccak_proof(keyed_source):
    proof, instances = _proof_and_instances()
    ok, gas = run_verifier_gas(keyed_source, proof, instances)
    assert ok and gas > 100_000
    assert estimate_code_size(keyed_source) > 0


@pytest.mark.parametrize("where", ["proof", "instance"])
def test_yul_vm_rejects_a_corrupted_input(keyed_source, where):
    proof, instances = _proof_and_instances()
    if where == "proof":
        bad = bytearray(proof)
        bad[300] ^= 1
        proof = bytes(bad)
    else:
        instances[1] ^= 1
    assert not run_verifier(keyed_source, proof, instances)


def test_deploy_roundtrip(artifacts, tmp_path):
    """The generated verifier and the port's Summa.sol deploy on the
    in-process node (tests/test_contracts.py's round trip); the entry_16
    proof verifies through the Summa -> verifier call, a flipped byte not."""
    from circuits_halo2_tpu_torch.backend.signer import AddressInput
    from circuits_halo2_tpu_torch.backend.web3_transport import deploy_summa

    assert artifacts.vk.transcript_repr == VK_DIGEST  # the digest the proof was made with
    proof, instances = _proof_and_instances()
    sender = "0xf39fd6e51aad88f6f4ce6ab8827279cfffb92266"
    dep = tmp_path / "deployments.json"
    provider, saddr, vaddr = deploy_summa(artifacts, 4, 2, 8, sender=sender,
                                          deployments_path=str(dep))
    assert saddr != vaddr and saddr.startswith("0x") and len(saddr) == 42
    assert AddressInput(deployments_path=str(dep), chain_id=provider.chain_id).resolve() == saddr
    c = Web3SummaContract(provider, saddr)
    c.submit_commitment(sender, instances[1], instances[2:], CRYPTOS, 1)
    assert c.verify_inclusion_proof(proof, instances, 1)
    bad = bytearray(proof)
    bad[123] ^= 1
    assert not c.verify_inclusion_proof(bytes(bad), instances, 1)


def test_calldata_encoding():
    data = encode_verify_calldata(b"\xaa" * 64, [1, 2])
    assert int.from_bytes(data[4 + 0x40 : 4 + 0x60], "big") == 64
    assert data[4 + 0x60 : 4 + 0x60 + 64] == b"\xaa" * 64


def test_overflow_guard():
    assert not pipeline.is_there_risk_of_overflow(8, 4)
    assert pipeline.is_there_risk_of_overflow(32, 4)
    assert pipeline.calculate_max_root_balance(8, 4) == ((1 << 64) - 1) * 5


@pytest.mark.slow
def test_fixture_regenerates_from_jax():
    """The JAX package's generator, run live, still gives the fixture."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_contract_fixtures", HERE.parent / "scripts" / "make_torch_contract_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.make() == FIX


# --- the Summa registrar (tests/test_summa_behavior.py), on the port ----------

OWNER = "0xowner"
ADDR = "0x" + "22" * 20
CRYPTOS = [Cryptocurrency("ETH", "ETH"), Cryptocurrency("USDT", "ETH")]


def _proof(addr="0xCexAddress", chain="ETH", sig="0xsig", msg="Summa ownership"):
    return AddressOwnershipProof(addr, chain, sig, msg)


@pytest.fixture(params=["sol", "sim"])
def stack(request):
    if request.param == "sol":
        from circuits_halo2_tpu_torch.contracts.sol_exec import SolSummaContract

        sim = SolSummaContract(lambda p, i: True, 4, 2, 8, owner=OWNER)
    else:
        sim = SummaContractSim(lambda p, i: True, 4, 2, 8, owner=OWNER)
    return sim, Web3SummaContract(FakeRpcProvider(sim, ADDR), ADDR)


def test_sol_exec_runs_the_ports_own_summa_sol():
    from circuits_halo2_tpu_torch.contracts import sol_exec

    src = Path(sol_exec.__file__).parent / "solidity" / "Summa.sol"
    assert src.is_file() and "circuits_halo2_tpu_torch" in src.parts


def test_ownership_stored_and_event(stack):
    sim, c = stack
    c.submit_proof_of_address_ownership(OWNER, [_proof()])
    assert sim.address_ownership_proofs[0].cex_address == "0xCexAddress"
    assert sim.events[-1][0] == "AddressOwnershipProofSubmitted"


def test_ownership_reverts_for_non_owner(stack):
    _, c = stack
    with pytest.raises(ValueError):
        c.submit_proof_of_address_ownership("0xmallory", [_proof()])


def test_ownership_rejects_duplicate_address(stack):
    _, c = stack
    c.submit_proof_of_address_ownership(OWNER, [_proof()])
    with pytest.raises(ValueError):
        c.submit_proof_of_address_ownership(OWNER, [_proof(chain="BTC")])


@pytest.mark.parametrize("bad", [_proof(addr=""), _proof(chain=""), _proof(sig=""),
                                 _proof(msg="")])
def test_ownership_rejects_invalid_fields(stack, bad):
    _, c = stack
    with pytest.raises(ValueError):
        c.submit_proof_of_address_ownership(OWNER, [bad])


def test_ownership_lookup_unverified_reverts(stack):
    sim, c = stack
    c.submit_proof_of_address_ownership(OWNER, [_proof()])
    assert sim.get_address_ownership_proof(keccak256(b"0xCexAddress")).chain == "ETH"
    with pytest.raises(ValueError, match="Address not verified"):
        sim.get_address_ownership_proof(keccak256(b"0xother"))


def test_commitment_stored_and_event(stack):
    sim, c = stack
    c.submit_commitment(OWNER, 0x177B, [556862, 556862], CRYPTOS, 1)
    assert sim.commitments[1].mst_root == 0x177B
    assert sim.events[-1][0] == "LiabilitiesCommitmentSubmitted"


@pytest.mark.parametrize("sender, root, balances, cryptos", [
    ("0xmallory", 1, [1, 1], CRYPTOS),  # not the owner
    (OWNER, 0, [1, 1], CRYPTOS),  # zero root
    (OWNER, 0x177B, [1, 0], CRYPTOS),  # a zero root sum
    (OWNER, 0x177B, [1, 1], [Cryptocurrency("", "ETH"), Cryptocurrency("USDT", "ETH")]),
    (OWNER, 0x177B, [1, 1, 1], CRYPTOS),  # count mismatch
])
def test_commitment_rejected(stack, sender, root, balances, cryptos):
    _, c = stack
    with pytest.raises(ValueError):
        c.submit_commitment(sender, root, balances, cryptos, 1)


def test_verify_inclusion_happy_path(stack):
    _, c = stack
    c.submit_commitment(OWNER, 0x177B, [556862, 556862], CRYPTOS, 1)
    assert c.verify_inclusion_proof(b"\x01" * 64, [7, 0x177B, 556862, 556862], 1)


@pytest.mark.parametrize("inputs, timestamp", [
    ([7, 0xBAD, 556862, 556862], 1),  # wrong root
    ([7, 0x177B, 556862, 556862], 2),  # another timestamp's root
    ([7, 0x177B, 1, 556862], 1),  # wrong balances
])
def test_verify_inclusion_rejected(stack, inputs, timestamp):
    _, c = stack
    c.submit_commitment(OWNER, 0x177B, [556862, 556862], CRYPTOS, 1)
    c.submit_commitment(OWNER, 0x200, [1, 1], CRYPTOS, 2)
    with pytest.raises(Exception):
        c.verify_inclusion_proof(b"\x01", inputs, timestamp)


def test_verifier_exception_reverts_with_message():
    def boom(proof, inputs):
        raise RuntimeError("malformed point")

    sim = SummaContractSim(boom, 4, 2, 8, owner=OWNER)
    sim.submit_commitment(OWNER, 0x177B, [1, 1], CRYPTOS, 1)
    with pytest.raises(ValueError, match="Invalid inclusion proof"):
        sim.verify_inclusion_proof(b"\x01", [7, 0x177B, 1, 1], 1)


def test_verifier_false_returns_false():
    sim = SummaContractSim(lambda p, i: False, 4, 2, 8, owner=OWNER)
    sim.submit_commitment(OWNER, 0x177B, [1, 1], CRYPTOS, 1)
    assert sim.verify_inclusion_proof(b"\x01", [7, 0x177B, 1, 1], 1) is False
