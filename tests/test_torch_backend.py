"""The port's operator backend on the CPU: the cases of tests/test_backend.py
and tests/test_web3_transport.py on the port's modules, and the port's
examples run end to end with ``--device cpu`` (k=11, entry_16): the
``summa_solvency_flow`` round, whose exported calldata equals the JAX
package's proof and which the port's verifier and its generated EVM
verifier (in the port's Yul VM) accept; ``gen_commitment``'s root;
``gen_inclusion_verifier`` and ``gen_inclusion_proof`` on the flow's key.
Exact."""

import json
import threading
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu_torch.backend.address_ownership import (AddressOwnership,
                                                                parse_signature_csv)
from circuits_halo2_tpu_torch.backend.apis import leaf_hash_from_inputs
from circuits_halo2_tpu_torch.backend.signer import AddressInput, SummaSigner
from circuits_halo2_tpu_torch.backend.web3_transport import (FakeRpcProvider, RpcError,
                                                             Web3SummaContract, decode_abi,
                                                             encode_abi)
from circuits_halo2_tpu_torch.contracts.summa_sim import (AddressOwnershipProof,
                                                          Cryptocurrency, SummaContractSim)
from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree

torch.set_num_threads(2)

HERE = Path(__file__).parent
CSV = HERE / "fixtures_csv"
GOLDEN_ROOT_16 = 0x177BF452AD139F067A64FE09FDC30AAE46144D60ABFA2AD9F0C70928E29A26D1
CRYPTOS = [Cryptocurrency("ETH", "ETH"), Cryptocurrency("USDT", "ETH")]
PROOFS = json.loads((HERE / "fixtures_torch_proofs.json").read_text())


# --- tests/test_backend.py ---------------------------------------------------

@pytest.fixture()
def summa():
    return SummaContractSim(lambda p, i: True, 4, 2, 8)


@pytest.fixture()
def signer(summa):
    return SummaSigner("0x" + "11" * 32, summa, sender=summa.owner)


def test_signature_csv_parsing():
    proofs = parse_signature_csv(str(CSV / "signatures.csv"))
    assert len(proofs) == 2
    assert proofs[0].chain == "ETH"
    assert proofs[0].cex_address.startswith("0x")
    assert "Summa proof of solvency" in proofs[0].message


def test_ownership_dedup(summa, signer):
    ownership = AddressOwnership(signer, str(CSV / "signatures.csv"))
    ownership.dispatch_proof_of_address_ownership()
    assert len(summa.address_ownership_proofs) == 2
    with pytest.raises(ValueError, match="already verified"):
        ownership.dispatch_proof_of_address_ownership()


def test_commitment_validation(summa, signer):
    signer.submit_commitment(GOLDEN_ROOT_16, [556862, 556862], CRYPTOS, 1)
    assert summa.commitments[1].mst_root == GOLDEN_ROOT_16
    with pytest.raises(ValueError, match="mismatch"):
        signer.submit_commitment(1, [1], CRYPTOS, 2)
    with pytest.raises(PermissionError):
        summa.submit_commitment("0xnotowner", 1, [1, 2], CRYPTOS, 3)


def test_concurrent_commitments_nonce_lock(summa, signer):
    threads = [threading.Thread(target=signer.submit_commitment,
                                args=(GOLDEN_ROOT_16, [556862, 556862], CRYPTOS, ts))
               for ts in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(summa.commitments) == 10
    assert signer.nonce == 10


def test_address_input_resolution(tmp_path):
    assert AddressInput(address="0xabc").resolve() == "0xabc"
    path = tmp_path / "deployments.json"
    path.write_text(json.dumps({"31337": {"address": "0xdef", "name": "Summa"}}))
    assert AddressInput(deployments_path=str(path), chain_id=31337).resolve() == "0xdef"


def test_leaf_hash_from_inputs_matches_tree():
    tree = MerkleSumTree.from_csv(str(CSV / "entry_16.csv"), "cpu")
    e = tree.entries[0]
    assert leaf_hash_from_inputs(e.username, [str(b) for b in e.balances]) == tree.leaves()[0].hash
    assert tree.root.hash == GOLDEN_ROOT_16


def test_inclusion_verification_root_checks(summa, signer):
    signer.submit_commitment(GOLDEN_ROOT_16, [556862, 556862], CRYPTOS, 1)
    pub = [123, GOLDEN_ROOT_16, 556862, 556862]
    assert summa.verify_inclusion_proof(b"\x00", pub, 1)
    with pytest.raises(ValueError, match="Invalid root hash"):
        summa.verify_inclusion_proof(b"", [0, 999] + pub[2:], 1)
    with pytest.raises(ValueError, match="Invalid root balance"):
        summa.verify_inclusion_proof(b"", [0, GOLDEN_ROOT_16, 1, 2], 1)


# --- tests/test_web3_transport.py --------------------------------------------

OWNER = "0xowner"
ADDR = "0x" + "11" * 20


def _stack():
    sim = SummaContractSim(lambda proof, inputs: True, 4, 2, 8, owner=OWNER)
    provider = FakeRpcProvider(sim, ADDR)
    contract = Web3SummaContract(provider, ADDR)
    return sim, provider, contract, SummaSigner("0xkey", contract, OWNER)


def test_abi_roundtrip():
    types = ["uint256", "uint256[]", "tuple(string,string)[]", "bytes"]
    values = [0x177B, [556862, 556862], [("ETH", "ETH"), ("USDT", "ETH")], b"\x01\x02\x03"]
    out = decode_abi(types, encode_abi(types, values))
    assert out[0] == values[0]
    assert list(out[1]) == values[1]
    assert [tuple(t) for t in out[2]] == values[2]
    assert bytes(out[3]) == values[3]


def test_flow_through_rpc():
    sim, provider, contract, signer = _stack()
    signer.submit_proof_of_address_ownership(
        [AddressOwnershipProof("0xabc", "ETH", "0xsig", "Summa proof of ownership")])
    assert sim.address_ownership_proofs[0].cex_address == "0xabc"
    signer.submit_commitment(0x177B, [556862, 556862], CRYPTOS, 1)
    assert sim.commitments[1].mst_root == 0x177B
    assert provider.request("eth_getTransactionCount", [OWNER, "pending"]) == hex(2)
    assert contract.verify_inclusion_proof(b"\x00" * 32, [7, 0x177B, 556862, 556862], 1)
    with pytest.raises(ValueError):  # non-owner reverted: nonce consumed, state unchanged
        contract.submit_commitment("0xmallory", 1, [1, 1], CRYPTOS, 2)
    assert 2 not in sim.commitments


def test_concurrent_submissions_nonce_serialized():
    sim, provider, _, signer = _stack()
    errs = []

    def submit(ts):
        try:
            signer.submit_commitment(0x100 + ts, [1, 2], CRYPTOS, ts)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=submit, args=(ts,)) for ts in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(sim.commitments) == 8
    assert provider.request("eth_getTransactionCount", [OWNER, "pending"]) == hex(8)


def test_nonce_reuse_rejected():
    _, provider, _, _ = _stack()
    tx = {"from": OWNER, "to": ADDR, "data": "0x00000000", "nonce": "0x0"}
    provider.request("eth_sendTransaction", [tx])
    with pytest.raises(RpcError, match="nonce too low"):
        provider.request("eth_sendTransaction", [tx])


# --- the port's examples, end to end -----------------------------------------

@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    from circuits_halo2_tpu_torch.examples import summa_solvency_flow

    out = tmp_path_factory.mktemp("flow")
    data, round_ = summa_solvency_flow.main(["--device", "cpu", "--out", str(out)])
    return out, data, round_


def _keyed_to_the_flow(monkeypatch, flow):
    """Hand the examples the flow's k=11 key in place of a second keygen."""
    from circuits_halo2_tpu_torch.utils import pipeline

    art = flow[2].snapshot.trusted_setup
    monkeypatch.setattr(pipeline, "generate_setup_artifacts",
                        lambda k, ptau, *shape, device: art)
    return art


def test_summa_solvency_flow_on_the_cpu(flow):
    from circuits_halo2_tpu_torch.contracts.sol_generator import SolidityGenerator
    from circuits_halo2_tpu_torch.contracts.yul_vm import run_verifier
    from circuits_halo2_tpu_torch.examples import _common
    from circuits_halo2_tpu_torch.models.verifier import verify

    out, data, round_ = flow
    written = json.loads((out / "inclusion_proof_solidity_calldata.json").read_text())
    assert written == data
    proof = bytes.fromhex(data["proof"][2:])
    instances = [int(v, 16) for v in data["public_inputs"]]
    assert len(proof) == 2144 and instances[1] == GOLDEN_ROOT_16
    # the VK's own digest is the fixture's, so the bytes are the JAX package's
    assert data["proof"][2:] == PROOFS["keccak_vk_digest_proof"]
    art = round_.snapshot.trusted_setup
    assert art.device == torch.device("cpu") and art.vk.k == _common.K
    assert verify(art.params, art.vk, [instances], proof)
    source = SolidityGenerator(art.params, art.vk, len(instances)).render()
    assert run_verifier(source, proof, instances)
    bad = list(instances)
    bad[2] += 1
    assert not run_verifier(source, proof, bad)



BULK_USERS = [5, 0, 9]


@pytest.fixture(scope="module")
def bulk(flow):
    """Users 5, 0 and 9 of the flow's snapshot in one traced
    ``Snapshot.generate_proofs_of_inclusion`` call: the proofs, and the
    call's spans and counts."""
    from circuits_halo2_tpu_torch.utils import tracing as TR

    TR.drain()
    TR.enable()
    try:
        got = flow[2].snapshot.generate_proofs_of_inclusion(BULK_USERS)
    finally:
        TR.disable()
    return got, *TR.drain()


def test_snapshot_proves_users_in_bulk(flow, bulk):
    """Each user's public inputs are the hex of its circuit's instances; the
    middle user's calldata (user 0) is the one-at-a-time calldata of the
    flow, the JAX package's bytes for the same circuit and rng; the others
    carry proofs of their own."""
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit

    _, data, round_ = flow
    snapshot = round_.snapshot
    got = bulk[0]
    assert got[1].get_proof() == data["proof"] == "0x" + PROOFS["keccak_vk_digest_proof"]
    assert got[1].get_public_inputs() == data["public_inputs"]
    for user, one in zip(BULK_USERS, got):
        want = MstInclusionCircuit.init(*snapshot.shape, snapshot.mst.generate_proof(user))
        assert one.get_public_inputs() == [hex(v) for v in want.instances()[0]]
        assert len(one.get_proof()) == len(data["proof"])
    assert len({one.get_proof() for one in got}) == len(BULK_USERS)


def test_bulk_self_check_runs_one_pairing_and_its_spans_nest(bulk):
    _, spans, counts = bulk
    assert counts[("verify", "pairings")] == {"n": 1}
    assert counts[("verify", "proofs")] == {"n": len(BULK_USERS)}
    by_id = {s.id: s for s in spans}
    (check,) = [s for s in spans if s.name == "self_check"]
    replays = [s for s in spans if s.name == "transcript" and s.parent == check.id]
    assert len(replays) == len(BULK_USERS)
    (encode,) = [s for s in spans if s.name == "calldata"]
    assert check.end <= encode.start and encode.parent is None and check.parent is None
    assert all(by_id.get(s.parent) is not check or s.name == "transcript" for s in spans)


@pytest.mark.parametrize("where", ["first commitment", "last evaluation"])
def test_a_flipped_byte_is_named_and_nothing_exported(flow, bulk, monkeypatch, where):
    """A point no longer on the curve fails its replay; an evaluation
    changed in its lowest byte replays and fails the folded pairing, and the
    check of each proof alone names it."""
    from circuits_halo2_tpu_torch.utils import pipeline
    from circuits_halo2_tpu_torch.utils import tracing as TR

    proofs = [bytes.fromhex(one.get_proof()[2:]) for one in bulk[0]]
    bad = bytearray(proofs[1])
    bad[31 if where == "first commitment" else len(bad) - 2 * 64 - 1] ^= 1
    proofs[1] = bytes(bad)
    monkeypatch.setattr(pipeline, "prove_batch", lambda *args, **kwargs: list(proofs))
    TR.enable()
    try:
        with pytest.raises(RuntimeError, match=r"proofs \[1\] failed verification"):
            flow[2].snapshot.generate_proofs_of_inclusion(BULK_USERS)
    finally:
        TR.disable()
    spans, counts = TR.drain()
    assert not [s for s in spans if s.name == "calldata"]
    assert counts[("verify", "pairings")] == {"n": 1 if where == "first commitment" else 4}


def test_deferred_accumulator_equals_the_jax_package(flow, bulk):
    """``verify(..., defer_pairing=True)`` (the accumulator as one host
    Pippenger, the quotient's pieces as terms of it) returns the JAX
    package's pair on each bulk proof, under the JAX package's own
    constraint system and params."""
    from circuits_halo2_tpu.models.keygen import VerifyingKey as JaxVerifyingKey
    from circuits_halo2_tpu.models.mst_inclusion import compile_circuit as jax_compile
    from circuits_halo2_tpu.models.verifier import verify as jax_verify
    from circuits_halo2_tpu.utils.srs import ParamsKZG as JaxParams
    from circuits_halo2_tpu_torch.examples import _common
    from circuits_halo2_tpu_torch.models.verifier import verify

    art = flow[2].snapshot.trusted_setup
    vk = art.vk
    _, jcs, _, _ = jax_compile(*art.circuit_shape, vk.k)
    jvk = JaxVerifyingKey(vk.k, jcs, list(vk.fixed_commitments), list(vk.permutation_commitments),
                          [], [], vk.omega, vk.transcript_repr)
    jparams = JaxParams.read(str(_common.PTAU))
    for one in bulk[0]:
        instances = [[int(v, 16) for v in one.get_public_inputs()]]
        proof = bytes.fromhex(one.get_proof()[2:])
        ours = verify(art.params, vk, instances, proof, defer_pairing=True)
        assert ours == jax_verify(jparams, jvk, instances, proof, defer_pairing=True)
        assert ours[0] is True and ours[1][0] is not None


def test_gen_commitment(tmp_path):
    from circuits_halo2_tpu_torch.examples import gen_commitment

    data = gen_commitment.main(["--device", "cpu", "--out", str(tmp_path)])
    assert data == {"root_hash": hex(GOLDEN_ROOT_16), "root_balances": [hex(556862)] * 2}
    assert json.loads((tmp_path / "commitment_solidity_calldata.json").read_text()) == data


def test_gen_inclusion_verifier(flow, tmp_path, monkeypatch):
    from circuits_halo2_tpu_torch.examples import gen_inclusion_verifier

    _keyed_to_the_flow(monkeypatch, flow)
    source = gen_inclusion_verifier.main(["--device", "cpu", "--out", str(tmp_path)])
    assert (tmp_path / "InclusionVerifier.sol").read_text() == source
    fix = json.loads((HERE / "fixtures_torch_contracts.json").read_text())
    assert len(source) == fix["verifier_length"] + len("_torch")  # the header names the port


def test_gen_inclusion_proof(flow, tmp_path, monkeypatch):
    from circuits_halo2_tpu_torch.examples import gen_inclusion_proof

    _keyed_to_the_flow(monkeypatch, flow)
    data = gen_inclusion_proof.main(["--device", "cpu", "--out", str(tmp_path)])
    assert data == flow[1]  # user 0 under the same key and blinding: the same calldata
    assert json.loads((tmp_path / "inclusion_proof_solidity_calldata.json").read_text()) == data
