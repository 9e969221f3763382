"""Proof pipeline entry points (``circuits_halo2_tpu/utils/pipeline.py``):
setup artifacts, the native-path prover and verifier, and EVM calldata.

Every device-side step runs on the ``device`` the artifacts were made for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.incremental import compile_chained_circuit, compile_incremental_circuit
from ..models.keygen import ProvingKey, VerifyingKey, keygen
from ..models.mst_inclusion import MstInclusionCircuit, compile_circuit
from ..models.prover import BlindingRng, prove
from ..models.verifier import verify
from ..ops.field import FR_MOD
from .srs import ParamsKZG, setup_cached
from .transcript import Blake2bTranscript, KeccakTranscript


@dataclass
class SetupArtifacts:
    params: ParamsKZG
    pk: ProvingKey
    vk: VerifyingKey
    cs: object
    config: object
    circuit_shape: tuple  # (levels, n_currencies, n_bytes)
    device: torch.device


@dataclass
class ProofSolidityCallData:
    """EVM calldata bundle."""

    proof: str                 # 0x-prefixed hex
    public_inputs: list[str]   # 0x-prefixed U256 hex


@dataclass
class CommitmentSolidityCallData:
    """The root commitment as EVM calldata."""

    root_hash: str
    root_balances: list[str]


def _setup(k: int, ptau_path: str | None, compiled, shape: tuple, device) -> SetupArtifacts:
    """The SRS file at ``ptau_path`` downsized to 2^k points on ``device``
    when it is larger (the cached unsafe deterministic setup when
    ``ptau_path`` is None), and keygen on ``device`` of a compiled circuit
    ``(circuit, cs, config, asn)``."""
    if ptau_path is None:
        params = setup_cached(k)
    else:
        params = ParamsKZG.read(ptau_path)
        if params.k < k:
            raise ValueError("provided ptau is smaller than the requested k")
        if params.k > k:
            params = params.downsize(k, device)
    _, cs, config, asn = compiled
    vk, pk = keygen(params, cs, asn, device)
    return SetupArtifacts(params, pk, vk, cs, config, shape, torch.device(device))


def generate_setup_artifacts(k: int, ptau_path: str | None, levels: int, n_currencies: int,
                             n_bytes: int, device="cuda:0") -> SetupArtifacts:
    """Load the SRS (or the cached unsafe deterministic setup when
    ``ptau_path`` is None), downsize it to 2^k points on ``device`` when the
    file is larger, and run keygen on ``device`` (the card unless the caller
    asks for the CPU)."""
    return _setup(k, ptau_path, compile_circuit(levels, n_currencies, n_bytes, k),
                  (levels, n_currencies, n_bytes), device)


def generate_incremental_artifacts(k: int, ptau_path: str | None, levels: int,
                                   n_currencies: int, n_bytes: int,
                                   device="cuda:0") -> SetupArtifacts:
    """Setup and keygen of the incremental step circuit
    (``models/incremental.IncrementalMstInclusionCircuit``), with the SRS
    handling of ``generate_setup_artifacts``."""
    return _setup(k, ptau_path, compile_incremental_circuit(levels, n_currencies, n_bytes, k),
                  (levels, n_currencies, n_bytes), device)


def generate_chained_artifacts(k: int, ptau_path: str | None, levels: int, n_currencies: int,
                               n_bytes: int, nsteps: int, device="cuda:0") -> SetupArtifacts:
    """Setup and keygen of the N-step chained circuit
    (``models/incremental.ChainedMstInclusionCircuit``)."""
    return _setup(k, ptau_path,
                  compile_chained_circuit(levels, n_currencies, n_bytes, nsteps, k),
                  (levels, n_currencies, n_bytes), device)


def full_prover(artifacts: SetupArtifacts, circuit: MstInclusionCircuit,
                instances: list[list[int]], rng: BlindingRng | None = None) -> bytes:
    """Native-path proof (Blake2b transcript, compressed points)."""
    return prove(artifacts.params, artifacts.pk, circuit, artifacts.config, instances,
                 artifacts.device, rng=rng, transcript_cls=Blake2bTranscript)


def full_verifier(artifacts: SetupArtifacts, proof: bytes, instances: list[list[int]]) -> bool:
    try:
        return verify(artifacts.params, artifacts.vk, instances, proof,
                      transcript_cls=Blake2bTranscript)
    except (ValueError, AssertionError, KeyError):
        return False


def gen_proof_solidity_calldata(artifacts: SetupArtifacts, circuit: MstInclusionCircuit,
                                rng: BlindingRng | None = None,
                                vk_digest: int | None = None) -> ProofSolidityCallData:
    """EVM-path proof (Keccak transcript, uncompressed points), verified
    before export."""
    instances = circuit.instances()
    proof = prove(artifacts.params, artifacts.pk, circuit, artifacts.config, instances,
                  artifacts.device, rng=rng, transcript_cls=KeccakTranscript,
                  vk_digest=vk_digest)
    if not verify(artifacts.params, artifacts.vk, instances, proof,
                  transcript_cls=KeccakTranscript, vk_digest=vk_digest):
        raise RuntimeError("proof verification failed before calldata export")
    return ProofSolidityCallData("0x" + proof.hex(),
                                 [field_element_to_solidity_calldata(v) for v in instances[0]])


def field_element_to_solidity_calldata(value: int) -> str:
    """U256 hex (minimal length, 0x-prefixed)."""
    return hex(value)


def calculate_max_root_balance(n_bytes: int, n_levels: int) -> int:
    """Max value the Merkle root balance can reach."""
    return ((1 << (8 * n_bytes)) - 1) * (n_levels + 1)


def is_there_risk_of_overflow(n_bytes: int, n_levels: int) -> bool:
    """Root-balance overflow guard."""
    return calculate_max_root_balance(n_bytes, n_levels) > FR_MOD
