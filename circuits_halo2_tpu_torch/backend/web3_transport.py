"""Web3/JSON-RPC transport seam for the operator backend.

The reference's ``SummaSigner`` wraps an ethers-rs
``SignerMiddleware<Provider<Http>, LocalWallet>`` (`signer.rs:20-57`) —
transactions are ABI-encoded, nonce-managed, and submitted over JSON-RPC.
This module provides the same seam shape without a chain:

- a minimal ABI encoder/decoder (uint256, bytes, string, dynamic arrays,
  dynamic tuples — everything ``Summa.sol``'s methods need);
- ``FakeRpcProvider`` — an in-process JSON-RPC node: ``eth_chainId``,
  ``eth_getTransactionCount``, ``eth_sendTransaction`` (decodes calldata,
  dispatches to a ``SummaContractSim``, ENFORCES strictly-sequential
  nonces like a real mempool), ``eth_call``,
  ``eth_getTransactionReceipt``;
- ``Web3SummaContract`` — duck-type compatible with ``SummaContractSim``
  for ``SummaSigner``, but every call round-trips through ABI calldata and
  the provider, so the signer's nonce lock is exercised against real
  transaction semantics (`backend/src/tests.rs:146-191`).

A production deployment swaps ``FakeRpcProvider`` for an HTTP provider
with the same ``request(method, params)`` surface; nothing above the
transport changes.
"""

from __future__ import annotations

import json
import threading
from typing import Any

from ..contracts.summa_sim import (
    AddressOwnershipProof,
    Cryptocurrency,
    SummaContractSim,
)
from ..ops.keccak import keccak256

# ---------------------------------------------------------------------------
# Minimal ABI codec
# ---------------------------------------------------------------------------


def _parse_type(t: str):
    """'uint256[]' → ('array', 'uint256'); 'tuple(a,b)' → ('tuple', [a, b])."""
    t = t.strip()
    if t.endswith("[]"):
        return ("array", t[:-2])
    if t.startswith("tuple(") and t.endswith(")"):
        inner, depth, parts, start = t[6:-1], 0, [], 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append(inner[start:i])
                start = i + 1
        parts.append(inner[start:])
        return ("tuple", [p for p in parts if p])
    return ("base", t)


def _is_dynamic(t: str) -> bool:
    kind, inner = _parse_type(t)
    if kind == "array":
        return True
    if kind == "tuple":
        return any(_is_dynamic(p) for p in inner)
    return inner in ("bytes", "string")


def _enc_word(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def _encode_one(t: str, v: Any) -> bytes:
    kind, inner = _parse_type(t)
    if kind == "base":
        if inner.startswith("uint") or inner.startswith("int"):
            return _enc_word(v)
        if inner == "address":
            return _enc_word(int(v, 16) if isinstance(v, str) else int(v))
        if inner == "bool":
            return _enc_word(1 if v else 0)
        if inner in ("bytes", "string"):
            data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            padded = data + b"\x00" * ((-len(data)) % 32)
            return _enc_word(len(data)) + padded
        raise ValueError(f"unsupported ABI type {t}")
    if kind == "array":
        return _enc_word(len(v)) + encode_abi([inner] * len(v), list(v))
    # tuple
    return encode_abi(inner, list(v))


def encode_abi(types: list[str], values: list[Any]) -> bytes:
    """Standard head/tail ABI encoding."""
    heads: list[bytes | None] = []
    tails: list[bytes] = []
    for t, v in zip(types, values):
        if _is_dynamic(t):
            heads.append(None)
            tails.append(_encode_one(t, v))
        else:
            heads.append(_encode_one(t, v))
            tails.append(b"")
    head_size = sum(32 if h is None else len(h) for h in heads)
    out, offset = b"", head_size
    for h, tail in zip(heads, tails):
        if h is None:
            out += _enc_word(offset)
            offset += len(tail)
        else:
            out += h
    return out + b"".join(tails)


def _decode_one(t: str, data: bytes, pos: int):
    """Returns (value, static_size_consumed)."""
    kind, inner = _parse_type(t)
    if kind == "base":
        if inner in ("bytes", "string"):
            ofs = int.from_bytes(data[pos : pos + 32], "big")
            ln = int.from_bytes(data[ofs : ofs + 32], "big")
            raw = data[ofs + 32 : ofs + 32 + ln]
            return (raw.decode("utf-8") if inner == "string" else raw), 32
        if inner == "bool":
            return bool(int.from_bytes(data[pos : pos + 32], "big")), 32
        return int.from_bytes(data[pos : pos + 32], "big"), 32
    if kind == "array":
        ofs = int.from_bytes(data[pos : pos + 32], "big")
        ln = int.from_bytes(data[ofs : ofs + 32], "big")
        vals = decode_abi([inner] * ln, data[ofs + 32 :])
        return vals, 32
    # tuple
    if _is_dynamic(t):
        ofs = int.from_bytes(data[pos : pos + 32], "big")
        return tuple(decode_abi(inner, data[ofs:])), 32
    vals, p = [], pos
    for part in inner:
        v, sz = _decode_one(part, data, p)
        vals.append(v)
        p += sz
    return tuple(vals), p - pos


def decode_abi(types: list[str], data: bytes) -> list[Any]:
    out, pos = [], 0
    for t in types:
        v, sz = _decode_one(t, data, pos)
        out.append(v)
        pos += sz
    return out


def selector(signature: str) -> bytes:
    return keccak256(signature.encode("utf-8"))[:4]


# Method signatures mirror contracts/src/Summa.sol (submitProofOfAddress-
# Ownership :112, submitCommitment :144, verifyInclusionProof :193).
SIG_OWNERSHIP = "submitProofOfAddressOwnership((string,string,string,string)[])"
SIG_COMMITMENT = "submitCommitment(uint256,uint256[],(string,string)[],uint256)"
SIG_VERIFY = "verifyInclusionProof(bytes,uint256[],uint256)"

_T_OWNERSHIP = ["tuple(string,string,string,string)[]"]
_T_COMMITMENT = ["uint256", "uint256[]", "tuple(string,string)[]", "uint256"]
_T_VERIFY = ["bytes", "uint256[]", "uint256"]


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class FakeRpcProvider:
    """In-process JSON-RPC node fronting a SummaContractSim.

    Speaks the subset of the eth namespace the signer path uses, with real
    transaction semantics: per-account strictly-sequential nonces (a reused
    or skipped nonce is rejected exactly like a mempool would)."""

    def __init__(
        self,
        contract: SummaContractSim | None = None,
        address: str | None = None,
        chain_id: int = 31337,
    ):
        self.contract = contract
        self.address = address.lower() if address else None
        self.chain_id = chain_id
        # deployed-contract registry: creation transactions land here and
        # cross-contract calls (Summa -> IVerifier) route through it
        self.contracts: dict[str, Any] = {}
        if contract is not None and address is not None:
            self.contracts[self.address] = contract
        self.nonces: dict[str, int] = {}
        self.receipts: dict[str, dict] = {}
        self._lock = threading.Lock()

    def contract_at(self, address: str):
        return self.contracts[address.lower()]

    # -- the provider surface (matches web3/ethers providers) ---------------

    def request(self, method: str, params: list | None = None) -> Any:
        params = params or []
        if method == "eth_chainId":
            return hex(self.chain_id)
        if method == "eth_getTransactionCount":
            return hex(self.nonces.get(params[0].lower(), 0))
        if method == "eth_sendTransaction":
            return self._send_transaction(params[0])
        if method == "eth_call":
            return self._call(params[0])
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(params[0])
        raise RpcError(-32601, f"method not found: {method}")

    # -- internals -----------------------------------------------------------

    def _send_transaction(self, tx: dict) -> str:
        sender = tx["from"].lower()
        data = bytes.fromhex(tx["data"][2:])
        with self._lock:
            expected = self.nonces.get(sender, 0)
            nonce = int(tx["nonce"], 16) if isinstance(tx["nonce"], str) else tx["nonce"]
            if nonce < expected:
                raise RpcError(-32000, "nonce too low")
            if nonce > expected:
                raise RpcError(-32000, "nonce too high")
            txh = "0x" + keccak256(data + nonce.to_bytes(8, "big") + sender.encode()).hex()
            created = None
            try:
                if not tx.get("to"):
                    created = self._create(sender, data, nonce)
                else:
                    self._dispatch(tx["from"], data, tx.get("to"))
                status = "0x1"
            except (ValueError, PermissionError):
                status = "0x0"
            # the nonce is consumed either way (like a mined revert)
            self.nonces[sender] = expected + 1
            self.receipts[txh] = {
                "transactionHash": txh,
                "status": status,
                "contractAddress": created,
            }
            return txh

    def _create(self, sender: str, data: bytes, nonce: int) -> str:
        """Contract-creation transaction. On this node the "initcode" is a
        CREATE_PREFIX-tagged JSON container holding the contract SOURCE —
        the executable form of code on this chain (the Yul verifier runs in
        contracts/yul_vm, Solidity in contracts/sol_exec) — plus constructor
        args. The deployed address derives from (sender, nonce) like CREATE."""
        if not data.startswith(CREATE_PREFIX):
            raise ValueError("creation data is not a recognized initcode container")
        payload = json.loads(data[len(CREATE_PREFIX):])
        addr = (
            "0x"
            + keccak256(sender.encode() + nonce.to_bytes(8, "big"))[-20:].hex()
        )
        lang, source = payload["lang"], payload["source"]
        if lang == "yul":
            obj = DeployedYulVerifier(source)
        elif lang == "sol":
            from ..contracts.sol_exec import SolSummaContract

            vaddr, levels, ncur, nbytes = payload["args"]
            vcontract = self.contract_at(vaddr)
            obj = SolSummaContract(
                lambda proof, inputs: vcontract.verify_proof(proof, inputs),
                levels, ncur, nbytes, owner=sender, source_text=source,
            )
        else:
            raise ValueError(f"unknown contract language {lang!r}")
        self.contracts[addr] = obj
        if self.contract is None:
            # first Summa-shaped deployment becomes the default binding
            if lang == "sol":
                self.contract, self.address = obj, addr
        return addr

    def _route(self, to: str | None):
        if to:
            # an explicit target must resolve; silently falling back to the
            # default binding would let a mis-addressed cross-contract call
            # "succeed" against the wrong contract (a real node reverts)
            try:
                return self.contracts[to.lower()]
            except KeyError:
                raise RpcError(3, f"no contract at {to}") from None
        if self.contract is None:
            raise RpcError(3, "no contract bound")
        return self.contract

    def _dispatch(self, sender: str, data: bytes, to: str | None = None):
        contract = self._route(to)
        sel, args = data[:4], data[4:]
        if sel == selector(SIG_OWNERSHIP):
            (proofs,) = decode_abi(_T_OWNERSHIP, args)
            contract.submit_proof_of_address_ownership(
                sender, [AddressOwnershipProof(*p) for p in proofs]
            )
        elif sel == selector(SIG_COMMITMENT):
            root, balances, cryptos, ts = decode_abi(_T_COMMITMENT, args)
            contract.submit_commitment(
                sender, root, list(balances),
                [Cryptocurrency(*c) for c in cryptos], ts,
            )
        else:
            raise ValueError(f"unknown selector {sel.hex()}")

    def _call(self, tx: dict) -> str:
        contract = self._route(tx.get("to"))
        data = bytes.fromhex(tx["data"][2:])
        sel, args = data[:4], data[4:]
        if sel == selector(SIG_VERIFY):
            proof, inputs, ts = decode_abi(_T_VERIFY, args)
            try:
                ok = contract.verify_inclusion_proof(bytes(proof), list(inputs), ts)
            except ValueError:
                raise RpcError(3, "execution reverted")
            return "0x" + _enc_word(1 if ok else 0).hex()
        raise RpcError(3, "execution reverted")


class Web3SummaContract:
    """RPC-backed Summa binding, duck-type compatible with SummaContractSim
    for SummaSigner (methods take the sender first)."""

    def __init__(self, provider: FakeRpcProvider, address: str):
        self.provider = provider
        self.address = address

    def _transact(self, sender: str, data: bytes) -> dict:
        nonce = int(self.provider.request("eth_getTransactionCount", [sender, "pending"]), 16)
        txh = self.provider.request(
            "eth_sendTransaction",
            [{"from": sender, "to": self.address, "data": "0x" + data.hex(),
              "nonce": hex(nonce)}],
        )
        receipt = self.provider.request("eth_getTransactionReceipt", [txh])
        if receipt["status"] != "0x1":
            raise ValueError("transaction reverted")
        return receipt

    def submit_proof_of_address_ownership(
        self, sender: str, proofs: list[AddressOwnershipProof]
    ):
        data = selector(SIG_OWNERSHIP) + encode_abi(
            _T_OWNERSHIP,
            [[(p.cex_address, p.chain, p.signature, p.message) for p in proofs]],
        )
        return self._transact(sender, data)

    def submit_commitment(
        self, sender: str, mst_root, root_balances, cryptocurrencies, timestamp
    ):
        data = selector(SIG_COMMITMENT) + encode_abi(
            _T_COMMITMENT,
            [mst_root, list(root_balances),
             [(c.name, c.chain) for c in cryptocurrencies], timestamp],
        )
        return self._transact(sender, data)

    def verify_inclusion_proof(
        self, proof: bytes, public_inputs: list[int], timestamp: int
    ) -> bool:
        data = selector(SIG_VERIFY) + encode_abi(
            _T_VERIFY, [proof, list(public_inputs), timestamp]
        )
        out = self.provider.request(
            "eth_call", [{"to": self.address, "data": "0x" + data.hex()}, "latest"]
        )
        return int(out, 16) == 1


# ---------------------------------------------------------------------------
# Deployment (reference: backend's deploy flow — ethers ContractFactory
# deploys InclusionVerifier then Summa and records deployments.json,
# `backend/src/contracts/mod.rs` + `scripts/update_verifier_contract.sh`)
# ---------------------------------------------------------------------------

# "initcode" container tag for this node: the executable form of code on
# this chain is the contract SOURCE (Yul runs in contracts/yul_vm, the
# Solidity subset in contracts/sol_exec).
CREATE_PREFIX = b"CCTPU-CREATE1\x00"


def encode_creation(lang: str, source: str, args: list | None = None) -> bytes:
    return CREATE_PREFIX + json.dumps(
        {"lang": lang, "source": source, "args": args or []}
    ).encode()


class DeployedYulVerifier:
    """An InclusionVerifier deployed on the fake node: holds the contract
    source; calls execute in the Yul VM with the full gas model."""

    def __init__(self, source: str):
        self.source = source

    def verify_proof(self, proof: bytes, instances: list[int]) -> bool:
        from ..contracts.yul_vm import run_verifier

        return run_verifier(self.source, bytes(proof), list(instances))


def _deploy_tx(provider: FakeRpcProvider, sender: str, data: bytes) -> str:
    nonce = int(provider.request("eth_getTransactionCount", [sender, "pending"]), 16)
    txh = provider.request(
        "eth_sendTransaction",
        [{"from": sender, "data": "0x" + data.hex(), "nonce": hex(nonce)}],
    )
    receipt = provider.request("eth_getTransactionReceipt", [txh])
    if receipt["status"] != "0x1":
        raise ValueError("deployment transaction reverted")
    return receipt["contractAddress"]


def deploy_summa(
    artifacts,
    mst_levels: int,
    currencies_count: int,
    balance_byte_range: int,
    provider: FakeRpcProvider | None = None,
    sender: str = "0xf39fd6e51aad88f6f4ce6ab8827279cfffb92266",
    deployments_path: str | None = None,
):
    """Deploy round-trip against the in-process node: generate the verifier
    from the live VK, deploy it, deploy the shipped ``Summa.sol`` pointing
    at the verifier ADDRESS (cross-contract calls route through the node),
    and record the receipt-derived addresses in ``deployments.json`` in the
    shape ``SummaSigner``'s ``AddressInput`` resolves.

    Returns ``(provider, summa_address, verifier_address)``.
    """
    import os

    from ..contracts.sol_generator import SolidityGenerator

    provider = provider or FakeRpcProvider()
    verifier_src = SolidityGenerator(
        artifacts.params, artifacts.vk, mst_levels
    ).render()
    vaddr = _deploy_tx(provider, sender, encode_creation("yul", verifier_src))
    summa_src = open(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "contracts", "solidity", "Summa.sol",
        )
    ).read()
    saddr = _deploy_tx(
        provider,
        sender,
        encode_creation(
            "sol", summa_src,
            [vaddr, mst_levels, currencies_count, balance_byte_range],
        ),
    )
    if deployments_path is not None:
        with open(deployments_path, "w") as f:
            json.dump(
                {
                    str(provider.chain_id): {
                        "address": saddr,
                        "name": "Summa",
                        "verifierAddress": vaddr,
                    }
                },
                f,
                indent=2,
            )
    return provider, saddr, vaddr
