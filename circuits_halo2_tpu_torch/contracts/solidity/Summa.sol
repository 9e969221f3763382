// SPDX-License-Identifier: Apache-2.0
pragma solidity ^0.8.18;

import "./IVerifier.sol";

/// @title Summa proof-of-solvency registrar (TPU-framework edition)
/// @notice On-chain registry for a CEX's address-ownership proofs and
/// per-round liabilities commitments, with user-side inclusion-proof
/// verification delegated to a generated SNARK verifier.
/// Behavioral parity target: the reference registrar
/// (`contracts/src/Summa.sol:11-220`); the executable specification of this
/// state machine also lives in circuits_halo2_tpu/contracts/summa_sim.py,
/// which the backend tests exercise.
contract Summa {
    address public owner;

    struct SummaConfig {
        uint16 mstLevels;
        uint16 currenciesCount;
        uint8 balanceByteRange;
    }

    struct AddressOwnershipProof {
        string cexAddress;
        string chain;
        bytes signature;
        bytes message;
    }

    struct Cryptocurrency {
        string name;
        string chain;
    }

    struct Commitment {
        uint256 mstRoot;
        uint256[] rootBalances;
        Cryptocurrency[] cryptocurrencies;
    }

    SummaConfig public config;
    IVerifier public immutable inclusionVerifier;

    AddressOwnershipProof[] public addressOwnershipProofs;
    mapping(bytes32 => uint256) private ownershipProofByAddress;
    mapping(uint256 => Commitment) public commitments;

    event AddressOwnershipProofSubmitted(AddressOwnershipProof[] addressOwnershipProofs);
    event LiabilitiesCommitmentSubmitted(
        uint256 indexed timestamp,
        uint256 mstRoot,
        uint256[] rootBalances,
        Cryptocurrency[] cryptocurrencies
    );

    modifier onlyOwner() {
        require(msg.sender == owner, "Ownable: caller is not the owner");
        _;
    }

    constructor(
        IVerifier verifier,
        uint16 mstLevels,
        uint16 currenciesCount,
        uint8 balanceByteRange
    ) {
        owner = msg.sender;
        inclusionVerifier = verifier;
        config = SummaConfig(mstLevels, currenciesCount, balanceByteRange);
    }

    function submitProofOfAddressOwnership(
        AddressOwnershipProof[] memory proofs
    ) public onlyOwner {
        for (uint256 i = 0; i < proofs.length; i++) {
            bytes32 key = keccak256(abi.encodePacked(proofs[i].cexAddress));
            require(ownershipProofByAddress[key] == 0, "Address already verified");
            addressOwnershipProofs.push(proofs[i]);
            ownershipProofByAddress[key] = addressOwnershipProofs.length;
            require(
                bytes(proofs[i].cexAddress).length != 0 &&
                    bytes(proofs[i].chain).length != 0 &&
                    bytes(proofs[i].signature).length != 0 &&
                    bytes(proofs[i].message).length != 0,
                "Invalid proof of address ownership"
            );
        }
        emit AddressOwnershipProofSubmitted(proofs);
    }

    function getAddressOwnershipProof(
        bytes32 addressHash
    ) public view returns (AddressOwnershipProof memory) {
        require(ownershipProofByAddress[addressHash] > 0, "Address not verified");
        // index is stored +1 so 0 can mean "not submitted"
        return addressOwnershipProofs[ownershipProofByAddress[addressHash] - 1];
    }

    function submitCommitment(
        uint256 mstRoot,
        uint256[] memory rootBalances,
        Cryptocurrency[] memory cryptocurrencies,
        uint256 timestamp
    ) public onlyOwner {
        require(mstRoot != 0, "Invalid MST root");
        require(
            cryptocurrencies.length == rootBalances.length,
            "Root liabilities sums and liabilities number mismatch"
        );
        Commitment storage commitment = commitments[timestamp];
        commitment.mstRoot = mstRoot;
        delete commitment.rootBalances;
        delete commitment.cryptocurrencies;
        for (uint256 i = 0; i < rootBalances.length; i++) {
            require(
                bytes(cryptocurrencies[i].chain).length != 0 &&
                    bytes(cryptocurrencies[i].name).length != 0,
                "Invalid cryptocurrency"
            );
            require(
                rootBalances[i] != 0,
                "All root sums should be greater than zero"
            );
            commitment.rootBalances.push(rootBalances[i]);
            commitment.cryptocurrencies.push(cryptocurrencies[i]);
        }
        emit LiabilitiesCommitmentSubmitted(
            timestamp, mstRoot, rootBalances, cryptocurrencies
        );
    }

    function verifyInclusionProof(
        bytes memory proof,
        uint256[] memory publicInputs,
        uint256 timestamp
    ) public view returns (bool) {
        Commitment storage commitment = commitments[timestamp];
        require(commitment.mstRoot == publicInputs[1], "Invalid root hash");
        for (uint256 i = 2; i < publicInputs.length; i++) {
            require(
                commitment.rootBalances[i - 2] == publicInputs[i],
                "Invalid root balance"
            );
        }
        try inclusionVerifier.verifyProof(proof, publicInputs) returns (bool ok) {
            return ok;
        } catch {
            require(false, "Invalid inclusion proof");
            return false;
        }
    }
}
