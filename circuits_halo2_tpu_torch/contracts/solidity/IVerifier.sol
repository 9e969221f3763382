// SPDX-License-Identifier: Apache-2.0
pragma solidity ^0.8.18;

/// Interface of the generated SNARK verifier
/// (`contracts/src/interfaces/IVerifier.sol` parity).
interface IVerifier {
    function verifyProof(
        bytes calldata proof,
        uint256[] calldata instances
    ) external view returns (bool);
}
