"""Fiat-Shamir transcripts: the JAX package's host classes, with the Keccak
squeeze hashed by the port's own native library (``native.keccak256``).

Byte formats and challenge derivation are unchanged, so proofs from either
package read in the other's verifier.
"""

from __future__ import annotations

from circuits_halo2_tpu.ops.field import FR_MOD
from circuits_halo2_tpu.utils import transcript as _T

from .. import native

Blake2bTranscript = _T.Blake2bTranscript


class KeccakTranscript(_T.KeccakTranscript):
    """EVM-compatible transcript (see ``circuits_halo2_tpu/utils/transcript.py``)."""

    def squeeze_challenge(self) -> int:
        data = bytes(self.buf) if self.fresh else bytes(self.buf) + b"\x01"
        h = native.keccak256(data)
        self.buf = bytearray(h)
        self.fresh = False
        return int.from_bytes(h, "big") % FR_MOD
