"""Frozen copy of ``circuits_halo2_tpu_torch/utils/transcript.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

Fiat–Shamir transcripts.

Only the Blake2b format is kept here (the benchmark proves with it); the
port's module also has the Keccak one (`zk_prover/src/circuits/utils.rs:93-102`
Blake2b native path; `:134-160` Keccak EVM path):

- (not copied) ``KeccakTranscript``: running byte buffer (hashed by the port's native
  library through ``ops/keccak.keccak256``); scalars/coordinates absorbed as
  32-byte big-endian words; squeeze = keccak256(buffer) mod r, buffer resets
  to the raw hash; consecutive squeezes hash (state || 0x01). Points are
  written uncompressed (x, y). This is exactly the transcript the generated
  Solidity verifier replays (`contracts/src/InclusionVerifier.sol:92-113`).

- ``Blake2bTranscript``: halo2's Blake2bWrite/Read with Challenge255 —
  blake2b-512 keyed with personalization "Halo2-Transcript"; domain prefixes
  0=challenge, 1=point, 2=scalar; scalars 32-byte LE; points compressed
  (32-byte, y-parity in the top bit); challenges from 64 uniform LE bytes.
"""

from __future__ import annotations

import hashlib

from . import curve as C
from .field import FQ_MOD, FR_MOD


def _g1_compress(point) -> bytes:
    """halo2curves bn256 G1Affine::to_bytes: x LE with y-sign in bit 255."""
    if point is None:
        return b"\x00" * 32
    x, y = point
    b = bytearray(x.to_bytes(32, "little"))
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def _g1_decompress(data: bytes):
    b = bytearray(data)
    sign = (b[31] >> 7) & 1
    b[31] &= 0x7F
    x = int.from_bytes(bytes(b), "little")
    if x == 0 and sign == 0:
        return None
    y2 = (pow(x, 3, FQ_MOD) + C.B_G1) % FQ_MOD
    y = pow(y2, (FQ_MOD + 1) // 4, FQ_MOD)
    if y * y % FQ_MOD != y2:
        raise ValueError("invalid x coordinate")
    if y & 1 != sign:
        y = FQ_MOD - y
    return (x, y)


class Blake2bTranscript:
    """halo2 Blake2bWrite/Blake2bRead with Challenge255."""

    PREFIX_CHALLENGE = b"\x00"
    PREFIX_POINT = b"\x01"
    PREFIX_SCALAR = b"\x02"

    def __init__(self, proof: bytes | None = None):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.proof = bytearray() if proof is None else None
        self.reader = memoryview(proof) if proof is not None else None
        self.offset = 0

    def common_scalar(self, value: int):
        self.state.update(self.PREFIX_SCALAR)
        self.state.update(int(value % FR_MOD).to_bytes(32, "little"))

    def common_point(self, point):
        if point is None:
            raise ValueError("cannot absorb the point at infinity")
        self.state.update(self.PREFIX_POINT)
        self.state.update(point[0].to_bytes(32, "little"))
        self.state.update(point[1].to_bytes(32, "little"))

    def write_point(self, point):
        self.common_point(point)
        self.proof += _g1_compress(point)

    def write_scalar(self, value: int):
        self.common_scalar(value)
        self.proof += int(value % FR_MOD).to_bytes(32, "little")

    def finalize(self) -> bytes:
        return bytes(self.proof)

    def read_point(self):
        point = _g1_decompress(bytes(self.reader[self.offset : self.offset + 32]))
        self.offset += 32
        self.common_point(point)
        return point

    def read_scalar(self) -> int:
        v = int.from_bytes(self.reader[self.offset : self.offset + 32], "little")
        self.offset += 32
        if v >= FR_MOD:
            raise ValueError("scalar out of range")
        self.common_scalar(v)
        return v

    def squeeze_challenge(self) -> int:
        self.state.update(self.PREFIX_CHALLENGE)
        digest = self.state.copy().digest()
        # keep absorbing on the same state (halo2 clones for finalize)
        return int.from_bytes(digest, "little") % FR_MOD

    squeeze_challenge_cont = squeeze_challenge
