"""Frozen copy of the Keccak transcript of
``circuits_halo2_tpu_torch/utils/transcript.py`` for the benchmark's
reference, reading proofs only, over the reference's own plain-Python
``keccak.keccak256`` (it imports nothing of the port; later changes to the
port do not move it).

The EVM path's transcript (`zk_prover/src/circuits/utils.rs:134-160`, the
one the generated Solidity verifier replays): a running byte buffer;
scalars and coordinates absorbed as 32-byte big-endian words; a squeeze is
keccak256(buffer) mod r, after which the buffer is the raw hash; a squeeze
with nothing absorbed since the last hashes (buffer || 0x01). Points are
written uncompressed, (x, y).
"""

from __future__ import annotations

from . import curve as C
from .field import FQ_MOD, FR_MOD
from .keccak import keccak256


class KeccakTranscript:
    """The proof reader: ``verifier.verify``'s transcript interface."""

    def __init__(self, proof: bytes):
        self.buf = bytearray()
        self.reader = memoryview(proof)
        self.offset = 0
        self.fresh = False  # anything absorbed since the last squeeze?

    def common_scalar(self, value: int):
        self.buf += int(value % FR_MOD).to_bytes(32, "big")
        self.fresh = True

    def common_point(self, point):
        if point is None:
            raise ValueError("cannot absorb the point at infinity")
        self.buf += point[0].to_bytes(32, "big")
        self.buf += point[1].to_bytes(32, "big")
        self.fresh = True

    def read_point(self):
        if self.offset + 64 > len(self.reader):
            raise ValueError("proof too short")
        x = int.from_bytes(self.reader[self.offset:self.offset + 32], "big")
        y = int.from_bytes(self.reader[self.offset + 32:self.offset + 64], "big")
        self.offset += 64
        if x >= FQ_MOD or y >= FQ_MOD:
            raise ValueError("point coordinate out of range")
        point = (x, y)
        if not C.g1_is_on_curve(point) or (x == 0 and y == 0):
            raise ValueError("point not on curve")
        self.common_point(point)
        return point

    def read_scalar(self) -> int:
        if self.offset + 32 > len(self.reader):
            raise ValueError("proof too short")
        v = int.from_bytes(self.reader[self.offset:self.offset + 32], "big")
        self.offset += 32
        if v >= FR_MOD:
            raise ValueError("scalar out of range")
        self.common_scalar(v)
        return v

    def squeeze_challenge(self) -> int:
        data = bytes(self.buf) if self.fresh else bytes(self.buf) + b"\x01"
        h = keccak256(data)
        self.buf = bytearray(h)
        self.fresh = False
        return int.from_bytes(h, "big") % FR_MOD
