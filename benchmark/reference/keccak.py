"""Keccak-256 in plain Python for the benchmark's reference: the original
Keccak submission's padding (domain byte 0x01, not SHA-3's 0x06), as
Ethereum's ``keccak256``, with no native library and nothing of the port.

The state is 25 lanes of 64 bits, lane (x, y) at index x + 5y; a block of
the 136-byte rate is XORed into lanes 0..16, little-endian, before each
Keccak-f[1600] permutation (24 rounds of theta, rho and pi, chi, iota).
"""

from __future__ import annotations

RATE = 136
MASK = (1 << 64) - 1
ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)


def _rho_pi() -> list[tuple[int, int, int]]:
    """(source lane, destination lane, rotation) of rho and pi: lane (x, y)
    rotated by the offset of the (x, y) -> (y, 2x + 3y) walk from (1, 0) moves
    to lane (y, 2x + 3y)."""
    offsets = {(0, 0): 0}
    x, y = 1, 0
    for t in range(24):
        offsets[(x, y)] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    return [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), offsets[(x, y)])
            for y in range(5) for x in range(5)]


RHO_PI = _rho_pi()


def keccak_f(a: list[int]) -> None:
    """Keccak-f[1600] on the 25 lanes, in place."""
    b = [0] * 25
    for rc in ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for x in range(5):
            d = c[x - 1] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63)) & MASK)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        for src, dst, r in RHO_PI:
            v = a[src]
            b[dst] = ((v << r) | (v >> (64 - r))) & MASK if r else v
        for y in range(0, 25, 5):
            row = b[y:y + 5]
            for x in range(5):
                a[x + y] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5])
        a[0] ^= rc


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data) + b"\x01" + bytes(-(len(data) + 1) % RATE)
    padded[-1] |= 0x80
    state = [0] * 25
    for ofs in range(0, len(padded), RATE):
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(padded[ofs + 8 * i:ofs + 8 * i + 8], "little")
        keccak_f(state)
    return b"".join(lane.to_bytes(8, "little") for lane in state[:4])
