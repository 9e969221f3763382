"""Grain-LFSR Poseidon parameter generation.

Re-implements the standard Poseidon parameter derivation (Grain LFSR with
shrinking, per the Poseidon paper's reference scripts) that the reference
repo runs via Sage (`zk_prover/circuit_parameters_gen/
generate_parameters_grain.sage`, invoked as documented in
`zk_prover/src/chips/poseidon/poseidon_params.rs:6-16`:
``sage generate_parameters_grain.sage 1 0 254 2 8 56 <bn254 Fr modulus>``).

The generated constants are cross-checked in tests against the extracted
``poseidon_constants.json``.
"""

from __future__ import annotations

from .field import FR_MOD


class GrainLFSR:
    """80-bit Grain LFSR with the Poseidon initialization and shrinking."""

    TAPS = (62, 51, 38, 23, 13, 0)

    def __init__(self, field: int, sbox: int, n: int, t: int, r_f: int, r_p: int):
        bits = []
        for value, width in ((field, 2), (sbox, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits.extend(int(b) for b in bin(value)[2:].zfill(width))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):  # discard initial keystream
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def next_bit(self) -> int:
        """Shrinking generator: a keystream bit gates whether the next is used."""
        while True:
            gate = self._next_raw()
            out = self._next_raw()
            if gate == 1:
                return out

    def random_bits(self, num_bits: int) -> int:
        v = 0
        for _ in range(num_bits):
            v = (v << 1) | self.next_bit()
        return v

    def random_field_element(self, n_bits: int, modulus: int) -> int:
        while True:
            v = self.random_bits(n_bits)
            if v < modulus:
                return v


def generate_poseidon_params(
    t: int = 2,
    r_f: int = 8,
    r_p: int = 56,
    n: int = 254,
    modulus: int = FR_MOD,
) -> tuple[list[list[int]], list[list[int]], list[list[int]]]:
    """Round constants and Cauchy MDS from one continuous Grain stream.

    Round constants use rejection sampling (resample while >= p); the MDS
    samples 2t elements from the *same continuing* stream reduced mod p
    (no rejection), requires them pairwise distinct and all x_i + y_j != 0,
    then sets M[i][j] = (x_i + y_j)^-1.

    Returns (round_constants[(R_F+R_P)][t], mds[t][t], mds_inv[t][t]).
    """
    g = GrainLFSR(field=1, sbox=0, n=n, t=t, r_f=r_f, r_p=r_p)
    flat = [g.random_field_element(n, modulus) for _ in range((r_f + r_p) * t)]
    rc = [flat[i * t : (i + 1) * t] for i in range(r_f + r_p)]

    while True:
        rand_list = [g.random_bits(n) % modulus for _ in range(2 * t)]
        if len(set(rand_list)) != len(rand_list):
            continue
        xs, ys = rand_list[:t], rand_list[t:]
        if any((x + y) % modulus == 0 for x in xs for y in ys):
            continue
        mds = [[pow(x + y, -1, modulus) for y in ys] for x in xs]
        break

    # Matrix inverse of the 2x2 (general t via Gauss-Jordan not needed here).
    if t == 2:
        a, b = mds[0]
        c, d = mds[1]
        det_inv = pow((a * d - b * c) % modulus, -1, modulus)
        mds_inv = [
            [d * det_inv % modulus, (-b) * det_inv % modulus],
            [(-c) * det_inv % modulus, a * det_inv % modulus],
        ]
    else:
        mds_inv = _matrix_inverse(mds, modulus)
    return rc, mds, mds_inv


def _matrix_inverse(m: list[list[int]], p: int) -> list[list[int]]:
    t = len(m)
    aug = [[m[i][j] % p for j in range(t)] + [int(i == j) for j in range(t)] for i in range(t)]
    for col in range(t):
        piv = next(r for r in range(col, t) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [v * inv % p for v in aug[col]]
        for r in range(t):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(v - f * w) % p for v, w in zip(aug[r], aug[col])]
    return [row[t:] for row in aug]
