"""Poseidon over BN254 Fr (t=2, rate 1, 8 full / 56 partial rounds, x^5):
the host half of ``circuits_halo2_tpu/ops/poseidon.py``.

Constants are read from ``poseidon_constants.json`` beside this module (a
copy of the reference's, held equal to it by the tests). ``hash_n`` runs the
native C++ sponge; ``permute`` / ``hash_n_py`` are the plain-int reference.
The batched device sponge is ``ops/poseidon_kernel.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

from . import field as F

T = 2
RATE = 1
R_FULL = 8
R_PARTIAL = 56
N_ROUNDS = R_FULL + R_PARTIAL

CONSTANTS_PATH = Path(__file__).resolve().parent / "poseidon_constants.json"
_data = json.loads(CONSTANTS_PATH.read_text())
ROUND_CONSTANTS: list[list[int]] = [[int(a, 16), int(b, 16)] for a, b in _data["round_constants"]]
MDS: list[list[int]] = [[int(x, 16) for x in row] for row in _data["mds"]]
MDS_INV: list[list[int]] = [[int(x, 16) for x in row] for row in _data["mds_inv"]]


def permute(state: list[int]) -> list[int]:
    """One Poseidon permutation on a 2-word state of Fr ints."""
    p = F.FR_MOD
    s0, s1 = state
    for r, rc in enumerate(ROUND_CONSTANTS):
        full = r < R_FULL // 2 or r >= R_FULL // 2 + R_PARTIAL
        s0 = pow((s0 + rc[0]) % p, 5, p)
        s1 = (s1 + rc[1]) % p
        if full:
            s1 = pow(s1, 5, p)
        s0, s1 = (MDS[0][0] * s0 + MDS[0][1] * s1) % p, (MDS[1][0] * s0 + MDS[1][1] * s1) % p
    return [s0, s1]


def hash_n_py(inputs: list[int]) -> int:
    """ConstantLength<L> sponge on Python ints (reference path)."""
    state = [0, (len(inputs) << 64) % F.FR_MOD]
    for m in inputs:
        state[0] = (state[0] + m) % F.FR_MOD
        state = permute(state)
    return state[0]


def hash_n(inputs: list[int]) -> int:
    """ConstantLength<L> Poseidon hash of L field elements (native C++)."""
    from .. import native

    return native.poseidon_hash_batch([[x % F.FR_MOD for x in inputs]], len(inputs))[0]
