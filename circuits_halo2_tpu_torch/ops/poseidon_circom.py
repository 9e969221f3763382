"""Circomlib-compatible Poseidon over BN254 Fr.

The reference's Nova IVC side-module hashes with circom's Poseidon
(`poseidon-rs`, used by `zk_prover/examples/nova_incremental_verifier.rs:262`
and `zk_prover/src/circom/merkle_sum_tree.circom` via circomlib), which is a
*different* instantiation from the halo2 one (`ops/poseidon.py`): width
t = n_inputs + 1 with the capacity element first, per-t partial round counts,
and its own Grain-derived constants. The reference repo itself notes the two
are incompatible (`nova_incremental_verifier.rs:239` comment).

Constants are re-derived from the standard Grain LFSR procedure
(`ops/grain.py`) with the circomlib parameterization — verified against the
canonical circomlib test vector H(1,2) in tests — so nothing is transcribed
from circomlib's generated tables.
"""

from __future__ import annotations

import functools

from .field import FR_MOD
from .grain import generate_poseidon_params

# circomlib partial-round counts, indexed by t = n_inputs + 1
# (circomlib poseidon.circom N_ROUNDS_P table for t = 2..17)
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
R_F = 8


@functools.lru_cache(maxsize=None)
def params(t: int) -> tuple[tuple, tuple]:
    """(round_constants[(R_F+R_P)][t], mds[t][t]) for a given width."""
    r_p = N_ROUNDS_P[t - 2]
    rc, mds, _ = generate_poseidon_params(t=t, r_f=R_F, r_p=r_p)
    return tuple(tuple(r) for r in rc), tuple(tuple(r) for r in mds)


def permute(state: list[int], t: int) -> list[int]:
    """Full circomlib Poseidon permutation on a width-t state."""
    rc, mds, = params(t)
    r_p = N_ROUNDS_P[t - 2]
    p = FR_MOD
    ri = 0

    def ark(s, r):
        return [(v + rc[r][i]) % p for i, v in enumerate(s)]

    def mix(s):
        return [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]

    for _ in range(R_F // 2):
        state = mix([pow(v, 5, p) for v in ark(state, ri)])
        ri += 1
    for _ in range(r_p):
        s = ark(state, ri)
        state = mix([pow(s[0], 5, p)] + s[1:])
        ri += 1
    for _ in range(R_F // 2):
        state = mix([pow(v, 5, p) for v in ark(state, ri)])
        ri += 1
    return state


def hash_n(inputs: list[int]) -> int:
    """circomlib Poseidon(nInputs): state = [0, inputs...], output state[0]."""
    assert 1 <= len(inputs) <= len(N_ROUNDS_P) + 1
    t = len(inputs) + 1
    state = [0] + [v % FR_MOD for v in inputs]
    return permute(state, t)[0]
