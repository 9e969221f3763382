"""The verifying key, worked out again from the configuration alone.

The permutation assembly is a frozen copy of the port's
(``circuits_halo2_tpu_torch/models/keygen.py``, halo2's cycle splicing).
The commitments are not computed by an MSM over an SRS file: the benchmark's
SRS is the unsafe deterministic setup (``utils/srs.ParamsKZG.setup``), whose
secret s is sha256(seed || k) mod r, so the commitment of the column with
evaluations f_i is [sum_i f_i L_i(s)] G1, one scalar product in Fr and one
point multiplication. That also gives each VK commitment's discrete log,
which the verifier (``verifier.py``) folds into the generator's scalar.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from . import curve as C
from . import field as F
from .circuit import compile_circuit
from .cs import Column, ConstraintSystem

P = F.FR_MOD
SRS_SEED = b"circuits-halo2-tpu-test-srs"
# generator of the order-(p-1)/2^28 subgroup, halo2curves bn256 Fr
DELTA = pow(F.FR_GENERATOR, 1 << F.FR_TWO_ADICITY, F.FR_MOD)


def srs_secret(k: int) -> int:
    """The toxic waste of ``ParamsKZG.setup(k)`` with the default seed."""
    return int.from_bytes(hashlib.sha256(SRS_SEED + k.to_bytes(4, "little")).digest(),
                          "little") % P


def omega_for_k(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (halo2 domain omega)."""
    return pow(F.FR_ROOT_OF_UNITY, 1 << (F.FR_TWO_ADICITY - k), P)


def lagrange_at(s: int, k: int) -> list[int]:
    """L_i(s) = w^i (s^n - 1) / (n (s - w^i)) for i < 2^k."""
    n = 1 << k
    omega = omega_for_k(k)
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * omega % P
    scale = (pow(s, n, P) - 1) * pow(n, -1, P) % P
    invs = F.batch_inv([(s - w) % P for w in pows])
    return [scale * w % P * d % P for w, d in zip(pows, invs)]


class PermutationAssembly:
    """halo2 permutation keygen Assembly: identity mapping spliced by copies."""

    def __init__(self, columns: list[Column], n: int):
        self.columns = columns
        self.col_index = {c: i for i, c in enumerate(columns)}
        self.n = n
        self.mapping = [[(i, j) for j in range(n)] for i in range(len(columns))]
        self.aux = [[(i, j) for j in range(n)] for i in range(len(columns))]
        self.sizes = [[1] * n for _ in range(len(columns))]

    def copy(self, left: tuple[Column, int], right: tuple[Column, int]):
        lc = self.col_index[left[0]]
        rc = self.col_index[right[0]]
        lr, rr = left[1], right[1]
        left_cycle = self.aux[lc][lr]
        right_cycle = self.aux[rc][rr]
        if left_cycle == right_cycle:
            return
        if self.sizes[left_cycle[0]][left_cycle[1]] < self.sizes[right_cycle[0]][right_cycle[1]]:
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle[0]][left_cycle[1]] += self.sizes[right_cycle[0]][right_cycle[1]]
        i = right_cycle
        while True:
            self.aux[i[0]][i[1]] = left_cycle
            i = self.mapping[i[0]][i[1]]
            if i == right_cycle:
                break
        self.mapping[lc][lr], self.mapping[rc][rr] = self.mapping[rc][rr], self.mapping[lc][lr]

    def sigmas(self, omega: int) -> list[list[int]]:
        """Sigma polynomial values: delta^col' · omega^row' per mapped cell."""
        n = self.n
        omega_pows = [1] * n
        for j in range(1, n):
            omega_pows[j] = omega_pows[j - 1] * omega % P
        deltas = [1]
        for _ in range(len(self.columns) - 1):
            deltas.append(deltas[-1] * DELTA % P)
        return [[deltas[ci] * omega_pows[rj] % P for ci, rj in self.mapping[i]]
                for i in range(len(self.columns))]


@dataclass
class VerifyingKey:
    """What ``pinning.render_pinned`` and ``verifier.verify`` read, and the
    discrete log of every commitment."""

    k: int
    cs: ConstraintSystem
    omega: int
    fixed_dlogs: list[int]
    permutation_dlogs: list[int]
    fixed_commitments: list = field(default_factory=list)
    permutation_commitments: list = field(default_factory=list)
    transcript_repr: int = 0


def commitment_dlog(values: list[int], lagrange: list[int]) -> int:
    return sum(v * l for v, l in zip(values, lagrange) if v) % P


def verifying_key(levels: int, n_currencies: int, n_bytes: int, k: int) -> VerifyingKey:
    """The VK of the MstInclusion circuit of this shape at 2^k rows on the
    unsafe setup of 2^k points."""
    from .pinning import transcript_repr

    _, cs, _, asn = compile_circuit(levels, n_currencies, n_bytes, k)
    n = 1 << k
    omega = omega_for_k(k)
    assembly = PermutationAssembly(cs.permutation_columns, n)
    for left, right in asn.copies:
        assembly.copy(left, right)
    lagrange = lagrange_at(srs_secret(k), k)
    fixed = [commitment_dlog(col, lagrange) for col in asn.fixed]
    perm = [commitment_dlog(col, lagrange) for col in assembly.sigmas(omega)]
    vk = VerifyingKey(k, cs, omega, fixed, perm)
    vk.fixed_commitments = [C.g1_mul(C.G1_GEN, d) for d in fixed]
    vk.permutation_commitments = [C.g1_mul(C.G1_GEN, d) for d in perm]
    vk.transcript_repr = transcript_repr(vk)
    return vk
