"""PLONKish key generation (``circuits_halo2_tpu/models/keygen.py``):
permutation sigmas, fixed and sigma commitments, VK / PK.

The permutation Assembly reproduces halo2's cycle-splicing exactly, so the
sigma polynomials and the VK commitments match the reference keygen bit for
bit. Commitments go through the device Pippenger (``ops/msm``) and the
keygen polynomials through one batched iNTT, both on ``device``.
"""

from __future__ import annotations


from dataclasses import dataclass

from ..ops import field as F
from ..ops import msm as MSM
from ..ops import ntt as NTT
from ..utils.poly_device import intt_cols
from ..utils.srs import ParamsKZG
from .assignment import Assignment
from .cs import Column, ConstraintSystem

# DELTA: generator of the order-(p-1)/2^28 subgroup, halo2curves bn256 Fr.
# Cross-checked against the generated verifier's hard-coded delta
# (`contracts/src/InclusionVerifier.sol` quotient section).
DELTA = pow(F.FR_GENERATOR, 1 << F.FR_TWO_ADICITY, F.FR_MOD)


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
        if (
            self.sizes[left_cycle[0]][left_cycle[1]]
            < self.sizes[right_cycle[0]][right_cycle[1]]
        ):
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle[0]][left_cycle[1]] += self.sizes[right_cycle[0]][
            right_cycle[1]
        ]
        i = right_cycle
        while True:
            self.aux[i[0]][i[1]] = left_cycle
            i = self.mapping[i[0]][i[1]]
            if i == right_cycle:
                break
        self.mapping[lc][lr], self.mapping[rc][rr] = (
            self.mapping[rc][rr],
            self.mapping[lc][lr],
        )

    def sigmas(self, omega: int) -> list[list[int]]:
        """Sigma polynomial values: delta^col' · omega^row' per mapped cell."""
        n, p = self.n, F.FR_MOD
        omega_pows = [1] * n
        for j in range(1, n):
            omega_pows[j] = omega_pows[j - 1] * omega % p
        deltas = [1]
        for _ in range(len(self.columns) - 1):
            deltas.append(deltas[-1] * DELTA % p)
        out = []
        for i in range(len(self.columns)):
            col = [0] * n
            for j in range(n):
                ci, rj = self.mapping[i][j]
                col[j] = deltas[ci] * omega_pows[rj] % p
            out.append(col)
        return out


@dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list
    permutation_commitments: list
    fixed_values: list[list[int]]
    sigma_values: list[list[int]]
    omega: int
    transcript_repr: int = 0  # Blake2b pinned-VK digest (native path)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_polys: list[list[int]]   # coefficient form
    sigma_polys: list[list[int]]   # coefficient form
    l0: list[int]                  # Lagrange basis poly l_0 (coeff form)
    l_last: list[int]
    l_active_row: list[int]        # 1 - (l_last + l_blind), evaluations


def build_permutation(cs: ConstraintSystem, asn: Assignment) -> PermutationAssembly:
    assembly = PermutationAssembly(cs.permutation_columns, asn.n)
    for left, right in asn.copies:
        assembly.copy(left, right)
    return assembly


def keygen(params: ParamsKZG, cs: ConstraintSystem, asn: Assignment, device):
    """Produce (vk, pk) from a compiled circuit's keygen assignment."""
    n = asn.n
    k = params.k
    if n != params.n:
        raise ValueError("params domain must match circuit size")
    omega = NTT.omega_for_k(k)

    fixed_values = [list(col) for col in asn.fixed]
    sigma_values = build_permutation(cs, asn).sigmas(omega)
    fixed_commitments = MSM.msm_auto_batch(params.g_lagrange, fixed_values, device)
    permutation_commitments = MSM.msm_auto_batch(params.g_lagrange, sigma_values, device)

    vk = VerifyingKey(k, cs, fixed_commitments, permutation_commitments,
                      fixed_values, sigma_values, omega)
    from .pinning import transcript_repr

    vk.transcript_repr = transcript_repr(vk)

    blinders = cs.blinding_factors()
    usable = n - blinders - 1
    l0_evals = [0] * n
    l0_evals[0] = 1
    l_last_evals = [0] * n
    l_last_evals[usable] = 1
    l_active = [1] * usable + [0] * (n - usable)

    # one batched iNTT for every keygen polynomial (fixed + sigma + l0/l_last)
    all_polys = intt_cols(fixed_values + sigma_values + [l0_evals, l_last_evals], omega, device)
    nf = len(fixed_values)
    ns = len(sigma_values)
    pk = ProvingKey(vk, all_polys[:nf], all_polys[nf : nf + ns],
                    all_polys[nf + ns], all_polys[nf + ns + 1], l_active)
    return vk, pk
