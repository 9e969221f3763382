"""The port's copies of the circom sources and of the Poseidon round-number
calculator: ``tests/test_circom_source.py`` and ``tests/test_round_numbers.py``
on the port's files (``circuits_halo2_tpu_torch/circom``), each result
also equal to the JAX package's on the same input. Exact."""

import re
from pathlib import Path

import pytest

from circuits_halo2_tpu.merkle import circom_mst as JCM
from circuits_halo2_tpu.merkle import circom_r1cs as JCR
from circuits_halo2_tpu.ops.poseidon_round_numbers import find_round_numbers as jax_rounds
from circuits_halo2_tpu_torch.merkle import circom_mst as CM
from circuits_halo2_tpu_torch.merkle import circom_r1cs as CR
from circuits_halo2_tpu_torch.ops import poseidon_circom as PC
from circuits_halo2_tpu_torch.ops.poseidon_round_numbers import find_round_numbers

HERE = Path(__file__).parent
CIRCOM_DIR = HERE.parent / "circuits_halo2_tpu_torch" / "circom"
STATE_1 = str(HERE / "fixtures_csv" / "states" / "entry_16_1.csv")


def _read(name):
    return (CIRCOM_DIR / name).read_text()


def test_main_instantiation_matches_builder_default():
    m = re.search(
        r"component\s+main\s*\{\s*public\s*\[step_in\]\s*\}\s*=\s*"
        r"IncrementalMstInclusion\((\d+),\s*(\d+),\s*(\d+)\)",
        _read("incremental_mst_inclusion.circom"),
    )
    assert m, "main instantiation missing"
    assert tuple(int(g) for g in m.groups()) == (4, 2, 14)


def test_templates_and_widths():
    mst = _read("merkle_sum_tree.circom")
    inc = _read("incremental_mst_inclusion.circom")
    for tpl in ("Summer", "Swapper", "Hasher", "MerkleSumTreeInclusion"):
        assert re.search(rf"template\s+{tpl}\(", mst), tpl
    assert re.search(r"template\s+IncrementalMstInclusion\(", inc)
    assert mst.count("Num2Bits(8 * N_BYTES)") >= 2
    assert "Poseidon(1 + N_CURRENCIES)" in inc
    assert inc.count("Poseidon(2)") == 2
    assert "Poseidon(2 * (N_CURRENCIES + 1))" in mst


def test_constraint_accounting_matches_synthesizer():
    """The circomlib cost model of the circom text predicts the port's
    synthesized constraint count, which equals the JAX package's."""
    levels, ncur, nbytes = 4, 2, 14
    r1cs, wit = CR.build_incremental_mst_inclusion(CM.build_merkle_proof(STATE_1, 0), (0, 0),
                                                   nbytes)
    assert r1cs.check(wit)

    def poseidon_cost(n_inputs):
        t = n_inputs + 1
        return 3 * (8 * t + PC.N_ROUNDS_P[t - 2])

    cost = poseidon_cost(1 + ncur) + 2 * poseidon_cost(2) + levels * poseidon_cost(2 * (ncur + 1))
    cost += (levels * 2 * ncur + ncur) * (8 * nbytes + 1)
    cost += levels * (1 + 2 * (1 + ncur))
    cost += 2
    assert len(r1cs.constraints) == cost
    jr1cs, jwit = JCR.build_incremental_mst_inclusion(JCM.build_merkle_proof(STATE_1, 0),
                                                      (0, 0), nbytes)
    assert r1cs.constraints == jr1cs.constraints and wit == jwit


def test_canonical_round_numbers():
    assert find_round_numbers(254, 2, 128) == jax_rounds(254, 2, 128) == (8, 56)


@pytest.mark.parametrize("t", [3, 5])
def test_other_widths_sane(t):
    r_f, r_p = find_round_numbers(254, t, 128)
    assert (r_f, r_p) == jax_rounds(254, t, 128)
    assert r_f >= 8 and r_p >= 30 and r_p % 2 == 0
