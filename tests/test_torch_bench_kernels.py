"""The port's bench entry points at the MSM, NTT and headline stages,
against the JAX package's root ``bench_suite.py`` and ``bench.py`` on the
CPU at tiny sizes (MSM and NTT at 2^8, the headline at 16 lanes x 4
iterations): the same metric names, units and fields at the same
parameters, the headline's data and host chain equal to the JAX bench's,
and every gate holding. The JAX stage functions are called directly, never
a JAX ``main()``; the JAX ``bench.py`` has only its ``main()``, so its line
is read from the source."""

import ast
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_suite as jax_bench_suite
from circuits_halo2_tpu.ops import field as JF
from circuits_halo2_tpu.ops import poseidon as JP
from circuits_halo2_tpu.ops import poseidon_fast as PF
from circuits_halo2_tpu_torch import bench as BH
from circuits_halo2_tpu_torch import bench_suite as BS
from circuits_halo2_tpu_torch.ops import field_torch as FT
from test_torch_bench import check_line, parse_lines

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
KERNEL_LOG2, MSM_BATCH, NTT_ITERS = 8, 4, 8
HEADLINE_BATCH, HEADLINE_ITERS = 16, 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX MSM and NTT stages' JSON lines at 2^8."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_bench_suite.bench_msm(KERNEL_LOG2)
        jax_bench_suite.bench_ntt(KERNEL_LOG2)
    return parse_lines(buf.getvalue())


@pytest.fixture(scope="module")
def port_run():
    """The port's MSM, NTT and headline stages at the same sizes, one warm
    repeat each (each gate is checked before its line is emitted)."""
    bench = BS.Bench(CPU, 1)
    BS.bench_msm(bench, KERNEL_LOG2, MSM_BATCH)
    BS.bench_ntt(bench, KERNEL_LOG2, NTT_ITERS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BH, "HOST_N", 1000)
        BH.bench_headline(bench, HEADLINE_BATCH, HEADLINE_ITERS)
    return {line["metric"]: line for line in bench.lines}


def _jax_headline_line() -> dict:
    """The keys and constant values of the dict the JAX ``bench.py`` prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return {k.value: (v.value if isinstance(v, ast.Constant) else None)
                    for k, v in zip(node.keys, node.values)}
    raise AssertionError("no metric dict in bench.py")


@pytest.mark.parametrize("metric", [f"msm_pippenger_2^{KERNEL_LOG2}x{MSM_BATCH}",
                                    f"ntt_2^{KERNEL_LOG2}"])
def test_kernel_lines_match_jax(metric, jax_run, port_run):
    check_line(port_run[metric], jax_run[metric])


def test_headline_line_matches_jax(port_run):
    want = _jax_headline_line()
    got = port_run[want["metric"]]
    assert want["metric"] == "poseidon_bn254_hashes_per_sec"
    assert got["unit"] == want["unit"] == "hashes/s"
    # the tunnel probe is not carried
    assert set(want) - {"probe_s"} <= set(got), set(want) - set(got)
    assert (got["batch"], got["iters"]) == (HEADLINE_BATCH, HEADLINE_ITERS)
    assert got["value"] == pytest.approx(HEADLINE_BATCH * HEADLINE_ITERS / got["median_s"])
    assert got["baseline_host_hps"] > 0 and got["baseline_host_threads"] >= 1
    assert got["device"] == "cpu" and got["events_s"] is None


def test_headline_data_and_chain_equal_jax():
    """The port's lanes are the JAX bench's field elements, and the JAX host
    sponge's chain of lane 0 is the port's gate value."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 1 << 14, size=(BH.LENGTH, PF.NLIMBS, HEADLINE_BATCH), dtype=np.uint32)
    arr[:, PF.LOW:, :] = 0
    want = [[v * PF.R15_INV % JF.FR_MOD for v in PF.limbs15_to_ints(arr[i])]
            for i in range(BH.LENGTH)]
    got = BH.seeded_inputs(HEADLINE_BATCH)
    assert got == want
    h = JP.hash_n([row[0] for row in want])
    for _ in range(HEADLINE_ITERS - 1):
        h = JP.hash_n([h] * BH.LENGTH)
    assert BH.host_chain([row[0] for row in got], HEADLINE_ITERS) == h


def test_headline_chain_equals_host_chain_per_lane():
    """One step of the plain chain equals the host sponge in every lane."""
    inputs = BH.seeded_inputs(2)
    x = torch.as_tensor(FT.to_mont_limbs([v for row in inputs for v in row])
                        .reshape(FT.NLIMBS, BH.LENGTH, 2).transpose(1, 0, 2).copy())
    final = BH.chain(x, 1)
    for lane in range(2):
        assert FT.from_mont_ints(final[0][:, lane:lane + 1])[0] == BH.host_chain(
            [row[lane] for row in inputs], 1)
