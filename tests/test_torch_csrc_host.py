"""The CUDA kernels' per-thread code, compiled for the host with g++.

``csrc/bn254.cuh`` and the per-thread functions of ``csrc/poseidon.cu``,
``csrc/msm_scan.cu`` and ``csrc/poseidon_mxu.cu`` also compile as plain C++
(``BN_HD``); the ``__global__`` launchers do not. A small harness runs the
sponges, the bare permutation and the lane scan exactly as one CUDA thread
would (K4's matrix product done by a plain loop in place of the tensor
cores) and the results are held to the plain torch versions. Exact. The launches themselves are checked on
the card (``chip_smoke.py``, ``-m cuda`` tests)."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon as PS
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "circuits_halo2_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include "poseidon.cu"
#include "msm_scan.cu"
#include "poseidon_mxu.cu"

template <class T> static std::vector<T> take(size_t n) {
    std::vector<T> v(n);
    if (fread(v.data(), sizeof(T), n, stdin) != n) exit(2);
    return v;
}

int main(int argc, char** argv) {
    std::string mode = argv[1];
    int L = atoi(argv[2]);
    long n = atol(argv[3]);
    if (mode == "sponge" || mode == "permute" || mode == "mxu_sponge") {
        static uint32_t rc[64][2][8], mds[2][2][8];
        static uint8_t w[32 * 64];
        if (mode == "mxu_sponge") memcpy(w, take<uint8_t>(sizeof w).data(), sizeof w);
        auto r = take<uint32_t>(64 * 2 * 8), m = take<uint32_t>(32), cap = take<uint32_t>(8);
        memcpy(rc, r.data(), sizeof rc);
        memcpy(mds, m.data(), sizeof mds);
        auto in = take<uint32_t>((size_t)L * 8 * n);
        std::vector<uint32_t> out(8 * n);
        const mxu::HostReducer red{w};
        for (long i = 0; i < n; ++i) {
            uint32_t d[8];
            if (mode == "sponge") {
                pos_sponge(in.data(), L, n, i, cap.data(), d, rc, mds);
            } else if (mode == "mxu_sponge") {
                mxu::sponge(red, in.data(), L, n, i, true, cap.data(), d, rc, mds);
            } else {  // permute: L = 2 words, s0 then s1
                uint32_t s1[8];
                for (int k = 0; k < 8; ++k) {
                    d[k] = in[k * n + i];
                    s1[k] = in[(8 + k) * n + i];
                }
                pos_permute(d, s1, rc, mds);
            }
            for (int k = 0; k < 8; ++k) out[k * n + i] = d[k];
        }
        fwrite(out.data(), 4, out.size(), stdout);
    } else {
        auto seg = take<int32_t>((size_t)L * n), val = take<int32_t>((size_t)L * n);
        auto xs = take<uint32_t>((size_t)L * 8 * n), ys = take<uint32_t>((size_t)L * 8 * n);
        std::vector<uint32_t> o((size_t)3 * L * 8 * n);
        uint32_t *ox = o.data(), *oy = ox + L * 8 * n, *oz = oy + L * 8 * n;
        for (long l = 0; l < n; ++l)
            scan_lane(seg.data(), val.data(), xs.data(), ys.data(), ox, oy, oz, L, n, l);
        fwrite(o.data(), 4, o.size(), stdout);
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(["g++", "-O2", "-std=c++17", "-w", "-I", str(CSRC), "-x", "c++",
                    str(d / "harness.cpp"), "-o", str(exe)], check=True, timeout=300)
    return exe


def _run(exe, mode, L, n, payload: bytes) -> np.ndarray:
    out = subprocess.run([str(exe), mode, str(L), str(n)], input=payload,
                         capture_output=True, check=True, timeout=300).stdout
    return np.frombuffer(out, dtype=np.int32).copy()


def _words(values) -> np.ndarray:
    return FT.limbs_to_words(torch.as_tensor(FT.ints_to_limbs(values)), 0).numpy()


@pytest.mark.parametrize("length", [2, 3, 4])
def test_sponge_thread_code_matches_plain(harness, length):
    rng = np.random.default_rng(length)
    n = 40
    cols = [[int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
            for _ in range(length)]
    for c in cols:
        c[0], c[1] = 0, F.FR_MOD - 1
    inp = torch.stack([torch.as_tensor(FT.to_mont_limbs(c)) for c in cols])
    rc = _words([PK._mont(c) for row in PS.ROUND_CONSTANTS for c in row]).T
    mds = _words([PK._mont(c) for row in PS.MDS for c in row]).T
    cap = _words([PK._mont(PK.capacity(length))]).reshape(8)
    payload = (np.ascontiguousarray(rc).tobytes() + np.ascontiguousarray(mds).tobytes()
               + cap.tobytes() + FT.limbs_to_words(inp, 1).numpy().tobytes())
    got = FT.words_to_limbs(torch.as_tensor(_run(harness, "sponge", length, n, payload)
                                            .reshape(8, n)), 0)
    assert torch.equal(got, PK.hash_batch_ref(inp))


def test_permute_thread_code_matches_plain(harness):
    rng = np.random.default_rng(5)
    n = 24
    s0, s1 = ([int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
              for _ in range(2))
    s0[0], s1[1] = 0, F.FR_MOD - 1
    a, b = (torch.as_tensor(FT.to_mont_limbs(v)) for v in (s0, s1))
    rc = _words([PK._mont(c) for row in PS.ROUND_CONSTANTS for c in row]).T
    mds = _words([PK._mont(c) for row in PS.MDS for c in row]).T
    payload = (np.ascontiguousarray(rc).tobytes() + np.ascontiguousarray(mds).tobytes()
               + np.zeros(8, np.int32).tobytes()
               + FT.limbs_to_words(torch.stack([a, b]), 1).numpy().tobytes())
    got = FT.words_to_limbs(torch.as_tensor(_run(harness, "permute", 2, n, payload)
                                            .reshape(8, n)), 0)
    assert torch.equal(got, PK.permute_ref(a, b)[0])


@pytest.mark.parametrize("length", [2, 3])
def test_mxu_sponge_thread_code_matches_plain(harness, length):
    """K4's per-thread sponge, inputs 0, p - 1 and 2^256 - 1 (a raw value
    above p in every limb) included."""
    rng = np.random.default_rng(20 + length)
    n = 6
    cols = [[int.from_bytes(rng.bytes(32), "little") for _ in range(n)] for _ in range(length)]
    for c in cols:
        c[0], c[1], c[2] = 0, F.FR_MOD - 1, (1 << 256) - 1
    inp = torch.stack([torch.as_tensor(FT.ints_to_limbs(c)) for c in cols])
    rc = PM._words([c for row in PS.ROUND_CONSTANTS for c in row])
    mds = PM._words([c for row in PS.MDS for c in row])
    cap = PM._words([PK.capacity(length)])
    payload = (PM.reduce_weights().tobytes() + rc.tobytes() + mds.tobytes() + cap.tobytes()
               + FT.limbs_to_words(inp, 1).numpy().tobytes())
    got = FT.words_to_limbs(torch.as_tensor(_run(harness, "mxu_sponge", length, n, payload)
                                            .reshape(8, n)), 0)
    assert torch.equal(got, PM.hash_batch_mxu_ref(inp))


def test_scan_thread_code_matches_plain(harness):
    rng = np.random.default_rng(3)
    n, B, W = 128, 2, 2
    base = native.g1_fixed_base_muls(C.G1_GEN, [int(v) + 1 for v in rng.integers(1, 10**9, 6)])
    pts = [base[i] for i in rng.integers(0, 6, n)]
    pts[10] = C.g1_neg(pts[9])
    xs = torch.as_tensor(FT.to_mont_limbs([p[0] for p in pts], FT.FQ))
    ys = torch.as_tensor(FT.to_mont_limbs([p[1] for p in pts], FT.FQ))
    valid = torch.ones(n, dtype=torch.bool)
    valid[[5, 70]] = False
    digits = torch.as_tensor(np.sort(rng.integers(0, 3, (B, W, n)), axis=-1))
    px, py = xs[:, None, None, :].expand(16, B, W, n), ys[:, None, None, :].expand(16, B, W, n)
    pv = valid.expand(B, W, n)
    L = TM._seg_chunk_len(n)
    lanes = B * W * n // L
    payload = b"".join(a.numpy().tobytes() for a in (
        digits.reshape(lanes, L).t().to(torch.int32).contiguous(),
        pv.reshape(lanes, L).t().to(torch.int32).contiguous(),
        MK._to_kernel(px, lanes, L), MK._to_kernel(py, lanes, L)))
    out = _run(harness, "scan", L, lanes, payload).reshape(3, L, 8, lanes)
    want = MK.segmented_scan_ref(px, py, pv, digits, L)
    for k in range(3):
        assert torch.equal(MK._from_kernel(torch.as_tensor(out[k]), px.shape), want[k])
