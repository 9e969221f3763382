"""The CUDA kernels' per-thread code, compiled for the host with g++.

``csrc/bn254.cuh``, ``csrc/bn254_fast.cuh`` and the per-thread functions of
``csrc/poseidon.cu``, ``csrc/msm_scan.cu`` and ``csrc/poseidon_mxu.cu`` also
compile as plain C++ (``BN_HD``; the carry-chain primitives of
``bn254_fast.cuh`` as C++ twins with an explicit carry flag); the
``__global__`` launchers do not. A small harness runs the lazy field
operations, the sponges, the bare permutation and the lane scan exactly
as one CUDA thread would (K4's matrix product done by a plain loop in place
of the tensor cores) and the results are held to Python ints and to the
plain torch versions. Exact. The launches themselves are checked on the card
(``chip_smoke.py``, ``-m cuda`` tests)."""

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
                pos_permute_canonical(d, s1, rc, mds);
            }
            for (int k = 0; k < 8; ++k) out[k * n + i] = d[k];
        }
        fwrite(out.data(), 4, out.size(), stdout);
    } else if (mode == "field") {  // L = 0: Fr, 1: Fq; n value sets a, b, c0, c1
        auto in = take<uint32_t>((size_t)32 * n);
        std::vector<uint32_t> out((size_t)48 * n);
        for (long i = 0; i < n; ++i) {
            const uint32_t *a = &in[32 * i], *b = a + 8, *c0 = a + 16, *c1 = a + 24;
            uint32_t* o = &out[48 * i];
            if (L == 0) {
                bnf::mul<bn254::Fr>(o, a, b);
                bnf::sqr<bn254::Fr>(o + 8, a);
                bnf::add<bn254::Fr>(o + 16, a, b);
                bnf::sub<bn254::Fr>(o + 24, a, b);
                bnf::canon<bn254::Fr>(o + 32, a);
                bnf::mul2<bn254::Fr>(o + 40, a, c0, b, c1);
            } else {
                bnf::mul<bn254::Fq>(o, a, b);
                bnf::sqr<bn254::Fq>(o + 8, a);
                bnf::add<bn254::Fq>(o + 16, a, b);
                bnf::sub<bn254::Fq>(o + 24, a, b);
                bnf::canon<bn254::Fq>(o + 32, a);
                bnf::mul2<bn254::Fq>(o + 40, a, c0, b, c1);
            }
        }
        fwrite(out.data(), 4, out.size(), stdout);
    } else {  // scan: n points, L steps per lane
        auto seg = take<int64_t>(n);
        auto val = take<uint8_t>(n);
        auto xs = take<int64_t>((size_t)16 * n), ys = take<int64_t>((size_t)16 * n);
        std::vector<int64_t> o((size_t)48 * n);
        int64_t *ox = o.data(), *oy = ox + 16 * n, *oz = oy + 16 * n;
        for (long g = 0; g < n / L; ++g)
            scan_lane(seg.data(), val.data(), xs.data(), ys.data(), ox, oy, oz, n, L, g);
        fwrite(o.data(), 8, o.size(), stdout);
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


def _run(exe, mode, L, n, payload: bytes, dtype=np.int32) -> np.ndarray:
    out = subprocess.run([str(exe), mode, str(L), str(n)], input=payload,
                         capture_output=True, check=True, timeout=300).stdout
    return np.frombuffer(out, dtype=dtype).copy()


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


FIELDS = {"fr": (0, F.FR_MOD), "fq": (1, F.FQ_MOD)}
FIELD_OPS = ["mul", "sqr", "add", "sub", "canon", "mul2"]


def _field_cases(p, rng):
    """(a, b, c0, c1): a, b < 2p at the edges and random; c0, c1 < p."""
    edges = [0, 1, p - 1, p, 2 * p - 1]
    rand = [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(40)]
    # words of all ones or zeros: the longest carry chains
    heavy = [sum(int(w) << (32 * i) for i, w in enumerate(rng.choice([0, 0xFFFFFFFF], 8)))
             % (2 * p) for _ in range(40)]
    pairs = [(a, b) for a in edges for b in edges] + list(zip(rand[:20], rand[20:]))
    pairs += list(zip(heavy[:20], heavy[20:])) + list(zip(heavy[::2], rand[::2]))
    pairs += [(e, r) for e, r in zip(edges, rand)] + [(r, e) for e, r in zip(edges, rand[5:])]
    canon = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(len(pairs))]
    return [(a, b, canon[i % len(canon)], canon[(i * 7 + 1) % len(canon)])
            for i, (a, b) in enumerate(pairs)]


@pytest.mark.parametrize("op", FIELD_OPS)
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_lazy_field_ops_match_python_ints(harness, field, op):
    """bn254_fast.cuh on inputs below 2p (0, 1, p - 1, p, 2p - 1 and random):
    every output below 2p and equal mod p to the Montgomery result; canon
    exact."""
    code, p = FIELDS[field]
    cases = _field_cases(p, np.random.default_rng(code))
    words = np.stack([_words(list(col)) for col in zip(*cases)])  # (4, 8, n)
    out = _run(harness, "field", code, len(cases),
               np.ascontiguousarray(words.transpose(2, 0, 1)).astype(np.int32).tobytes())
    out = out.view(np.uint32).reshape(len(cases), 6, 8)
    k = FIELD_OPS.index(op)
    r_inv = pow(1 << 256, -1, p)
    for (a, b, c0, c1), row in zip(cases, out):
        got = sum(int(w) << (32 * i) for i, w in enumerate(row[k]))
        want = {"mul": a * b * r_inv, "sqr": a * a * r_inv, "add": a + b, "sub": a - b,
                "canon": a, "mul2": (a * c0 + b * c1) * r_inv}[op] % p
        assert got < (p if op == "canon" else 2 * p), (op, a, b)
        assert got % p == want, (op, a, b)


def _scan(exe, px, py, pv, digits, L):
    """The lane scan of csrc/msm_scan.cu run by the harness on the same
    (16, *batch, n) limbs the wrapper hands the kernel."""
    P = pv.numel()
    payload = b"".join(np.ascontiguousarray(a).tobytes() for a in (
        digits.reshape(P).to(torch.int64).numpy(), pv.reshape(P).to(torch.uint8).numpy(),
        px.reshape(16, P).numpy(), py.reshape(16, P).numpy()))
    out = _run(exe, "scan", L, P, payload, dtype=np.int64).reshape(3, 16, P)
    return [torch.as_tensor(o).reshape(px.shape) for o in out]


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
    px = xs[:, None, None, :].expand(16, B, W, n).contiguous()
    py = ys[:, None, None, :].expand(16, B, W, n).contiguous()
    pv = valid.expand(B, W, n).contiguous()
    L = TM._seg_chunk_len(n)
    got = _scan(harness, px, py, pv, digits, L)
    want = MK.segmented_scan_ref(px, py, pv, digits, L)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


SCAN_N = 256  # one row: 16 lanes of 16 steps, 4 of 64 or one of 256


def _scan_pattern(name, rng):
    """(points, valid, digits) of one sorted row that stresses the lane scan."""
    base = native.g1_fixed_base_muls(C.G1_GEN, [int(v) for v in rng.integers(1, 10**9, 5)])
    base += [C.g1_neg(q) for q in base]
    pts = [base[i] for i in rng.integers(0, len(base), SCAN_N)]
    valid = rng.random(SCAN_N) > 0.1
    if name == "one_digit":  # one digit for the whole row: every lane one segment
        digits = np.full(SCAN_N, 7)
    elif name == "every_step":  # a digit change at every step
        digits = np.arange(SCAN_N)
    elif name == "skewed":  # 90 % zero scalars: bucket 0 spans lanes
        digits = np.sort(np.where(rng.random(SCAN_N) < 0.9, 0, rng.integers(1, 256, SCAN_N)))
    else:  # "crafted": invalid segment starts, P + (-P), P + P, boundary-crossing segments
        digits = np.sort(rng.integers(0, 12, SCAN_N))
        starts = np.flatnonzero(np.diff(digits)) + 1
        for s in starts[::2]:
            valid[s : s + 3] = False  # a segment that starts with invalid points
        digits[60:80] = digits[60]  # a segment across a 16- and 64-step lane boundary
        q, r = base[0], base[1]
        digits[100:110] = digits[99] + 1  # a segment that starts at 100
        pts[100:106] = [q, C.g1_neg(q), r, r, q, C.g1_add(C.g1_add(r, r), q)]
        valid[100:106] = True  # P + (-P), then P + P at Z = 1 and at Z != 1
        digits[16:20], valid[16:20] = digits[15], False  # invalid points opening a 16-step lane
        digits = np.maximum.accumulate(digits)
    return pts, valid, digits


@pytest.mark.parametrize("pattern", ["one_digit", "every_step", "crafted", "skewed"])
@pytest.mark.parametrize("L", [16, 64, 256])  # the shortest lane, k = 12's, a whole row
def test_scan_lanes_match_plain(harness, L, pattern):
    """Lanes of L steps on adversarial digits give the plain scan's outputs
    limb for limb."""
    pts, valid, digits = _scan_pattern(pattern, np.random.default_rng(L + 7))
    px = torch.as_tensor(FT.to_mont_limbs([p[0] for p in pts], FT.FQ)).reshape(16, 1, SCAN_N)
    py = torch.as_tensor(FT.to_mont_limbs([p[1] for p in pts], FT.FQ)).reshape(16, 1, SCAN_N)
    pv = torch.as_tensor(valid).reshape(1, SCAN_N)
    seg = torch.as_tensor(digits, dtype=torch.int64).reshape(1, SCAN_N)
    got = _scan(harness, px, py, pv, seg, L)
    want = MK.segmented_scan_ref(px, py, pv, seg, L)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
