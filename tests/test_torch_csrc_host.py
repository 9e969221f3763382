"""The CUDA kernels' per-thread code, compiled for the host with g++.

``csrc/bn254.cuh``, ``csrc/bn254_fast.cuh``, ``csrc/g1_jacobian.cuh`` and the
per-thread functions of ``csrc/poseidon.cu``, ``csrc/msm_scan.cu``,
``csrc/poseidon_mxu.cu`` and ``csrc/ec_fft.cu`` also compile as plain C++
(``BN_HD``; the carry-chain primitives of ``bn254_fast.cuh`` as C++ twins
with an explicit carry flag); the ``__global__`` launchers do not. A small
harness runs the lazy field operations, the sponges, the bare permutation,
the lane scan, X4's complete addition, double-and-add and butterflies
exactly as one CUDA thread would (K4's matrix product done by a plain loop
in place of the tensor cores), K4's warp reduction through the kernel's own
index functions for 32 lanes at once (a shuffle as an array read, ``mma`` by
the PTX fragment definition), and the results are held to Python ints and to
the plain torch versions; X4's butterflies, driven thread by thread, also
downsize the hermez-raw-11 ceremony file to the JAX package's bases. Exact. The launches themselves are checked on the card
(``chip_smoke.py``, ``-m cuda`` tests)."""

import hashlib
import json
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import curve as TC
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon as PS
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.utils import ec_fft as EC
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "circuits_halo2_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include "poseidon.cu"
#include "msm_scan.cu"
#include "poseidon_mxu.cu"
#include "ec_fft.cu"

template <class T> static std::vector<T> take(size_t n) {
    std::vector<T> v(n);
    if (fread(v.data(), sizeof(T), n, stdin) != n) exit(2);
    return v;
}

// K4's warp reduction for 32 lanes at once, through the kernel's own index
// functions: a shuffle is a read of the partner lane's array, and mma.sync
// m16n8k32 (u8 x u8 -> s32) is the PTX ISA's fragment definition
// (g = lane >> 2, t = lane & 3): A element (row, k) in register
// (row >= 8) + 2 (k >= 16) of lane (row % 8, (k % 16) / 4), byte k % 4;
// B element (k, n) in register (k >= 16) of lane (n, (k % 16) / 4), byte
// k % 4; C element (row, n) in register 2 (row >= 8) + n % 2 of lane
// (row % 8, n / 2).
template <int R, int B> static void model_round(uint32_t x[32][4][B]) {
    uint32_t v[32][2][B];
    for (int l = 0; l < 32; ++l) mxu::quad_send<R, B>(v[l], x[l], l);
    for (int l = 0; l < 32; ++l) mxu::quad_recv<R, B>(x[l], v[l ^ mxu::xor_mask<R>()], l);
}

static int byte_of(uint32_t w, int k) { return (w >> (8 * (k % 4))) & 0xff; }

static void model_mma(int32_t c[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
    for (int row = 0; row < 16; ++row)
        for (int n = 0; n < 8; ++n) {
            int32_t d = 0;
            for (int k = 0; k < 32; ++k)
                d += byte_of(a[(row % 8) * 4 + (k % 16) / 4][(row >= 8) + 2 * (k >= 16)], k)
                   * byte_of(b[n * 4 + (k % 16) / 4][k >= 16], k);
            c[(row % 8) * 4 + n / 2][2 * (row >= 8) + n % 2] += d;
        }
}

static void model_warp(uint32_t r[32][8], const uint32_t* t, const uint32_t* wb) {
    uint32_t x[32][4][4], y[32][4][4];
    for (int l = 0; l < 32; ++l) mxu::word_blocks(x[l], t + 16 * l);
    model_round<0, 4>(x);
    model_round<1, 4>(x);
    for (int mt = 0; mt < 2; ++mt)
        for (int nt = 0; nt < 4; ++nt) {
            int32_t c[32][4] = {};
            for (int ks = 0; ks < 2; ++ks) {
                uint32_t a[32][4], b[32][2];
                for (int l = 0; l < 32; ++l) {
                    mxu::a_frag(a[l], x[l], mt, ks);
                    for (int reg = 0; reg < 2; ++reg) b[l][reg] = wb[16 * l + mxu::b_index(ks, nt, reg)];
                }
                model_mma(c, a, b);
            }
            for (int l = 0; l < 32; ++l) mxu::c_pairs(y[l], c[l], mt, nt);
        }
    model_round<0, 4>(y);
    model_round<1, 4>(y);
    for (int l = 0; l < 32; ++l) {
        uint32_t p[16];
        mxu::lane_pairs(p, y[l]);
        mxu::finish_pairs(r[l], p);
    }
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
    } else if (mode == "warp") {  // n products (n a multiple of 32): the warp model, then HostReducer
        auto w = take<uint8_t>(32 * 64);
        auto wb = take<uint32_t>(32 * 16);
        auto t = take<uint32_t>((size_t)16 * n);
        std::vector<uint32_t> out((size_t)16 * n);
        const mxu::HostReducer red{w.data()};
        for (long i = 0; i < n; i += 32) {
            uint32_t r[32][8];
            model_warp(r, &t[16 * i], wb.data());
            for (int l = 0; l < 32; ++l) memcpy(&out[8 * (i + l)], r[l], 32);
        }
        for (long i = 0; i < n; ++i) red.reduce(&out[8 * (n + i)], &t[16 * i]);
        fwrite(out.data(), 4, out.size(), stdout);
    } else if (mode == "jac_add" || mode == "scalar_mul") {  // n cases of 6 x 8 words in, 3 x 8 out
        auto in = take<uint32_t>((size_t)48 * n);
        std::vector<uint32_t> out((size_t)24 * n);
        for (long i = 0; i < n; ++i) {
            const uint32_t* a = &in[48 * i];
            uint32_t* o = &out[24 * i];
            if (mode == "jac_add")
                g1::jac_add(o, o + 8, o + 16, a, a + 8, a + 16, a + 24, a + 32, a + 40);
            else  // the point, then the scalar k (words 24 .. 32)
                g1::scalar_mul(o, o + 8, o + 16, a, a + 8, a + 16, a + 24);
        }
        fwrite(out.data(), 4, out.size(), stdout);
    } else if (mode == "ec_fft") {  // L transforms of n points: state, twiddles, scales
        auto st = take<uint32_t>((size_t)24 * L * n);
        auto tw = take<uint32_t>((size_t)8 * L * (n - 1));
        auto sc = take<uint32_t>((size_t)8 * L);
        for (int s = 0; ((long)2 << s) <= n; ++s)
            for (long t = 0; t < L * n / 2; ++t) ec_fft_butterfly(st.data(), tw.data(), n, L, s, t);
        for (long q = 0; q < L * n; ++q) ec_fft_scale_point(st.data(), sc.data(), n, L, q);
        fwrite(st.data(), 4, st.size(), stdout);
    } else if (mode == "canon") {  // n values V < 2^268 of 9 words -> V mod p, then the quotients
        auto v = take<uint32_t>((size_t)9 * n);
        std::vector<uint32_t> out((size_t)9 * n);
        for (long i = 0; i < n; ++i) {
            mxu::canon(&out[8 * i], &v[9 * i]);
            out[8 * n + i] = mxu::quotient(((uint64_t)v[9 * i + 8] << 32) | v[9 * i + 7]);
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


def _ints(words: np.ndarray, n_words: int) -> list[int]:
    """Rows of little-endian 32-bit words -> ints."""
    w = words.view(np.uint32).reshape(-1, n_words)
    return [sum(int(x) << (32 * i) for i, x in enumerate(row)) for row in w]


def _word_rows(values, n_words: int) -> np.ndarray:
    return np.frombuffer(b"".join(int(v).to_bytes(4 * n_words, "little") for v in values),
                         dtype="<u4").reshape(len(values), n_words)


def _products(case: str, rng) -> list[int]:
    """64 product values (two warps) below 2^512."""
    if case == "random":
        return [int.from_bytes(rng.bytes(64), "little") for _ in range(64)]
    if case == "bytes_0_or_ff":
        vals = [int.from_bytes(bytes(rng.choice([0, 0xFF], 64).astype(np.uint8)), "little")
                for _ in range(62)]
        return vals + [0, (1 << 512) - 1]
    # ragged: the second warp has 11 active lanes; the rest, as in the
    # kernel, multiply zeros
    vals = [int.from_bytes(rng.bytes(64), "little") for _ in range(43)]
    return vals + [0] * 21


@pytest.mark.parametrize("case", ["random", "bytes_0_or_ff", "ragged"])
def test_mxu_warp_model_matches_host_reducer(harness, case):
    """K4's register reduction (quad transposes, A/C fragment maps, the B
    packing of ``fragment_weights``) run for whole warps against the plain
    matrix-product reducer and Python's ``t % p``."""
    vals = _products(case, np.random.default_rng(len(case)))
    payload = (PM.reduce_weights().tobytes() + PM.fragment_weights().tobytes()
               + _word_rows(vals, 16).tobytes())
    out = _ints(_run(harness, "warp", 0, len(vals), payload), 8)
    model, host = out[: len(vals)], out[len(vals):]
    assert host == [v % F.FR_MOD for v in vals]
    assert model == host


def test_mxu_canon_edges(harness):
    """``mxu::canon`` at its edges: V = 0, p - 1, p, 3p - 1, 2^268 - 1, and
    V >> 224 at k·d - 1 and k·d over the range of V >> 224 (< 2^44), held
    to Python's V % p; its reciprocal quotient held to the exact floor
    (V >> 224) // d (one low would still give V % p)."""
    p, d = F.FR_MOD, PM.QDIV
    rng = np.random.default_rng(11)
    vals = [0, p - 1, p, 2 * p - 1, 2 * p, 3 * p - 1, (1 << 268) - 1, (1 << 256) - 1]
    for k in [1, 2, 3, 1000, 5000, (1 << 44) // d - 1, (1 << 44) // d]:
        for top in (k * d - 1, k * d):
            low = int.from_bytes(rng.bytes(28), "little")
            vals += [top << 224, (top << 224) + (1 << 224) - 1, (top << 224) + low]
    vals += [int.from_bytes(rng.bytes(33), "little") >> 4 for _ in range(40)]  # < 2^260
    vals += [int.from_bytes(rng.bytes(34), "little") >> 4 for _ in range(40)]  # < 2^268
    assert max(vals) < 1 << 268
    out = _run(harness, "canon", 0, len(vals), _word_rows(vals, 9).tobytes())
    n = len(vals)
    assert out[8 * n:].view(np.uint32).tolist() == [(v >> 224) // d for v in vals]
    assert _ints(out[: 8 * n], 8) == [v % p for v in vals]


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


# ---------------------------------------------------------------------------
# X4 (csrc/g1_jacobian.cuh, csrc/ec_fft.cu)
# ---------------------------------------------------------------------------

Q = F.FQ_MOD


def _jacobian(p, z):
    """Affine p (or None) -> plain Jacobian ints with Z = z (Z = 0 for None,
    its X and Y then arbitrary: drawn from z, so two infinities differ)."""
    if p is None:
        return (z, z * 7 % Q, 0)
    return (p[0] * z * z % Q, p[1] * z * z * z % Q, z)


def _mont_words(values) -> np.ndarray:
    """Plain Fq ints -> (len, 8) Montgomery words."""
    return _word_rows([(v << 256) % Q for v in values], 8)


def _points_out(words: np.ndarray) -> list:
    """(n, 24) Montgomery words of Jacobian points -> affine points."""
    vals = _ints(words.reshape(-1, 8), 8)
    r_inv = pow(1 << 256, -1, Q)
    jac = [tuple(v * r_inv % Q for v in vals[3 * i : 3 * i + 3]) for i in range(len(vals) // 3)]
    return [None if z == 0 else TC._jac_to_affine((x, y, z)) for x, y, z in jac]


def _add_cases():
    rng = random.Random(13)
    pts = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, F.FR_MOD) for _ in range(12)])
    zs = [rng.randrange(1, Q) for _ in range(40)]
    p, q = pts[0], pts[1]
    neg_p = TC.g1_neg(p)
    cases = [(p, None), (None, q), (None, None), (p, p), (p, neg_p), (neg_p, p), (p, q)]
    cases += [(pts[i], pts[i + 1]) for i in range(2, 11)]
    return [(_jacobian(a, zs[2 * i]), _jacobian(b, zs[2 * i + 1]))
            for i, (a, b) in enumerate(cases)], cases


def test_complete_add_thread_code(harness):
    """g1::jac_add at P + inf, inf + Q, inf + inf, P + P and P + (-P) (each
    side at its own Z), and random pairs: the affine sum equals ops/curve's
    on Python ints, and the Jacobian words equal the plain torch
    ``ops/msm.jac_add`` limb for limb."""
    jac, cases = _add_cases()
    rows = np.stack([_mont_words([*a, *b]).reshape(48) for a, b in jac])
    out = _run(harness, "jac_add", 0, len(jac), rows.tobytes()).view(np.uint32).reshape(-1, 24)
    want = [TC.g1_add(a, b) for a, b in cases]
    assert _points_out(out) == want
    assert want[2] is None and want[4] is None and want[3] == TC.g1_double(cases[3][0])
    cols = [torch.as_tensor(FT.to_mont_limbs([c[i] for c in sum(jac, ())][s::2], FT.FQ))
            for s in (0, 1) for i in range(3)]
    got = FT.words_to_limbs(torch.as_tensor(out.astype(np.int64).reshape(-1, 3, 8)
                                            .transpose(1, 2, 0).copy()), 1)
    ref = TM.jac_add(tuple(cols[:3]), tuple(cols[3:]))
    for c in range(3):
        assert torch.equal(got[c], ref[c])


def test_double_and_add_thread_code(harness):
    """g1::scalar_mul by 0, 1, r - 1, 2^253 and random 254-bit scalars (some
    above r), of points at Z != 1 and of infinity: k P as ops/curve."""
    rng = random.Random(17)
    r = F.FR_MOD
    scalars = [0, 1, 2, r - 1, r, 1 << 253, (1 << 254) - 1]
    scalars += [rng.getrandbits(254) for _ in range(9)]
    pts = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, r) for _ in scalars])
    pts[5] = None
    rows = [np.concatenate([_mont_words(_jacobian(p, rng.randrange(1, Q))).reshape(24),
                            _word_rows([k], 8).reshape(8), np.zeros(16, np.uint32)])
            for p, k in zip(pts, scalars)]
    out = _run(harness, "scalar_mul", 0, len(rows), np.stack(rows).tobytes())
    got = _points_out(out.view(np.uint32).reshape(-1, 24))
    assert got == [None if p is None else TC.g1_mul(p, k % r) for p, k in zip(pts, scalars)]
    assert got[0] is None and got[4] is None and got[3] == TC.g1_neg(pts[3])


def _ec_fft_thread_code(exe, points, transforms):
    """X4's butterflies and scale pass, thread by thread, on the inputs the
    wrapper hands the kernel (``utils/ec_fft.transform_inputs``)."""
    x, y, z, tw, scale = EC.transform_inputs(points, transforms, "cpu")
    nb, n = x.shape[1], x.shape[2]
    if scale is None:
        scale = torch.as_tensor(FT.ints_to_limbs([1] * nb))
    state = torch.stack([FT.limbs_to_words(c, 0) for c in (x, y, z)])
    payload = b"".join(t.numpy().tobytes() for t in (
        state, FT.limbs_to_words(tw, 0), FT.limbs_to_words(scale, 0)))
    out = torch.as_tensor(_run(exe, "ec_fft", nb, n, payload).reshape(3, 8, nb, n))
    return EC.jacobian_to_affine(*(FT.words_to_limbs(out[c], 0) for c in range(3)))


def test_ec_fft_thread_code_matches_host(harness):
    """Two transforms in one state (forward, and the n^-1-scaled inverse) of
    16 points with an infinity lane, held to the host ``ec_fft``."""
    rng = random.Random(19)
    n = 16
    points = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, F.FR_MOD) for _ in range(n)])
    points[7] = None
    omega = NTT.omega_for_k(4)
    omega_inv, n_inv = F.fr_inv(omega), F.fr_inv(n)
    fwd, inv = _ec_fft_thread_code(harness, points, [(omega, 1), (omega_inv, n_inv)])
    assert fwd == EC.ec_fft(points, omega)
    assert inv == [None if p is None else TC.g1_mul(p, n_inv) for p in EC.ec_fft(points, omega_inv)]


def test_ec_fft_thread_code_downsizes_the_ceremony_file(harness):
    """hermez-raw-11 downsized to k = 10 by X4's per-thread code: the 1024
    Lagrange bases hash to the JAX package's (tests/fixtures_torch_criterion.json,
    scripts/make_torch_criterion_fixtures.py)."""
    fix = json.loads((TESTS / "fixtures_torch_criterion.json").read_text())["downsize"]
    params = ParamsKZG.read(str(TESTS / fix["ptau"]))
    k = fix["k"]
    omega_inv, n_inv = F.fr_inv(NTT.omega_for_k(k)), F.fr_inv(1 << k)
    (lagrange,) = _ec_fft_thread_code(harness, params.g[: 1 << k], [(omega_inv, n_inv)])
    raw = b"".join(TC.g1_to_raw_bytes(p) for p in lagrange)
    assert len(lagrange) == fix["count"]
    assert hashlib.sha256(raw).hexdigest() == fix["g_lagrange_sha256"]
