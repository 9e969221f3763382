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
downsize the hermez-raw-11 ceremony file to the JAX package's bases. X0's
per-thread functions (the divstep inversion among them) run for every
element, and X1's block phases (``csrc/ntt.cu``) for every thread of every
block of a launch, a cluster's blocks on buffers of their own; X2's phases
(``csrc/msm_combine.cu``) likewise, against the host's window fold. Exact. The
launches themselves are checked on the card (``chip_smoke.py``, ``-m cuda``
tests)."""

import hashlib
import json
import random
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_halo2_tpu import native as JNAT
from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu.ops import field_jax as FJ
from circuits_halo2_tpu.ops import ntt as JN
from circuits_halo2_tpu.utils import poly_device as JPD
from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import curve as TC
from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon as PS
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.utils import ec_fft as EC
from circuits_halo2_tpu_torch.utils import poly_device as TPD
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
#include "field_ops.cu"
#include "ntt.cu"
#include "msm_combine.cu"

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

// An X4 pass as the card runs it: blocks of X4_BLOCK threads in turn, each
// thread's part before the pair meets, then each thread's part after it,
// on the block's shared memory.
template <class Half, class Finish> static void x4_blocks(long threads, Half half, Finish finish) {
    std::vector<uint32_t> sm((size_t)X4_SLOTS * 24 * X4_BLOCK);
    for (long b0 = 0; b0 < threads; b0 += X4_BLOCK) {
        for (int i = 0; i < X4_BLOCK && b0 + i < threads; ++i) half(sm.data(), i, b0 + i);
        for (int i = 0; i < X4_BLOCK && b0 + i < threads; ++i) finish(sm.data(), i, b0 + i);
    }
}

// An X0 launch as the card runs it, thread by thread: op 0 the product,
// 1-3 add, sub, neg, 4 the power, 5 the inversion (the exponent's words
// holding R^3 mod p).
template <class P>
static void x0_threads(int op, const int64_t* a, const int64_t* b, int64_t* out,
                       const fops::Shape& s, const fops::Strides& sa, const fops::Strides& sb,
                       const fops::Exponent& e, int64_t m) {
    for (uint32_t t = 0; t < (uint32_t)m; ++t) {
        if (op == 0)
            fops::mont_mul_thread<P>(a, b, out, s, sa, sb, m, t);
        else if (op < 4)
            fops::linear_thread<P>(op - 1, a, b, out, s, sa, sb, m, t);
        else if (op == 4)
            fops::pow_thread<P>(a, out, s, sa, e, m, t);
        else
            fops::inv_thread<P>(a, out, s, sa, e.w, m, t);
    }
}

// An X1 launch as the card runs it: cluster after cluster (one block, where
// the pass has no clusters), each block on a shared-memory buffer of its own
// (refilled with a pattern first, so a read of a slot no block wrote shows),
// each phase run for every thread of every block of the cluster before the
// next, as the kernel's barriers order them; a block reaches another's
// buffer through the peer table.
struct HostPeers {
    std::vector<uint32_t*> sms;
    uint32_t* operator()(uint32_t*, int rank) const { return sms[rank]; }
};

static void x1_blocks(const x1::Args& a, const x1::Pass& p) {
    const int C = 1 << p.lc;
    std::vector<std::vector<uint32_t>> bufs(C, std::vector<uint32_t>(x1::smem_bytes(p) / 4));
    HostPeers peers;
    for (auto& b : bufs) peers.sms.push_back(b.data());
    for (int64_t blk = 0; blk < (p.blocks >> p.lc); ++blk) {
        for (auto& b : bufs) std::fill(b.begin(), b.end(), 0xa5a5a5a5u);
        for (int r = 0; r < C; ++r)
            for (int t = 0; t < p.threads; ++t) {
                x1::load_twiddles(peers.sms[r], p, a, t);
                x1::load_lines(peers.sms[r], p, a, blk, r, t);
            }
        int s = 0;
        for (; s + 1 < p.lm - p.lc; s += 2)
            for (int r = 0; r < C; ++r)
                for (int t = 0; t < p.threads; ++t) x1::stage_pair(peers.sms[r], p, s, t);
        for (; s < p.lm; ++s)
            for (int r = 0; r < C; ++r)
                for (int t = 0; t < p.threads; ++t) x1::stage(peers.sms[r], p, a, s, r, t, peers);
        for (int r = 0; r < C; ++r)
            for (int t = 0; t < p.threads; ++t) x1::store_lines(peers.sms[r], p, a, blk, r, t);
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
    } else if (mode == "ec_fft") {  // L transforms of n points, nd digits a GLV half
        const int nd = atoi(argv[4]);
        auto st = take<uint32_t>((size_t)24 * L * n);
        auto dg = take<int8_t>((size_t)L * (n - 1) * 2 * nd);
        auto sd = take<int8_t>((size_t)L * 2 * nd);
        auto beta = take<uint32_t>(8);
        for (int s = 0; ((long)2 << s) <= n; ++s)
            x4_blocks(L * n, [&](uint32_t* sm, int i, long gt) {
                x4_stage_half(sm, i, st.data(), dg.data(), beta.data(), n, L, s, nd, gt);
            }, [&](uint32_t* sm, int i, long gt) {
                x4_stage_finish(sm, i, st.data(), n, L, s, gt);
            });
        x4_blocks(2 * L * n, [&](uint32_t* sm, int i, long gt) {
            x4_scale_half(sm, i, st.data(), sd.data(), beta.data(), n, L, nd, gt);
        }, [&](uint32_t* sm, int i, long gt) {
            x4_scale_finish(sm, i, st.data(), n, L, gt);
        });
        fwrite(st.data(), 4, st.size(), stdout);
    } else if (mode == "phi") {  // n points of a (3, 8, n) state, then beta
        auto st = take<uint32_t>((size_t)24 * n);
        auto beta = take<uint32_t>(8);
        std::vector<uint32_t> out(st.size());
        for (long q = 0; q < n; ++q)
            x4_load(g1::PointRef{out.data() + q, n}, st.data(), n, q, beta.data(), true);
        fwrite(out.data(), 4, out.size(), stdout);
    } else if (mode == "canon") {  // n values V < 2^268 of 9 words -> V mod p, then the quotients
        auto v = take<uint32_t>((size_t)9 * n);
        std::vector<uint32_t> out((size_t)9 * n);
        for (long i = 0; i < n; ++i) {
            mxu::canon(&out[8 * i], &v[9 * i]);
            out[8 * n + i] = mxu::quotient(((uint64_t)v[9 * i + 8] << 32) | v[9 * i + 7]);
        }
        fwrite(out.data(), 4, out.size(), stdout);
    } else if (mode == "fops") {  // X0: field (L), op (n), nd, then each operand's storage length
        const int nd = atoi(argv[4]);
        const long alen = atol(argv[5]), blen = atol(argv[6]);
        auto meta = take<int64_t>(3 * nd + 2);
        auto av = take<int64_t>(alen), bv = take<int64_t>(blen);
        auto ex = take<uint32_t>(9);
        fops::Shape s;
        fops::Strides sa, sb;
        int64_t m;
        if (!fops::collapse(meta.data(), nd, s, sa, sb, m)) exit(3);
        fops::Exponent e;
        memcpy(e.w, ex.data(), 32);
        e.nbits = (int)ex[8];
        std::vector<int64_t> out((size_t)16 * m + 1);
        out[16 * m] = s.ndim;  // the axes left after collapsing
        if (L == 0)
            x0_threads<bn254::Fr>(n, av.data(), bv.data(), out.data(), s, sa, sb, e, m);
        else
            x0_threads<bn254::Fq>(n, av.data(), bv.data(), out.data(), s, sa, sb, e, m);
        fwrite(out.data(), 8, out.size(), stdout);
    } else if (mode == "x1") {  // X1: L rows of n points from n_in lanes; the table, the factors
        const long n_in = atol(argv[4]), si_len = atol(argv[7]), so_len = atol(argv[8]);
        const int one_pass = atoi(argv[5]), target = atoi(argv[6]);
        auto in = take<int64_t>((size_t)16 * L * n_in);
        auto tw = take<uint32_t>((size_t)8 * n);
        auto si = take<uint32_t>((size_t)8 * si_len), so = take<uint32_t>((size_t)8 * so_len);
        std::vector<int64_t> out((size_t)16 * L * n + 1);
        std::vector<uint32_t> scratch((size_t)8 * L * n);
        x1::Args a{in.data(), out.data(), scratch.data(), tw.data(),
                   si_len ? si.data() : nullptr, so_len ? so.data() : nullptr,
                   (int)(si_len > 1), (int)(so_len > 1), 0, 0, 0, L, n_in};
        x1::Pass ps[2];
        const int launches = x1::plan(x1::ilog2(n), L, one_pass, target, a, ps);
        for (int i = 0; i < launches; ++i) x1_blocks(a, ps[i]);
        out[16 * L * n] = launches + 16 * ps[0].lc;  // the launches and the first's cluster
        fwrite(out.data(), 8, out.size(), stdout);
    } else if (mode == "x2") {  // X2: n commitments' (16, n, 32, 32) limbs of X, Y, Z, then R^3
        const size_t len = (size_t)16 * n * x2::NWIN * x2::PARTS;
        auto x = take<int64_t>(len), y = take<int64_t>(len), z = take<int64_t>(len);
        auto r3 = take<uint32_t>(8);
        std::vector<int64_t> out((size_t)x2::OUT * n);
        x2::Args a{x.data(), y.data(), z.data(), out.data(), n, {}};
        memcpy(a.r3.w, r3.data(), 32);
        std::vector<uint32_t> sm(x2::SMEM_WORDS);
        for (long blk = 0; blk < n; ++blk) {  // each phase for every thread, as the barriers order them
            std::fill(sm.begin(), sm.end(), 0xa5a5a5a5u);
            for (int j = 0; j < x2::THREADS; ++j) x2::window_sum(sm.data(), a, blk, j);
            for (int level = 0; level < x2::LEVELS; ++level)
                for (int j = 0; j < x2::THREADS; ++j) x2::fold(sm.data(), level, j);
            x2::finish(sm.data(), a, blk);
        }
        fwrite(out.data(), 8, out.size(), stdout);
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


def _run(exe, mode, L, n, payload: bytes, dtype=np.int32, *extra) -> np.ndarray:
    out = subprocess.run([str(exe), mode, str(L), str(n), *map(str, extra)], input=payload,
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


def _beta_words() -> bytes:
    return _mont_words([EK.BETA]).tobytes()


def _x4_thread_code(exe, x, y, z, digits, scale):
    """X4's stages and scale pass, pair by pair (``csrc/ec_fft.cu``), on the
    arguments of ``ops/ec_fft_kernel.ec_fft``; the (3, 8, B, n) state out."""
    nb, n = x.shape[1], x.shape[2]
    if scale is None:
        scale = torch.as_tensor(EK.scalar_digits([1] * nb))
    state = torch.stack([FT.limbs_to_words(c, 0) for c in (x, y, z)])
    payload = b"".join(t.numpy().tobytes() for t in (state, digits, scale)) + _beta_words()
    out = _run(exe, "ec_fft", nb, n, payload, np.int32, EK.DIGITS)
    return torch.as_tensor(out.reshape(3, 8, nb, n))


def _ec_fft_thread_code(exe, points, transforms):
    """X4 on the inputs the wrapper hands the kernel
    (``utils/ec_fft.transform_inputs``), as affine points."""
    out = _x4_thread_code(exe, *EC.transform_inputs(points, transforms, "cpu"))
    return EC.jacobian_to_affine(*(FT.words_to_limbs(out[c], 0) for c in range(3)))


def _jacobian_state(jac) -> np.ndarray:
    """Plain Jacobian int triples -> the (3, 8, n) Montgomery word state."""
    return np.stack([_mont_words([p[c] for p in jac]).T for c in range(3)])


def test_phi_thread_code_is_lambda(harness):
    """X4's load with phi, (BETA X, Y, Z), at Z != 1 and at infinity: the
    affine point is [LAMBDA] P (ops/curve), and BETA and LAMBDA are cube
    roots of unity."""
    rng = random.Random(29)
    pts = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, F.FR_MOD) for _ in range(6)])
    pts[2] = None
    jac = [_jacobian(p, rng.randrange(1, Q)) for p in pts]
    out = _run(harness, "phi", 0, len(pts), _jacobian_state(jac).tobytes() + _beta_words())
    got = _points_out(out.view(np.uint32).reshape(3, 8, -1).transpose(2, 0, 1).reshape(-1, 24))
    assert got == [None if p is None else TC.g1_mul(p, EK.LAMBDA) for p in pts]
    assert pow(EK.BETA, 3, Q) == 1 != EK.BETA and pow(EK.LAMBDA, 3, F.FR_MOD) == 1 != EK.LAMBDA


def test_glv_window_mul_thread_code(harness):
    """X4's scale pass as a GLV multiply (one point a transform, each its own
    scalar): k in {0, 1, 2, r - 1, LAMBDA, r - LAMBDA, 2^253} and random, of
    points at Z != 1 and of infinity, gives k P (ops/curve) and the plain
    torch ``glv_mul_ref``'s limbs."""
    rng = random.Random(31)
    r = F.FR_MOD
    scalars = [0, 1, 2, r - 1, EK.LAMBDA, r - EK.LAMBDA, 1 << 253]
    scalars += [rng.randrange(r) for _ in range(7)] + [5, r - 2]
    pts = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, r) for _ in scalars])
    pts[9] = pts[-1] = None
    jac = [_jacobian(p, rng.randrange(1, Q)) for p in pts]
    cols = [torch.as_tensor(FT.to_mont_limbs([p[c] for p in jac], FT.FQ)).unsqueeze(-1)
            for c in range(3)]
    digits = torch.as_tensor(EK.scalar_digits(scalars))
    out = _x4_thread_code(harness, *cols, torch.zeros(len(pts), 0, 2, EK.DIGITS, dtype=torch.int8),
                          digits)
    got = tuple(FT.words_to_limbs(out[c], 0) for c in range(3))
    affine = EC.jacobian_to_affine(*(c.reshape(16, 1, -1) for c in got))[0]
    assert affine == [None if p is None else TC.g1_mul(p, k) for p, k in zip(pts, scalars)]
    want = EK.glv_mul_ref(tuple(c[..., 0] for c in cols), digits)
    for g, w in zip(got, want):
        assert torch.equal(g[..., 0], w)


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


# ---------------------------------------------------------------------------
# X0 and X1 (csrc/field_ops.cuh): each kernel's per-thread function run for
# every element of the output, as the card runs it
# ---------------------------------------------------------------------------

X0_OPS = {"mul": 0, "add": 1, "sub": 2, "neg": 3, "pow": 4}
X0_FIELDS = {"fr": (0, FT.FR, FJ.FR), "fq": (1, FT.FQ, FJ.FQ)}


def _storage_from(x: torch.Tensor) -> np.ndarray:
    """The int64 storage under a view, from its first element on (what the
    kernel's pointer sees)."""
    count = x.untyped_storage().nbytes() // 8 - x.storage_offset()
    return torch.as_strided(x, (count,), (1,), x.storage_offset()).numpy()


def _x0(exe, code: int, op: str, a: torch.Tensor, b: torch.Tensor, exponent: int = 0):
    """X0's per-thread code over the broadcast batch of the views a and b,
    read through ``FT.strides_meta`` as the wrapper hands them over; returns
    the (16, *batch) output and the batch axes left after the collapse."""
    batch, meta = FT.strides_meta(a, b)
    sa, sb = _storage_from(a), _storage_from(b)
    ex = [(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(8)] + [max(1, exponent.bit_length())]
    payload = (np.asarray(meta, np.int64).tobytes() + sa.tobytes() + sb.tobytes()
               + np.asarray(ex, np.uint32).tobytes())
    out = _run(exe, "fops", code, X0_OPS[op], payload, np.int64, len(batch), len(sa), len(sb))
    return torch.as_tensor(out[:-1]).reshape((16,) + batch), int(out[-1])


def _x0_ref(op: str, a, b, spec, exponent: int = 0):
    return {"mul": lambda: FT.mont_mul_ref(a, b, spec), "add": lambda: FT.add_mod_ref(a, b, spec),
            "sub": lambda: FT.sub_mod_ref(a, b, spec), "neg": lambda: FT.neg_mod_ref(a, spec),
            "pow": lambda: FT.mont_pow_ref(a, exponent, spec)}[op]()


def _x0_operands(p: int, op: str, seed: int):
    """Flat operands: 0, 1 and p - 1 against each other and random values
    below p; for the product also values in [p, 2^256) (to_mont's raw limbs)
    against canonical ones, on either side."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(24)]
    a = [0, 1, p - 1, 0, 1, p - 1, 0, p - 1] + rand
    b = [0, 0, 0, 1, p - 1, p - 1, p - 1, 1] + rand[::-1]
    if op == "mul":
        above = [p, p + 1, 2 * p - 1, 5 * p, (1 << 256) - 1]
        above += [p + int.from_bytes(rng.bytes(32), "little") % ((1 << 256) - p) for _ in range(7)]
        canon = rand[: len(above)]
        a, b = a + above + canon, b + canon + above
    return (torch.as_tensor(FT.ints_to_limbs(v)) for v in (a, b))


@pytest.mark.parametrize("op", sorted(X0_OPS))
@pytest.mark.parametrize("field", sorted(X0_FIELDS))
def test_x0_thread_code_matches_plain_and_jax(harness, field, op):
    """X0a-X0c's per-thread code on edge and random operands gives the plain
    torch versions' limbs and field_jax's (the inversion: a^(p - 2), 0 -> 0)."""
    code, ts, js = X0_FIELDS[field]
    ta, tb = _x0_operands(ts.mod_int, op, seed=code * 8 + X0_OPS[op])
    exponent = ts.mod_int - 2
    got, _ = _x0(harness, code, op, ta, tb, exponent)
    assert torch.equal(got, _x0_ref(op, ta, tb, ts, exponent))
    ja, jb = (jnp.asarray(t.numpy().astype(np.uint32)) for t in (ta, tb))
    want = {"mul": lambda: FJ.mont_mul(ja, jb, js), "add": lambda: FJ.add_mod(ja, jb, js),
            "sub": lambda: FJ.sub_mod(ja, jb, js), "neg": lambda: FJ.neg_mod(ja, js),
            "pow": lambda: FJ.inv_mont(ja, js)}[op]()
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("exponent", [0, 1, 5, 12345, (1 << 256) - 1])
def test_x0_pow_thread_code_exponents(harness, exponent):
    """X0c at exponents 0 (the plain loop's one squaring of 1), 1, 5, 12345
    and 2^256 - 1 gives the plain ``mont_pow`` limb for limb."""
    ta, _ = _x0_operands(FT.FR.mod_int, "pow", seed=exponent % 97)
    ta = ta[:, :12]
    got, _ = _x0(harness, 0, "pow", ta, ta, exponent)
    assert torch.equal(got, FT.mont_pow_ref(ta, exponent))


def _limbs(rng, count: int) -> torch.Tensor:
    """(16, count) limbs of random 16-bit values: any value below 2^256."""
    return torch.as_tensor(rng.integers(0, 1 << 16, (16, count), dtype=np.int64))


def _strided_case(name: str):
    """(a, b, batch axes left after the collapse) for operands laid out as
    the prover hands them over, each read in place."""
    rng = np.random.default_rng(len(name))
    if name == "lane_table":  # (16, U, B, n) columns x a (16, 1, 1, n) table
        return _limbs(rng, 2 * 3 * 8).reshape(16, 2, 3, 8), _limbs(rng, 8).reshape(16, 1, 1, 8), 2
    if name == "challenge":  # (16, U, B, n) x a (16, U, 1, 1) challenge per user
        return _limbs(rng, 2 * 3 * 8).reshape(16, 2, 3, 8), _limbs(rng, 2).reshape(16, 2, 1, 1), 2
    if name == "column_view":  # sigma[:, :, idx]-like: a column of a wider tensor
        cols = _limbs(rng, 2 * 5 * 8).reshape(16, 2, 5, 8)
        return cols[:, :, 3], _limbs(rng, 2 * 8).reshape(16, 2, 8), 2
    if name == "expand":  # a constant expanded (stride 0) against a transposed view
        wide = _limbs(rng, 6 * 4).reshape(16, 6, 4).transpose(1, 2)
        return wide, _limbs(rng, 1).reshape(16, 1, 1).expand(16, 4, 6), 2
    if name == "contiguous":  # merges into one axis
        return _limbs(rng, 2 * 3 * 8).reshape(16, 2, 3, 8), _limbs(rng, 48).reshape(16, 2, 3, 8), 1
    # as_strided: overlapping rows at an offset, and limbs at stride 1 with a
    # broadcast axis
    flat = _limbs(rng, 64).reshape(-1)
    a = torch.as_strided(flat, (16, 4, 6), (60, 1, 7), 5)
    return a, torch.as_strided(flat, (16, 1, 6), (1, 0, 16), 0), 2


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
@pytest.mark.parametrize("case", ["lane_table", "challenge", "column_view", "expand",
                                  "contiguous", "as_strided"])
def test_x0_thread_code_reads_strided_operands(harness, case, op):
    """The offsets X0 computes from ``strides_meta`` after the host's collapse
    read broadcast, strided, transposed and ``torch.as_strided`` operands in
    place: the outputs equal the plain versions on the same views (values
    anywhere below 2^256, limb for limb)."""
    a, b, axes = _strided_case(case)
    got, left = _x0(harness, 1 if op == "sub" else 0, op, a, b)
    spec = FT.FQ if op == "sub" else FT.FR
    assert torch.equal(got, _x0_ref(op, a, b, spec))
    if op != "neg":
        assert left == axes


# The inversion (X0c): the divstep code against the Fermat chain

X0_OPS["inv"] = 5


def _divsteps_to_zero(p: int, g: int) -> int:
    """The paper's divsteps from (delta, f, g) = (1, p, g) until g = 0."""
    delta, f, steps = 1, p, 0
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) >> 1
        else:
            delta, g = 1 + delta, (g + (g & 1) * f) >> 1
        steps += 1
    return steps


def _inversion_inputs(p: int, seed: int) -> list[int]:
    """0, 1, p - 1, R mod p, raw values up to 2^256 - 1, random values, and
    the eight that need the most divsteps among those and 1,500 more
    candidates (random, small, p minus small, powers of two and their
    neighbours, p's halvings)."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(24)]
    raw = [p, p + 1, 2 * p - 1, 5 * p, (1 << 256) - 1] + [
        p + int.from_bytes(rng.bytes(32), "little") % ((1 << 256) - p) for _ in range(7)]
    cand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(1200)]
    cand += list(range(2, 66)) + [p - i for i in range(2, 66)]
    cand += [(1 << i) % p for i in range(254)] + [((1 << i) - 1) % p for i in range(2, 254)]
    cand += [(p - 1) >> i for i in range(1, 64)]
    worst = sorted(cand, key=lambda g: -_divsteps_to_zero(p, g))[:8]
    return [0, 1, p - 1, (1 << 256) % p] + raw + rand + worst


@pytest.mark.parametrize("field", sorted(X0_FIELDS))
def test_x0c_divstep_inversion_matches_fermat_and_jax(harness, field):
    """X0c's divstep inversion (25 batches of 30, the paper's bound for 254
    bits with 14 to spare) gives the Fermat chain's limbs, mont_pow_ref(a,
    p - 2), and field_jax's inv_mont at 0, 1, p - 1, R mod p, raw limbs up
    to 2^256 - 1 (reduced first), random values and the inputs that need
    the most divsteps of a seeded search; none needs more than 750."""
    code, ts, js = X0_FIELDS[field]
    p = ts.mod_int
    vals = _inversion_inputs(p, seed=code)
    assert max(_divsteps_to_zero(p, v % p) for v in vals) <= 25 * 30
    a = torch.as_tensor(FT.ints_to_limbs(vals))
    got, _ = _x0(harness, code, "inv", a, a, (1 << 768) % p)
    assert torch.equal(got, FT.mont_pow_ref(a, p - 2, ts))
    want = FJ.inv_mont(jnp.asarray(a.numpy().astype(np.uint32)), js)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    nonzero = [i for i, v in enumerate(vals) if v % p]
    inv = FT.limbs_to_ints(got)
    assert all(inv[i] * vals[i] % p == pow(1 << 256, 2, p) for i in nonzero)


# X1 (csrc/ntt.cu): every block of a launch, each phase for every thread
# before the next, from what ``ntt_passes`` hands the kernel


def _x1(exe, a, omega, n=None, in_scale=None, out_scale=None,
        one_pass=NTT.ONE_PASS_MAX_LOG, target=132, cluster=False):
    """X1's block code on the (16, *batch, n_in) limbs ``a``: the output, the
    launches and (with ``cluster``) log2 of the first launch's cluster size.
    ``target`` is the grid the plan aims for (the card's SM count; 1 keeps
    the most lines a block)."""
    n_in = int(a.shape[-1])
    n = n or n_in
    tw = NTT._powers(n, omega % F.FR_MOD, "cpu")
    si = in_scale.words if in_scale else torch.empty((0, 8), dtype=torch.int32)
    so = out_scale.words if out_scale else torch.empty((0, 8), dtype=torch.int32)
    payload = b"".join(t.contiguous().numpy().tobytes() for t in (a, tw, si, so))
    rows = a[0].numel() // n_in
    out = _run(exe, "x1", rows, n, payload, np.int64, n_in, one_pass, target, len(si), len(so))
    got = torch.as_tensor(out[:-1]).reshape(tuple(a.shape[:-1]) + (n,))
    return (got, int(out[-1]) % 16, int(out[-1]) // 16) if cluster else (got, int(out[-1]) % 16)


def _fr_limbs(shape, seed):
    """Canonical Montgomery limbs of random elements, 0 and p - 1 first and
    last."""
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(count)]
    vals[0], vals[-1] = 0, F.FR_MOD - 1
    return torch.as_tensor(FT.to_mont_limbs(vals)).reshape((16,) + tuple(shape))


@pytest.mark.parametrize("k,rows,one_pass,target,cluster", [
    (11, 2, 11, 132, 3),  # one pass, a row over a cluster of 8 blocks
    (11, 2, 11, 1, 0),    # one pass, a row a block
    (11, 2, 10, 132, 0),  # the same transform in two passes
    (13, 2, 11, 132, 0),  # two passes, a line a block
    (13, 2, 11, 1, 0),    # two passes, 16 and 32 lines a block
    (16, 2, 11, 132, 0),  # two passes, 2 lines a block
    (6, 3, 11, 8, 0),     # one pass, 3 rows in a 4-line block
    (8, 3, 11, 132, 2),   # one pass, a row over a cluster of 4
    (1, 3, 11, 1, 0),     # 2 points
])
def test_x1_block_code_matches_plain_and_jax(harness, k, rows, one_pass, target, cluster):
    """X1's block code over ``rows`` random rows of 2^k points (0 and p - 1
    among them), in one launch up to 2^one_pass points (a row spread over a
    cluster of blocks where the rows are few) and two above, gives
    ``ntt_ref``'s limbs and, at 2^11 and 2^13, the JAX package's ``ntt``."""
    n = 1 << k
    a = _fr_limbs((rows, n), seed=k * 10 + rows)
    omega = NTT.omega_for_k(k)
    got, launches, lc = _x1(harness, a, omega, one_pass=one_pass, target=target, cluster=True)
    assert launches == (1 if k <= one_pass else 2) and lc == cluster
    assert torch.equal(got, NTT.ntt_ref(a, omega))
    if k in (11, 13) and target > 1 and one_pass == NTT.ONE_PASS_MAX_LOG:
        want = JN.ntt(jnp.asarray(a.numpy().astype(np.uint32)), omega)
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("method", ["coeff_to_extended", "lagrange_to_coeff",
                                    "extended_to_coeff", "vanishing_to_coeff"])
def test_x1_block_code_fused_domain_transforms(harness, method):
    """The Domain's transforms with their factors folded into X1's load and
    store (the coset g^j on 2^11 of 2^13 input lanes; n^-1 on store; n_ext^-1
    g^-k on store; 1 / Zh on load and n_ext^-1 g^-k on store) give the
    plain sequence's limbs (mont_mul_ref, zero lanes, ntt_ref, mont_mul_ref)
    and the JAX package's Domain."""
    dom, jdom = TPD.domain(11, 3, "cpu"), JPD.domain(11, 3)
    wide = method != "coeff_to_extended" and method != "lagrange_to_coeff"
    a = _fr_limbs((2, dom.n_ext if wide else dom.n), seed=len(method))
    ja = jnp.asarray(a.numpy().astype(np.uint32))
    n_inv = FT.const_tensor(FT.FR.const(F.fr_inv(dom.n)), "cpu", 3)
    ext_inv = FT.const_tensor(FT.FR.const(F.fr_inv(dom.n_ext)), "cpu", 3)
    lanes = lambda t: t.reshape(16, 1, -1)  # noqa: E731
    omega_inv = F.fr_inv(dom.omega_ext)
    if method == "coeff_to_extended":
        got, launches = _x1(harness, a, dom.omega_ext, dom.n_ext, in_scale=dom._coset_lanes)
        padded = torch.nn.functional.pad(a, (0, dom.n_ext - dom.n))
        plain = NTT.ntt_ref(FT.mont_mul_ref(padded, lanes(dom._coset)), dom.omega_ext)
        want = jdom.coeff_to_extended(ja)
    elif method == "lagrange_to_coeff":
        got, launches = _x1(harness, a, F.fr_inv(dom.omega),
                            out_scale=NTT.const_lanes(F.fr_inv(dom.n), "cpu"))
        plain = FT.mont_mul_ref(NTT.ntt_ref(a, F.fr_inv(dom.omega)), n_inv)
        want = jdom.lagrange_to_coeff(ja)
    elif method == "extended_to_coeff":
        got, launches = _x1(harness, a, omega_inv, out_scale=dom._to_coeff_lanes)
        coeffs = FT.mont_mul_ref(NTT.ntt_ref(a, omega_inv), ext_inv)
        plain = FT.mont_mul_ref(coeffs, lanes(dom._coset_inv))
        want = jdom.extended_to_coeff(ja)
    else:
        got, launches = _x1(harness, a, omega_inv, in_scale=dom._zh_inv_lanes,
                            out_scale=dom._to_coeff_lanes)
        divided = FT.mont_mul_ref(a, lanes(dom._zh_inv))
        coeffs = FT.mont_mul_ref(NTT.ntt_ref(divided, omega_inv), ext_inv)
        plain = FT.mont_mul_ref(coeffs, lanes(dom._coset_inv))
        want = jdom.extended_to_coeff(jdom.divide_by_vanishing(ja))
    assert launches == (1 if got.shape[-1] <= 1 << NTT.ONE_PASS_MAX_LOG else 2)
    assert torch.equal(got, plain)
    assert torch.equal(got, getattr(dom, method)(a))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


# ---------------------------------------------------------------------------
# X2 (csrc/msm_combine.cu)
# ---------------------------------------------------------------------------

def _x2_grids():
    """Three (32 windows x 32 partials) grids of affine points (None at
    infinity): all at infinity; the edge cases; every partial a distinct
    point, d = 15 and window 31 included (the largest weights)."""
    rng = random.Random(19)
    r = F.FR_MOD
    ks = [rng.randrange(1, r) for _ in range(2 * 32 * 32)]
    a, c = rng.randrange(1, r), rng.randrange(1, r)
    # P and -P/16 (the fold's P + (-P)), Q and 16 Q (the fold's doubling)
    ks += [a, -a * pow(16, -1, r) % r, c, 16 * c % r]
    pts = native.g1_fixed_base_muls(C.G1_GEN, ks)
    full, edge = pts[:1024], pts[1024:2048]
    p_a, p_cancel, q, q16 = pts[2048:]
    edge = [edge[32 * w : 32 * w + 32] for w in range(32)]
    edge[0] = [None] * 32  # window 0: T_0 + 16 T_1 = P - P at the fold's first level
    edge[0][17], edge[0][1] = p_a, p_cancel
    edge[1] = [edge[1][3]] * 32  # equal partials: the running sum doubles
    p = edge[2][5]
    edge[2][31], edge[2][30], edge[2][15], edge[2][14] = p, TC.g1_neg(p), p, TC.g1_neg(p)
    edge[3] = [None] * 32  # both nibble windows zero
    edge[4][1:16] = [None] * 15  # the row sums' nibble window zero
    edge[5] = [None] * 32  # T_10 = 16 Q, T_11 = Q: the fold doubles
    edge[5][17], edge[5][1] = q16, q
    return [[None] * 1024, sum(edge, []), full]


def test_x2_block_code_matches_host_fold(harness):
    """X2's phases, thread by thread and block by block in the kernel's
    order, on three commitments' partials at random Z (a partial at
    infinity with random X and Y; the weight-0 partials filled): the affine
    points equal the JAX package's native MSM over the grid's points and
    weights, and ``ops/msm._combine_windows_host``'s (the card tests'
    reference), and the all-infinity grid gives None."""
    grids = _x2_grids()
    rng = random.Random(23)
    jac = [_jacobian(p, rng.randrange(1, Q)) for g in grids for p in g]
    acc = tuple(torch.as_tensor(FT.to_mont_limbs([j[c] for j in jac], FT.FQ))
                .reshape(16, len(grids), 32, 32) for c in range(3))
    payload = b"".join(t.numpy().tobytes() for t in acc) + _word_rows(
        [(1 << 768) % Q], 8).tobytes()
    rows = _run(harness, "x2", 0, len(grids), payload, np.int64).reshape(len(grids), 17)
    got = TM._affine_from_rows(torch.as_tensor(rows))
    weights = [wt << (8 * w) for w in range(32) for wt in TM.PARTIAL_WEIGHTS]
    want = [JNAT.g1_msm(*zip(*[(p, k % F.FR_MOD) for p, k in zip(g, weights) if p and k]))
            if any(g) else None for g in grids]
    assert got == want == TM._combine_windows_host(acc)
    assert got[0] is None and got[1] is not None and got[2] is not None
