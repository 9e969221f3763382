// K3: Pippenger bucket scan -- chunk-local segmented sums of digit-sorted
// affine points over BN254 Fq, one thread per lane.
//
// Replaces: circuits_halo2_tpu/ops/msm_pallas.py::_scan_pallas (kernel body
// _scan_kern), reached from ops/msm.py::_segmented_sum_parts_pallas for every
// KZG commitment in keygen and in the prover.
//
// Semantics (identical to msm.py::_segmented_sum_parts, phase 1): the points
// are cut into lanes (chunks) of L consecutive positions; each lane walks its
// points in order; when the digit changes the Jacobian accumulator's Z is
// reset to 0 (infinity, X and Y kept); the point is added with jac_madd
// (madd-2007-bl, same formulas and the same case selection: P at infinity,
// invalid Q, doubling, P + (-P)); and the canonical local sum is written
// after every step. Canonical outputs make the result limb-for-limb equal to
// the plain torch scan.
//
// What bounds it on the card. Its multiplies (1,340 wide multiplies a mixed
// add) take about 0.12 ms for a k=13 batch of 3 columns (786,432
// points). The int64-limb interface it keeps (649 bytes a point: the limbs
// of px and py, the digit and the flag in, three limb outputs out, four
// times the bytes of 32-byte field elements) moves that to 0.15 ms. The
// first port ran at
// 20x that: one thread per lane (6144 lanes of L = 128 steps: 48 blocks of
// 128 threads for 132 SMs), each a serial chain, behind a wrapper that
// converted every limb to 32-bit words and back (2.5x the kernel's time).
// Measured on the H100 (PERF.md): writing int64 limbs straight from each
// thread (8 bytes a thread, the threads' positions far apart: a partial
// sector each)
// doubled the time, and reading them so cost nearly 2x more at 16 columns;
// both now move whole sectors. What is left is not the multiply pipe: a
// warp alone spends about 5 cycles per instruction of its mixed add (the
// carry chains are dependent), and an SM with its 8 resident warps (176
// registers a thread) does only 1.7x the work of one with 1.5; which shared
// resource that is, the tools on the machine (no ncu) do not say.
//
// Design:
// - One thread per lane, L serial steps. Exact segment-anchored sub-lanes
//   (a thread per S < L steps, replaying from the last valid segment start)
//   were built and measured on the H100 (PERF.md): they lost at every lane
//   length the path uses -- L = 128, 256 and 512 (k = 13 to 15), by 13-29 %
//   at half a lane and 39-58 % at a quarter -- because a warp runs as long
//   as its longest replay. So they went.
// - No conversion pass. The kernel reads the (16, P) int64 limbs of px / py
//   (P = every point of the batch), the int64 digits and the bool flags, and
//   writes the three (16, P) int64 outputs, packing and unpacking 32-bit
//   words. The written steps go through shared memory in groups of 4, a
//   warp at a time, so every global load and store moves whole 32-byte
//   sectors (the kernel below says how).
// - Fq arithmetic from bn254_fast.cuh: lazily reduced products, squarings
//   and adds inside jac_madd; h, rr and the accumulator are canonical where
//   the case tests read them, and every output is canonical.
// - The block size follows the thread count so the blocks cover every SM.

#include "bn254_fast.cuh"

using bn254::Fq;

// dbl-2009-l (ops/msm.py::jac_double), a = 0 curve; canonical in and out.
BN_HD void jac_double(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                      const uint32_t x[8], const uint32_t y[8], const uint32_t z[8]) {
    uint32_t a[8], b[8], c[8], xb[8], d[8], e[8], f[8], t[8], c8[8];
    bnf::sqr<Fq>(a, x);
    bnf::sqr<Fq>(b, y);
    bnf::sqr<Fq>(c, b);
    bnf::add<Fq>(xb, x, b);
    bnf::sqr<Fq>(t, xb);
    bnf::sub<Fq>(t, t, a);
    bnf::sub<Fq>(d, t, c);
    bnf::dbl<Fq>(d, d);
    bnf::add<Fq>(e, a, a);
    bnf::add<Fq>(e, e, a);
    bnf::sqr<Fq>(f, e);
    bnf::dbl<Fq>(t, d);
    uint32_t xo[8], yo[8], zo[8];
    bnf::sub<Fq>(xo, f, t);
    bnf::dbl<Fq>(c8, c);
    bnf::dbl<Fq>(c8, c8);
    bnf::dbl<Fq>(c8, c8);
    bnf::sub<Fq>(t, d, xo);
    bnf::mul<Fq>(t, e, t);
    bnf::sub<Fq>(yo, t, c8);
    bnf::mul<Fq>(t, y, z);
    bnf::dbl<Fq>(zo, t);
    bnf::canon<Fq>(x3, xo);
    bnf::canon<Fq>(y3, yo);
    bnf::canon<Fq>(z3, zo);
}

// madd-2007-bl (ops/msm.py::jac_madd): (x1, y1, z1) += affine (x2, y2),
// `valid` false meaning Q is the point at infinity. In place; the
// accumulator is canonical in and out.
BN_HD void jac_madd(uint32_t x1[8], uint32_t y1[8], uint32_t z1[8],
                    const uint32_t x2[8], const uint32_t y2[8], bool valid) {
    uint32_t z1z1[8], u2[8], s2[8], h[8], hh[8], i4[8], j[8], rr[8], v[8], t[8];
    uint32_t x3[8], y3[8], z3[8];
    bnf::sqr<Fq>(z1z1, z1);
    bnf::mul<Fq>(u2, x2, z1z1);
    bnf::mul<Fq>(t, y2, z1);
    bnf::mul<Fq>(s2, t, z1z1);
    bnf::sub<Fq>(h, u2, x1);
    bnf::canon<Fq>(h, h);
    bnf::sqr<Fq>(hh, h);
    bnf::dbl<Fq>(i4, hh);
    bnf::dbl<Fq>(i4, i4);
    bnf::mul<Fq>(j, h, i4);
    bnf::sub<Fq>(t, s2, y1);
    bnf::dbl<Fq>(rr, t);
    bnf::canon<Fq>(rr, rr);
    bnf::mul<Fq>(v, x1, i4);
    bnf::sqr<Fq>(t, rr);
    bnf::sub<Fq>(t, t, j);
    uint32_t v2[8];
    bnf::dbl<Fq>(v2, v);
    bnf::sub<Fq>(x3, t, v2);
    bnf::sub<Fq>(t, v, x3);
    bnf::mul<Fq>(t, rr, t);
    uint32_t yj[8];
    bnf::mul<Fq>(yj, y1, j);
    bnf::dbl<Fq>(yj, yj);
    bnf::sub<Fq>(y3, t, yj);
    bnf::add<Fq>(t, z1, h);
    bnf::sqr<Fq>(t, t);
    bnf::sub<Fq>(t, t, z1z1);
    bnf::sub<Fq>(z3, t, hh);
    bnf::canon<Fq>(x3, x3);
    bnf::canon<Fq>(y3, y3);
    bnf::canon<Fq>(z3, z3);

    const bool p_inf = bn254::is_zero(z1);
    const bool h_zero = bn254::is_zero(h);
    const bool r_zero = bn254::is_zero(rr);
    const bool q_inf = !valid;
    if (h_zero && r_zero && !p_inf && !q_inf) {
        jac_double(x3, y3, z3, x1, y1, z1);
    }
    if (h_zero && !r_zero && !p_inf && !q_inf) bn254::set_zero(z3);
    if (p_inf) {
        bn254::copy(x3, x2);
        bn254::copy(y3, y2);
#pragma unroll
        for (int w = 0; w < 8; ++w) z3[w] = Fq::one(w);
    }
    if (!q_inf) {  // q at infinity leaves (x1, y1, z1) as it is
        bn254::copy(x1, x3);
        bn254::copy(y1, y3);
        bn254::copy(z1, z3);
    }
}

// 16 int64 limbs of point q (stride P between limbs) -> 8 words.
BN_HD void load_limbs(uint32_t w[8], const int64_t* a, int64_t P, int64_t q) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
        w[k] = (uint32_t)a[(2 * k) * P + q] | ((uint32_t)a[(2 * k + 1) * P + q] << 16);
}

// The serial scan's state: the Jacobian accumulator and the current digit.
struct ScanState {
    uint32_t x[8], y[8], z[8];
    int64_t seg;
};

BN_HD void scan_reset(ScanState& st) {
    bn254::set_zero(st.x);
    bn254::set_zero(st.y);
    bn254::set_zero(st.z);
    st.seg = -1;
}

// One step of the serial scan: the point (ex, ey) with digit eseg.
BN_HD void scan_apply(ScanState& st, int64_t eseg, const uint32_t ex[8], const uint32_t ey[8],
                      bool valid) {
    if (eseg != st.seg) bn254::set_zero(st.z);
    jac_madd(st.x, st.y, st.z, ex, ey, valid);
    st.seg = eseg;
}

#ifndef __CUDACC__
BN_HD void store_limbs(int64_t* a, int64_t P, int64_t q, const uint32_t w[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        a[(2 * k) * P + q] = w[k] & 0xffffu;
        a[(2 * k + 1) * P + q] = w[k] >> 16;
    }
}

// Lane `g` of the scan, one thread's work written straight to memory (the
// host harness's reference of the kernel below): positions [g L, (g + 1) L).
// seg: (P) digits, valid: (P) flags, px, py, ox, oy, oz: (16, P) limbs;
// L divides P.
BN_HD void scan_lane(const int64_t* seg, const uint8_t* valid, const int64_t* px,
                     const int64_t* py, int64_t* ox, int64_t* oy, int64_t* oz, int64_t P, int L,
                     int64_t g) {
    ScanState st;
    scan_reset(st);
    for (int64_t q = g * L; q < (g + 1) * L; ++q) {
        uint32_t ex[8], ey[8];
        load_limbs(ex, px, P, q);
        load_limbs(ey, py, P, q);
        scan_apply(st, seg[q], ex, ey, valid[q] != 0);
        store_limbs(ox, P, q, st.x);
        store_limbs(oy, P, q, st.y);
        store_limbs(oz, P, q, st.z);
    }
}
#endif

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_FLUSH = 4;              // steps a warp stages before it stores them
constexpr int SCAN_SLOT = 24 * 32 + 8;     // words of one staged step of a warp (padded)
constexpr int SCAN_WARP_WORDS = SCAN_FLUSH * SCAN_SLOT;

// The kernel: thread g runs lane g. Its L steps run in lock step across
// the warp in groups of SCAN_FLUSH, through the warp's slice of shared
// memory: the warp loads the group's points (lane (t, k) of each load
// reading step k of thread t, so one load takes 8 whole 32-byte sectors:
// 4 consecutive positions of 8 threads), each thread runs its steps from
// there and stages its outputs (24 words a step) in the same slots, and the
// warp stores them as int64 limbs the way it loaded. Word w of step k of
// lane t sits at k * SCAN_SLOT + w * 32 + t: every shared access of the
// warp hits 32 distinct banks. No __launch_bounds__: with one, ptxas held
// the kernel to 168 registers and spilled, 4-5 % slower on the H100
// (PERF.md); without, it takes 176 and spills nothing.
__global__ void
msm_scan_kernel(const int64_t* __restrict__ seg, const uint8_t* __restrict__ valid,
                const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                int64_t* __restrict__ ox, int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                int64_t P, int L) {
    extern __shared__ uint32_t stage[];
    const int lane = threadIdx.x & 31;
    uint32_t* warp_stage = stage + (threadIdx.x >> 5) * SCAN_WARP_WORDS;
    const int64_t threads = P / L;
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t g0 = g - lane;
    const bool live = g < threads;
    const int64_t start = g * L;
    ScanState st;
    scan_reset(st);
    int64_t* const outs[3] = {ox, oy, oz};
    const int k = lane & 3;
    for (int k0 = 0; k0 < L; k0 += SCAN_FLUSH) {
#pragma unroll 1
        for (int group = 0; group < 4; ++group) {
            const int t = group * 8 + (lane >> 2);
            if (g0 + t >= threads) continue;
            const int64_t q = (g0 + t) * L + k0 + k;
            uint32_t* slot = warp_stage + k * SCAN_SLOT + t;
            uint32_t w8[8];
            load_limbs(w8, px, P, q);
#pragma unroll
            for (int w = 0; w < 8; ++w) slot[w * 32] = w8[w];
            load_limbs(w8, py, P, q);
#pragma unroll
            for (int w = 0; w < 8; ++w) slot[(8 + w) * 32] = w8[w];
        }
        __syncwarp();
        if (live) {
#pragma unroll 1
            for (int j = 0; j < SCAN_FLUSH; ++j) {
                const int64_t q = start + k0 + j;
                uint32_t* slot = warp_stage + j * SCAN_SLOT + lane;
                uint32_t ex[8], ey[8];
#pragma unroll
                for (int w = 0; w < 8; ++w) {
                    ex[w] = slot[w * 32];
                    ey[w] = slot[(8 + w) * 32];
                }
                scan_apply(st, seg[q], ex, ey, valid[q] != 0);
#pragma unroll
                for (int w = 0; w < 8; ++w) {
                    slot[w * 32] = st.x[w];
                    slot[(8 + w) * 32] = st.y[w];
                    slot[(16 + w) * 32] = st.z[w];
                }
            }
        }
        __syncwarp();
#pragma unroll 1
        for (int group = 0; group < 4; ++group) {
            const int t = group * 8 + (lane >> 2);
            if (g0 + t >= threads) continue;
            const int64_t q = (g0 + t) * L + k0 + k;
            const uint32_t* slot = warp_stage + k * SCAN_SLOT + t;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
#pragma unroll
                for (int w = 0; w < 8; ++w) {
                    const uint32_t word = slot[(c * 8 + w) * 32];
                    outs[c][(2 * w) * P + q] = word & 0xffffu;
                    outs[c][(2 * w + 1) * P + q] = word >> 16;
                }
            }
        }
        __syncwarp();
    }
}

extern "C" int msm_scan_cuda(const int64_t* seg, const uint8_t* valid, const int64_t* px,
                             const int64_t* py, int64_t* ox, int64_t* oy, int64_t* oz,
                             int64_t P, int L, void* stream) {
    if (L <= 0 || L % SCAN_FLUSH || P % L) return (int)cudaErrorInvalidValue;
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t threads = P / L;
    int block = SCAN_THREADS;  // halve the block until the grid covers every SM
    while (block > 32 && (threads + block - 1) / block < sms) block /= 2;
    const int64_t blocks = (threads + block - 1) / block;
    const size_t smem = (size_t)(block / 32) * SCAN_WARP_WORDS * sizeof(uint32_t);
    cudaFuncSetAttribute(msm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)((SCAN_THREADS / 32) * SCAN_WARP_WORDS * sizeof(uint32_t)));
    if (blocks > 0)
        msm_scan_kernel<<<(unsigned)blocks, block, smem, (cudaStream_t)stream>>>(
            seg, valid, px, py, ox, oy, oz, P, L);
    return (int)cudaGetLastError();
}
#endif
