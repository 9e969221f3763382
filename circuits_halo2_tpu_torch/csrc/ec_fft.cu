// X4: the EC-FFT over BN254 G1 -- one butterfly stage per launch, two
// threads per butterfly, each multiplying by one GLV half of the twiddle in
// signed 4-bit windows, and a launch that multiplies every point by a
// constant scalar (the n^-1 of the inverse transform) the same way.
//
// Replaces: circuits_halo2_tpu/utils/ec_fft.py::ec_fft_device and its
// jitted stage scan _ec_fft_core (XLA, not Pallas), which rebuilds the
// Lagrange bases of a downsized SRS (ParamsKZG.downsize). The plain torch
// version is ops/ec_fft_kernel.py::ec_fft_ref.
//
// Semantics (identical to ec_fft_ref): the state is n Jacobian points per
// transform, B transforms, in bit-reversed order. Stage s (half = 2^s) takes
// butterfly j of transform b to its pair (u, v) = (q, q + half), q =
// (j / half) 2 half + j % half, computes V = w P_v for the twiddle w =
// omega_s^(j % half), and writes u + V at q and u - V at q + half with the
// complete addition (g1::jac_add). Every output is canonical, so the state
// equals the plain version's limb for limb.
//
// The multiply. BN254 G1 has the endomorphism phi(x, y) = (beta x, y) =
// [lambda] P. The host splits every twiddle as w = k1 + lambda k2 (mod r)
// with |k1|, |k2| < 2^126 (GLV, ops/ec_fft_kernel.glv_split) and recodes
// each half into nd signed 4-bit digits in [-8, 8], least significant first
// (a negative half has its digits negated). Thread h of the pair computes
// R_h = [k_h] P_h with P_0 = P_v and P_1 = phi(P_v) (one Fq product):
// T_m = m P_h for m up to its largest |digit| (T_2m = 2 T_m, T_2m+1 = T_2m +
// T_1), then from its top nonzero digit down, four doublings and one
// complete add of +-T_|d| for each nonzero digit. The pair meets through
// shared memory: each thread computes V = R_0 + R_1 from both accumulators,
// thread 0 writes u + V and thread 1 u - V. The scale pass is the same
// multiply, two threads a point, thread 0 writing R_0 + R_1.
//
// What bounds it on the card. A thread's chain is about 126 doublings (2
// products, 5 squarings) and 32 complete adds (11 products, 5 squarings)
// with its table, against 96 bytes in and out: operations, by far, and
// the latency of one dependent chain of carry chains, since a stage at
// n = 2^13 has only 8,192 threads (one or two warps an SM). The design cuts
// that chain 2.5 times from the reference's LSB-first double-and-add over
// the whole twiddle (about 253 doublings and 127 adds) and doubles the
// threads. Registers: every point (the table, the accumulator, u and V)
// lives in shared memory, 9 slots of 96 bytes a thread, and the complete
// add reads its operands coordinate by coordinate where the formula needs
// them, so no point stays live in registers across it: 154 registers and
// no spill (an SM holds 8 blocks of 32 threads by its shared memory, so
// registers do not limit what it holds).
//
// Layout: the state is (3, 8, B n) 32-bit words (coordinate, word, point),
// so a warp's loads of one word of consecutive points are consecutive; the
// twiddle digits (B, n - 1, 2, nd) int8 hold stage s of transform b at
// columns 2^s - 1 + (0 .. 2^s); the scale digits (B, 2, nd); beta (8)
// Montgomery words. Shared memory: word w of slot e of thread i at
// [(24 e + w) X4_BLOCK + i] (a warp's accesses hit 32 banks).

#include "g1_jacobian.cuh"

constexpr int X4_BLOCK = 32;  // threads a block
// Blocks an SM holds: its 228 KB of shared memory over a block's 27 KB (and
// 1 KB the SM keeps for each block). With it __launch_bounds__ allows 255
// registers; at 16 (128 registers) ptxas spilled 88-208 bytes.
constexpr int X4_BLOCKS_PER_SM = 8;
constexpr int X4_ACC = 8;     // the accumulator; T_1 .. T_8 in slots 0 .. 7
constexpr int X4_SLOTS = 9;
constexpr int X4_WINDOW = 4;

BN_HD g1::PointRef x4_slot(volatile uint32_t* sm, int i, int e) {
    return g1::PointRef{sm + 24 * e * X4_BLOCK + i, X4_BLOCK};
}

// Point q of the (3, 8, stride) state into slot `to`; phi multiplies X by beta.
BN_HD void x4_load(g1::PointRef to, const uint32_t* st, int64_t stride, int64_t q,
                   const uint32_t* beta, bool phi) {
    uint32_t a[8], b[8];
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int w = 0; w < 8; ++w) a[w] = st[(c * 8 + w) * stride + q];
        if (c == 0 && phi) {
#pragma unroll
            for (int w = 0; w < 8; ++w) b[w] = beta[w];
            bnf::mul<bn254::Fq>(a, a, b);
            bnf::canon<bn254::Fq>(a, a);
        }
        g1::put(to, c, a);
    }
}

// Slot `to` = 2^doublings (the point in slot `from`), in registers.
BN_HD void x4_double(g1::PointRef to, g1::PointRef from, int doublings) {
    uint32_t x[8], y[8], z[8];
    g1::get(x, from, 0);
    g1::get(y, from, 1);
    g1::get(z, from, 2);
#pragma unroll 1
    for (int i = 0; i < doublings; ++i) g1::jac_double(x, y, z, x, y, z);
    g1::put(to, 0, x);
    g1::put(to, 1, y);
    g1::put(to, 2, z);
}

// Thread i's slot ACC = sum_w dg[w] 16^w times the point in its slot 0
// (infinity, all words 0, when every digit is 0). Slots 1 .. 7 end as the
// table, as far as the largest |digit| needed it.
BN_HD void x4_window_mul(volatile uint32_t* sm, int i, const int8_t* dg, int nd) {
    int top = -1, most = 0;
#pragma unroll 1
    for (int w = 0; w < nd; ++w) {
        const int d = dg[w];
        if (d) top = w;
        most = d > most ? d : -d > most ? -d : most;
    }
    const g1::PointRef acc = x4_slot(sm, i, X4_ACC), t1 = x4_slot(sm, i, 0);
    uint32_t a[8];
    if (top < 0) {
        bn254::set_zero(a);
#pragma unroll 1
        for (int c = 0; c < 3; ++c) g1::put(acc, c, a);
        return;
    }
#pragma unroll 1
    for (int m = 2; m <= most; ++m) {
        if (m % 2 == 0)
            x4_double(x4_slot(sm, i, m - 1), x4_slot(sm, i, m / 2 - 1), 1);
        else
            g1::jac_add(x4_slot(sm, i, m - 1), x4_slot(sm, i, m - 2), t1, false);
    }
    int d = dg[top];
    const g1::PointRef first = x4_slot(sm, i, (d < 0 ? -d : d) - 1);
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
        g1::get(a, first, c);
        if (c == 1 && d < 0) g1::neg(a, a);
        g1::put(acc, c, a);
    }
#pragma unroll 1
    for (int w = top - 1; w >= 0; --w) {
        x4_double(acc, acc, X4_WINDOW);
        d = dg[w];
        if (d) g1::jac_add(acc, acc, x4_slot(sm, i, (d < 0 ? -d : d) - 1), d < 0);
    }
}

// Thread gt (< B n) of stage s, before the pair meets: its half of the
// butterfly's multiply into slot ACC, and u into slot 1.
BN_HD void x4_stage_half(volatile uint32_t* sm, int i, const uint32_t* st, const int8_t* dg,
                         const uint32_t* beta, int64_t n, int64_t B, int s, int nd, int64_t gt) {
    const int64_t t = gt >> 1, stride = B * n;
    const int h = (int)(gt & 1);
    const int64_t b = t / (n / 2), j = t % (n / 2);
    const int64_t half = (int64_t)1 << s, pos = j & (half - 1);
    const int64_t qu = b * n + ((j >> s) << (s + 1)) + pos;
    x4_load(x4_slot(sm, i, 0), st, stride, qu + half, beta, h);
    x4_window_mul(sm, i, dg + ((b * (n - 1) + half - 1 + pos) * 2 + h) * nd, nd);
    x4_load(x4_slot(sm, i, 1), st, stride, qu, beta, false);
}

// After the pair met: V = R_0 + R_1 into slot 0, then u + V (thread 0) or
// u - V (thread 1) into the state.
BN_HD void x4_stage_finish(volatile uint32_t* sm, int i, uint32_t* st, int64_t n, int64_t B,
                           int s, int64_t gt) {
    const int64_t t = gt >> 1;
    const int h = (int)(gt & 1);
    const int64_t b = t / (n / 2), j = t % (n / 2);
    const int64_t half = (int64_t)1 << s, pos = j & (half - 1);
    const int64_t q = b * n + ((j >> s) << (s + 1)) + pos + h * half;
    const g1::PointRef v = x4_slot(sm, i, 0);
    g1::jac_add(v, x4_slot(sm, i & ~1, X4_ACC), x4_slot(sm, i | 1, X4_ACC), false);
    g1::jac_add(g1::PointRef{st + q, B * n}, x4_slot(sm, i, 1), v, h);
}

// Thread gt (< 2 B n) of the scale pass, before the pair meets.
BN_HD void x4_scale_half(volatile uint32_t* sm, int i, const uint32_t* st, const int8_t* dg,
                         const uint32_t* beta, int64_t n, int64_t B, int nd, int64_t gt) {
    const int64_t q = gt >> 1;
    const int h = (int)(gt & 1);
    x4_load(x4_slot(sm, i, 0), st, B * n, q, beta, h);
    x4_window_mul(sm, i, dg + ((q / n) * 2 + h) * nd, nd);
}

// After the pair met: thread 0 writes R_0 + R_1 over the point.
BN_HD void x4_scale_finish(volatile uint32_t* sm, int i, uint32_t* st, int64_t n, int64_t B,
                           int64_t gt) {
    if (gt & 1) return;
    g1::jac_add(g1::PointRef{st + (gt >> 1), B * n}, x4_slot(sm, i, X4_ACC),
                x4_slot(sm, i | 1, X4_ACC), false);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Both kernels: thread pairs in neighbouring lanes, which meet at a
// __syncwarp after every global read of the pass and before every write
// (each point is read and written by one pair, so the update is in place).
__global__ void __launch_bounds__(X4_BLOCK, X4_BLOCKS_PER_SM)
ec_fft_stage_kernel(uint32_t* st, const int8_t* __restrict__ dg,
                    const uint32_t* __restrict__ beta, int64_t n, int64_t B, int s, int nd) {
    __shared__ uint32_t sm[X4_SLOTS * 24 * X4_BLOCK];
    const int64_t gt = (int64_t)blockIdx.x * X4_BLOCK + threadIdx.x;
    const bool live = gt < B * n;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (!live) return;
    x4_stage_half(sm, threadIdx.x, st, dg, beta, n, B, s, nd, gt);
    __syncwarp(mask);
    x4_stage_finish(sm, threadIdx.x, st, n, B, s, gt);
}

__global__ void __launch_bounds__(X4_BLOCK, X4_BLOCKS_PER_SM)
ec_fft_scale_kernel(uint32_t* st, const int8_t* __restrict__ dg,
                    const uint32_t* __restrict__ beta, int64_t n, int64_t B, int nd) {
    __shared__ uint32_t sm[X4_SLOTS * 24 * X4_BLOCK];
    const int64_t gt = (int64_t)blockIdx.x * X4_BLOCK + threadIdx.x;
    const bool live = gt < 2 * B * n;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (!live) return;
    x4_scale_half(sm, threadIdx.x, st, dg, beta, n, B, nd, gt);
    __syncwarp(mask);
    x4_scale_finish(sm, threadIdx.x, st, n, B, gt);
}

static unsigned x4_blocks(int64_t threads) {
    return (unsigned)((threads + X4_BLOCK - 1) / X4_BLOCK);
}

extern "C" int ec_fft_stage_cuda(uint32_t* st, const int8_t* dg, const uint32_t* beta, int64_t n,
                                 int64_t B, int s, int nd, void* stream) {
    if (n < 2 || (n & (n - 1)) || B < 1 || s < 0 || ((int64_t)2 << s) > n || nd < 1)
        return (int)cudaErrorInvalidValue;
    ec_fft_stage_kernel<<<x4_blocks(B * n), X4_BLOCK, 0, (cudaStream_t)stream>>>(st, dg, beta, n,
                                                                                B, s, nd);
    return (int)cudaGetLastError();
}

extern "C" int ec_fft_scale_cuda(uint32_t* st, const int8_t* dg, const uint32_t* beta, int64_t n,
                                 int64_t B, int nd, void* stream) {
    if (n < 1 || B < 1 || nd < 1) return (int)cudaErrorInvalidValue;
    ec_fft_scale_kernel<<<x4_blocks(2 * B * n), X4_BLOCK, 0, (cudaStream_t)stream>>>(st, dg, beta,
                                                                                    n, B, nd);
    return (int)cudaGetLastError();
}
#endif
