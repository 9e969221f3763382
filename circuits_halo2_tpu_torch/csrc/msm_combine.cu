// X2: the MSM's window combine -- each commitment's 32 x 32 Jacobian bucket
// partials folded into one affine point on the card.
//
// Replaces the host's fold of the same partials (ops/msm.py::
// _combine_windows_host: an inversion a partial and a host Pippenger over
// the 1,024 small points), which CPU tensors still take. Its counterpart in
// the JAX package, circuits_halo2_tpu/ops/msm.py, is the window fold: the
// host's over 32 window sums (:617 _combine_windows_host) and the XLA
// Horner of its sharded path (:585 _pippenger_core). The port's bucket
// stage hands back 32 partials a window instead of one window sum
// (ops/msm.py::_pippenger_windows), so X2 starts a level lower.
//
// Semantics. The input is the bucket stage's (16, B, NWIN, PARTS) int64
// limbs of X, Y and Z, Montgomery Fq, canonical (Z = 0 at infinity). With
// S[w, i] the partial of window w, commitment b's point is
//   sum_{w, i} PARTIAL_WEIGHTS[i] 2^(8 w) S[w, i],
// PARTIAL_WEIGHTS = 16 g for the row sums (i = g < 16) and r for the column
// sums (i = 16 + r). Over 64 nibble windows j that is
//   sum_j 2^(4 j) T_j,   T_j = sum_{d=1..15} d P_{j,d},
// P_{2w,d} = S[w, 16 + d] and P_{2w+1,d} = S[w, d]; the partials of
// weight 0 (i = 0, 16) are never read. The output is a (B, 17) int64 row a
// commitment: the affine X's 8 words, Y's 8 words (plain, not Montgomery,
// canonical; each word's 32 bits in an int64) and 1, or 17 zeros where the
// point is at infinity. Every addition is g1::jac_add, every doubling
// g1::jac_double, with the cases of ops/msm.py (infinity, P = Q, P = -Q),
// so the point is the same group element as the host's, and an affine
// point has one canonical form.
//
// What bounds it. One commitment is a dependent chain: 28 complete adds a
// nibble window (the running sum: run += P_d, acc += run, d from 15 down),
// then 252 doublings and 6 adds across the windows (a tree whose levels
// double by 4, 8, ..., 128, one serial doubling chain as long as Horner's),
// then one inversion (X0c's 750 divsteps) and six products: some 265,000
// wide multiplies in a row. The work is 1,798 adds and 768 doublings a
// commitment (about 4.2 million wide multiplies, half a millisecond of
// the card's multiply rate at B = 1,000), so a launch of B blocks takes
// the chain's latency for B up to the SM count. Measured on the H100
// (PERF.md): 1.58 ms a launch for B = 1 to 48, 2.13 ms at 132, 130
// registers and no spill; the chain at one instruction a clock would take
// 0.27 ms.
//
// Design:
// - One block a commitment, one thread a nibble window j (64 threads).
// - Phase 1 (window_sum): thread j reads its 15 partials from global
//   memory, one at a time through a staging slot, and forms T_j by the
//   running sum in its two slots of shared memory.
// - Phase 2 (fold, levels 0-5, a barrier before each): at level l the
//   threads j = 0 mod 2^(l+1) double T_{j + 2^l} 4 2^l times in registers
//   and add it to T_j, so after level 5 slot 0 holds the sum.
// - Phase 3 (finish, thread 0): X / Z^2 and Y / Z^3 through one divstep
//   inversion, out of Montgomery form, stored.
// - Shared memory: three points a thread, word w of coordinate c of slot k
//   of thread j at ((3 k + c) 8 + w) 64 + j, so that a warp's accesses hit
//   32 distinct banks (18,432 bytes a block). The complete add reads its
//   operands from there coordinate by coordinate (g1::PointRef).
// The phases are per-thread BN_HD functions, so the host harness of the
// tests runs them block by block in the kernel's order.

#include "field_ops.cuh"
#include "g1_jacobian.cuh"

namespace x2 {

using bn254::Fq;

constexpr int NWIN = 32;     // 8-bit windows (ops/msm.py NWIN)
constexpr int PARTS = 32;    // partials a window: 16 row sums, then 16 column sums
constexpr int SPLIT = 16;    // the first column sum
constexpr int THREADS = 64;  // one a nibble window
constexpr int LEVELS = 6;    // log2 THREADS
constexpr int OUT = 17;      // int64s a commitment: X, Y words, the flag
constexpr int SMEM_WORDS = 3 * 24 * THREADS;

enum Slot { RUN = 0, ACC = 1, PART = 2 };

struct Args {
    const int64_t* x;  // (16, B, NWIN, PARTS) limbs, contiguous
    const int64_t* y;
    const int64_t* z;
    int64_t* out;      // (B, OUT)
    int64_t b;         // commitments
    fops::Words r3;    // R^3 mod q
};

BN_HD g1::PointRef slot(uint32_t* sm, int k, int j) {
    return g1::PointRef{sm + 3 * 8 * THREADS * k + j, THREADS};
}

// partial i of window w of commitment blk into slot k of thread j
BN_HD void load_partial(uint32_t* sm, const Args& a, int64_t blk, int w, int i, int k, int j) {
    const int64_t limb = a.b * NWIN * PARTS;
    const int64_t off = (blk * NWIN + w) * PARTS + i;
    const int64_t* coord[3] = {a.x, a.y, a.z};
    uint32_t v[8];
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
        fops::load(v, coord[c], limb, off);
        g1::put(slot(sm, k, j), c, v);
    }
}

// Phase 1, thread j: T_j = sum_{d=1..15} d P_{j,d} into its ACC slot.
BN_HD void window_sum(uint32_t* sm, const Args& a, int64_t blk, int j) {
    const int w = j >> 1;
    const int first = (j & 1) ? 0 : SPLIT;  // row sums on odd j, column sums on even j
    const g1::PointRef run = slot(sm, RUN, j), acc = slot(sm, ACC, j), part = slot(sm, PART, j);
    load_partial(sm, a, blk, w, first + 15, RUN, j);
    load_partial(sm, a, blk, w, first + 15, ACC, j);
#pragma unroll 1
    for (int d = 14; d >= 1; --d) {
        load_partial(sm, a, blk, w, first + d, PART, j);
        g1::jac_add(run, run, part, false);
        g1::jac_add(acc, acc, run, false);
    }
}

// Phase 2, level l, thread j: T_j += 2^(4 2^l) T_{j + 2^l} where j = 0
// mod 2^(l+1); the other threads wait.
BN_HD void fold(uint32_t* sm, int level, int j) {
    const int h = 1 << level;
    if (j & (2 * h - 1)) return;
    const g1::PointRef hi = slot(sm, ACC, j + h);
    uint32_t x[8], y[8], z[8];
    g1::get(x, hi, 0);
    g1::get(y, hi, 1);
    g1::get(z, hi, 2);
#pragma unroll 1
    for (int i = 0; i < 4 * h; ++i) g1::jac_double(x, y, z, x, y, z);
    g1::put(hi, 0, x);
    g1::put(hi, 1, y);
    g1::put(hi, 2, z);
    g1::jac_add(slot(sm, ACC, j), slot(sm, ACC, j), hi, false);
}

// Phase 3, thread 0: the sum in slot ACC of thread 0 -> commitment blk's row.
BN_HD void finish(uint32_t* sm, const Args& a, int64_t blk) {
    const g1::PointRef p = slot(sm, ACC, 0);
    int64_t* row = a.out + blk * OUT;
    uint32_t x[8], y[8], z[8];
    g1::get(z, p, 2);
    if (bn254::is_zero(z)) {
#pragma unroll 1
        for (int k = 0; k < OUT; ++k) row[k] = 0;
        return;
    }
    g1::get(x, p, 0);
    g1::get(y, p, 1);
    uint32_t zi[8], zi2[8], one[8];
    fops::inv<Fq>(zi, z, a.r3.w);  // Z^-1, Montgomery
    fops::mont_sqr<Fq>(zi2, zi);
    fops::mont_mul<Fq>(zi, zi2, zi);  // Z^-3
    fops::mont_mul<Fq>(x, x, zi2);
    fops::mont_mul<Fq>(y, y, zi);
    bn254::set_zero(one);
    one[0] = 1;
    fops::mont_mul<Fq>(x, x, one);  // out of Montgomery form
    fops::mont_mul<Fq>(y, y, one);
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
        row[k] = x[k];
        row[8 + k] = y[k];
    }
    row[16] = 1;
}

}  // namespace x2

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(x2::THREADS) msm_combine_kernel(x2::Args a) {
    __shared__ uint32_t sm[x2::SMEM_WORDS];
    const int64_t blk = blockIdx.x;
    const int j = threadIdx.x;
    x2::window_sum(sm, a, blk, j);
#pragma unroll 1
    for (int level = 0; level < x2::LEVELS; ++level) {
        __syncthreads();
        x2::fold(sm, level, j);
    }
    __syncthreads();
    if (j == 0) x2::finish(sm, a, blk);
}

// x, y, z: contiguous (16, b, NWIN, PARTS) limbs; out: (b, 17); r3: R^3 mod
// q as 8 little-endian words.
extern "C" int msm_combine_cuda(const int64_t* x, const int64_t* y, const int64_t* z,
                                int64_t* out, int64_t b, const uint32_t* r3, void* stream) {
    if (b < 0 || b >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    x2::Args a{x, y, z, out, b, {}};
    for (int i = 0; i < 8; ++i) a.r3.w[i] = r3[i];
    msm_combine_kernel<<<(unsigned)b, x2::THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
#endif
