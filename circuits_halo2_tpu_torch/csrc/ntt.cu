// X1: the number-theoretic transform over Fr in at most two passes over
// device memory, its sub-transforms run in shared memory, with an optional
// per-lane (or constant) factor applied on load and on store.
//
// Replaces: circuits_halo2_tpu/ops/ntt.py::_ntt_core_scan and
// _ntt_device (jitted XLA, not Pallas): a bit-reversal gather and log2(n)
// radix-2 stages over the whole array. The plain torch version is
// ops/ntt.py::ntt_ref (the same stage loop); ops/ntt.py::transform_ref adds
// the factors around it as the unfused sequence did (mont_mul, ntt_ref,
// mont_mul), and every output here is canonical, so the limbs are equal.
//
// Semantics. Row r of the contiguous (16, rows, n_in) int64 limb input,
// lanes j >= n_in taken as 0, goes to row r of the contiguous (16, rows, n)
// output: out[k] = so(k) sum_j si(j) a[j] w^(j k), w a primitive n-th root
// given as the packed table tw[e] = w^e (e < n), si and so packed per-lane
// tables or constants (step 0), or absent.
//
// Four-step. n = n1 n2, input index j = j1 + n1 j2, output k = k2 + n2 k1:
//   out[k2 + n2 k1] = sum_j1 (w^n2)^(j1 k1) w^(j1 k2) sum_j2 a[j1 + n1 j2] (w^n1)^(j2 k2)
// - pass A: a block takes W consecutive j1 of one row (the W int64 of a
//   limb row at one j2 are contiguous, so a warp's loads are whole
//   sectors), loads their n2-point columns at stride n1 into shared memory,
//   runs the n2-point transforms, multiplies by w^(j1 k2) and writes
//   32-byte packed words to the scratch (rows, n2, n1, 8);
// - pass B: a block takes W consecutive k2, reads their contiguous n1-point
//   rows of the scratch, runs the n1-point transforms, applies so,
//   canonicalises and writes int64 limbs to out[k2 + n2 k1] (W contiguous
//   int64 of a limb row at each k1).
// For n <= 2^ONE_PASS_MAX_LOG = 2^11 one pass takes whole rows: W rows a
// block, or, where the rows are too few to give every SM a block, a row
// over a cluster of up to 8 blocks, whose stages with pairs in two blocks
// reach the other block's shared memory through the cluster (distributed
// shared memory) with a cluster barrier between stages. At the entry_16
// k=11 prove's 2^11 transforms (19 and 20 rows) that takes 0.028 ms of
// device time, two passes 0.040-0.042 and a block a row 0.065; at 9 rows
// the cluster and two passes both take 0.024 (H100 80GB HBM3, 700 W;
// scripts/time_kernels.py --kernels x1plan). The bit reversal of the
// radix-2 DIT is in the addressing: thread i of a load fills shared slot i
// from input element rev(i), so there is no gather and the shared-memory
// stores are conflict-free. The input is read through the wrapper's contiguous copy
// (ops/ntt.py makes a strided view contiguous: only parallel/ntt_sharded
// hands one over, off the single-card path).
//
// Shared memory (dynamic): the block's W lines of m points as 8 planes of
// 32-bit words, word k of point (line, pos) at k * W * LS + line * LS +
// pos, LS = m + pad with pad = 32 / W (1 from W = 32), so a warp reading W
// lines at 32 / W consecutive positions, or one line at 32, hits 32 banks;
// then each stage's twiddles, stage s (half = 2^s) at slots 2^s - 1 + k,
// again as 8 planes, so the k-th butterflies of a warp read consecutive
// slots. Stage s's twiddle k is w^(k n / 2^(s+1)) = tw[k << (logn - 1 - s)]
// for a sub-transform of any size, so one n-word table serves both passes,
// the cross factor w^(j1 k2) = tw[j1 k2] (j1 k2 < n) included: one table,
// not two small ones and a product, at one more 32-byte read an element.
// W m <= 2^11 points a block (64 KB) and m - 1 twiddles (at most 64 KB for
// the one pass of 2^11, 32 KB for m = 2^10): two blocks an SM up to m =
// 2^10, one for the 2^11 one-pass row.
//
// Stages run two a barrier (stage_pair: four points a thread, in
// registers) where both lie inside a block's points, the odd one and a
// cluster's cross-block stages one at a time.
//
// Arithmetic: bn254_fast.cuh's lazy product and add / sub on [0, 2p): the
// input (canonical) and its factor give a product below 2p, every
// butterfly keeps [0, 2p), pass B canonicalises once before the store.
//
// What bounds it (chip_smoke.py's x1_bound). The products a radix-2
// transform cannot skip, (n / 2) log2(n) less the n - 1 whose twiddle is 1
// (log2(n) / 2 - 1 an element), 132 wide multiplies each, with the int64
// limbs read once and written once (128 + 128 bytes an element). This
// design does (log2 n - 1) / 2 products an element, half a product more
// (each pass's first stage pair skips the 3 / 4 of a product an element
// whose twiddle is 1, the cross factor adds one), plus the factors on load
// and store; it reads
// 128 bytes (+ 32 of the cross twiddle from L2) and writes 32 in pass A,
// reads 32 and writes 128 in pass B: 320 bytes of device memory an
// element, not the stage loop's 16 x 256 + 256.

#include <cstddef>

#include "bn254_fast.cuh"
#include "field_ops.cuh"

namespace x1 {

using bn254::Fr;

// The two settings of the plan. A build for measuring the plans against each
// other (scripts/time_kernels.py) may lower them with -D; the library never does.
#ifndef X1_ONE_PASS_MAX_LOG
#define X1_ONE_PASS_MAX_LOG 11
#endif
#ifndef X1_MAX_CLUSTER_LOG
#define X1_MAX_CLUSTER_LOG 3
#endif

constexpr int BLOCK_POINTS_LOG = 11;  // W m <= 2^11 points a block
constexpr int MAX_THREADS = 256;
constexpr int ONE_PASS_MAX_LOG = X1_ONE_PASS_MAX_LOG;  // one pass up to 2^11 points
constexpr int MAX_CLUSTER_LOG = X1_MAX_CLUSTER_LOG;  // 8 blocks, the portable cluster size
constexpr int MAX_LOGN = 22;        // two passes of at most 2^11 points
static_assert(ONE_PASS_MAX_LOG <= BLOCK_POINTS_LOG, "a one-pass row must fit a block's plan");

enum Kind { ONE_PASS = 0, PASS_A = 1, PASS_B = 2 };

// One launch: its kind, log2 of the sub-transform's points m, of the
// lines W a block holds and of the blocks C of a cluster that share one line
// (one pass only: each holds m / C of its points), a line's stride in
// shared memory, the threads a block and the blocks.
struct Pass {
    int kind, lm, lw, lc, ls, threads;
    int64_t blocks;
};

// What every launch reads: the contiguous (16, rows, n_in) input, the
// (16, rows, n) output, the (rows, n2, n1, 8) scratch, the (n, 8) table of
// w^e, the factors (packed (L, 8) words; step 0 for a constant, 1 per
// lane; null for none).
struct Args {
    const int64_t* in;
    int64_t* out;
    uint32_t* scratch;
    const uint32_t* tw;
    const uint32_t* si;
    const uint32_t* so;
    int si_step, so_step;
    int logn, log_n1, log_n2;
    int64_t rows, n_in;
};

BN_HD int ilog2(int64_t v) {
    int r = 0;
    while (((int64_t)2 << r) <= v) ++r;
    return r;
}

BN_HD uint32_t bit_rev(uint32_t x, int bits) {
    if (bits == 0) return 0;
#ifdef __CUDA_ARCH__
    return __brev(x) >> (32 - bits);
#else
    uint32_t r = 0;
    for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1u) << (bits - 1 - i);
    return r;
#endif
}

// A pass of `lines` lines of 2^lm points, W = 2^lw of them a block (a
// block stays within a row: W <= 2^max_lw): W as large as 2^11 points a
// block allow, at most the lines, then halved while the grid has fewer
// than target_blocks (the launcher's SM count), so small transforms still
// spread over the card. A one-pass line that still leaves the grid short
// is spread over a cluster of up to 2^MAX_CLUSTER_LOG blocks, each holding
// at least 64 of its points. W m / C / 8 threads a block (four butterflies
// a stage each; two in a cluster, whose lines are few), 32 to 256.
static inline Pass make_pass(int kind, int lm, int64_t lines, int max_lw, int target_blocks) {
    Pass p;
    p.kind = kind;
    p.lm = lm;
    p.lw = BLOCK_POINTS_LOG > lm ? BLOCK_POINTS_LOG - lm : 0;
    if (p.lw > max_lw) p.lw = max_lw;
    while (p.lw > 0 && ((int64_t)1 << p.lw) >= 2 * lines) --p.lw;
    while (p.lw > 0 && (lines >> p.lw) < target_blocks) --p.lw;
    p.lc = 0;
    while (kind == ONE_PASS && p.lw == 0 && p.lc < MAX_CLUSTER_LOG && lm - p.lc > 6
           && (lines << p.lc) < target_blocks)
        ++p.lc;
    const int lp = lm - p.lc;  // log2 of a block's points of a line
    p.ls = (1 << lp) + (p.lw >= 5 ? 1 : (32 >> p.lw));
    const int64_t points = (int64_t)1 << (lp + p.lw), per = p.lc ? 4 : 8;
    p.threads = (int)(points / per < 32 ? 32 : points / per > MAX_THREADS ? MAX_THREADS
                                                                         : points / per);
    p.blocks = ((lines + ((int64_t)1 << p.lw) - 1) >> p.lw) << p.lc;
    return p;
}

// The launches of an n = 2^logn transform of `rows` rows: one pass up to
// 2^one_pass_max_log points, else pass A over the n2 = 2^floor(logn / 2)
// point columns and pass B over the n1-point rows. Returns the count.
static inline int plan(int logn, int64_t rows, int one_pass_max_log, int target_blocks, Args& a,
                       Pass ps[2]) {
    a.logn = logn;
    if (logn <= one_pass_max_log) {
        a.log_n1 = logn;
        a.log_n2 = 0;
        ps[0] = make_pass(ONE_PASS, logn, rows, BLOCK_POINTS_LOG, target_blocks);
        return 1;
    }
    a.log_n2 = logn / 2;
    a.log_n1 = logn - a.log_n2;
    ps[0] = make_pass(PASS_A, a.log_n2, rows << a.log_n1, a.log_n1, target_blocks);
    ps[1] = make_pass(PASS_B, a.log_n1, rows << a.log_n2, a.log_n2, target_blocks);
    return 2;
}

// Dynamic shared memory of a block, in bytes: its lines and the twiddles of
// the stages inside them.
static inline size_t smem_bytes(const Pass& p) {
    const size_t m = (size_t)1 << (p.lm - p.lc);
    return 4 * 8 * (((size_t)p.ls << p.lw) + m);
}

BN_HD void sm_get(uint32_t v[8], const uint32_t* sm, int plane, int i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = sm[k * plane + i];
}

BN_HD void sm_put(uint32_t* sm, int plane, int i, const uint32_t v[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[k * plane + i] = v[k];
}

// element e of a packed (L, 8) word array
BN_HD void packed_get(uint32_t v[8], const uint32_t* p, int64_t e) {
#ifdef __CUDA_ARCH__
    const uint4* q = reinterpret_cast<const uint4*>(p + 8 * e);
    const uint4 lo = __ldg(q), hi = __ldg(q + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
#else
    for (int k = 0; k < 8; ++k) v[k] = p[8 * e + k];
#endif
}

BN_HD void packed_put(uint32_t* p, int64_t e, const uint32_t v[8]) {
#ifdef __CUDA_ARCH__
    uint4* q = reinterpret_cast<uint4*>(p + 8 * e);
    q[0] = make_uint4(v[0], v[1], v[2], v[3]);
    q[1] = make_uint4(v[4], v[5], v[6], v[7]);
#else
    for (int k = 0; k < 8; ++k) p[8 * e + k] = v[k];
#endif
}

// input element j of `row` into v (0 for j >= n_in), times si(j)
BN_HD void load_input(uint32_t v[8], const Args& a, int64_t row, int64_t j) {
    if (j >= a.n_in) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0;
        return;
    }
    fops::load(v, a.in, a.rows * a.n_in, row * a.n_in + j);
    if (a.si) {
        uint32_t s[8];
        packed_get(s, a.si, j * a.si_step);
        bnf::mul<Fr>(v, v, s);
    }
}

// v (< 2p) times so(k), canonical, to output element k of `row`
BN_HD void store_output(const Args& a, int64_t row, int64_t k, uint32_t v[8]) {
    if (a.so) {
        uint32_t s[8];
        packed_get(s, a.so, k * a.so_step);
        bnf::mul<Fr>(v, v, s);
    }
    bnf::canon<Fr>(v, v);
    fops::store(a.out, a.rows << a.logn, (row << a.logn) + k, v);
}

// ---------------------------------------------------------------------------
// A block's phases; thread `tid` of p.threads does its share of each, the
// block (the cluster, for a line spread over one) synchronising between
// them (the g++ harness runs every thread of a phase, in every block of a
// cluster, before the next phase). `blk` is the block's index, a cluster's
// for a spread line, and `rank` the block's in its cluster.
// ---------------------------------------------------------------------------

// The twiddles of stages s < lm - lc (the stages inside a block's points)
// into the shared slots after the lines.
BN_HD void load_twiddles(uint32_t* sm, const Pass& p, const Args& a, int tid) {
    const int m = 1 << (p.lm - p.lc);
    uint32_t* t = sm + 8 * (p.ls << p.lw);
    for (int i = tid; i < m - 1; i += p.threads) {
        const int s = ilog2(i + 1);
        const int64_t k = i + 1 - (1 << s);
        uint32_t w[8];
        packed_get(w, a.tw, k << (a.logn - 1 - s));
        sm_put(t, m, i, w);
    }
}

// The block's W lines (its part of a spread line) into shared memory,
// point pos of a line from input point rev(pos) of its sub-transform.
BN_HD void load_lines(uint32_t* sm, const Pass& p, const Args& a, int64_t blk, int rank,
                      int tid) {
    const int lm = p.lm, lw = p.lw, lp = lm - p.lc, plane = p.ls << lw;
    const int count = 1 << (lp + lw);
    for (int i = tid; i < count; i += p.threads) {
        uint32_t v[8];
        int line, pos;
        if (p.kind == PASS_A) {  // W consecutive j1 of a row, the line index fastest
            line = i & ((1 << lw) - 1);
            pos = i >> lw;
            const int64_t lines = (int64_t)1 << (a.log_n1 - lw);
            const int64_t row = blk / lines;
            const int64_t j1 = ((blk % lines) << lw) + line;
            load_input(v, a, row, j1 + ((int64_t)bit_rev(pos, lm) << a.log_n1));
        } else {
            line = i >> lp;
            pos = i & ((1 << lp) - 1);
            const int64_t r = (blk << lw) + line;  // a row (one pass) or a (row, k2) line
            const uint32_t src = bit_rev((rank << lp) + pos, lm);
            if (p.kind == ONE_PASS) {
                if (r < a.rows)
                    load_input(v, a, r, src);
                else
                    for (int k = 0; k < 8; ++k) v[k] = 0;
            } else {
                packed_get(v, a.scratch, (r << lm) + src);
            }
        }
        sm_put(sm, plane, line * p.ls + pos, v);
    }
}

BN_HD void butterfly(uint32_t* su, int iu, uint32_t* sv, int iv, int plane, const uint32_t w[8]) {
    uint32_t u[8], v[8], x[8];
    sm_get(u, su, plane, iu);
    sm_get(v, sv, plane, iv);
    bnf::mul<Fr>(x, v, w);
    bnf::sub<Fr>(v, u, x);
    bnf::add<Fr>(u, u, x);
    sm_put(su, plane, iu, u);
    sm_put(sv, plane, iv, v);
}

// Radix-2 DIT stage s of every line: (u, v) -> (u + w v, u - w v). A stage
// whose pairs lie in two blocks of a cluster (half >= the block's points)
// reads and writes the other block's shared memory through peer(sm, rank):
// the pair's lower block takes the first half of its pairs, the upper block
// the second, with the twiddle from the table in device memory.
template <class Peer>
BN_HD void stage(uint32_t* sm, const Pass& p, const Args& a, int s, int rank, int tid,
                 const Peer& peer) {
    const int lp = p.lm - p.lc, plane = p.ls << p.lw, half = 1 << s;
    const int count = 1 << (lp - 1 + p.lw);
    if (s >= lp) {  // across blocks (one line a block)
        const int d = 1 << (s - lp), hi = rank & d;
        uint32_t* other = peer(sm, rank ^ d);
        uint32_t* su = hi ? other : sm;
        uint32_t* sv = hi ? sm : other;
        for (int b = tid; b < count; b += p.threads) {
            const int q = b + (hi ? count : 0);  // the point in the lower block
            const int64_t k = (((int64_t)(rank & ~d) << lp) + q) & (half - 1);
            uint32_t w[8];
            packed_get(w, a.tw, k << (a.logn - 1 - s));
            butterfly(su, q, sv, q, plane, w);
        }
        return;
    }
    const uint32_t* t = sm + 8 * plane;
    for (int b = tid; b < count; b += p.threads) {
        const int line = b >> (lp - 1), j = b & ((1 << (lp - 1)) - 1);
        const int k = j & (half - 1);
        const int iu = line * p.ls + ((j >> s) << (s + 1)) + k;
        uint32_t w[8];
        sm_get(w, t, 1 << lp, half - 1 + k);
        butterfly(sm, iu, sm, iu + half, plane, w);
    }
}

// Stages s and s + 1 (both inside a block's points) at once, one thread a
// group of four points q + {0, 1, 2, 3} half: (q, q + half) and (q + 2 half,
// q + 3 half) with w_s(k), then (q, q + 2 half) with w_s+1(k) and
// (q + half, q + 3 half) with w_s+1(k + half), the four values in
// registers: half the barriers and shared-memory traffic of two stages,
// and two independent products at a time. At s = 0 three of the four
// twiddles are 1 (k = 0), for every thread alike, and their products are
// skipped: 3 m / 4 of a sub-transform's (m / 2) log2(m) products.
BN_HD void stage_pair(uint32_t* sm, const Pass& p, int s, int tid) {
    const int lp = p.lm - p.lc, plane = p.ls << p.lw, half = 1 << s;
    const uint32_t* t = sm + 8 * plane;
    const int count = 1 << (lp - 2 + p.lw);
    for (int b = tid; b < count; b += p.threads) {
        const int line = b >> (lp - 2), j = b & ((1 << (lp - 2)) - 1);
        const int k = j & (half - 1);
        const int i0 = line * p.ls + ((j >> s) << (s + 2)) + k;
        uint32_t x[4][8], w[8], y[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) sm_get(x[c], sm, plane, i0 + c * half);
        const bool first = s == 0;
        if (!first) sm_get(w, t, 1 << lp, half - 1 + k);
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
            if (first)
                bn254::copy(y, x[c + 1]);
            else
                bnf::mul<Fr>(y, x[c + 1], w);
            bnf::sub<Fr>(x[c + 1], x[c], y);
            bnf::add<Fr>(x[c], x[c], y);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            if (first && c == 0) {
                bn254::copy(y, x[2]);
            } else {
                sm_get(w, t, 1 << lp, 2 * half - 1 + k + c * half);
                bnf::mul<Fr>(y, x[c + 2], w);
            }
            bnf::sub<Fr>(x[c + 2], x[c], y);
            bnf::add<Fr>(x[c], x[c], y);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) sm_put(sm, plane, i0 + c * half, x[c]);
    }
}

// The transformed lines out: pass A times w^(j1 k2) to the scratch, the
// others through store_output.
BN_HD void store_lines(uint32_t* sm, const Pass& p, const Args& a, int64_t blk, int rank,
                       int tid) {
    const int lw = p.lw, lp = p.lm - p.lc, plane = p.ls << lw;
    const int count = 1 << (lp + lw);
    for (int i = tid; i < count; i += p.threads) {
        uint32_t v[8];
        if (p.kind == ONE_PASS) {  // along a row: consecutive k
            const int line = i >> lp, k = i & ((1 << lp) - 1);
            const int64_t row = (blk << lw) + line;
            if (row >= a.rows) continue;
            sm_get(v, sm, plane, line * p.ls + k);
            store_output(a, row, ((int64_t)rank << lp) + k, v);
            continue;
        }
        const int line = i & ((1 << lw) - 1), pos = i >> lw;  // W lines at each point
        sm_get(v, sm, plane, line * p.ls + pos);
        if (p.kind == PASS_A) {
            const int64_t lines = (int64_t)1 << (a.log_n1 - lw);
            const int64_t row = blk / lines;
            const int64_t j1 = ((blk % lines) << lw) + line, k2 = pos;
            uint32_t w[8];
            packed_get(w, a.tw, j1 * k2);
            bnf::mul<Fr>(v, v, w);
            packed_put(a.scratch, (((row << a.log_n2) + k2) << a.log_n1) + j1, v);
        } else {
            const int64_t lines = (int64_t)1 << (a.log_n2 - lw);
            const int64_t row = blk / lines;
            const int64_t k2 = ((blk % lines) << lw) + line, k1 = pos;
            store_output(a, row, k2 + (k1 << a.log_n2), v);
        }
    }
}

}  // namespace x1

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// Another block's shared memory, at the same offset, in the cluster's window
struct ClusterPeer {
    __device__ uint32_t* operator()(uint32_t* sm, int rank) const {
        return cg::this_cluster().map_shared_rank(sm, rank);
    }
};

__device__ __forceinline__ void barrier(const x1::Pass& p) {
    if (p.lc)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

__global__ void __launch_bounds__(x1::MAX_THREADS, 2)
ntt_pass_kernel(x1::Args a, x1::Pass p) {
    extern __shared__ uint32_t sm[];
    const int tid = threadIdx.x;
    const int rank = p.lc ? (int)cg::this_cluster().block_rank() : 0;
    const int64_t blk = blockIdx.x >> p.lc;
    x1::load_twiddles(sm, p, a, tid);
    x1::load_lines(sm, p, a, blk, rank, tid);
    barrier(p);
    const int lp = p.lm - p.lc;
    int s = 0;
    for (; s + 1 < lp; s += 2) {
        x1::stage_pair(sm, p, s, tid);
        barrier(p);
    }
    for (; s < p.lm; ++s) {
        x1::stage(sm, p, a, s, rank, tid, ClusterPeer());
        barrier(p);  // also keeps every block of a cluster alive until no peer reads it
    }
    x1::store_lines(sm, p, a, blk, rank, tid);
}

}  // namespace

static int target_blocks() {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return sms;
}

// The plan ntt_cuda takes for `rows` rows of 2^logn points on the current
// device: for each launch its kind, log2 of its lines a block and of its
// cluster, its threads and its blocks (five int64 a launch into desc).
// Returns the launches.
extern "C" int ntt_plan_cuda(int64_t rows, int logn, int64_t* desc) {
    x1::Args a{};
    x1::Pass ps[2];
    const int launches = x1::plan(logn, rows, x1::ONE_PASS_MAX_LOG, target_blocks(), a, ps);
    for (int i = 0; i < launches; ++i) {
        const int64_t d[5] = {ps[i].kind, ps[i].lw, ps[i].lc, ps[i].threads, ps[i].blocks};
        for (int k = 0; k < 5; ++k) desc[5 * i + k] = d[k];
    }
    return launches;
}

// The transform of `rows` rows (see the top of this file); scratch holds
// rows n 8 words when logn > ONE_PASS_MAX_LOG. Every launch is checked.
extern "C" int ntt_cuda(const int64_t* in, int64_t* out, uint32_t* scratch, const uint32_t* tw,
                        const uint32_t* si, int si_step, const uint32_t* so, int so_step,
                        int64_t rows, int64_t n_in, int logn, void* stream) {
    if (logn < 0 || logn > x1::MAX_LOGN || rows < 1 || n_in < 1 || n_in > ((int64_t)1 << logn)
        || (rows << logn) >= ((int64_t)1 << 31))
        return (int)cudaErrorInvalidValue;
    x1::Args a{in, out, scratch, tw, si, so, si_step, so_step, 0, 0, 0, rows, n_in};
    x1::Pass ps[2];
    const int launches = x1::plan(logn, rows, x1::ONE_PASS_MAX_LOG, target_blocks(), a, ps);
    static bool opted_in = false;
    if (!opted_in) {
        int device = 0, most = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        const int err = (int)cudaFuncSetAttribute(
            ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err) return err;
        opted_in = true;
    }
    for (int i = 0; i < launches; ++i) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute cluster[1];
        cfg.gridDim = dim3((unsigned)ps[i].blocks);
        cfg.blockDim = dim3(ps[i].threads);
        cfg.dynamicSmemBytes = x1::smem_bytes(ps[i]);
        cfg.stream = (cudaStream_t)stream;
        cluster[0].id = cudaLaunchAttributeClusterDimension;
        cluster[0].val.clusterDim.x = 1u << ps[i].lc;
        cluster[0].val.clusterDim.y = cluster[0].val.clusterDim.z = 1;
        cfg.attrs = cluster;
        cfg.numAttrs = ps[i].lc ? 1 : 0;
        const int err = (int)cudaLaunchKernelEx(&cfg, ntt_pass_kernel, a, ps[i]);
        if (err) return err;
        const int after = (int)cudaGetLastError();
        if (after) return after;
    }
    return 0;
}
#endif
