// K4: the ConstantLength<L> Poseidon sponge with every modular reduction
// done as one u8 x u8 -> s32 matrix product on the tensor cores, and K5/K6:
// the probe kernel of the same reduction (ITERS dependent iterations of a
// multiply variant per lane, or one exactness check).
//
// Replaces: poseidon_mxu.py::hash_batch_mxu (kernel body _sponge_kernel) and
// scripts/exp_poseidon_mxu.py::run / ::_check_mxu_mul_exact of the JAX
// package.
//
// Domain: plain residues, no Montgomery factor. Every value between
// operations is canonical (< p) in 8 little-endian 32-bit words. A product
// t = a*b (or the MDS row ca*a + cb*b, < 2p^2 < 2^509) is 64 bytes t_h, and
//
//     t = sum_h t_h 2^(8h)  ==  sum_h t_h c_h  (mod p),   c_h = 2^(8h) mod p
//       =  sum_j 2^(8j) S_j,   S_j = sum_h W[j][h] t_h,   W[j][h] = byte j of c_h
//
// so the reduction is S = T (lanes x 64 byte planes) . W^T (64 x 32 bytes).
//
// Bounds, for this representation. Every entry of W and every byte plane is
// < 2^8, so each S_j <= 64 * 255 * 255 = 4,161,600 < 2^22: the int32
// accumulator of the tensor cores is exact and no operand needs splitting
// (the TPU version split the weights into lo/hi byte rows because bf16 holds
// only 8 exact bits and f32 accumulates exactly only below 2^24). Two
// neighbouring sums pack into one word, S_2i + 2^8 S_2i+1 < 2^31. The value
// V = sum_j S_j 2^(8j) = sum_h t_h c_h < 64 * 255 * p < 2^14 p < 2^268 is
// carried into 9 words (each partial sum < 2^48 in a 64-bit accumulator,
// top word < 2^12). It is then made canonical on the CUDA cores:
// q = floor(a / d) for a = V >> 224 < 2^44 and d = (p >> 224) + 1, so
// q*p <= V and V - q*p < 3p; two conditional subtractions of p finish. The
// quotient is a multiply-high by a reciprocal, not a division:
// q = (a * m) >> 73 with m = ceil(2^73 / d) = 0xa948e8c458b (44 bits) is
// exact, because m*d - 2^73 = 8,361,841 < 2^29, so a * (m*d - 2^73) < 2^73
// for every a < 2^44 (Granlund and Montgomery, PLDI 1994). Products come from
// the carry-chain wide products of bn254_fast.cuh (sqr_wide, mul_wide,
// mul2_wide): canonical operands and canonical MDS constants keep every sum
// below 2p^2 < 2^512, and every add of two canonical values is a modular add
// (sum < 2p < 2^256), so no intermediate leaves its word range. Inputs to
// the sponge may be any value < 2^256 (a raw keccak digest): they are made
// canonical by the same step before they are absorbed.
//
// What bounds it on the card: integer multiply issue on the CUDA cores. Per
// permutation: 144 squarings of 36 word products, 72 products of 64 and 128
// MDS rows of 128 (26,176), and 344 reductions of 12 (8 for q*p, 4 for the
// reciprocal): 30,304 wide multiplies against K1's 49,568, plus 344
// reductions of 32 x 64 x 2 = 4,096 tensor-core operations per lane (1.4 M),
// which the int8 peak of 1,979 T/s covers in a fifth of the multiply time.
//
// Design: one thread per message, 128 threads (4 warps) per block, no shared
// memory. A warp reduces its 32 messages together with 16
// mma.sync.m16n8k32 u8 products (2 m-tiles x 4 n-tiles x 2 k-steps):
// - B = W^T (k = 64 bytes, n = 32 sums) stays in registers for the whole
//   kernel: 16 words per lane, packed on the host in fragment order
//   (ops/poseidon_mxu.py::fragment_weights) and loaded once from __constant__.
// - A = the product bytes. Lane 4g + q holds message row g + 8 (q & 1) of
//   m-tile q >> 1. A word of a product is 4 consecutive k of one row, so the
//   A fragments are whole product words: lane (g, t) needs words t, t+4,
//   t+8, t+12 of each product of its quad, a 4 x 4 transpose of word blocks
//   inside the quad (two __shfl_xor_sync rounds of 8 words, and selects).
// - C: lane (g, t) holds sums 8 nt + 2t and 8 nt + 2t + 1 of the two rows of
//   each m-tile. It packs each pair into one word, and a second transpose of
//   the same shape hands every lane the 16 pairs of its own message.
// Every lane of a warp takes part in each shuffle and product, so the ragged
// tail is masked by loading zeros and storing nothing, never by returning
// early. The index functions of the transposes and fragments are BN_HD: the
// g++ harness of the tests runs them over 32 lane arrays, with a shuffle as
// an array read and the product by the PTX fragment definitions.
// Not wgmma: it reads B from shared memory and needs a warpgroup barrier
// per reduction, the staging this design removes, for tensor-core work that
// is a small part of the kernel's time.

#include "bn254_fast.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MX_FN static __device__ __forceinline__
#else
#define MX_FN static inline
#endif

namespace mxu {

using bn254::Fr;

constexpr uint64_t QRECIP = 0xa948e8c458bull;  // ceil(2^73 / d), d = (p >> 224) + 1

// floor(a / d) for a < 2^44 (the bound in the header).
BN_HD uint32_t quotient(uint64_t a) {
#ifdef __CUDA_ARCH__
    return (uint32_t)(__umul64hi(a, QRECIP) >> 9);
#else
    return (uint32_t)(((unsigned __int128)a * QRECIP) >> 73);
#endif
}

// r = V mod p for V = v[0..7] + v[8] * 2^256 < 2^268.
BN_HD void canon(uint32_t r[8], const uint32_t v[9]) {
    const uint32_t q = quotient(((uint64_t)v[8] << 32) | v[7]);  // V >> 224
    uint32_t t[8];
    uint64_t carry = 0;
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t m = (uint64_t)q * Fr::mod(i) + carry;
        carry = m >> 32;
        int64_t s = (int64_t)v[i] - (int64_t)(uint32_t)m + borrow;
        t[i] = (uint32_t)s;
        borrow = s >> 32;
    }
    const uint32_t top = (uint32_t)((int64_t)v[8] - (int64_t)carry + borrow);  // V - qp < 3p
    bn254::reduce_once<Fr>(r, t, top);
    bn254::reduce_once<Fr>(r, r, 0);
}

// r = sum_i P_i 2^(16i) mod p, for the 16 pair sums P_i = S_2i + 2^8 S_2i+1.
BN_HD void finish_pairs(uint32_t r[8], const uint32_t p[16]) {
    uint32_t v[9];
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        acc += (uint64_t)p[2 * w] + ((uint64_t)p[2 * w + 1] << 16);
        v[w] = (uint32_t)acc;
        acc >>= 32;
    }
    v[8] = (uint32_t)acc;
    canon(r, v);
}

// r = sum_j S_j 2^(8j) mod p, for the 32 column sums S_j < 2^22.
BN_HD void finish(uint32_t r[8], const int32_t s[32]) {
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = (uint32_t)s[2 * i] + ((uint32_t)s[2 * i + 1] << 8);
    finish_pairs(r, p);
}

// Any value < 2^256 -> canonical.
BN_HD void canon256(uint32_t r[8], const uint32_t a[8]) {
    uint32_t v[9];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i];
    v[8] = 0;
    canon(r, v);
}

// The reduction with the matrix product on the host: W row-major (32, 64).
struct HostReducer {
    const uint8_t* w;
    void reduce(uint32_t r[8], const uint32_t t[16]) const {
        int32_t s[32];
        for (int j = 0; j < 32; ++j) {
            int32_t acc = 0;
            for (int h = 0; h < 64; ++h)
                acc += (int32_t)w[j * 64 + h] * (int32_t)((t[h >> 2] >> (8 * (h & 3))) & 0xff);
            s[j] = acc;
        }
        finish(r, s);
    }
};

// ---------------------------------------------------------------------------
// The warp's reduction, lane by lane (g = lane >> 2, q or t = lane & 3)
// ---------------------------------------------------------------------------

// Block s of a product is its words s, s + 4, s + 8, s + 12: x[s][i] = t[4i + s].
BN_HD void word_blocks(uint32_t x[4][4], const uint32_t t[16]) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[s][i] = t[4 * i + s];
}

// The quad transpose: afterwards block s of lane 4g + q is what block q of
// lane 4g + s was. Round 0 exchanges across lane ^ 2 the pairs of blocks
// (u, 2 + u), round 1 across lane ^ 1 the pairs (2u, 2u + 1), u = 0, 1. In
// each pair a lane sends one block, the high one where its lane bit of that
// round is 0, and takes its partner's block into the same slot.
template <int R> BN_HD int xor_mask() { return R == 0 ? 2 : 1; }
template <int R> BN_HD int pair_slot(int u, int hi) { return R == 0 ? 2 * hi + u : 2 * u + hi; }
template <int R> BN_HD bool sends_hi(int lane) { return ((lane >> (1 - R)) & 1) == 0; }

template <int R, int B>
BN_HD void quad_send(uint32_t v[2][B], const uint32_t x[4][B], int lane) {
    const bool hi = sends_hi<R>(lane);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int b = 0; b < B; ++b) v[u][b] = hi ? x[pair_slot<R>(u, 1)][b] : x[pair_slot<R>(u, 0)][b];
}

template <int R, int B>
BN_HD void quad_recv(uint32_t x[4][B], const uint32_t v[2][B], int lane) {
    const bool hi = sends_hi<R>(lane);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int b = 0; b < B; ++b) {
            const int s1 = pair_slot<R>(u, 1), s0 = pair_slot<R>(u, 0);
            x[s1][b] = hi ? v[u][b] : x[s1][b];
            x[s0][b] = hi ? x[s0][b] : v[u][b];
        }
}

// After the first transpose x[q][i] is word 4i + t of lane 4g + q's product.
// The A fragment of m-tile mt, k-step ks (bytes 32 ks .. 32 ks + 31): rows g
// (q = 2 mt) and g + 8 (q = 2 mt + 1), words 8 ks + t and 8 ks + 4 + t.
BN_HD void a_frag(uint32_t a[4], const uint32_t x[4][4], int mt, int ks) {
    a[0] = x[2 * mt][2 * ks];
    a[1] = x[2 * mt + 1][2 * ks];
    a[2] = x[2 * mt][2 * ks + 1];
    a[3] = x[2 * mt + 1][2 * ks + 1];
}

// B fragment words of this lane: b[(ks * 4 + nt) * 2 + reg].
BN_HD int b_index(int ks, int nt, int reg) { return (ks * 4 + nt) * 2 + reg; }

// The C fragment of m-tile mt, n-tile nt holds S_(8 nt + 2t), S_(8 nt + 2t + 1)
// of rows g (c0, c1) and g + 8 (c2, c3): one pair word for each message.
BN_HD void c_pairs(uint32_t y[4][4], const int32_t c[4], int mt, int nt) {
    y[2 * mt][nt] = (uint32_t)c[0] + ((uint32_t)c[1] << 8);
    y[2 * mt + 1][nt] = (uint32_t)c[2] + ((uint32_t)c[3] << 8);
}

// After the second transpose y[s][nt] is lane 4g + s's pair 4 nt + t of this
// lane's message.
BN_HD void lane_pairs(uint32_t p[16], const uint32_t y[4][4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) p[4 * nt + s] = y[s][nt];
}

template <class Red>
MX_FN void pow5(const Red& red, uint32_t x[8]) {
    uint32_t t[16], x2[8], x4[8];
    bnf::sqr_wide(t, x);
    red.reduce(x2, t);
    bnf::sqr_wide(t, x2);
    red.reduce(x4, t);
    bnf::mul_wide(t, x4, x);
    red.reduce(x, t);
}

// One round on canonical plain residues; rc/mds are plain residues.
template <bool FULL, class Red>
MX_FN void perm_round(const Red& red, uint32_t s0[8], uint32_t s1[8], const uint32_t rc[2][8],
                      const uint32_t (*mds)[2][8]) {
    bn254::add<Fr>(s0, s0, rc[0]);
    bn254::add<Fr>(s1, s1, rc[1]);
    pow5(red, s0);
    if (FULL) pow5(red, s1);
    uint32_t t[16], n0[8];
    bnf::mul2_wide(t, s0, mds[0][0], s1, mds[0][1]);
    red.reduce(n0, t);
    bnf::mul2_wide(t, s0, mds[1][0], s1, mds[1][1]);
    red.reduce(s1, t);
    bn254::copy(s0, n0);
}

template <class Red>
MX_FN void permute(const Red& red, uint32_t s0[8], uint32_t s1[8],
                   const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
#pragma unroll 1
    for (int r = 0; r < 4; ++r) perm_round<true>(red, s0, s1, rc[r], mds);
#pragma unroll 1
    for (int r = 4; r < 60; ++r) perm_round<false>(red, s0, s1, rc[r], mds);
#pragma unroll 1
    for (int r = 60; r < 64; ++r) perm_round<true>(red, s0, s1, rc[r], mds);
}

// The sponge for message `idx` of `n` (in is (L, 8, n) words, any value
// < 2^256; cap the canonical capacity word); writes the canonical digest.
// An inactive lane (active == false) reads zeros and still runs every
// reduction with its warp.
template <class Red>
MX_FN void sponge(const Red& red, const uint32_t* in, int L, int64_t n, int64_t idx,
                  bool active, const uint32_t cap[8], uint32_t out[8],
                  const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
    uint32_t s0[8], s1[8];
    bn254::set_zero(s0);
    bn254::copy(s1, cap);
    for (int i = 0; i < L; ++i) {
        uint32_t m[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) m[w] = active ? in[((int64_t)i * 8 + w) * n + idx] : 0u;
        canon256(m, m);
        bn254::add<Fr>(s0, s0, m);
        permute(red, s0, s1, rc, mds);
    }
    bn254::copy(out, s0);
}

// Probe variants (K5; CHECK is K6).
enum Variant { VPU_MUL = 0, BOUNDARY = 1, MXU_MUL = 2, BCAST = 3, CHECK = 4 };
constexpr int BCAST_ROWS = 18;

}  // namespace mxu

#ifdef __CUDACC__
__constant__ uint32_t MXU_RC[64][2][8];
__constant__ uint32_t MXU_MDS[2][2][8];
__constant__ uint32_t MXU_WB[32][16];  // 2048 bytes: W^T as each lane's 16 B-fragment words

constexpr int MXU_THREADS = 128;

// acc (16 x 8 s32) += a (16 x 32 u8, row) . b (32 x 8 u8, col), one warp.
static __device__ __forceinline__ void mma_u8(int32_t c[4], const uint32_t a[4], uint32_t b0,
                                              uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int R, int B>
static __device__ __forceinline__ void quad_round(uint32_t x[4][B], int lane) {
    uint32_t v[2][B];
    mxu::quad_send<R, B>(v, x, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int b = 0; b < B; ++b) v[u][b] = __shfl_xor_sync(0xffffffffu, v[u][b], mxu::xor_mask<R>());
    mxu::quad_recv<R, B>(x, v, lane);
}

struct RegisterReducer {
    uint32_t b[16];  // this lane's B fragments, mxu::b_index order
    int lane;

    __device__ RegisterReducer() : lane((int)(threadIdx.x & 31)) {
#pragma unroll
        for (int i = 0; i < 16; ++i) b[i] = MXU_WB[lane][i];
    }

    __device__ void reduce(uint32_t r[8], const uint32_t t[16]) const {
        uint32_t x[4][4], y[4][4];
        mxu::word_blocks(x, t);
        quad_round<0, 4>(x, lane);
        quad_round<1, 4>(x, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                int32_t c[4] = {0, 0, 0, 0};
#pragma unroll
                for (int ks = 0; ks < 2; ++ks) {
                    uint32_t a[4];
                    mxu::a_frag(a, x, mt, ks);
                    mma_u8(c, a, b[mxu::b_index(ks, nt, 0)], b[mxu::b_index(ks, nt, 1)]);
                }
                mxu::c_pairs(y, c, mt, nt);
            }
        quad_round<0, 4>(y, lane);
        quad_round<1, 4>(y, lane);
        uint32_t p[16];
        mxu::lane_pairs(p, y);
        mxu::finish_pairs(r, p);
    }
};

struct Words8 {
    uint32_t v[8];
};

__global__ void __launch_bounds__(MXU_THREADS)
poseidon_mxu_sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           int L, int64_t n, Words8 cap) {
    const RegisterReducer red;
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = idx < n;
    uint32_t d[8];
    mxu::sponge(red, in, L, n, idx, active, cap.v, d, MXU_RC, MXU_MDS);
    if (active) {
#pragma unroll
        for (int w = 0; w < 8; ++w) out[(int64_t)w * n + idx] = d[w];
    }
}

// x, y, out: (8, n) words for the field variants, (18, n) u32 for BCAST.
template <int V>
__global__ void __launch_bounds__(MXU_THREADS)
poseidon_mxu_probe_kernel(const uint32_t* __restrict__ x_in, const uint32_t* __restrict__ y_in,
                          uint32_t* __restrict__ out, int64_t n, int iters) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = idx < n;
    if (V == mxu::BCAST) {
        if (!active) return;
        uint32_t acc[mxu::BCAST_ROWS];
#pragma unroll
        for (int i = 0; i < mxu::BCAST_ROWS; ++i) acc[i] = x_in[(int64_t)i * n + idx];
        for (int j0 = 0; j0 < iters; j0 += mxu::BCAST_ROWS) {
#pragma unroll
            for (int r = 0; r < mxu::BCAST_ROWS; ++r) {
                if (j0 + r < iters) {
                    const uint32_t b = acc[r];
#pragma unroll
                    for (int i = 0; i < mxu::BCAST_ROWS; ++i) acc[i] = acc[i] + acc[i] * b;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < mxu::BCAST_ROWS; ++i) out[(int64_t)i * n + idx] = acc[i];
        return;
    }
    const RegisterReducer red;
    uint32_t x[8], y[8], t[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        x[w] = active ? x_in[(int64_t)w * n + idx] : 0u;
        y[w] = active ? y_in[(int64_t)w * n + idx] : 0u;
    }
    if (V == mxu::VPU_MUL) {
        for (int it = 0; it < iters; ++it) {
            uint32_t nx[8];
            bn254::mul<bn254::Fr>(nx, x, y);
            bn254::copy(y, x);
            bn254::copy(x, nx);
        }
        bn254::add<bn254::Fr>(x, x, y);
    } else if (V == mxu::MXU_MUL) {
        for (int it = 0; it < iters; ++it) {
            uint32_t nx[8];
            bnf::mul_wide(t, x, y);
            red.reduce(nx, t);
            bn254::copy(y, x);
            bn254::copy(x, nx);
        }
        bn254::add<bn254::Fr>(x, x, y);
    } else if (V == mxu::BOUNDARY) {
        for (int it = 0; it < iters; ++it) {
#pragma unroll
            for (int w = 0; w < 8; ++w) t[w] = t[w + 8] = x[w];
            red.reduce(x, t);
        }
    } else {  // CHECK
        bnf::mul_wide(t, x, y);
        red.reduce(x, t);
    }
    if (active) {
#pragma unroll
        for (int w = 0; w < 8; ++w) out[(int64_t)w * n + idx] = x[w];
    }
}

extern "C" int poseidon_mxu_set_constants(const uint32_t* rc, const uint32_t* mds,
                                          const uint32_t* wb) {
    cudaMemcpyToSymbol(MXU_RC, rc, sizeof(MXU_RC));
    cudaMemcpyToSymbol(MXU_MDS, mds, sizeof(MXU_MDS));
    cudaMemcpyToSymbol(MXU_WB, wb, sizeof(MXU_WB));
    return (int)cudaGetLastError();
}

static unsigned mxu_blocks(int64_t n) {
    return (unsigned)((n + MXU_THREADS - 1) / MXU_THREADS);
}

extern "C" int poseidon_mxu_hash_batch_cuda(const uint32_t* in, uint32_t* out, int L,
                                            int64_t n, const uint32_t* cap, void* stream) {
    Words8 c;
    for (int w = 0; w < 8; ++w) c.v[w] = cap[w];
    if (n > 0)
        poseidon_mxu_sponge_kernel<<<mxu_blocks(n), MXU_THREADS, 0, (cudaStream_t)stream>>>(
            in, out, L, n, c);
    return (int)cudaGetLastError();
}

extern "C" int poseidon_mxu_probe_cuda(int variant, const uint32_t* x, const uint32_t* y,
                                       uint32_t* out, int64_t n, int iters, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const unsigned blocks = mxu_blocks(n);
    cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
        case mxu::VPU_MUL:
            poseidon_mxu_probe_kernel<mxu::VPU_MUL><<<blocks, MXU_THREADS, 0, s>>>(x, y, out, n, iters);
            break;
        case mxu::BOUNDARY:
            poseidon_mxu_probe_kernel<mxu::BOUNDARY><<<blocks, MXU_THREADS, 0, s>>>(x, y, out, n, iters);
            break;
        case mxu::MXU_MUL:
            poseidon_mxu_probe_kernel<mxu::MXU_MUL><<<blocks, MXU_THREADS, 0, s>>>(x, y, out, n, iters);
            break;
        case mxu::BCAST:
            poseidon_mxu_probe_kernel<mxu::BCAST><<<blocks, MXU_THREADS, 0, s>>>(x, y, out, n, iters);
            break;
        case mxu::CHECK:
            poseidon_mxu_probe_kernel<mxu::CHECK><<<blocks, MXU_THREADS, 0, s>>>(x, y, out, n, iters);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
#endif
