// K1: ConstantLength<L> Poseidon sponge over BN254 Fr, one message per thread,
// and K2: one bare permutation per thread (below).
//
// Replaces: circuits_halo2_tpu/ops/poseidon_pallas2.py::hash_batch_pallas2
// (kernel body _sponge_kernel), which hashes every level of the Merkle sum
// tree. t = 2, rate 1, capacity word L·2^64; 4 full + 56 partial + 4 full
// rounds of x^5 and a 2x2 MDS.
//
// What bounds it on the card: the integer multiply pipe. Against 8·L·4
// bytes read and 32 written per message, one permutation needs 49,568 wide
// multiplies on the product of bn254_fast.cuh: 144 squarings (x^2, x^4 of
// each x^5), 72 products (x^4 · x) and 128 two-product MDS rows with one
// reduction each. Tens of thousands of integer operations per byte: far
// from memory. On the H100 the time follows the count of IMAD-pipe
// instructions at about 4 cycles each per warp (PERF.md).
//
// What held the first port back was the work around those multiplies:
// canonical CIOS products in C++ over uint64_t, whose 64-bit adds nvcc
// lowers onto the multiply pipe (IMAD.X, IMAD.MOV), a canonicalisation
// after every product and add, and squarings run as general products
// (282,880 instructions a permutation, 104,536 of them on the IMAD pipe).
// The design (106,880 and 52,600):
// - the state (s0, s1) stays in registers as 8x32-bit words, R = 2^256,
//   lazily reduced in [0, 2p) (bn254_fast.cuh): no canonicalisation inside
//   the permutation; products on PTX carry chains, split by word parity so
//   that each word product is one IMAD.WIDE;
// - x^2 and x^4 are dedicated squarings (36 word products, not 64);
// - each MDS row s0·m0 + s1·m1 is one wide two-product sum and one
//   Montgomery reduction (the constants are canonical, so the sum stays
//   below 4p^2);
// - the digest (and K2's two outputs) are made canonical once, at the end.
// Round constants and the MDS matrix sit in __constant__ memory (every
// thread of a warp reads the same word: a broadcast), set once per library
// load. No shared memory and no inter-thread traffic; occupancy is set by
// registers: ptxas gives 80, so 3 blocks of POS_THREADS = 256 (24 warps) fit
// an SM; forcing 64 registers spilled and ran slower. Input words are laid out
// (L, 8, n) and output (8, n), so a warp's loads and stores are coalesced;
// the grid covers ceil(n / POS_THREADS) blocks and the ragged tail is masked.
// Below 2^13 messages (the 14 smallest tree levels) the grid fills few SMs
// and a launch is latency-bound; not redesigned here.

#include "bn254_fast.cuh"

#ifndef __CUDACC__
#define __constant__
#endif

__constant__ uint32_t POS_RC[64][2][8];
__constant__ uint32_t POS_MDS[2][2][8];

using bn254::Fr;

BN_HD void pos_pow5(uint32_t x[8]) {
    uint32_t x2[8], x4[8];
    bnf::sqr<Fr>(x2, x);
    bnf::sqr<Fr>(x4, x2);
    bnf::mul<Fr>(x, x4, x);
}

// One round on the lazy state (every word below 2p in and out).
template <bool FULL>
BN_HD void pos_round(uint32_t s0[8], uint32_t s1[8], const uint32_t rc[2][8],
                     const uint32_t (*mds)[2][8]) {
    bnf::add<Fr>(s0, s0, rc[0]);
    bnf::add<Fr>(s1, s1, rc[1]);
    pos_pow5(s0);
    if (FULL) pos_pow5(s1);
    uint32_t n0[8];
    bnf::mul2<Fr>(n0, s0, mds[0][0], s1, mds[0][1]);
    bnf::mul2<Fr>(s1, s0, mds[1][0], s1, mds[1][1]);
    bn254::copy(s0, n0);
}

BN_HD void pos_permute(uint32_t s0[8], uint32_t s1[8],
                       const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
#pragma unroll 1
    for (int r = 0; r < 4; ++r) pos_round<true>(s0, s1, rc[r], mds);
#pragma unroll 1
    for (int r = 4; r < 60; ++r) pos_round<false>(s0, s1, rc[r], mds);
#pragma unroll 1
    for (int r = 60; r < 64; ++r) pos_round<true>(s0, s1, rc[r], mds);
}

// K2's thread: canonical (s0, s1) in, the canonical permuted pair out.
BN_HD void pos_permute_canonical(uint32_t s0[8], uint32_t s1[8],
                                 const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
    pos_permute(s0, s1, rc, mds);
    bnf::canon<Fr>(s0, s0);
    bnf::canon<Fr>(s1, s1);
}

// The sponge for message `idx` of `n`: in is (L, 8, n) Montgomery words,
// cap the Montgomery capacity word; writes the canonical Montgomery digest.
BN_HD void pos_sponge(const uint32_t* in, int L, int64_t n, int64_t idx,
                      const uint32_t cap[8], uint32_t out[8],
                      const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
    uint32_t s0[8], s1[8];
    bn254::set_zero(s0);
    bn254::copy(s1, cap);
    for (int i = 0; i < L; ++i) {
        uint32_t m[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) m[w] = in[((int64_t)i * 8 + w) * n + idx];
        bnf::add<Fr>(s0, s0, m);
        pos_permute(s0, s1, rc, mds);
    }
    bnf::canon<Fr>(out, s0);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int POS_THREADS = 256;

struct Words8 {
    uint32_t v[8];
};

__global__ void __launch_bounds__(POS_THREADS)
poseidon_sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int L,
                       int64_t n, Words8 cap) {
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    uint32_t d[8];
    pos_sponge(in, L, n, idx, cap.v, d, POS_RC, POS_MDS);
#pragma unroll
    for (int w = 0; w < 8; ++w) out[(int64_t)w * n + idx] = d[w];
}

// K2: one permutation of n states (s0, s1), each (8, n) Montgomery words,
// one state per thread. Replaces poseidon_pallas2.py::permute_tiles; same
// bound and design as the sponge above (integer multiply issue, lazy state
// in registers, constants in __constant__ memory, ragged tail masked).
__global__ void __launch_bounds__(POS_THREADS)
poseidon_permute_kernel(const uint32_t* __restrict__ s0_in, const uint32_t* __restrict__ s1_in,
                        uint32_t* __restrict__ s0_out, uint32_t* __restrict__ s1_out,
                        int64_t n) {
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    uint32_t s0[8], s1[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        s0[w] = s0_in[(int64_t)w * n + idx];
        s1[w] = s1_in[(int64_t)w * n + idx];
    }
    pos_permute_canonical(s0, s1, POS_RC, POS_MDS);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        s0_out[(int64_t)w * n + idx] = s0[w];
        s1_out[(int64_t)w * n + idx] = s1[w];
    }
}

extern "C" int poseidon_set_constants(const uint32_t* rc, const uint32_t* mds) {
    cudaMemcpyToSymbol(POS_RC, rc, sizeof(POS_RC));
    cudaMemcpyToSymbol(POS_MDS, mds, sizeof(POS_MDS));
    return (int)cudaGetLastError();
}

extern "C" int poseidon_hash_batch_cuda(const uint32_t* in, uint32_t* out, int L,
                                        int64_t n, const uint32_t* cap,
                                        void* stream) {
    Words8 c;
    for (int w = 0; w < 8; ++w) c.v[w] = cap[w];
    const int64_t blocks = (n + POS_THREADS - 1) / POS_THREADS;
    if (blocks > 0)
        poseidon_sponge_kernel<<<(unsigned)blocks, POS_THREADS, 0, (cudaStream_t)stream>>>(
            in, out, L, n, c);
    return (int)cudaGetLastError();
}

extern "C" int poseidon_permute_cuda(const uint32_t* s0_in, const uint32_t* s1_in,
                                     uint32_t* s0_out, uint32_t* s1_out, int64_t n,
                                     void* stream) {
    const int64_t blocks = (n + POS_THREADS - 1) / POS_THREADS;
    if (blocks > 0)
        poseidon_permute_kernel<<<(unsigned)blocks, POS_THREADS, 0, (cudaStream_t)stream>>>(
            s0_in, s1_in, s0_out, s1_out, n);
    return (int)cudaGetLastError();
}
#endif
