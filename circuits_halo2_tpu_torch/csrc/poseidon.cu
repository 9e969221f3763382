// K1: ConstantLength<L> Poseidon sponge over BN254 Fr, one message per thread,
// and K2: one bare permutation per thread (below).
//
// Replaces: circuits_halo2_tpu/ops/poseidon_pallas2.py::hash_batch_pallas2
// (kernel body _sponge_kernel), which hashes every level of the Merkle sum
// tree. t = 2, rate 1, capacity word L·2^64; 4 full + 56 partial + 4 full
// rounds of x^5 and a 2x2 MDS.
//
// What bounds it on the card: integer multiply issue. One permutation is
// 472 Montgomery products (8 full rounds x 10 + 56 partial x 7), each 128
// mul.wide/mad.hi pairs, against 8·L·4 bytes read and 32 bytes written per
// message -- tens of thousands of integer ops per byte, far from the memory
// bound.
//
// Design: the TPU kernel carried 18x15-bit redundant limbs because its
// lanes have no wide multiply; Hopper has 32x32->64, so the state (s0, s1)
// lives in registers as 8x32-bit words (R = 2^256) with canonical CIOS
// products. Round constants and the MDS matrix sit in __constant__ memory
// (every thread of a warp reads the same word: a broadcast), set once per
// library load. The L absorptions and 64 rounds loop inside the thread; no
// shared memory and no inter-thread traffic, so occupancy is limited only
// by registers. Input words are laid out (L, 8, n) and output (8, n), so a
// warp's loads and stores are coalesced. No N % 1024 rule: the grid
// covers ceil(n / 256) blocks and the ragged tail is masked.

#include "bn254.cuh"

#ifndef __CUDACC__
#define __constant__
#endif

__constant__ uint32_t POS_RC[64][2][8];
__constant__ uint32_t POS_MDS[2][2][8];

using bn254::Fr;

BN_HD void pos_pow5(uint32_t x[8]) {
    uint32_t x2[8], x4[8];
    bn254::mul<Fr>(x2, x, x);
    bn254::mul<Fr>(x4, x2, x2);
    bn254::mul<Fr>(x, x4, x);
}

BN_HD void pos_permute(uint32_t s0[8], uint32_t s1[8],
                       const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
    for (int r = 0; r < 64; ++r) {
        const bool full = r < 4 || r >= 60;
        bn254::add<Fr>(s0, s0, rc[r][0]);
        bn254::add<Fr>(s1, s1, rc[r][1]);
        pos_pow5(s0);
        if (full) pos_pow5(s1);
        uint32_t n0[8], n1[8], t[8];
        bn254::mul<Fr>(n0, mds[0][0], s0);
        bn254::mul<Fr>(t, mds[0][1], s1);
        bn254::add<Fr>(n0, n0, t);
        bn254::mul<Fr>(n1, mds[1][0], s0);
        bn254::mul<Fr>(t, mds[1][1], s1);
        bn254::add<Fr>(s1, n1, t);
        bn254::copy(s0, n0);
    }
}

// The sponge for message `idx` of `n`: in is (L, 8, n) Montgomery words,
// cap the Montgomery capacity word; writes the Montgomery digest.
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
        bn254::add<Fr>(s0, s0, m);
        pos_permute(s0, s1, rc, mds);
    }
    bn254::copy(out, s0);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

struct Words8 {
    uint32_t v[8];
};

__global__ void poseidon_sponge_kernel(const uint32_t* __restrict__ in,
                                       uint32_t* __restrict__ out, int L,
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
// bound and design as the sponge above (integer multiply issue, state in
// registers, constants in __constant__ memory, ragged tail masked).
__global__ void poseidon_permute_kernel(const uint32_t* __restrict__ s0_in,
                                        const uint32_t* __restrict__ s1_in,
                                        uint32_t* __restrict__ s0_out,
                                        uint32_t* __restrict__ s1_out, int64_t n) {
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    uint32_t s0[8], s1[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        s0[w] = s0_in[(int64_t)w * n + idx];
        s1[w] = s1_in[(int64_t)w * n + idx];
    }
    pos_permute(s0, s1, POS_RC, POS_MDS);
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
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 0)
        poseidon_sponge_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            in, out, L, n, c);
    return (int)cudaGetLastError();
}

extern "C" int poseidon_permute_cuda(const uint32_t* s0_in, const uint32_t* s1_in,
                                     uint32_t* s0_out, uint32_t* s1_out, int64_t n,
                                     void* stream) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 0)
        poseidon_permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            s0_in, s1_in, s0_out, s1_out, n);
    return (int)cudaGetLastError();
}
#endif
