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
// so the reduction is S = W (32 x 64 bytes) . T (64 byte planes x lanes).
//
// Bounds, for this representation. Every entry of W and every byte plane is
// < 2^8, so each S_j <= 64 * 255 * 255 = 4,161,600 < 2^22: the int32
// accumulator of the tensor cores is exact and no operand needs splitting
// (the TPU version split the weights into lo/hi byte rows because bf16 holds
// only 8 exact bits and f32 accumulates exactly only below 2^24). The value
// V = sum_j S_j 2^(8j) = sum_h t_h c_h < 64 * 255 * p < 2^14 p < 2^268 is
// carried into 9 words (each partial sum < 2^47 in a 64-bit accumulator,
// top word < 2^15). It is then made canonical on the CUDA cores:
// q = floor((V >> 224) / d) with d = (p >> 224) + 1, so q*p <= V and
// V - q*p < 3p; two conditional subtractions of p finish. Products of
// canonical values and the MDS sums never exceed 2^512, and every add of
// two canonical values is a modular add (sum < 2p < 2^256), so no
// intermediate leaves its word range. Inputs to the sponge may be any
// value < 2^256 (a raw keccak digest): they are made canonical by the same
// step before they are absorbed.
//
// What bounds it on the card: integer multiply issue on the CUDA cores. Per
// permutation there are 472 products of 64 mul.wide each (30,208, against
// K1's 64,192 for its 472 CIOS products) and 344 reductions of
// 32 x 64 x 2 = 4,096 tensor-core operations per lane (1.4 M), which the
// int8 peak of 1,979 T/s covers in a fifth of the multiply time.
//
// Design: one thread per message, 128 threads (4 warps) per block. A thread
// forms its product on the CUDA cores (32 x 32 -> 64) and writes the 16
// product words, which are its 64 byte planes, into its warp's tile in
// shared memory (the B fragments, one column per lane). The warp then runs
// 16 wmma m16n16k16 u8 products (2 row tiles x 2 lane tiles x 4 k steps)
// against W, which each block copies from __constant__ memory into shared
// memory once, tiled as the A fragments; the s32 sums go back through shared
// memory, one column of 32 per lane. Every thread of a warp takes part in
// each product, so the ragged tail is masked by loading zeros and storing
// nothing, never by returning early. wgmma would feed the tensor cores
// faster; this version only has to be right.

#include "bn254.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <mma.h>
#define MX_FN static __device__ __forceinline__
#else
#define MX_FN static inline
#endif

namespace mxu {

using bn254::Fr;

// d = (p >> 224) + 1
constexpr uint64_t QDIV = 0x30644e73ull;

// t (16 words) = a * b, schoolbook on 32 x 32 -> 64 products.
BN_HD void product(uint32_t t[16], const uint32_t a[8], const uint32_t b[8]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t s = (uint64_t)a[j] * b[i] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
}

// t += u over 16 words (the sum stays < 2^512 where it is used).
BN_HD void add_wide(uint32_t t[16], const uint32_t u[16]) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        c += (uint64_t)t[i] + u[i];
        t[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r = V mod p for V = v[0..7] + v[8] * 2^256 < 2^268.
BN_HD void canon(uint32_t r[8], const uint32_t v[9]) {
    const uint64_t a = ((uint64_t)v[8] << 32) | v[7];  // V >> 224
    const uint32_t q = (uint32_t)(a / QDIV);
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

// r = sum_j S_j 2^(8j) mod p, for the 32 column sums S_j < 2^22.
BN_HD void finish(uint32_t r[8], const int32_t s[32]) {
    uint32_t v[9];
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        acc += (uint64_t)(uint32_t)s[4 * w] + ((uint64_t)(uint32_t)s[4 * w + 1] << 8)
             + ((uint64_t)(uint32_t)s[4 * w + 2] << 16) + ((uint64_t)(uint32_t)s[4 * w + 3] << 24);
        v[w] = (uint32_t)acc;
        acc >>= 32;
    }
    v[8] = (uint32_t)acc;
    canon(r, v);
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

template <class Red>
MX_FN void pow5(const Red& red, uint32_t x[8]) {
    uint32_t t[16], x2[8], x4[8];
    product(t, x, x);
    red.reduce(x2, t);
    product(t, x2, x2);
    red.reduce(x4, t);
    product(t, x4, x);
    red.reduce(x, t);
}

// One permutation on canonical plain residues; rc/mds are plain residues.
template <class Red>
MX_FN void permute(const Red& red, uint32_t s0[8], uint32_t s1[8],
                   const uint32_t (*rc)[2][8], const uint32_t (*mds)[2][8]) {
    for (int r = 0; r < 64; ++r) {
        const bool full = r < 4 || r >= 60;
        bn254::add<Fr>(s0, s0, rc[r][0]);
        bn254::add<Fr>(s1, s1, rc[r][1]);
        pow5(red, s0);
        if (full) pow5(red, s1);
        uint32_t t[16], u[16], n0[8];
        product(t, mds[0][0], s0);
        product(u, mds[0][1], s1);
        add_wide(t, u);
        red.reduce(n0, t);
        product(t, mds[1][0], s0);
        product(u, mds[1][1], s1);
        add_wide(t, u);
        red.reduce(s1, t);
        bn254::copy(s0, n0);
    }
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
using namespace nvcuda;

__constant__ uint32_t MXU_RC[64][2][8];
__constant__ uint32_t MXU_MDS[2][2][8];
__constant__ uint4 MXU_W[128];  // 2048 bytes: W as 8 row-major 16 x 16 tiles

constexpr int MXU_THREADS = 128;
constexpr int MXU_WARPS = MXU_THREADS / 32;

struct MxuShared {
    // tile (mi, ki) of W at (mi * 4 + ki) * 256, element (m, k) at m * 16 + k
    __align__(256) unsigned char w[2048];
    // per warp, tile (ki, ni) of the byte planes at (ni * 4 + ki) * 256,
    // element (k, n) at n * 16 + k: lane ni * 16 + n writes its 64 bytes
    __align__(256) unsigned char b[MXU_WARPS][2048];
    // per warp, tile (mi, ni) of S at (ni * 2 + mi) * 256, element (m, n) at n * 16 + m
    __align__(256) int c[MXU_WARPS][1024];
};

struct TensorCoreReducer {
    const unsigned char* w;
    unsigned char* b;
    int* c;
    int lane;

    __device__ void reduce(uint32_t r[8], const uint32_t t[16]) const {
        const int ni = lane >> 4, n = lane & 15;
#pragma unroll
        for (int ki = 0; ki < 4; ++ki)
            *reinterpret_cast<uint4*>(b + (ni * 4 + ki) * 256 + n * 16) =
                make_uint4(t[4 * ki], t[4 * ki + 1], t[4 * ki + 2], t[4 * ki + 3]);
        __syncwarp();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
                wmma::fill_fragment(fc, 0);
#pragma unroll
                for (int ki = 0; ki < 4; ++ki) {
                    wmma::load_matrix_sync(fa, w + (mi * 4 + ki) * 256, 16);
                    wmma::load_matrix_sync(fb, b + (nj * 4 + ki) * 256, 16);
                    wmma::mma_sync(fc, fa, fb, fc);
                }
                wmma::store_matrix_sync(c + (nj * 2 + mi) * 256, fc, 16, wmma::mem_col_major);
            }
        }
        __syncwarp();
        int32_t s[32];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const int4* src = reinterpret_cast<const int4*>(c + (ni * 2 + mi) * 256 + n * 16);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int4 v = src[q];
                s[mi * 16 + 4 * q] = v.x;
                s[mi * 16 + 4 * q + 1] = v.y;
                s[mi * 16 + 4 * q + 2] = v.z;
                s[mi * 16 + 4 * q + 3] = v.w;
            }
        }
        mxu::finish(r, s);
    }
};

// Copies W into shared memory and returns this thread's reducer.
__device__ TensorCoreReducer block_reducer(MxuShared& sh) {
    if (threadIdx.x < 128) reinterpret_cast<uint4*>(sh.w)[threadIdx.x] = MXU_W[threadIdx.x];
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    return TensorCoreReducer{sh.w, sh.b[warp], sh.c[warp], (int)(threadIdx.x & 31)};
}

struct Words8 {
    uint32_t v[8];
};

__global__ void __launch_bounds__(MXU_THREADS)
poseidon_mxu_sponge_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           int L, int64_t n, Words8 cap) {
    __shared__ MxuShared sh;
    const TensorCoreReducer red = block_reducer(sh);
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
    __shared__ MxuShared sh;
    const TensorCoreReducer red = block_reducer(sh);
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
            mxu::product(t, x, y);
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
        mxu::product(t, x, y);
        red.reduce(x, t);
    }
    if (active) {
#pragma unroll
        for (int w = 0; w < 8; ++w) out[(int64_t)w * n + idx] = x[w];
    }
}

extern "C" int poseidon_mxu_set_constants(const uint32_t* rc, const uint32_t* mds,
                                          const uint8_t* w) {
    cudaMemcpyToSymbol(MXU_RC, rc, sizeof(MXU_RC));
    cudaMemcpyToSymbol(MXU_MDS, mds, sizeof(MXU_MDS));
    cudaMemcpyToSymbol(MXU_W, w, sizeof(MXU_W));
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
