// X4: the EC-FFT over BN254 G1 -- one butterfly stage per launch, one
// thread per butterfly, and a launch that multiplies every point by a
// constant scalar (the n^-1 of the inverse transform).
//
// Replaces: circuits_halo2_tpu/utils/ec_fft.py::ec_fft_device and its
// jitted stage scan _ec_fft_core (XLA, not Pallas), which rebuilds the
// Lagrange bases of a downsized SRS (ParamsKZG.downsize). The plain torch
// version is ops/ec_fft_kernel.py::ec_fft_ref.
//
// Semantics (identical to ec_fft_ref): the state is n Jacobian points per
// transform, B transforms, in bit-reversed order. Stage s (half = 2^s) takes
// butterfly j of transform b to its pair (u, v) = (q, q + half), q =
// (j / half) 2 half + j % half, computes V = w P_v by double-and-add over the
// plain twiddle w = omega_s^(j % half) (g1::scalar_mul: LSB first, as the
// reference), and writes u + V at q and u - V at q + half with the complete
// addition (g1::jac_add). Each point is read and written by one thread of a
// stage, so the update is in place. Every output is canonical, so the state
// equals the plain version's limb for limb.
//
// What bounds it on the card. A butterfly's work is its twiddle's double-
// and-add: one doubling per bit below the top set bit (2 products and 5
// squarings) and one complete add per set bit (11 products and 5 squarings),
// about 253 doublings and 127 adds for a random twiddle, plus the two adds
// of the butterfly: some 3,800 field products against 24 words in and out.
// It is bound by operations, by far. A stage at n = 2^13 has 4,096 threads,
// about one warp for each SM, each a serial chain of dependent carry
// chains: the first kernel is right and simple (no wgmma, no TMA, one launch
// a stage); how far it is from its bound is in PERF.md.
//
// Layout: the state is (3, 8, B n) 32-bit words (coordinate, word, point),
// so a warp's loads of one word of consecutive points are consecutive; the
// twiddles (8, B (n - 1)) hold stage s of transform b at columns
// b (n - 1) + 2^s - 1 + (0 .. 2^s); the scale (8, B) one plain scalar per
// transform.

#include "g1_jacobian.cuh"

BN_HD void load_point(uint32_t p[3][8], const uint32_t* st, int64_t stride, int64_t q) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int w = 0; w < 8; ++w) p[c][w] = st[(c * 8 + w) * stride + q];
}

BN_HD void store_point(uint32_t* st, int64_t stride, int64_t q, const uint32_t p[3][8]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int w = 0; w < 8; ++w) st[(c * 8 + w) * stride + q] = p[c][w];
}

// Butterfly t (< B n / 2) of stage s, in place on the (3, 8, B n) state.
BN_HD void ec_fft_butterfly(uint32_t* st, const uint32_t* tw, int64_t n, int64_t B, int s,
                            int64_t t) {
    const int64_t stride = B * n;
    const int64_t b = t / (n / 2), j = t % (n / 2);
    const int64_t half = (int64_t)1 << s, pos = j & (half - 1);
    const int64_t qu = b * n + ((j >> s) << (s + 1)) + pos, qv = qu + half;
    uint32_t u[3][8], v[3][8], k[8], out[3][8];
#pragma unroll
    for (int w = 0; w < 8; ++w) k[w] = tw[w * B * (n - 1) + b * (n - 1) + half - 1 + pos];
    load_point(u, st, stride, qu);
    load_point(out, st, stride, qv);
    g1::scalar_mul(v[0], v[1], v[2], out[0], out[1], out[2], k);
    g1::jac_add(out[0], out[1], out[2], u[0], u[1], u[2], v[0], v[1], v[2]);
    store_point(st, stride, qu, out);
    g1::neg(v[1], v[1]);
    g1::jac_add(out[0], out[1], out[2], u[0], u[1], u[2], v[0], v[1], v[2]);
    store_point(st, stride, qv, out);
}

// Point q (< B n) times its transform's scalar, in place.
BN_HD void ec_fft_scale_point(uint32_t* st, const uint32_t* scale, int64_t n, int64_t B,
                              int64_t q) {
    uint32_t p[3][8], r[3][8], k[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) k[w] = scale[w * B + q / n];
    load_point(p, st, B * n, q);
    g1::scalar_mul(r[0], r[1], r[2], p[0], p[1], p[2], k);
    store_point(st, B * n, q, r);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int ECFFT_THREADS = 128;

__global__ void ec_fft_stage_kernel(uint32_t* __restrict__ st, const uint32_t* __restrict__ tw,
                                    int64_t n, int64_t B, int s) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < B * (n / 2)) ec_fft_butterfly(st, tw, n, B, s, t);
}

__global__ void ec_fft_scale_kernel(uint32_t* __restrict__ st,
                                    const uint32_t* __restrict__ scale, int64_t n, int64_t B) {
    const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (q < B * n) ec_fft_scale_point(st, scale, n, B, q);
}

// Blocks of 128 threads, halved (down to 32) until the grid covers every SM:
// a stage at n = 2^13 has only 4,096 threads.
static void ec_fft_grid(int64_t threads, int64_t* blocks, int* block) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *block = ECFFT_THREADS;
    while (*block > 32 && (threads + *block - 1) / *block < sms) *block /= 2;
    *blocks = (threads + *block - 1) / *block;
}

extern "C" int ec_fft_stage_cuda(uint32_t* st, const uint32_t* tw, int64_t n, int64_t B, int s,
                                 void* stream) {
    if (n < 2 || (n & (n - 1)) || B < 1 || s < 0 || ((int64_t)2 << s) > n)
        return (int)cudaErrorInvalidValue;
    int64_t blocks;
    int block;
    ec_fft_grid(B * (n / 2), &blocks, &block);
    ec_fft_stage_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(st, tw, n, B, s);
    return (int)cudaGetLastError();
}

extern "C" int ec_fft_scale_cuda(uint32_t* st, const uint32_t* scale, int64_t n, int64_t B,
                                 void* stream) {
    if (n < 1 || B < 1) return (int)cudaErrorInvalidValue;
    int64_t blocks;
    int block;
    ec_fft_grid(B * n, &blocks, &block);
    ec_fft_scale_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(st, scale, n, B);
    return (int)cudaGetLastError();
}
#endif
