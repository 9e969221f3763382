// K3: Pippenger bucket scan -- chunk-local segmented sums of digit-sorted
// affine points over BN254 Fq, one thread per (msm, window, chunk) lane.
//
// Replaces: circuits_halo2_tpu/ops/msm_pallas.py::_scan_pallas (kernel body
// _scan_kern), reached from ops/msm.py::_segmented_sum_parts_pallas for every
// KZG commitment in keygen and in the prover.
//
// Semantics (identical to msm.py::_segmented_sum_parts, phase 1): each lane
// walks its L sorted points in order; when the digit changes the Jacobian
// accumulator's Z is reset to 0 (infinity, X and Y kept); the point is added
// with jac_madd (madd-2007-bl, same formulas and the same case selection:
// P at infinity, invalid Q, doubling, P + (-P)); and the canonical local sum
// is written after every step. Canonical field outputs make the result
// limb-for-limb equal to the plain torch scan.
//
// What bounds it on the card: serial latency per lane. Each step is ~11
// dependent Fq products (plus 7 more on the rare doubling path), and there
// are only B * 32 * n / L lanes: a k=13 commitment of 4 columns gives 8192
// threads, a fraction of what 132 SMs can keep in flight, so the kernel is
// latency- not throughput-bound. The design keeps the accumulator, the
// previous digit and all temporaries in registers (no shared memory, no
// global round trips inside the loop) and lays every array out as
// (L, words, lanes) so each step's loads and stores are coalesced across
// the warp. XYZZ buckets, sorting tricks and more lanes are later work.

#include "bn254.cuh"

using bn254::Fq;

// dbl-2009-l (ops/msm.py::jac_double), a = 0 curve.
BN_HD void jac_double(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                      const uint32_t x[8], const uint32_t y[8], const uint32_t z[8]) {
    uint32_t a[8], b[8], c[8], xb[8], d[8], e[8], f[8], t[8], c8[8];
    bn254::mul<Fq>(a, x, x);
    bn254::mul<Fq>(b, y, y);
    bn254::mul<Fq>(c, b, b);
    bn254::add<Fq>(xb, x, b);
    bn254::mul<Fq>(t, xb, xb);
    bn254::sub<Fq>(t, t, a);
    bn254::sub<Fq>(d, t, c);
    bn254::dbl<Fq>(d, d);
    bn254::add<Fq>(e, a, a);
    bn254::add<Fq>(e, e, a);
    bn254::mul<Fq>(f, e, e);
    bn254::dbl<Fq>(t, d);
    uint32_t xo[8], yo[8], zo[8];
    bn254::sub<Fq>(xo, f, t);
    bn254::dbl<Fq>(c8, c);
    bn254::dbl<Fq>(c8, c8);
    bn254::dbl<Fq>(c8, c8);
    bn254::sub<Fq>(t, d, xo);
    bn254::mul<Fq>(t, e, t);
    bn254::sub<Fq>(yo, t, c8);
    bn254::mul<Fq>(t, y, z);
    bn254::dbl<Fq>(zo, t);
    bn254::copy(x3, xo);
    bn254::copy(y3, yo);
    bn254::copy(z3, zo);
}

// madd-2007-bl (ops/msm.py::jac_madd): (x1, y1, z1) += affine (x2, y2),
// `valid` false meaning Q is the point at infinity. In-place on (x1, y1, z1).
BN_HD void jac_madd(uint32_t x1[8], uint32_t y1[8], uint32_t z1[8],
                    const uint32_t x2[8], const uint32_t y2[8], bool valid) {
    uint32_t z1z1[8], u2[8], s2[8], h[8], hh[8], i4[8], j[8], rr[8], v[8], t[8];
    uint32_t x3[8], y3[8], z3[8];
    bn254::mul<Fq>(z1z1, z1, z1);
    bn254::mul<Fq>(u2, x2, z1z1);
    bn254::mul<Fq>(t, y2, z1);
    bn254::mul<Fq>(s2, t, z1z1);
    bn254::sub<Fq>(h, u2, x1);
    bn254::mul<Fq>(hh, h, h);
    bn254::dbl<Fq>(i4, hh);
    bn254::dbl<Fq>(i4, i4);
    bn254::mul<Fq>(j, h, i4);
    bn254::sub<Fq>(t, s2, y1);
    bn254::dbl<Fq>(rr, t);
    bn254::mul<Fq>(v, x1, i4);
    bn254::mul<Fq>(t, rr, rr);
    bn254::sub<Fq>(t, t, j);
    uint32_t v2[8];
    bn254::dbl<Fq>(v2, v);
    bn254::sub<Fq>(x3, t, v2);
    bn254::sub<Fq>(t, v, x3);
    bn254::mul<Fq>(t, rr, t);
    uint32_t yj[8];
    bn254::mul<Fq>(yj, y1, j);
    bn254::dbl<Fq>(yj, yj);
    bn254::sub<Fq>(y3, t, yj);
    bn254::add<Fq>(t, z1, h);
    bn254::mul<Fq>(t, t, t);
    bn254::sub<Fq>(t, t, z1z1);
    bn254::sub<Fq>(z3, t, hh);

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

// One lane's scan. seg, valid: (L, lanes); xs, ys, ox, oy, oz: (L, 8, lanes).
BN_HD void scan_lane(const int32_t* seg, const int32_t* valid, const uint32_t* xs,
                     const uint32_t* ys, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                     int L, int64_t lanes, int64_t lane) {
    uint32_t x[8], y[8], z[8];
    bn254::set_zero(x);
    bn254::set_zero(y);
    bn254::set_zero(z);
    int32_t cseg = -1;
    for (int t = 0; t < L; ++t) {
        const int32_t eseg = seg[(int64_t)t * lanes + lane];
        const bool ev = valid[(int64_t)t * lanes + lane] != 0;
        uint32_t ex[8], ey[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
            ex[w] = xs[((int64_t)t * 8 + w) * lanes + lane];
            ey[w] = ys[((int64_t)t * 8 + w) * lanes + lane];
        }
        if (eseg != cseg) bn254::set_zero(z);
        jac_madd(x, y, z, ex, ey, ev);
        cseg = eseg;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
            const int64_t o = ((int64_t)t * 8 + w) * lanes + lane;
            ox[o] = x[w];
            oy[o] = y[w];
            oz[o] = z[w];
        }
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void msm_scan_kernel(const int32_t* __restrict__ seg,
                                const int32_t* __restrict__ valid,
                                const uint32_t* __restrict__ xs,
                                const uint32_t* __restrict__ ys, uint32_t* __restrict__ ox,
                                uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                                int L, int64_t lanes) {
    int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    scan_lane(seg, valid, xs, ys, ox, oy, oz, L, lanes, lane);
}

extern "C" int msm_scan_cuda(const int32_t* seg, const int32_t* valid, const uint32_t* xs,
                             const uint32_t* ys, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                             int L, int64_t lanes, void* stream) {
    const int threads = 128;
    const int64_t blocks = (lanes + threads - 1) / threads;
    if (blocks > 0)
        msm_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            seg, valid, xs, ys, ox, oy, oz, L, lanes);
    return (int)cudaGetLastError();
}
#endif
