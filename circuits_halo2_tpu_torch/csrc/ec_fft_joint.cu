// Experiment, on no path: X4's one-thread alternative, timed beside the
// shipped two-thread kernel (ec_fft.cu) by scripts/exp_x4_joint.py and built
// by it alone, never into the kernel library.
//
// One thread a butterfly (and a scaled point) runs both GLV halves of its
// scalar jointly: one table T_1..T_8 of P, then from the top nonzero digit
// of either half down, four doublings shared by both halves, a complete add
// of +-T_|d0| and one of +-phi(T_|d1|) (X times beta, one product) for each
// nonzero digit. Against two threads a butterfly: one table instead of two,
// the doublings shared, no V = R_0 + R_1, so about 1.4 times less work; but
// one chain of about 127 doublings and 64 adds, and half the threads.
//
// Same inputs and layout as ec_fft.cu, whose helpers it includes; the
// outputs are the same points in other Jacobian coordinates. Shared memory:
// T_1..T_8, the accumulator, phi's entry and u, 11 slots of 96 B a thread.

#include "ec_fft.cu"

constexpr int XJ_TMP = 9, XJ_U = 10, XJ_SLOTS = 11;
constexpr int XJ_BLOCKS_PER_SM = 6;  // 228 KB over a block's 33 KB (and 1 KB)

// Slot `to` = +-(the point in slot `from`), with X times beta where phi.
BN_HD void xj_copy(g1::PointRef to, g1::PointRef from, bool neg, bool phi,
                   const uint32_t* beta) {
    uint32_t a[8], b[8];
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
        g1::get(a, from, c);
        if (c == 0 && phi) {
#pragma unroll
            for (int w = 0; w < 8; ++w) b[w] = beta[w];
            bnf::mul<bn254::Fq>(a, a, b);
            bnf::canon<bn254::Fq>(a, a);
        }
        if (c == 1 && neg) g1::neg(a, a);
        g1::put(to, c, a);
    }
}

// Thread i's slot ACC = k1 P + k2 phi(P), P in its slot 0, the digits of k1
// at dg[0 .. nd) and of k2 at dg[nd .. 2 nd).
BN_HD void xj_joint_mul(volatile uint32_t* sm, int i, const int8_t* dg, int nd,
                        const uint32_t* beta) {
    int top = -1, most = 0;
#pragma unroll 1
    for (int w = 0; w < 2 * nd; ++w) {
        const int d = dg[w];
        if (d && w % nd > top) top = w % nd;
        most = d > most ? d : -d > most ? -d : most;
    }
    const g1::PointRef acc = x4_slot(sm, i, X4_ACC), t1 = x4_slot(sm, i, 0);
    const g1::PointRef tmp = x4_slot(sm, i, XJ_TMP);
    uint32_t a[8];
    bn254::set_zero(a);
#pragma unroll 1
    for (int c = 0; c < 3; ++c) g1::put(acc, c, a);
    if (top < 0) return;
#pragma unroll 1
    for (int m = 2; m <= most; ++m) {
        if (m % 2 == 0)
            x4_double(x4_slot(sm, i, m - 1), x4_slot(sm, i, m / 2 - 1), 1);
        else
            g1::jac_add(x4_slot(sm, i, m - 1), x4_slot(sm, i, m - 2), t1, false);
    }
    bool empty = true;
#pragma unroll 1
    for (int w = top; w >= 0; --w) {
        if (w < top) x4_double(acc, acc, X4_WINDOW);
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            const int d = dg[h * nd + w];
            if (!d) continue;
            const g1::PointRef t = x4_slot(sm, i, (d < 0 ? -d : d) - 1);
            if (empty) {
                xj_copy(acc, t, d < 0, h, beta);
            } else if (h) {
                xj_copy(tmp, t, false, true, beta);
                g1::jac_add(acc, acc, tmp, d < 0);
            } else {
                g1::jac_add(acc, acc, t, d < 0);
            }
            empty = false;
        }
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(X4_BLOCK, XJ_BLOCKS_PER_SM)
x4_joint_stage_kernel(uint32_t* st, const int8_t* __restrict__ dg,
                      const uint32_t* __restrict__ beta, int64_t n, int64_t B, int s, int nd) {
    __shared__ uint32_t sm[XJ_SLOTS * 24 * X4_BLOCK];
    const int64_t t = (int64_t)blockIdx.x * X4_BLOCK + threadIdx.x, stride = B * n;
    if (t >= B * n / 2) return;
    const int i = threadIdx.x;
    const int64_t b = t / (n / 2), j = t % (n / 2);
    const int64_t half = (int64_t)1 << s, pos = j & (half - 1);
    const int64_t qu = b * n + ((j >> s) << (s + 1)) + pos;
    x4_load(x4_slot(sm, i, 0), st, stride, qu + half, beta, false);
    xj_joint_mul(sm, i, dg + (b * (n - 1) + half - 1 + pos) * 2 * nd, nd, beta);
    x4_load(x4_slot(sm, i, XJ_U), st, stride, qu, beta, false);
    g1::jac_add(g1::PointRef{st + qu, stride}, x4_slot(sm, i, XJ_U), x4_slot(sm, i, X4_ACC), false);
    g1::jac_add(g1::PointRef{st + qu + half, stride}, x4_slot(sm, i, XJ_U),
                x4_slot(sm, i, X4_ACC), true);
}

__global__ void __launch_bounds__(X4_BLOCK, XJ_BLOCKS_PER_SM)
x4_joint_scale_kernel(uint32_t* st, const int8_t* __restrict__ dg,
                      const uint32_t* __restrict__ beta, int64_t n, int64_t B, int nd) {
    __shared__ uint32_t sm[XJ_SLOTS * 24 * X4_BLOCK];
    const int64_t q = (int64_t)blockIdx.x * X4_BLOCK + threadIdx.x;
    if (q >= B * n) return;
    const int i = threadIdx.x;
    x4_load(x4_slot(sm, i, 0), st, B * n, q, beta, false);
    xj_joint_mul(sm, i, dg + (q / n) * 2 * nd, nd, beta);
    xj_copy(g1::PointRef{st + q, B * n}, x4_slot(sm, i, X4_ACC), false, false, beta);
}

extern "C" int x4_joint_stage_cuda(uint32_t* st, const int8_t* dg, const uint32_t* beta,
                                   int64_t n, int64_t B, int s, int nd, void* stream) {
    if (n < 2 || (n & (n - 1)) || B < 1 || s < 0 || ((int64_t)2 << s) > n || nd < 1)
        return (int)cudaErrorInvalidValue;
    x4_joint_stage_kernel<<<x4_blocks(B * n / 2), X4_BLOCK, 0, (cudaStream_t)stream>>>(
        st, dg, beta, n, B, s, nd);
    return (int)cudaGetLastError();
}

extern "C" int x4_joint_scale_cuda(uint32_t* st, const int8_t* dg, const uint32_t* beta,
                                   int64_t n, int64_t B, int nd, void* stream) {
    if (n < 1 || B < 1 || nd < 1) return (int)cudaErrorInvalidValue;
    x4_joint_scale_kernel<<<x4_blocks(B * n), X4_BLOCK, 0, (cudaStream_t)stream>>>(st, dg, beta,
                                                                                 n, B, nd);
    return (int)cudaGetLastError();
}
#endif
