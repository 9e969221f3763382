// BN254 G1 in Jacobian coordinates for one CUDA thread, on the lazy Fq
// arithmetic of bn254_fast.cuh: the doubling of K3 (msm_scan.cu) and X4
// (ec_fft.cu), X4's complete addition and its double-and-add by a plain
// scalar. A point is three 8-word Montgomery Fq coordinates; Z = 0 is the
// point at infinity. Every function takes and returns canonical words, and
// follows the formulas and the case selection of the plain torch version
// (ops/msm.py) step for step, so the outputs are equal limb for limb.
// Per-thread code only (BN_HD): the g++ harness of the tests runs it too.

#pragma once
#include "bn254_fast.cuh"

namespace g1 {

using bn254::Fq;

// dbl-2009-l (ops/msm.py::jac_double), a = 0 curve; canonical in and out.
BN_HD void jac_double(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                      const uint32_t x[8], const uint32_t y[8], const uint32_t z[8]) {
    uint32_t a[8], b[8], c[8], xb[8], d[8], e[8], f[8], t[8], c8[8];
    bnf::sqr<Fq>(a, x);
    bnf::sqr<Fq>(b, y);
    bnf::sqr<Fq>(c, b);
    bnf::add<Fq>(xb, x, b);
    bnf::sqr<Fq>(t, xb);
    bnf::sub<Fq>(t, t, a);
    bnf::sub<Fq>(d, t, c);
    bnf::dbl<Fq>(d, d);
    bnf::add<Fq>(e, a, a);
    bnf::add<Fq>(e, e, a);
    bnf::sqr<Fq>(f, e);
    bnf::dbl<Fq>(t, d);
    uint32_t xo[8], yo[8], zo[8];
    bnf::sub<Fq>(xo, f, t);
    bnf::dbl<Fq>(c8, c);
    bnf::dbl<Fq>(c8, c8);
    bnf::dbl<Fq>(c8, c8);
    bnf::sub<Fq>(t, d, xo);
    bnf::mul<Fq>(t, e, t);
    bnf::sub<Fq>(yo, t, c8);
    bnf::mul<Fq>(t, y, z);
    bnf::dbl<Fq>(zo, t);
    bnf::canon<Fq>(x3, xo);
    bnf::canon<Fq>(y3, yo);
    bnf::canon<Fq>(z3, zo);
}

// add-2007-bl with the cases of ops/msm.py::jac_add: P at infinity gives Q,
// else Q at infinity gives P; P = Q (H = 0, R = 0) doubles P; P = -Q (H = 0,
// R != 0) gives infinity with the formula's X and Y, as the formula's own
// Z3 = 2 Z1 Z2 H is 0 there (ops/msm.py zeroes it explicitly). The outputs
// may alias the inputs (every input is read before the first output is
// written).
BN_HD void jac_add(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                   const uint32_t x1[8], const uint32_t y1[8], const uint32_t z1[8],
                   const uint32_t x2[8], const uint32_t y2[8], const uint32_t z2[8]) {
    uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], h[8], rr[8], i4[8], j[8], v[8],
        t[8], w[8];
    uint32_t xo[8], yo[8], zo[8];
    bnf::sqr<Fq>(z1z1, z1);
    bnf::sqr<Fq>(z2z2, z2);
    bnf::mul<Fq>(u1, x1, z2z2);
    bnf::mul<Fq>(u2, x2, z1z1);
    bnf::mul<Fq>(t, y1, z2);
    bnf::mul<Fq>(s1, t, z2z2);
    bnf::mul<Fq>(t, y2, z1);
    bnf::mul<Fq>(s2, t, z1z1);
    bnf::sub<Fq>(h, u2, u1);
    bnf::canon<Fq>(h, h);
    bnf::sub<Fq>(t, s2, s1);
    bnf::dbl<Fq>(rr, t);
    bnf::canon<Fq>(rr, rr);
    bnf::dbl<Fq>(t, h);
    bnf::sqr<Fq>(i4, t);  // I = (2H)^2
    bnf::mul<Fq>(j, h, i4);
    bnf::mul<Fq>(v, u1, i4);
    bnf::sqr<Fq>(t, rr);
    bnf::sub<Fq>(t, t, j);
    bnf::dbl<Fq>(w, v);
    bnf::sub<Fq>(xo, t, w);
    bnf::sub<Fq>(t, v, xo);
    bnf::mul<Fq>(t, rr, t);
    bnf::mul<Fq>(w, s1, j);
    bnf::dbl<Fq>(w, w);
    bnf::sub<Fq>(yo, t, w);
    bnf::mul<Fq>(t, z1, z2);
    bnf::mul<Fq>(t, t, h);
    bnf::dbl<Fq>(zo, t);
    bnf::canon<Fq>(xo, xo);
    bnf::canon<Fq>(yo, yo);
    bnf::canon<Fq>(zo, zo);

    const bool p_inf = bn254::is_zero(z1);
    const bool q_inf = bn254::is_zero(z2);
    const bool h_zero = bn254::is_zero(h);
    const bool r_zero = bn254::is_zero(rr);
    if (h_zero && r_zero && !p_inf && !q_inf) jac_double(xo, yo, zo, x1, y1, z1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        x3[i] = p_inf ? x2[i] : q_inf ? x1[i] : xo[i];
        y3[i] = p_inf ? y2[i] : q_inf ? y1[i] : yo[i];
        z3[i] = p_inf ? z2[i] : q_inf ? z1[i] : zo[i];
    }
}

// -y mod p, canonical (0 stays 0): the Y of -P (ops/field_torch.neg_mod).
BN_HD void neg(uint32_t r[8], const uint32_t y[8]) {
    uint32_t zero[8];
    bn254::set_zero(zero);
    bnf::sub<Fq>(r, zero, y);
    bnf::canon<Fq>(r, r);
}

// Index of the highest set bit of v != 0.
BN_HD int top_bit(uint32_t v) {
#ifdef __CUDA_ARCH__
    return 31 - __clz((int)v);
#else
    return 31 - __builtin_clz(v);
#endif
}

// Word i of k (i < 8) by selects, so that k stays in registers.
BN_HD uint32_t word(const uint32_t k[8], int i) {
    uint32_t r = k[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) r = i == j ? k[j] : r;
    return r;
}

// (x, y, z) = k P for a plain (not Montgomery) scalar k of 8 words, LSB
// first as utils/ec_fft.py::_scalar_mul_vec of the JAX package: R starts at
// infinity (all words 0), A at P; for each bit i, R = R + A where bit i is
// set, then A = 2 A. The doublings stop after k's top bit, where R no
// longer changes. k = 0 gives (0, 0, 0).
BN_HD void scalar_mul(uint32_t x[8], uint32_t y[8], uint32_t z[8], const uint32_t px[8],
                      const uint32_t py[8], const uint32_t pz[8], const uint32_t k[8]) {
    uint32_t ax[8], ay[8], az[8];
    bn254::copy(ax, px);
    bn254::copy(ay, py);
    bn254::copy(az, pz);
    bn254::set_zero(x);
    bn254::set_zero(y);
    bn254::set_zero(z);
    int top = -1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        if (k[i]) top = 32 * i + top_bit(k[i]);
    for (int i = 0; i <= top; ++i) {
        if ((word(k, i >> 5) >> (i & 31)) & 1u) jac_add(x, y, z, x, y, z, ax, ay, az);
        if (i < top) jac_double(ax, ay, az, ax, ay, az);
    }
}

}  // namespace g1
