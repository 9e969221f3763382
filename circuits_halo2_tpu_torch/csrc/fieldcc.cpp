// Native host-side runtime of the PyTorch/CUDA port (a copy of the JAX
// package's host runtime, with the same ABI version and byte formats).
//
// Torch and the CUDA kernels own the device compute path (NTT, MSM,
// Poseidon, polynomial phases); this C++ library owns the host runtime
// around it — the pieces the reference implements in native Rust
// (halo2curves BN254 field/curve arithmetic, Pippenger `best_multiexp`,
// keccak username hashing in `entry.rs:21`, SRS generation) that sit on the
// host side of the Fiat–Shamir serialization points. See SURVEY.md §2b.
//
// Data interchange is flat little-endian byte buffers (numpy-compatible):
//   scalar  = 32-byte LE canonical Fr element
//   affine  = 64-byte LE (x, y) Fq pair; (0, 0) = point at infinity
//   limbs16 = uint32[16][N] limb-major tensor, 16-bit limbs
//
// Exposed via extern "C" + ctypes. Built at first use by native.py:
// g++ -O3 -shared -fPIC -std=c++17 -pthread fieldcc.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <thread>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint32_t u32;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// 4x64 Montgomery arithmetic (CIOS), generic over the two BN254 moduli.
// ---------------------------------------------------------------------------

// FR (scalar field)
static const u64 FR_MOD[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL, 0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 FR_R[4]   = {0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL, 0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL};
static const u64 FR_R2[4]  = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL, 0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
static const u64 FR_INV = 0xc2e1f593efffffffULL;
// FQ (base field)
static const u64 FQ_MOD[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 FQ_R[4]   = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};
static const u64 FQ_R2[4]  = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL, 0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
static const u64 FQ_INV = 0x87d20782e4866389ULL;

struct Fp4 { u64 v[4]; };

static inline bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

static inline void sub4(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

template <const u64* MOD, u64 INV>
struct Mont {
    static void mul(u64 out[4], const u64 a[4], const u64 b[4]) {
        // CIOS Montgomery multiplication
        u64 t[6] = {0, 0, 0, 0, 0, 0};
        for (int i = 0; i < 4; ++i) {
            u128 carry = 0;
            for (int j = 0; j < 4; ++j) {
                u128 cur = (u128)a[j] * b[i] + t[j] + carry;
                t[j] = (u64)cur;
                carry = cur >> 64;
            }
            u128 cur = (u128)t[4] + carry;
            t[4] = (u64)cur;
            t[5] = (u64)(cur >> 64);
            u64 m = t[0] * INV;
            carry = ((u128)m * MOD[0] + t[0]) >> 64;
            for (int j = 1; j < 4; ++j) {
                u128 c2 = (u128)m * MOD[j] + t[j] + carry;
                t[j - 1] = (u64)c2;
                carry = c2 >> 64;
            }
            cur = (u128)t[4] + carry;
            t[3] = (u64)cur;
            t[4] = t[5] + (u64)(cur >> 64);
        }
        if (t[4] || geq(t, MOD)) sub4(out, t, MOD);
        else memcpy(out, t, 32);
    }
    static void sqr(u64 out[4], const u64 a[4]) { mul(out, a, a); }
    static void add(u64 out[4], const u64 a[4], const u64 b[4]) {
        u128 carry = 0;
        u64 t[4];
        for (int i = 0; i < 4; ++i) {
            u128 s = (u128)a[i] + b[i] + carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
        if (carry || geq(t, MOD)) sub4(out, t, MOD);
        else memcpy(out, t, 32);
    }
    static void sub(u64 out[4], const u64 a[4], const u64 b[4]) {
        u128 borrow = 0;
        u64 t[4];
        for (int i = 0; i < 4; ++i) {
            u128 d = (u128)a[i] - b[i] - borrow;
            t[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
        if (borrow) {
            u128 carry = 0;
            for (int i = 0; i < 4; ++i) {
                u128 s = (u128)t[i] + MOD[i] + carry;
                out[i] = (u64)s;
                carry = s >> 64;
            }
        } else memcpy(out, t, 32);
    }
    static void neg(u64 out[4], const u64 a[4]) {
        if (!(a[0] | a[1] | a[2] | a[3])) { memset(out, 0, 32); return; }
        sub4(out, MOD, a);
    }
    static bool is_zero(const u64 a[4]) { return !(a[0] | a[1] | a[2] | a[3]); }
    // a^e mod p (e as 4x64 LE), Montgomery in/out
    static void pow(u64 out[4], const u64 a[4], const u64 e[4], const u64 one[4]) {
        u64 acc[4];
        memcpy(acc, one, 32);
        for (int i = 3; i >= 0; --i) {
            for (int b = 63; b >= 0; --b) {
                sqr(acc, acc);
                if ((e[i] >> b) & 1) mul(acc, acc, a);
            }
        }
        memcpy(out, acc, 32);
    }
    // Montgomery inverse via Fermat: a^(p-2)
    static void inv(u64 out[4], const u64 a[4], const u64 one[4]) {
        u64 e[4];
        u64 two[4] = {2, 0, 0, 0};
        sub4(e, MOD, two);
        pow(out, a, e, one);
    }
};

typedef Mont<FR_MOD, FR_INV> FrM;
typedef Mont<FQ_MOD, FQ_INV> FqM;

// canonical LE bytes <-> u64[4]
static inline void load4(u64 out[4], const u8* p) { memcpy(out, p, 32); }
static inline void store4(u8* p, const u64 in[4]) { memcpy(p, in, 32); }

// ---------------------------------------------------------------------------
// Fr batch conversions: device limb tensors <-> canonical scalars
// ---------------------------------------------------------------------------

// limbs: uint32[16][n] limb-major, 16-bit limbs (possibly Montgomery form).
// out: n*32 bytes canonical LE. from_mont=1 applies the R^-1 factor.
extern "C" void fr_limbs16_to_scalars(const u32* limbs, size_t n, int from_mont, u8* out) {
    const u64 one[4] = {1, 0, 0, 0};
    for (size_t j = 0; j < n; ++j) {
        // assemble 256-bit value from 16 16-bit limbs (each < 2^32: carry)
        u64 v[5] = {0, 0, 0, 0, 0};
        for (int i = 0; i < 16; ++i) {
            u64 limb = limbs[(size_t)i * n + j];
            int word = i / 4, shift = (i % 4) * 16;
            u128 s = (u128)v[word] + ((u128)limb << shift);
            v[word] = (u64)s;
            u64 c = (u64)(s >> 64);
            for (int w = word + 1; c && w < 5; ++w) {
                u128 s2 = (u128)v[w] + c;
                v[w] = (u64)s2;
                c = (u64)(s2 >> 64);
            }
        }
        // reduce the (≤2^272) value mod p: fold the high word via 2^256 ≡ R
        u64 lo[4] = {v[0], v[1], v[2], v[3]};
        while (geq(lo, FR_MOD)) sub4(lo, lo, FR_MOD);
        if (v[4]) {
            u64 hi[4] = {v[4], 0, 0, 0};
            u64 hiR[4];
            FrM::mul(hiR, hi, FR_R2);    // hi * R mod p (mont-mul by R2 = hi*R)
            FrM::add(lo, lo, hiR);
        }
        if (from_mont) {
            FrM::mul(lo, lo, one);       // * R^-1
        }
        store4(out + j * 32, lo);
    }
}

// in: n*32 canonical LE scalars; limbs_out: uint32[16][n]. to_mont=1 stores a*R.
extern "C" void fr_scalars_to_limbs16(const u8* in, size_t n, int to_mont, u32* limbs_out) {
    for (size_t j = 0; j < n; ++j) {
        u64 v[4];
        load4(v, in + j * 32);
        if (to_mont) FrM::mul(v, v, FR_R2);
        for (int i = 0; i < 16; ++i) {
            int word = i / 4, shift = (i % 4) * 16;
            limbs_out[(size_t)i * n + j] = (u32)((v[word] >> shift) & 0xFFFF);
        }
    }
}

// In-place batched inversion of n canonical scalars (Montgomery trick: one inv).
extern "C" void fr_batch_inv(u8* scalars, size_t n) {
    if (!n) return;
    const u64 one[4] = {1, 0, 0, 0};
    std::vector<Fp4> pre(n);
    u64 acc[4];
    memcpy(acc, FR_R, 32);  // 1 in Montgomery form
    for (size_t i = 0; i < n; ++i) {
        u64 v[4];
        load4(v, scalars + i * 32);
        FrM::mul(v, v, FR_R2);  // to Montgomery
        memcpy(pre[i].v, acc, 32);
        if (!FrM::is_zero(v)) FrM::mul(acc, acc, v);
        store4(scalars + i * 32, v);  // stash mont form
    }
    u64 inv[4];
    FrM::inv(inv, acc, FR_R);
    for (size_t i = n; i-- > 0;) {
        u64 v[4];
        load4(v, scalars + i * 32);
        if (FrM::is_zero(v)) { store4(scalars + i * 32, v); continue; }
        u64 r[4];
        FrM::mul(r, inv, pre[i].v);
        FrM::mul(inv, inv, v);
        FrM::mul(r, r, one);  // from Montgomery
        store4(scalars + i * 32, r);
    }
}

// out = a*b mod p for n pairs of canonical scalars (elementwise)
extern "C" void fr_mul_batch(const u8* a, const u8* b, size_t n, u8* out) {
    const u64 one[4] = {1, 0, 0, 0};
    for (size_t i = 0; i < n; ++i) {
        u64 x[4], y[4], r[4];
        load4(x, a + i * 32);
        load4(y, b + i * 32);
        FrM::mul(x, x, FR_R2);
        FrM::mul(r, x, y);  // a*R * b * R^-1 = a*b
        (void)one;
        store4(out + i * 32, r);
    }
}

// ---------------------------------------------------------------------------
// BN254 G1 (Jacobian over Fq, Montgomery-form coordinates internally)
// ---------------------------------------------------------------------------

struct G1 {
    u64 x[4], y[4], z[4];  // z == 0 => infinity
};

static inline bool g1_is_inf(const G1& p) { return FqM::is_zero(p.z); }

static void g1_set_inf(G1& p) { memset(&p, 0, sizeof(G1)); }

// affine canonical bytes -> Jacobian Montgomery
static void g1_load_affine(G1& p, const u8* buf) {
    u64 x[4], y[4];
    load4(x, buf);
    load4(y, buf + 32);
    if (FqM::is_zero(x) && FqM::is_zero(y)) { g1_set_inf(p); return; }
    FqM::mul(p.x, x, FQ_R2);
    FqM::mul(p.y, y, FQ_R2);
    memcpy(p.z, FQ_R, 32);
}

// Jacobian Montgomery -> affine canonical bytes
static void g1_store_affine(u8* buf, const G1& p) {
    if (g1_is_inf(p)) { memset(buf, 0, 64); return; }
    const u64 one[4] = {1, 0, 0, 0};
    u64 zinv[4], zinv2[4], zinv3[4], x[4], y[4];
    FqM::inv(zinv, p.z, FQ_R);
    FqM::sqr(zinv2, zinv);
    FqM::mul(zinv3, zinv2, zinv);
    FqM::mul(x, p.x, zinv2);
    FqM::mul(y, p.y, zinv3);
    FqM::mul(x, x, one);
    FqM::mul(y, y, one);
    store4(buf, x);
    store4(buf + 32, y);
}

static void g1_double(G1& r, const G1& p) {
    if (g1_is_inf(p) || FqM::is_zero(p.y)) { g1_set_inf(r); return; }
    u64 a[4], b[4], c[4], d[4], e[4], f[4], t[4];
    FqM::sqr(a, p.x);            // A = X^2
    FqM::sqr(b, p.y);            // B = Y^2
    FqM::sqr(c, b);              // C = B^2
    FqM::add(d, p.x, b);         // D = 2*((X+B)^2 - A - C)
    FqM::sqr(d, d);
    FqM::sub(d, d, a);
    FqM::sub(d, d, c);
    FqM::add(d, d, d);
    FqM::add(e, a, a);           // E = 3A
    FqM::add(e, e, a);
    FqM::sqr(f, e);              // F = E^2
    u64 x3[4], y3[4], z3[4];
    FqM::sub(x3, f, d);          // X3 = F - 2D
    FqM::sub(x3, x3, d);
    FqM::sub(t, d, x3);          // Y3 = E*(D - X3) - 8C
    FqM::mul(y3, e, t);
    FqM::add(t, c, c);
    FqM::add(t, t, t);
    FqM::add(t, t, t);
    FqM::sub(y3, y3, t);
    FqM::mul(z3, p.y, p.z);      // Z3 = 2YZ
    FqM::add(z3, z3, z3);
    memcpy(r.x, x3, 32); memcpy(r.y, y3, 32); memcpy(r.z, z3, 32);
}

static void g1_add(G1& r, const G1& p, const G1& q) {
    if (g1_is_inf(p)) { r = q; return; }
    if (g1_is_inf(q)) { r = p; return; }
    u64 z1z1[4], z2z2[4], u1[4], u2[4], s1[4], s2[4];
    FqM::sqr(z1z1, p.z);
    FqM::sqr(z2z2, q.z);
    FqM::mul(u1, p.x, z2z2);
    FqM::mul(u2, q.x, z1z1);
    FqM::mul(s1, p.y, q.z); FqM::mul(s1, s1, z2z2);
    FqM::mul(s2, q.y, p.z); FqM::mul(s2, s2, z1z1);
    u64 h[4], rr[4];
    FqM::sub(h, u2, u1);
    FqM::sub(rr, s2, s1);
    if (FqM::is_zero(h)) {
        if (FqM::is_zero(rr)) { g1_double(r, p); return; }
        g1_set_inf(r); return;
    }
    u64 i[4], j[4], v[4], t[4];
    FqM::add(i, h, h); FqM::sqr(i, i);        // I = (2H)^2
    FqM::mul(j, h, i);                        // J = H*I
    FqM::add(rr, rr, rr);                     // r = 2*(S2-S1)
    FqM::mul(v, u1, i);                       // V = U1*I
    u64 x3[4], y3[4], z3[4];
    FqM::sqr(x3, rr);                         // X3 = r^2 - J - 2V
    FqM::sub(x3, x3, j);
    FqM::sub(x3, x3, v); FqM::sub(x3, x3, v);
    FqM::sub(t, v, x3);                       // Y3 = r*(V-X3) - 2*S1*J
    FqM::mul(y3, rr, t);
    FqM::mul(t, s1, j); FqM::add(t, t, t);
    FqM::sub(y3, y3, t);
    FqM::add(z3, p.z, q.z);                   // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2)*H
    FqM::sqr(z3, z3);
    FqM::sub(z3, z3, z1z1);
    FqM::sub(z3, z3, z2z2);
    FqM::mul(z3, z3, h);
    memcpy(r.x, x3, 32); memcpy(r.y, y3, 32); memcpy(r.z, z3, 32);
}

// mixed add: q affine-Montgomery (z implicit = 1/R form FQ_R)
struct G1Aff { u64 x[4], y[4]; bool inf; };

static void g1_madd(G1& r, const G1& p, const G1Aff& q) {
    if (q.inf) { r = p; return; }
    if (g1_is_inf(p)) {
        memcpy(r.x, q.x, 32); memcpy(r.y, q.y, 32); memcpy(r.z, FQ_R, 32);
        return;
    }
    u64 z1z1[4], u2[4], s2[4], h[4], rr[4];
    FqM::sqr(z1z1, p.z);
    FqM::mul(u2, q.x, z1z1);
    FqM::mul(s2, q.y, p.z); FqM::mul(s2, s2, z1z1);
    FqM::sub(h, u2, p.x);
    FqM::sub(rr, s2, p.y);
    if (FqM::is_zero(h)) {
        if (FqM::is_zero(rr)) { g1_double(r, p); return; }
        g1_set_inf(r); return;
    }
    u64 hh[4], i[4], j[4], v[4], t[4];
    FqM::sqr(hh, h);
    FqM::add(i, hh, hh); FqM::add(i, i, i);   // I = 4*HH
    FqM::mul(j, h, i);                        // J = H*I
    FqM::add(rr, rr, rr);                     // r = 2*(S2-Y1)
    FqM::mul(v, p.x, i);                      // V = X1*I
    u64 x3[4], y3[4], z3[4];
    FqM::sqr(x3, rr);
    FqM::sub(x3, x3, j);
    FqM::sub(x3, x3, v); FqM::sub(x3, x3, v);
    FqM::sub(t, v, x3);
    FqM::mul(y3, rr, t);
    FqM::mul(t, p.y, j); FqM::add(t, t, t);
    FqM::sub(y3, y3, t);
    FqM::add(z3, p.z, h);                     // Z3 = (Z1+H)^2 - Z1Z1 - HH
    FqM::sqr(z3, z3);
    FqM::sub(z3, z3, z1z1);
    FqM::sub(z3, z3, hh);
    memcpy(r.x, x3, 32); memcpy(r.y, y3, 32); memcpy(r.z, z3, 32);
}

// ---------------------------------------------------------------------------
// Pippenger MSM. points: n*64 canonical affine bytes; scalars: n*32 canonical.
// out: 64-byte canonical affine.
// ---------------------------------------------------------------------------

// one window's bucket accumulation + reduction → S_w = Σ_k k·B_k
static void msm_window(const std::vector<G1Aff>& pts, const u8* scalars,
                       size_t n, int c, int w, G1& out_sum) {
    size_t nbuckets = ((size_t)1 << c) - 1;
    std::vector<G1> buckets(nbuckets);
    for (auto& b : buckets) g1_set_inf(b);
    int bit0 = w * c;
    for (size_t i = 0; i < n; ++i) {
        if (pts[i].inf) continue;
        // extract c bits starting at bit0 from scalar i
        u64 v[4];
        load4(v, scalars + i * 32);
        int word = bit0 / 64, sh = bit0 % 64;
        u64 frag = v[word] >> sh;
        if (sh && word < 3) frag |= v[word + 1] << (64 - sh);
        frag &= nbuckets;  // (1<<c)-1
        if (!frag) continue;
        g1_madd(buckets[frag - 1], buckets[frag - 1], pts[i]);
    }
    // bucket reduction: sum_{k} k * bucket_k via running suffix sums
    G1 run, sum;
    g1_set_inf(run);
    g1_set_inf(sum);
    for (size_t k = nbuckets; k-- > 0;) {
        g1_add(run, run, buckets[k]);
        g1_add(sum, sum, run);
    }
    out_sum = sum;
}

extern "C" void g1_msm(const u8* points, const u8* scalars, size_t n, u8* out) {
    if (!n) { memset(out, 0, 64); return; }
    int c = 3;
    if (n >= 32) {
        size_t l = n;
        while (l >>= 1) ++c;  // c ≈ log2(n)
        c -= 2;
        if (c > 16) c = 16;
    }
    int windows = (254 + c - 1) / c;
    // preload affine Montgomery points
    std::vector<G1Aff> pts(n);
    for (size_t i = 0; i < n; ++i) {
        u64 x[4], y[4];
        load4(x, points + i * 64);
        load4(y, points + i * 64 + 32);
        pts[i].inf = FqM::is_zero(x) && FqM::is_zero(y);
        if (!pts[i].inf) {
            FqM::mul(pts[i].x, x, FQ_R2);
            FqM::mul(pts[i].y, y, FQ_R2);
        }
    }
    // windows are independent: stripe them across hardware threads, then
    // Horner-fold  acc = ((S_top·2^c + S_top-1)·2^c + …)  sequentially
    std::vector<G1> sums(windows);
    unsigned nthreads = std::thread::hardware_concurrency();
    if (nthreads == 0) nthreads = 1;
    if ((size_t)windows < (size_t)nthreads) nthreads = windows;
    if (n < 512) nthreads = 1;  // thread spawn not worth it for small MSMs
    if (nthreads <= 1) {
        for (int w = 0; w < windows; ++w)
            msm_window(pts, scalars, n, c, w, sums[w]);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nthreads);
        for (unsigned t = 0; t < nthreads; ++t) {
            threads.emplace_back([&, t]() {
                for (int w = t; w < windows; w += nthreads)
                    msm_window(pts, scalars, n, c, w, sums[w]);
            });
        }
        for (auto& th : threads) th.join();
    }
    G1 acc;
    g1_set_inf(acc);
    for (int w = windows - 1; w >= 0; --w) {
        for (int d = 0; d < c && !g1_is_inf(acc); ++d) g1_double(acc, acc);
        g1_add(acc, acc, sums[w]);
    }
    g1_store_affine(out, acc);
}

// fixed-base scalar muls: out[i] = scalars[i] * base (for SRS generation).
// base: 64-byte canonical affine; scalars: n*32; out: n*64.
extern "C" void g1_fixed_base_muls(const u8* base, const u8* scalars, size_t n, u8* out) {
    const int c = 8;  // window size
    const int windows = (254 + c - 1) / c;
    // table[w][d] = d * 2^{cw} * base, d in 1..2^c-1
    G1 b0;
    g1_load_affine(b0, base);
    std::vector<std::vector<G1>> table(windows);
    G1 wbase = b0;
    for (int w = 0; w < windows; ++w) {
        table[w].resize((1 << c) - 1);
        G1 acc = wbase;
        for (int d = 0; d < (1 << c) - 1; ++d) {
            table[w][d] = acc;
            g1_add(acc, acc, wbase);
        }
        wbase = acc;  // acc = 2^c * wbase after the loop
    }
    for (size_t i = 0; i < n; ++i) {
        u64 v[4];
        load4(v, scalars + i * 32);
        G1 acc;
        g1_set_inf(acc);
        for (int w = 0; w < windows; ++w) {
            int bit0 = w * c;
            int word = bit0 / 64, sh = bit0 % 64;
            u64 frag = v[word] >> sh;
            if (sh && word < 3) frag |= v[word + 1] << (64 - sh);
            frag &= (1 << c) - 1;
            if (frag) g1_add(acc, acc, table[w][frag - 1]);
        }
        g1_store_affine(out + i * 64, acc);
    }
}

// single scalar mul (double-and-add), for tests / odd cases
extern "C" void g1_scalar_mul(const u8* point, const u8* scalar, u8* out) {
    g1_msm(point, scalar, 1, out);
}

// batch point add: out[i] = a[i] + b[i] (canonical affine in/out)
extern "C" void g1_add_batch(const u8* a, const u8* b, size_t n, u8* out) {
    for (size_t i = 0; i < n; ++i) {
        G1 p, q, r;
        g1_load_affine(p, a + i * 64);
        g1_load_affine(q, b + i * 64);
        g1_add(r, p, q);
        g1_store_affine(out + i * 64, r);
    }
}

// ---------------------------------------------------------------------------
// Keccak-256 (the reference hashes usernames with ethers' keccak256,
// entry.rs:21). Batched over fixed-stride messages.
// ---------------------------------------------------------------------------

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline u64 rotl64(u64 x, int s) { return (x << s) | (x >> (64 - s)); }

static void keccak_f1600(u64 st[25]) {
    static const int rho[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
                                27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
    static const int pi[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
                               15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
    for (int round = 0; round < 24; ++round) {
        u64 bc[5];
        for (int i = 0; i < 5; ++i)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; ++i) {
            u64 t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        u64 t = st[1];
        for (int i = 0; i < 24; ++i) {
            u64 tmp = st[pi[i]];
            st[pi[i]] = rotl64(t, rho[i]);
            t = tmp;
        }
        for (int j = 0; j < 25; j += 5) {
            u64 row[5];
            for (int i = 0; i < 5; ++i) row[i] = st[j + i];
            for (int i = 0; i < 5; ++i)
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
        }
        st[0] ^= KECCAK_RC[round];
    }
}

// One keccak256 of a single message.
extern "C" void keccak256(const u8* msg, size_t len, u8* out32) {
    u64 st[25];
    memset(st, 0, sizeof(st));
    const size_t rate = 136;
    while (len >= rate) {
        for (size_t i = 0; i < rate / 8; ++i) {
            u64 w;
            memcpy(&w, msg + i * 8, 8);
            st[i] ^= w;
        }
        keccak_f1600(st);
        msg += rate;
        len -= rate;
    }
    u8 block[136];
    memset(block, 0, rate);
    memcpy(block, msg, len);
    block[len] ^= 0x01;       // keccak (pre-NIST) padding
    block[rate - 1] ^= 0x80;
    for (size_t i = 0; i < rate / 8; ++i) {
        u64 w;
        memcpy(&w, block + i * 8, 8);
        st[i] ^= w;
    }
    keccak_f1600(st);
    memcpy(out32, st, 32);
}

// Batch: n messages with prefix offsets (offsets[n+1] entries into data).
extern "C" void keccak256_batch(const u8* data, const u64* offsets, size_t n, u8* out) {
    for (size_t i = 0; i < n; ++i)
        keccak256(data + offsets[i], offsets[i + 1] - offsets[i], out + i * 32);
}

// ---------------------------------------------------------------------------
// Poseidon BN254 t=2 (rate 1), 8 full / 56 partial rounds, x^5 S-box — the
// reference's PoseidonSpec (poseidon_spec.rs:14-38). Used for host-side MST
// builds / verify replay; constants injected at init from Python (generated
// by the in-repo Grain LFSR, ops/grain.py) to keep a single source of truth.
// ---------------------------------------------------------------------------

static u64 POS_RC[64][2][4];   // round constants, Montgomery form
static u64 POS_MDS[2][2][4];   // MDS matrix, Montgomery form
static int POS_READY = 0;

extern "C" void poseidon_init(const u8* rc /*64*2*32*/, const u8* mds /*2*2*32*/) {
    for (int r = 0; r < 64; ++r)
        for (int i = 0; i < 2; ++i) {
            u64 v[4];
            load4(v, rc + (r * 2 + i) * 32);
            FrM::mul(POS_RC[r][i], v, FR_R2);
        }
    for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) {
            u64 v[4];
            load4(v, mds + (i * 2 + j) * 32);
            FrM::mul(POS_MDS[i][j], v, FR_R2);
        }
    POS_READY = 1;
}

static inline void sbox(u64 x[4]) {
    u64 x2[4], x4[4];
    FrM::sqr(x2, x);
    FrM::sqr(x4, x2);
    FrM::mul(x, x4, x);
}

static void poseidon_permute(u64 st[2][4]) {
    const int RF = 8, RP = 56;
    int r = 0;
    for (int half = 0; half < 2; ++half) {
        int nf = RF / 2;
        for (int k = 0; k < nf; ++k, ++r) {
            for (int i = 0; i < 2; ++i) FrM::add(st[i], st[i], POS_RC[r][i]);
            sbox(st[0]);
            sbox(st[1]);
            u64 n0[4], n1[4], t[4];
            FrM::mul(n0, POS_MDS[0][0], st[0]); FrM::mul(t, POS_MDS[0][1], st[1]); FrM::add(n0, n0, t);
            FrM::mul(n1, POS_MDS[1][0], st[0]); FrM::mul(t, POS_MDS[1][1], st[1]); FrM::add(n1, n1, t);
            memcpy(st[0], n0, 32); memcpy(st[1], n1, 32);
        }
        if (half == 0) {
            for (int k = 0; k < RP; ++k, ++r) {
                for (int i = 0; i < 2; ++i) FrM::add(st[i], st[i], POS_RC[r][i]);
                sbox(st[0]);
                u64 n0[4], n1[4], t[4];
                FrM::mul(n0, POS_MDS[0][0], st[0]); FrM::mul(t, POS_MDS[0][1], st[1]); FrM::add(n0, n0, t);
                FrM::mul(n1, POS_MDS[1][0], st[0]); FrM::mul(t, POS_MDS[1][1], st[1]); FrM::add(n1, n1, t);
                memcpy(st[0], n0, 32); memcpy(st[1], n1, 32);
            }
        }
    }
}

// ConstantLength<L> sponge hash over rate-1/capacity-1 (halo2_gadgets
// primitives semantics): capacity init = (L << 64) in the field; absorb one
// element per permutation with rate-position addition; squeeze state[0].
// msgs: n*L*32 canonical LE; out: n*32.
static void poseidon_hash_range(const u8* msgs, size_t lo, size_t hi, size_t L,
                                u8* out) {
    for (size_t m = lo; m < hi; ++m) {
        u64 st[2][4];
        // init: state = [0, capacity], capacity = L << 64 (ConstantLength)
        memset(st[0], 0, 32);
        u64 cap[4] = {0, (u64)L, 0, 0};
        FrM::mul(st[1], cap, FR_R2);
        for (size_t i = 0; i < L; ++i) {
            u64 v[4];
            load4(v, msgs + (m * L + i) * 32);
            u64 vm[4];
            FrM::mul(vm, v, FR_R2);
            FrM::add(st[0], st[0], vm);
            poseidon_permute(st);
        }
        // rate = 1, so ConstantLength zero-padding never applies; squeeze
        // state[0] directly (halo2_gadgets primitives semantics).
        const u64 one[4] = {1, 0, 0, 0};
        u64 r[4];
        FrM::mul(r, st[0], one);
        store4(out + m * 32, r);
    }
}

extern "C" int poseidon_hash_batch(const u8* msgs, size_t n, size_t L, u8* out) {
    if (!POS_READY) return -1;
    size_t nthreads = std::thread::hardware_concurrency();
    if (const char* env = getenv("CIRCUITS_NATIVE_THREADS")) {
        long v = atol(env);
        if (v > 0) nthreads = (size_t)v;
    }
    if (nthreads < 1) nthreads = 1;
    if (n < 1024 || nthreads == 1) {
        poseidon_hash_range(msgs, 0, n, L, out);
        return 0;
    }
    std::vector<std::thread> workers;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
        size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        workers.emplace_back(poseidon_hash_range, msgs, lo, hi, L, out);
    }
    for (auto& w : workers) w.join();
    return 0;
}

extern "C" int fieldcc_abi_version() { return 5; }
