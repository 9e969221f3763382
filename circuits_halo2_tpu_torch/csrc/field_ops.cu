// X0: the prover's field arithmetic on the card, one thread an element,
// reading and writing the port's (16, *batch) int64 16-bit limb tensors in
// place of any conversion pass. (X1, the NTT, is csrc/ntt.cu.)
//
// Replaces the JAX package's compiled (XLA, not Pallas) field arithmetic,
// which its prover runs as jitted programs:
// - X0a field_mont_mul_cuda: circuits_halo2_tpu/ops/field_jax.py::mont_mul
//   (and mont_sqr, to_mont, from_mont, pow5, which call it);
// - X0b field_linear_cuda: field_jax.py::add_mod, sub_mod, neg_mod, one
//   kernel with an op code;
// - X0c field_inv_cuda: field_jax.py::inv_mont, the Fermat inversion of
//   utils/poly_device.py::batch_inv_dev, as a Bernstein-Yang divstep
//   inversion (csrc/field_ops.cuh inv): 25 batches of 30 divsteps on
//   signed 30-bit limbs, a fixed count, then one product by R^3;
// - field_pow_cuda: field_jax.py::mont_pow (a lax.scan over the exponent's
//   bits), the chain for any exponent, off the prover's path since the
//   inversion has its own kernel.
// The plain torch versions are ops/field_torch.py's *_ref functions (the
// inversion's is mont_pow_ref(a, p - 2)); the per-thread code
// (csrc/field_ops.cuh) gives their limbs exactly.
//
// What bounds them on the card. A product is 132 wide multiplies (64 word
// products, 68 in the reduction) against 384 bytes of int64 limbs (two
// operands in, one out; a broadcast operand is read once): at the H100's
// 3.35 TB/s and about 8.4e12 wide multiplies a second, 115 ns of bytes for
// 16 ns of multiplies a thousand elements, so X0a and X0b are bound by the
// bytes of the int64-limb layout (four times those of 32-byte elements).
// The inversion is operations, and on the prover's path only a few
// elements (one a permutation set or lookup), so a launch is one thread's
// dependent chain: the Fermat chain's 381 products (about 50,000 wide
// multiplies) become 750 divsteps on two 32-bit words (about 17 word
// operations each) and 25 matrix updates of four 9-limb numbers (94 wide
// multiplies each, 2,350 in all), plus the product by R^3.
//
// Design: the simplest kernels that are right. Each thread computes its
// operands' offsets from its batch index through the strides the wrapper
// hands over (collapsed here on the host where axes are contiguous in every
// operand, so most calls decompose over one or two axes), loads 16 limbs an
// operand with the carries between them propagated, runs the per-thread
// code and stores 16 normalised limbs; consecutive threads touch
// consecutive int64s of every limb row.

#include "field_ops.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

using bn254::Fq;
using bn254::Fr;

namespace {

constexpr int THREADS = 256;      // X0a, X0b
constexpr int POW_THREADS = 128;  // the chain and the inversion

unsigned blocks(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class P>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, fops::Shape s, fops::Strides sa, fops::Strides sb,
                uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::mont_mul_thread<P>(a, b, out, s, sa, sb, n, t);
}

template <class P>
__global__ void __launch_bounds__(THREADS)
linear_kernel(int op, const int64_t* __restrict__ a, const int64_t* __restrict__ b,
              int64_t* __restrict__ out, fops::Shape s, fops::Strides sa, fops::Strides sb,
              uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::linear_thread<P>(op, a, b, out, s, sa, sb, n, t);
}

template <class P>
__global__ void __launch_bounds__(POW_THREADS)
pow_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, fops::Shape s,
           fops::Strides sa, fops::Exponent e, uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::pow_thread<P>(a, out, s, sa, e, n, t);
}

template <class P>
__global__ void __launch_bounds__(POW_THREADS)
inv_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, fops::Shape s,
           fops::Strides sa, fops::Words r3, uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::inv_thread<P>(a, out, s, sa, r3.w, n, t);
}

}  // namespace

// field: 0 Fr, 1 Fq. out is a contiguous (16, n) tensor, n the batch size.
extern "C" int field_mont_mul_cuda(const int64_t* a, const int64_t* b, int64_t* out,
                                   const int64_t* meta, int nd, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, sb;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, sb, n) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        mont_mul_kernel<Fr><<<blocks(m, THREADS), THREADS, 0, st>>>(a, b, out, s, sa, sb, m);
    else
        mont_mul_kernel<Fq><<<blocks(m, THREADS), THREADS, 0, st>>>(a, b, out, s, sa, sb, m);
    return (int)cudaGetLastError();
}

// op: 0 a + b, 1 a - b, 2 -a (b unused; its strides are a's)
extern "C" int field_linear_cuda(int op, const int64_t* a, const int64_t* b, int64_t* out,
                                 const int64_t* meta, int nd, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, sb;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, sb, n) || field < 0 || field > 1 || op < 0 || op > 2)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        linear_kernel<Fr><<<blocks(m, THREADS), THREADS, 0, st>>>(op, a, b, out, s, sa, sb, m);
    else
        linear_kernel<Fq><<<blocks(m, THREADS), THREADS, 0, st>>>(op, a, b, out, s, sa, sb, m);
    return (int)cudaGetLastError();
}

// exp: the exponent's 8 little-endian words, nbits its bits from the top
// one (1 for the exponent 0); meta as above, a given twice.
extern "C" int field_pow_cuda(const int64_t* a, int64_t* out, const int64_t* meta, int nd,
                              const uint32_t* exp, int nbits, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, unused;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, unused, n) || field < 0 || field > 1 || nbits < 1
        || nbits > 256)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    fops::Exponent e;
    for (int i = 0; i < 8; ++i) e.w[i] = exp[i];
    e.nbits = nbits;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        pow_kernel<Fr><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, e, m);
    else
        pow_kernel<Fq><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, e, m);
    return (int)cudaGetLastError();
}

// r3: R^3 mod p as 8 little-endian words; meta as above, a given twice.
extern "C" int field_inv_cuda(const int64_t* a, int64_t* out, const int64_t* meta, int nd,
                              const uint32_t* r3, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, unused;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, unused, n) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    fops::Words w;
    for (int i = 0; i < 8; ++i) w.w[i] = r3[i];
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        inv_kernel<Fr><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, w, m);
    else
        inv_kernel<Fq><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, w, m);
    return (int)cudaGetLastError();
}
#endif
