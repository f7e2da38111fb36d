// PAM4 quantize-encode and Q(mean)-decode for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/pam4.py: pam4_quantize_encode
// (_encode_kernel) and pam4_decode_dequantize (_decode_kernel), in the
// form the training path runs them (repro/collectives/backends.py):
// encode carries _encode's zero-block guard (a block whose shared scale
// sits at the f32-tiny floor gets the zero code), decode fuses Q(mean)
// (eq. 3) with dequantization, and the same decode at n = 1 turns one
// peer's own codes back into its quantized gradient (the local term of
// error feedback).
//
// What bounds it on the H100: both are one pass over the bucket with a
// handful of flops per element, so the bound is bytes: encode reads 4 B
// and writes 4 B per element per peer, decode reads 4 B and writes 4 B
// per element per row, against 3.35 TB/s of HBM.
//
// Design: one thread per output element in a grid-stride loop, so
// neighbouring threads touch neighbouring addresses and every load and
// store is coalesced; the per-block scale is a broadcast read that stays
// in L1.  Exactness comes first: the arithmetic is written with the
// correctly rounded intrinsics in the order of the JAX reference
// (__fdiv_rn then __fmul_rn, so nvcc cannot contract or reassociate it),
// and rintf rounds half to even as jnp.round does.  Where the JAX code
// divides by a compile-time constant (total / n, scale / levels), XLA
// compiles the division into a product with the f32 reciprocal, so the
// decode multiplies by __frcp_rn(n) and __frcp_rn(levels) too; and XLA
// contracts the error-feedback term flat - q * r into one fused
// multiply-add, so the decode, given the base, computes it with fmaf.
// That is what makes both bit-exact with the JAX training path.  Encode reads the
// bucket through a row stride and pads the ragged last block with zeros
// itself, so a (peers, elements) view of the flat gradient stack needs
// no copy; decode drops the pad columns as it writes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;        // enough to fill 132 SMs
constexpr float kTiny = 1.17549435e-38f;     // jnp.finfo(float32).tiny

int grid_for(long long count) {
  const long long want = (count + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

// u[r, j] for j < nb * block: the code of g[r * ld + j] (0 past m) under
// scale[j / block].
__global__ void __launch_bounds__(kThreads)
pam4_encode_kernel(const float* __restrict__ g,
                   const float* __restrict__ scale, int* __restrict__ u,
                   long long rows, int m, long long ld, int nb, int block,
                   int levels) {
  const long long width = (long long)nb * block;
  const long long count = rows * width;
  const float lv = (float)levels;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads) {
    const long long r = i / width;
    const int j = (int)(i - r * width);
    const float s = scale[j / block];
    int code = levels;                       // the zero code
    if (!(s <= kTiny)) {
      const float x = j < m ? g[r * ld + j] : 0.f;
      float q = rintf(__fmul_rn(__fdiv_rn(x, s), lv));
      q = fminf(fmaxf(q, -lv), lv);
      code = (int)q + levels;
    }
    u[i] = code;
  }
}

// out[r, j] for j < m: (rint(total[r, j] / n) - levels) * (safe / levels),
// each division a product with the f32 reciprocal (see above); with a
// base, base[r, j] - that product, rounded once.
__global__ void __launch_bounds__(kThreads)
pam4_decode_kernel(const int* __restrict__ total,
                   const float* __restrict__ scale,
                   const float* __restrict__ base, float* __restrict__ out,
                   long long rows, int m, long long ld, int nb, int block,
                   int levels, int n) {
  const long long width = (long long)nb * block;
  const long long count = rows * m;
  const float lv = (float)levels;
  const float rcp_n = __frcp_rn((float)n);
  const float rcp_lv = __frcp_rn(lv);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads) {
    const long long r = i / m;
    const int j = (int)(i - r * m);
    const float s = scale[j / block];
    const float safe = s <= kTiny ? 1.f : s;
    const float q =
        rintf(__fmul_rn((float)total[r * width + j], rcp_n)) - lv;
    const float step = __fmul_rn(safe, rcp_lv);
    out[i] = base == nullptr ? __fmul_rn(q, step)
                             : __fmaf_rn(-q, step, base[r * ld + j]);
  }
}

}  // namespace

// g: rows of m f32 values, row r at g + r * ld; scale: (nb,) f32 with
// nb = ceil(m / block); u: contiguous (rows, nb * block) int32.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int pam4_encode(const void* g, const void* scale, void* u,
                           long long rows, int m, long long ld, int nb,
                           int block, int bits, void* stream) {
  if (bits < 2 || bits > 16 || block < 1 || m < 1 ||
      (long long)nb * block < m || (long long)(nb - 1) * block >= m)
    return (int)cudaErrorInvalidValue;
  const long long count = rows * (long long)nb * block;
  pam4_encode_kernel<<<grid_for(count), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(scale),
      static_cast<int*>(u), rows, m, ld, nb, block, (1 << (bits - 1)) - 1);
  return (int)cudaGetLastError();
}

// total: contiguous (rows, nb * block) int32, each row a sum of n
// peers' codes; scale: (nb,) f32; base: null, or rows of m f32 values,
// row r at base + r * ld; out: contiguous (rows, m) f32.
extern "C" int pam4_decode(const void* total, const void* scale,
                           const void* base, void* out, long long rows,
                           int m, long long ld, int nb, int block, int bits,
                           int n, void* stream) {
  if (bits < 2 || bits > 16 || block < 1 || m < 1 || n < 1 ||
      (long long)nb * block < m || (long long)(nb - 1) * block >= m)
    return (int)cudaErrorInvalidValue;
  pam4_decode_kernel<<<grid_for(rows * (long long)m), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(total), static_cast<const float*>(scale),
      static_cast<const float*>(base), static_cast<float*>(out), rows, m, ld,
      nb, block, (1 << (bits - 1)) - 1, n);
  return (int)cudaGetLastError();
}
