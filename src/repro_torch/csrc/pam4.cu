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
// per element per row, against 3.35 TB/s of HBM.  Encode must also keep
// its instructions under that: the IEEE division it owes JAX is a dozen
// instructions an element.
//
// Encode's design: a two-dimensional grid, blockIdx.y the row and
// blockIdx.x the columns, so no thread divides a flat index by the
// width.  Where the block size is a multiple of 4 (the plan's vector
// forms) a thread owns 4 consecutive columns: one scale (the 4 share a
// block), one 16-byte load of x and one 16-byte store of codes.  The
// output rows are always 16-byte aligned; where an input row is not (a
// view off the alignment, or a row stride not a multiple of 4), the
// "shifted" form loads the aligned vectors that cover the row and takes
// each thread's 4 values from its own vector and its neighbour's by warp
// shuffle.  Vectors that cross the row's start, the ragged tail before m
// or the pad columns are read element by element (0 past m).  Every other
// block size takes the scalar form: a thread an element, one scale read
// and one 32-bit division a thread.  Decode: one thread per output
// element in a grid-stride loop, so neighbouring threads touch
// neighbouring addresses and every load and store is coalesced; the
// per-block scale is a broadcast read that stays in L1.
//
// Exactness comes first: the arithmetic is written with the
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;        // enough to fill 132 SMs
constexpr int kGridY = 65535;
constexpr float kTiny = 1.17549435e-38f;     // jnp.finfo(float32).tiny
enum EncodeForm { kScalar = 0, kAligned = 1, kShifted = 2 };

int grid_for(long long count) {
  const long long want = (count + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

// the code of x under the block scale s (the zero code where s is at the
// f32-tiny floor: the zero-block guard)
__device__ __forceinline__ int encode_one(float x, float s, float lv,
                                          int levels) {
  if (s <= kTiny) return levels;
  float q = rintf(__fmul_rn(__fdiv_rn(x, s), lv));
  q = fminf(fmaxf(q, -lv), lv);
  return (int)q + levels;
}

// u[r, j] for j < width: the code of g[r * ld + j] (0 past m) under
// scale[j / block]; a thread an element.
__global__ void __launch_bounds__(kThreads)
pam4_encode_kernel(const float* __restrict__ g,
                   const float* __restrict__ scale, int* __restrict__ u,
                   long long rows, int m, long long ld, int width, int block,
                   int levels) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= width) return;
  const float s = __ldg(scale + j / block);
  const float lv = (float)levels;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float x = j < m ? g[r * ld + j] : 0.f;
    u[r * width + j] = encode_one(x, s, lv, levels);
  }
}

// row[i0 .. i0 + 3], 0 outside [0, m); one 16-byte load where the four
// lie inside (row + i0 is then 16-byte aligned by the caller's form)
__device__ __forceinline__ float4 load4(const float* row, int i0, int m) {
  if (i0 >= 0 && i0 + 3 < m)
    return __ldg(reinterpret_cast<const float4*>(row + i0));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (i0 + e >= 0 && i0 + e < m) ? row[i0 + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// u[r, 4c .. 4c + 3] for the thread's chunk c (block % 4 == 0, so the
// four share a scale and every output row is 16-byte aligned).  SHIFT:
// an input row may start off the 16-byte alignment by d floats; the
// thread loads the aligned vector that holds row[4c - d ..] and takes
// the values past it from the next lane's vector.
template <bool SHIFT>
__global__ void __launch_bounds__(kThreads)
pam4_encode_vec_kernel(const float* __restrict__ g,
                       const float* __restrict__ scale, int* __restrict__ u,
                       long long rows, int m, long long ld, int width,
                       int block, int levels) {
  const int j0 = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const bool in = j0 < width;     // threads past it still shuffle
  const float s = in ? __ldg(scale + j0 / block) : 1.f;
  const float lv = (float)levels;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* row = g + r * ld;
    float4 x;
    if (!SHIFT) {
      x = load4(row, j0, m);
    } else {
      const int d = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
      const float4 lo = load4(row, j0 - d, m);
      if (d == 0) {
        x = lo;
      } else {
        float4 hi;
        hi.x = __shfl_down_sync(0xffffffffu, lo.x, 1);
        hi.y = __shfl_down_sync(0xffffffffu, lo.y, 1);
        hi.z = __shfl_down_sync(0xffffffffu, lo.z, 1);
        hi.w = __shfl_down_sync(0xffffffffu, lo.w, 1);
        if ((threadIdx.x & 31) == 31) hi = load4(row, j0 + 4 - d, m);
        x = d == 1   ? make_float4(lo.y, lo.z, lo.w, hi.x)
            : d == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                     : make_float4(lo.w, hi.x, hi.y, hi.z);
      }
    }
    if (in) {
      int4 c;
      c.x = encode_one(x.x, s, lv, levels);
      c.y = encode_one(x.y, s, lv, levels);
      c.z = encode_one(x.z, s, lv, levels);
      c.w = encode_one(x.w, s, lv, levels);
      *reinterpret_cast<int4*>(u + r * width + j0) = c;
    }
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
// nb = ceil(m / block); u: contiguous (rows, nb * block) int32; form: the
// wrapper plan's EncodeForm (kernels/pam4.py), refused where its
// conditions fail.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pam4_encode(const void* g, const void* scale, void* u,
                           long long rows, int m, long long ld, int nb,
                           int block, int bits, int form, void* stream) {
  const long long width = (long long)nb * block;
  const uintptr_t gp = reinterpret_cast<uintptr_t>(g);
  const bool vec = form == kAligned || form == kShifted;
  if (bits < 2 || bits > 16 || block < 1 || m < 1 || rows < 1 ||
      width < m || (long long)(nb - 1) * block >= m ||
      width > (1LL << 31) - 4LL * kThreads || gp % 4 ||
      (form != kScalar && !vec) || (vec && block % 4) ||
      (form == kAligned && (gp % 16 || (rows > 1 && ld % 4))))
    return (int)cudaErrorInvalidValue;
  const int per_block = vec ? 4 * kThreads : kThreads;
  const dim3 grid((unsigned)((width + per_block - 1) / per_block),
                  (unsigned)(rows < kGridY ? rows : kGridY));
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(scale),
        static_cast<int*>(u), rows, m, ld, (int)width, block,
        (1 << (bits - 1)) - 1);
  };
  if (form == kScalar)
    args(pam4_encode_kernel);
  else if (form == kAligned)
    args(pam4_encode_vec_kernel<false>);
  else
    args(pam4_encode_vec_kernel<true>);
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
