// PAM4 quantize-encode and Q(mean)-decode for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/pam4.py::pam4_quantize_encode
// (_encode_kernel) and src/repro/kernels/pam4.py::pam4_decode_dequantize
// (_decode_kernel), in the
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
// and one 32-bit division a thread.
//
// Decode's design, on the same grid (blockIdx.x over the m output
// columns, not the padded width): it moves 4 B of sums in and 4 B out a
// column (plus 4 B of base with error feedback) and does three rounded
// products a column, so bytes bound it as long as its instructions stay
// under them, and a flat index would cost a 64-bit division an element
// to find its row.  Here no thread divides an index; it computes its
// scale's index once (one 32-bit division) and its step once for every
// row.  Where block % 4 == 0 a thread owns 4 columns that share a scale:
// one 16-byte load of sums (a sum row is nb * block wide, a multiple of
// 4, so every row starts on 16 bytes), one 16-byte load of base and one
// 16-byte store.  At a bucket that is one wave of threads, each with one
// load in flight, so latency and the cache policy set the time: the
// first row's loads go out before the scale's, and the sums, read once,
// are loaded evict-first.  This "aligned" form needs every output row
// and every base row on 16 bytes (one row, or m % 4 == 0 and a base row
// stride a multiple of 4), which every decode of the training path
// meets: the Q(mean) sums are one row, and the error-feedback base is
// the bucket plus its residual, a fresh contiguous array.  Anything
// else (a base view off the alignment, 4 rows with m % 4 != 0, a block
// size not a multiple of 4) takes the scalar form, a thread an element:
// no path that is timed gives such a case, so it is kept simple rather
// than read around by shuffle as encode's views are.  The ragged tail
// before m is written element by element; pad columns are read (they
// lie inside the sum row) and never written.
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
constexpr int kGridY = 65535;
constexpr float kTiny = 1.17549435e-38f;     // jnp.finfo(float32).tiny
enum Form { kScalar = 0, kAligned = 1, kShifted = 2 };

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

// The dequantization step of a block of scale s: safe / levels, as a
// product with the f32 reciprocal (see above), safe = 1 at the f32-tiny
// floor (the zero-block guard).
__device__ __forceinline__ float decode_step(float s, float lv) {
  return __fmul_rn(s <= kTiny ? 1.f : s, __frcp_rn(lv));
}

// One column: (rint(t / n) - levels) * step, the division a product with
// the f32 reciprocal; with a base, base - that product, rounded once.
template <bool BASE>
__device__ __forceinline__ float decode_one(int t, float rcp_n, float lv,
                                            float step, float b) {
  const float q = rintf(__fmul_rn((float)t, rcp_n)) - lv;
  return BASE ? __fmaf_rn(-q, step, b) : __fmul_rn(q, step);
}

// out[r, j] for j < m, a thread a column: total[r * width + j] decoded
// under scale[j / block], minus from base[r * ld + j] where base is set.
__global__ void __launch_bounds__(kThreads)
pam4_decode_kernel(const int* __restrict__ total,
                   const float* __restrict__ scale,
                   const float* __restrict__ base, float* __restrict__ out,
                   long long rows, int m, long long ld, int width, int block,
                   int levels, int n) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const float lv = (float)levels;
  const float rcp_n = __frcp_rn((float)n);
  const float step = decode_step(__ldg(scale + j / block), lv);
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int t = total[r * width + j];
    out[r * m + j] = base == nullptr
        ? decode_one<false>(t, rcp_n, lv, step, 0.f)
        : decode_one<true>(t, rcp_n, lv, step, base[r * ld + j]);
  }
}

// out[r, j0 .. j0 + 3] for the thread's 4 columns (block % 4 == 0; the
// sums, every output row and, with BASE, every base row on 16 bytes).
// The first row's loads are issued before the scale's, so the two
// latencies overlap instead of adding up.  The sums are read once, so
// they are loaded evict-first (ld.global.cs); so is the error-feedback
// output stored, which is read again only at the next step, while the
// Q(mean) output, which the optimizer reads next, is stored as usual.
template <bool BASE>
__global__ void __launch_bounds__(kThreads)
pam4_decode_vec_kernel(const int* __restrict__ total,
                       const float* __restrict__ scale,
                       const float* __restrict__ base,
                       float* __restrict__ out, long long rows, int m,
                       long long ld, int width, int block, int levels,
                       int n) {
  const int j0 = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (j0 >= m) return;
  int4 t;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_row = [&](long long r) {
    t = __ldcs(reinterpret_cast<const int4*>(total + r * width + j0));
    if (BASE) b = load4(base + r * ld, j0, m);
  };
  long long r = blockIdx.y;
  load_row(r);
  const float lv = (float)levels;
  const float rcp_n = __frcp_rn((float)n);
  const float step = decode_step(__ldg(scale + j0 / block), lv);
  for (;;) {
    const float4 y = make_float4(
        decode_one<BASE>(t.x, rcp_n, lv, step, b.x),
        decode_one<BASE>(t.y, rcp_n, lv, step, b.y),
        decode_one<BASE>(t.z, rcp_n, lv, step, b.z),
        decode_one<BASE>(t.w, rcp_n, lv, step, b.w));
    float* o = out + r * m + j0;
    if (j0 + 3 < m && BASE) {
      __stcs(reinterpret_cast<float4*>(o), y);
    } else if (j0 + 3 < m) {
      *reinterpret_cast<float4*>(o) = y;
    } else {                        // the ragged tail
      o[0] = y.x;
      if (j0 + 1 < m) o[1] = y.y;
      if (j0 + 2 < m) o[2] = y.z;
    }
    r += gridDim.y;
    if (r >= rows) break;
    load_row(r);
  }
}

}  // namespace

// g: rows of m f32 values, row r at g + r * ld; scale: (nb,) f32 with
// nb = ceil(m / block); u: contiguous (rows, nb * block) int32; form: the
// wrapper's encode_form (kernels/pam4.py), refused where its
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
// row r at base + r * ld; out: contiguous (rows, m) f32; form: the
// wrapper's decode_form (kernels/pam4.py), refused where its conditions
// fail.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pam4_decode(const void* total, const void* scale,
                           const void* base, void* out, long long rows,
                           int m, long long ld, int nb, int block, int bits,
                           int n, int form, void* stream) {
  const long long width = (long long)nb * block;
  const uintptr_t tp = reinterpret_cast<uintptr_t>(total);
  const uintptr_t bp = reinterpret_cast<uintptr_t>(base);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  if (bits < 2 || bits > 16 || block < 1 || m < 1 || n < 1 || rows < 1 ||
      width < m || (long long)(nb - 1) * block >= m ||
      width > (1LL << 31) - 4LL * kThreads || tp % 4 || bp % 4 || op % 4 ||
      (form != kScalar && form != kAligned) ||
      (form == kAligned &&
       (block % 4 || tp % 16 || op % 16 || (rows > 1 && m % 4) ||
        (base != nullptr && (bp % 16 || (rows > 1 && ld % 4))))))
    return (int)cudaErrorInvalidValue;
  const int per_block = form == kAligned ? 4 * kThreads : kThreads;
  const dim3 grid((unsigned)(((long long)m + per_block - 1) / per_block),
                  (unsigned)(rows < kGridY ? rows : kGridY));
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(total), static_cast<const float*>(scale),
        static_cast<const float*>(base), static_cast<float*>(out), rows, m,
        ld, (int)width, block, (1 << (bits - 1)) - 1, n);
  };
  if (form == kScalar)
    args(pam4_decode_kernel);
  else if (base != nullptr)
    args(pam4_decode_vec_kernel<true>);
  else
    args(pam4_decode_vec_kernel<false>);
  return (int)cudaGetLastError();
}
