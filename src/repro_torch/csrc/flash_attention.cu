// Flash-attention prefill (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention.py (flash_attention /
// _flash_kernel), in the GQA-aware form of its twin
// repro/models/layers.py:blocked_attention: online-softmax attention with
// f32 m/l/acc, causal mask cols <= rows + (skv - sq), ragged mask
// cols < skv, -1e30 for masked scores, output acc / max(l, 1e-30).
//
// What bounds it on the H100: at serving prefill shapes (hd 48, a few
// hundred tokens) the work is ~4 * sq * skv * hd / 2 flops per head
// against 4 * s * hd * itemsize bytes, i.e. tens of flops per byte --
// below the bf16 tensor-core ridge, so the bound is bytes, and for long
// prompts it becomes operations.  This first kernel computes in f32 on the
// CUDA cores (no wgmma yet), so it runs far from either bound; the
// numbers are in PERF.md.
//
// Design: one thread block per (64-row query tile, query head, batch row).
// GQA is native: the block reads kv head = q head / rep, with no repeat.
// The scaled Q tile stays in shared memory as f32; K/V tiles of 64 rows
// stream through shared memory (widened to f32).  Two threads own each
// query row: each scores 32 of the tile's 64 columns in registers, the
// pair combines max and sum with one shuffle, writes its probabilities to
// shared memory, and accumulates half of the row's head dims.  Tiles
// wholly above the causal diagonal are never loaded; inside a tile the
// causal and ragged masks score -1e30.  Rows past sq (the ragged query
// tail) are computed on zero queries and not stored.  Shared rows are
// padded by one float against bank conflicts.  Inputs may be strided
// (last dim contiguous), so the model's transposed views need no copy.
// For training the kernel also writes each row's log-sum-exp m + log l
// (f32), which the backward (flash_attention_bwd.cu) rebuilds the
// probabilities from; serving passes a null pointer and writes none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;            // query rows per block (2 threads a row)
constexpr int kBK = 64;            // key/value rows per tile
constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - m) == 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // qs[BQ][HD+1], ks[BK][HD+1], vs[BK][HD], ps[BQ][BK+1]
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int h,
                       int hkv, int sq, int skv, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, float scale) {
  static_assert(HD % 2 == 0, "head dim must be even");
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * HD;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hq / (h / hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // this thread's query row in the tile
  const int half = tid & 1;     // which half of the columns / head dims
  const int row = q0 + r;
  const int shift = skv - sq;   // causal alignment at the sequence end

  const T* qb = q + bi * qsb + hq * qsh;
  const T* kb = k + bi * ksb + g * ksh;
  const T* vb = v + bi * vsb + g * vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i - rr * HD;
    const int qr = q0 + rr;
    qs[rr * LD + d] = qr < sq ? to_f32(qb[qr * qss + d]) * scale : 0.f;
  }

  // last key column any stored row of this tile may see
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int kv_end = min(skv, last_row + shift + 1);

  float m = kNegInf, l = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q tile loaded / previous K,V tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD;
      const int col = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (col < skv) {
        kx = to_f32(kb[col * kss + d]);
        vx = to_f32(vb[col * vss + d]);
      }
      ks[j * LD + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores of this row's 32 columns: an outer product over head dims
    float s[kBK / 2];
#pragma unroll
    for (int jj = 0; jj < kBK / 2; ++jj) s[jj] = 0.f;
    const float* qr = qs + r * LD;
    const float* kh = ks + half * LD;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int jj = 0; jj < kBK / 2; ++jj)
        s[jj] = fmaf(qd, kh[2 * jj * LD + d], s[jj]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK / 2; ++jj) {
      const int col = k0 + half + 2 * jj;
      const bool keep = col < skv && col <= row + shift;
      s[jj] = keep ? s[jj] : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_cur = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK / 2; ++jj) {
      const float p = expf(s[jj] - m_cur);
      ps[r * LP + half + 2 * jj] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_cur);
    l = l * alpha + sum;
    m = m_cur;
    __syncwarp();  // the row's two threads share one warp
    const float* pr = ps + r * LP;
    const float* vh = vs + half;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha;
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        acc[i] = fmaf(p, vh[j * HD + 2 * i], acc[i]);
    }
  }

  if (row < sq) {
    T* orow = out + (((size_t)bi * h + hq) * sq + row) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      orow[half + 2 * i] = from_f32<T>(acc[i] / den);
    if (lse != nullptr && half == 0)
      lse[((size_t)bi * h + hq) * sq + row] = m + logf(den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int h, int hkv, int sq, int skv,
           const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, h, hkv, sq, skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int h, int hkv, int sq, int skv, int hd,
                const long long* st, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, h, hkv, sq, skv, st, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, h, hkv, sq, skv, st, scale, s);
    case 48: return launch<T, 48>(q, k, v, out, lse, b, h, hkv, sq, skv, st, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, b, h, hkv, sq, skv, st, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, b, h, hkv, sq, skv, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, h, sq, hd), k/v: (b, hkv, skv, hd) with element strides (batch,
// head, row) given and the last dim contiguous; out: contiguous
// (b, h, sq, hd); lse: contiguous (b, h, sq) f32, or null to skip it.
// dtype code: 0 = float32, 1 = bfloat16 (all four tensors).  Returns the
// cudaError_t of the launch (0 = success); an unsupported head dim or
// dtype returns cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int h,
                                   int hkv, int sq, int skv, int hd,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   float scale, int dtype,
                                   void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, static_cast<float*>(lse), b, h,
                              hkv, sq, skv, hd, st, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse),
                                      b, h, hkv, sq, skv, hd, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
