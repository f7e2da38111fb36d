// Flash-attention backward for Hopper (sm_90a).
//
// The TPU kernel repro/kernels/attention.py (flash_attention /
// _flash_kernel) has no Pallas backward: the JAX package differentiates
// its jnp twin repro/models/layers.py:blocked_attention.  In the port the
// forward is a kernel (flash_attention.cu), so training needs this
// backward on the card.  It computes the flash-attention gradient from
// the forward's output O and per-row log-sum-exp L, with the forward's
// masks (causal cols <= rows + (skv - sq), ragged cols < skv) and GQA
// (kv head = q head / rep):
//   P = exp(S - L),  D = rowsum(dO * O),  dS = P * (dO V^T - D),
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
//
// What bounds it on the H100: it reads q, k, v, o, dO and writes dq, dk,
// dv once, and does ~2.5x the forward's products (S, dP, dV, dK, dQ:
// 10 * hd flops per visible (row, column) pair).  At the training shapes
// (t 512, hd 48, causal) that is ~160 flops per byte, below the bf16
// tensor-core ridge (~295), so the bound is bytes; longer sequences
// cross over to operations.  This first kernel computes in f32 on the
// CUDA cores (no wgmma), so it runs far from that bound; PERF.md has the
// numbers.
//
// Design: three launches, no atomics, so the result is deterministic.
//  1. a pre-pass, one warp per query row, writes D = rowsum(dO * O);
//  2. one block per (64-row kv tile, kv head, batch row) walks every
//     query head of its GQA group and every query tile at or below the
//     diagonal, and accumulates its rows' dK and dV in registers: the
//     rep heads' contributions are summed inside the block;
//  3. one block per (64-row query tile, query head, batch row) walks the
//     kv tiles up to the diagonal and accumulates its rows' dQ.
// Both main kernels rebuild each (64 x 64) tile of P and dS in shared
// memory from the scaled Q, dO, K and V tiles (widened to f32, rows
// padded by one float against bank conflicts): thread t owns column
// t % 64 and 32 rows, with the scores and dP of those rows in registers.
// Tiles wholly above the diagonal are never visited; inside a tile the
// masks give P = 0.  Inputs may be strided (last dim contiguous), like
// the forward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key/value rows per tile
constexpr int kLP = kBK + 1;     // padded row of the P / dS tiles
static_assert(kThreads == 2 * kBK && kThreads == 2 * kBQ, "2 threads a row");

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

// D[i] = sum_d dO[i, d] * O[i, d] for the (b, h, sq) rows; one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dot_kernel(const T* __restrict__ dout, const T* __restrict__ o,
               float* __restrict__ dsum, int h, int sq, int hd,
               long long gsb, long long gsh, long long gss, long long rows) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= rows) return;                 // uniform across the warp
  const int r = (int)(i % sq);
  const long long bh = i / sq;
  const int hq = (int)(bh % h);
  const long long bi = bh / h;
  const T* dr = dout + bi * gsb + hq * gsh + r * gss;
  const T* orow = o + i * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(dr[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[i] = acc;
}

template <int HD>
constexpr size_t smem_floats() {
  // qs, dos [BQ][HD+1]; ks, vs [BK][HD+1]; ps, dss [BQ][BK+1]; lse, D [BQ]
  return 2 * (size_t)kBQ * (HD + 1) + 2 * (size_t)kBK * (HD + 1) +
         2 * (size_t)kBQ * kLP + 2 * (size_t)kBQ;
}

// Rows [r0, r0 + 64) of a (., ., s, HD) tensor into a [64][HD+1] f32
// tile, times mul; rows past s read as zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int s,
                                          float mul) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int rr = i / HD, d = i - rr * HD;
    const int r = r0 + rr;
    dst[rr * LD + d] = r < s ? to_f32(src[r * stride + d]) * mul : 0.f;
  }
}

// One (64 x 64) tile of P (into ps, unless null) and dS (into dss) from
// the scaled queries qs, dO tile dos, K tile ks and V tile vs.  Thread t
// owns column t % 64 and rows i0 .. i0 + 31, i0 = (t / 64) * 32.
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, float* ps, float* dss, int q0,
    int k0, int sq, int skv, int shift) {
  constexpr int LD = HD + 1;
  constexpr int NR = kBQ / 2;
  const int c = threadIdx.x % kBK;
  const int i0 = (threadIdx.x / kBK) * NR;
  float s[NR], dp[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) s[i] = dp[i] = 0.f;
  const float* kr = ks + c * LD;
  const float* vr = vs + c * LD;
  const float* qb = qs + i0 * LD;
  const float* db = dos + i0 * LD;
#pragma unroll 2
  for (int d = 0; d < HD; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      s[i] = fmaf(qb[i * LD + d], kd, s[i]);
      dp[i] = fmaf(db[i * LD + d], vd, dp[i]);
    }
  }
  const int col = k0 + c;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int ii = i0 + i;
    const int row = q0 + ii;
    const bool keep = row < sq && col < skv && col <= row + shift;
    const float p = keep ? expf(s[i] - lse_s[ii]) : 0.f;
    if (ps != nullptr) ps[ii * kLP + c] = p;
    dss[ii * kLP + c] = p * (dp[i] - d_s[ii]);
  }
}

struct Strides {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss;
};

// Per-row log-sum-exp and D of query rows [q0, q0 + 64) into shared.
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const float* lse, const float* dsum,
                                          size_t base, int q0, int sq) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int r = q0 + i;
    lse_s[i] = r < sq ? lse[base + r] : 0.f;
    d_s[i] = r < sq ? dsum[base + r] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int h, int hkv, int sq, int skv,
                      Strides st, float scale) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;
  float* dss = ps + kBQ * kLP;
  float* lse_s = dss + kBQ * kLP;
  float* d_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = h / hkv;
  const int shift = skv - sq;
  const int c = threadIdx.x >> 1;     // this thread's kv row in the tile
  const int half = threadIdx.x & 1;   // which half of the head dims

  load_tile<T, HD>(ks, k + bi * st.ksb + g * st.ksh, st.kss, k0, skv, 1.f);
  load_tile<T, HD>(vs, v + bi * st.vsb + g * st.vsh, st.vss, k0, skv, 1.f);

  float adk[HD / 2], adv[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) adk[j] = adv[j] = 0.f;

  // the first query row that sees column k0 is k0 - shift
  const int q_start = (max(0, k0 - shift) / kBQ) * kBQ;
  for (int hi = 0; hi < rep; ++hi) {
    const int hq = g * rep + hi;
    const size_t base = ((size_t)bi * h + hq) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kBQ) {
      __syncthreads();   // K/V loaded / previous tiles consumed
      load_tile<T, HD>(qs, q + bi * st.qsb + hq * st.qsh, st.qss, q0, sq,
                       scale);
      load_tile<T, HD>(dos, dout + bi * st.gsb + hq * st.gsh, st.gss, q0,
                       sq, 1.f);
      load_rows(lse_s, d_s, lse, dsum, base, q0, sq);
      __syncthreads();
      tile_p_ds<HD>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq, skv,
                    shift);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        const float p = ps[i * kLP + c];
        const float ds = dss[i * kLP + c];
        const float* dor = dos + i * LD + half;
        const float* qr = qs + i * LD + half;
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) {
          adv[j] = fmaf(p, dor[2 * j], adv[j]);
          adk[j] = fmaf(ds, qr[2 * j], adk[j]);   // qs holds the scale
        }
      }
    }
  }
  const int row = k0 + c;
  if (row < skv) {
    const size_t o = (((size_t)bi * hkv + g) * skv + row) * HD + half;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) {
      dk[o + 2 * j] = from_f32<T>(adk[j]);
      dv[o + 2 * j] = from_f32<T>(adv[j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int h, int hkv, int sq, int skv, Strides st,
                    float scale) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LD;
  float* lse_s = dss + kBQ * kLP;
  float* d_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hq / (h / hkv);
  const int shift = skv - sq;
  const int r = threadIdx.x >> 1;     // this thread's query row in the tile
  const int half = threadIdx.x & 1;

  load_tile<T, HD>(qs, q + bi * st.qsb + hq * st.qsh, st.qss, q0, sq, scale);
  load_tile<T, HD>(dos, dout + bi * st.gsb + hq * st.gsh, st.gss, q0, sq,
                   1.f);
  const size_t base = ((size_t)bi * h + hq) * sq;
  load_rows(lse_s, d_s, lse, dsum, base, q0, sq);

  float adq[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) adq[j] = 0.f;

  const int last_row = min(q0 + kBQ, sq) - 1;
  const int kv_end = min(skv, last_row + shift + 1);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // Q tile loaded / previous K,V tile consumed
    load_tile<T, HD>(ks, k + bi * st.ksb + g * st.ksh, st.kss, k0, skv, 1.f);
    load_tile<T, HD>(vs, v + bi * st.vsb + g * st.vsh, st.vss, k0, skv, 1.f);
    __syncthreads();
    tile_p_ds<HD>(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, q0, k0, sq,
                  skv, shift);
    __syncthreads();
    const float* dr = dss + r * kLP;
#pragma unroll 2
    for (int cc = 0; cc < kBK; ++cc) {
      const float ds = dr[cc];
      const float* kr = ks + cc * LD + half;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) adq[j] = fmaf(ds, kr[2 * j], adq[j]);
    }
  }
  const int row = q0 + r;
  if (row < sq) {
    T* out = dq + (base + row) * HD + half;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) out[2 * j] = from_f32<T>(adq[j] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* dsum, void* dq,
           void* dk, void* dv, int b, int h, int hkv, int sq, int skv,
           const Strides& st, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const long long rows = (long long)b * h * sq;
  const long long pre_blocks = (rows * 32 + kThreads - 1) / kThreads;
  row_dot_kernel<T><<<(unsigned)pre_blocks, kThreads, 0, stream>>>(
      dt, static_cast<const T*>(o), dsum, h, sq, HD, st.gsb, st.gsh, st.gss,
      rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD>;
  auto q_kernel = flash_bwd_dq_kernel<T, HD>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 kv_grid((skv + kBK - 1) / kBK, hkv, b);
  kv_kernel<<<kv_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), h,
      hkv, sq, skv, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid((sq + kBQ - 1) / kBQ, h, b);
  q_kernel<<<q_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<T*>(dq), h, hkv, sq, skv, st,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* o, const float* lse, const void* dout,
                float* dsum, void* dq, void* dk, void* dv, int b, int h,
                int hkv, int sq, int skv, const Strides& st, float scale,
                cudaStream_t s) {
#define FLASH_BWD_CASE(HD)                                                  \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, o, lse, dout, dsum, dq, dk, dv, b, h, hkv, \
                         sq, skv, st, scale, s);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

// q: (b, h, sq, hd), k/v: (b, hkv, skv, hd), dout: (b, h, sq, hd), each
// with element strides (batch, head, row) given and the last dim
// contiguous; o: contiguous (b, h, sq, hd), the forward's output; lse:
// contiguous (b, h, sq) f32, the forward's log-sum-exp; dsum: (b, h, sq)
// f32 scratch; dq: contiguous (b, h, sq, hd), dk/dv: contiguous
// (b, hkv, skv, hd).  dtype code: 0 = float32, 1 = bfloat16 (every
// tensor but lse and dsum).  Returns the cudaError_t of the launches.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dsum, void* dq, void* dk,
    void* dv, int b, int h, int hkv, int sq, int skv, int hd, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long gsb, long long gsh, long long gss, float scale, int dtype,
    void* stream) {
  if (hkv < 1 || h % hkv || skv < sq || sq < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss};
  auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, l, dout, ds, dq, dk, dv, b, h,
                              hkv, sq, skv, st, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, l, dout, ds, dq, dk,
                                      dv, b, h, hkv, sq, skv, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
