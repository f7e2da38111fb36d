// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (paged_attention / _paged_attention_kernel): one pending query per slot
// attends over that slot's pages of the shared KV pool in place, steered
// by the slot's page-table row; positions >= length score -1e30; online
// softmax with f32 m/l/acc; output acc / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each slot reads ceil(len/page) pages
// of K and V once (2 * len * hkv * hd * itemsize bytes) and does 4 flops
// per byte-pair read, far below the ~295 flops/byte ridge, so the floor is
// device-memory bandwidth (3.35 TB/s).
//
// Design: one thread block per (slot, kv head).  The block reads its own
// page-table row and length (no scalar prefetch on a GPU).  It walks the
// slot's valid positions in tiles of 32: the tile's K and V rows are
// copied from their pages into shared memory as f32 (bf16 pages are
// widened with __bfloat162float), each of the rep = h/hkv query rows
// scores the tile, and one warp per query row folds the tile into the
// row's online-softmax state.  Pages past the slot's length are never
// read: a fully masked page would leave (m, l, acc) exactly unchanged
// once m is finite, so skipping it gives the same result.  The K tile row
// is padded by one float so the per-row dot products do not collide on a
// shared-memory bank.  A slot of length 0 is a pad row: zeros are written.
// Simple first: no cp.async/TMA pipeline and no split over pages
// (flash-decoding); with b*hkv blocks the grid can be smaller than the
// card at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;          // positions per tile == warp width
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

__host__ __device__ inline size_t smem_floats(int rep, int hd) {
  // qs[rep][hd], acc[rep][hd], ks[tile][hd+1], vs[tile][hd], sc[rep][tile],
  // m/l/alpha[rep]
  return (size_t)2 * rep * hd + (size_t)kTile * (hd + 1) +
         (size_t)kTile * hd + (size_t)rep * kTile + 3 * rep;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, TQ* __restrict__ out,
                       int h, int hkv, int ps, int hd, int nb, float scale) {
  extern __shared__ float smem[];
  const int rep = h / hkv;
  float* qs = smem;
  float* acc = qs + rep * hd;
  float* ks = acc + rep * hd;
  float* vs = ks + kTile * (hd + 1);
  float* sc = vs + kTile * hd;
  float* m_s = sc + rep * kTile;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  const int slot = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = ((size_t)slot * h + (size_t)g * rep) * hd;
  TQ* ob = out + row0;
  // positions beyond the page table do not exist (the gathered view of the
  // plain version is nb * ps long)
  const int len = min(lengths[slot], nb * ps);
  if (len <= 0) {
    for (int i = tid; i < rep * hd; i += kThreads) ob[i] = from_f32<TQ>(0.f);
    return;
  }
  for (int i = tid; i < rep * hd; i += kThreads) {
    qs[i] = to_f32(q[row0 + i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int* pt = page_table + (size_t)slot * nb;

  for (int base = 0; base < len; base += kTile) {
    const int n = min(kTile, len - base);
    __syncthreads();  // previous tile fully consumed; init visible
    for (int i = tid; i < n * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      const int p = base + j;
      const int blk = p / ps;
      const size_t src =
          (((size_t)pt[blk] * hkv + g) * ps + (p - blk * ps)) * hd + d;
      ks[j * (hd + 1) + d] = to_f32(kp[src]);
      vs[j * hd + d] = to_f32(vp[src]);
    }
    __syncthreads();
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, j = i - r * kTile;
      float s = kNegInf;
      if (j < n) {
        const float* qr = qs + r * hd;
        const float* kr = ks + j * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float s = sc[r * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = expf(s - m_cur);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sc[r * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        m_s[r] = m_cur;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = sc + r * kTile;
      float a = acc[i] * a_s[r];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads)
    ob[i] = from_f32<TQ>(acc[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* lengths, void* out, int b, int h, int hkv, int ps,
           int hd, int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(h / hkv, hd) * sizeof(float);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(b, hkv), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), pt, lengths, static_cast<TQ*>(out), h,
      hkv, ps, hd, nb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = success); an unknown dtype code returns cudaErrorInvalidValue.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* page_table,
                                   const void* lengths, void* out, int b,
                                   int h, int hkv, int ps, int hd, int nb,
                                   float scale, int q_dtype, int kv_dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const int*>(page_table);
  auto ln = static_cast<const int*>(lengths);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, pt, ln, out, b, h, hkv,
                                ps, hd, nb, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k_pool, v_pool, pt, ln, out, b, h,
                                        hkv, ps, hd, nb, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_pool, v_pool, pt, ln, out, b, h,
                                        hkv, ps, hd, nb, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, pt, ln,
                                                out, b, h, hkv, ps, hd, nb,
                                                scale, s);
  return (int)cudaErrorInvalidValue;
}
