// Flash-attention backward for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/attention.py:63 (flash_attention /
// _flash_kernel) has no Pallas backward: the JAX package differentiates
// its jnp twin repro/models/layers.py:blocked_attention.  In the port the
// forward is a kernel (flash_attention.cu), so training needs this
// backward on the card.  It computes the flash-attention gradient from
// the forward's output O and per-row log-sum-exp L, with the forward's
// masks (causal cols <= rows + (skv - sq), ragged cols < skv) and GQA
// (kv head = q head / rep).  Non-causal (whisper's encoder and cross-
// attention, any sq and skv) it is the same code with the shift set to
// skv, which no column reaches: each K/V tile then visits every query
// tile from row 0, each query tile every K/V tile, and only the ragged
// ends mask:
//   P = exp(S - L),  D = rowsum(dO * O),  dS = P * (dO V^T - D),
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
//
// What bounds it on the H100: it reads q, k, v, o, dO and writes dq, dk,
// dv once, and does ~2.5x the forward's products (S, dP, dV, dK, dQ:
// 10 * hd flops per visible (row, column) pair).  At the training shapes
// (t 512, hd 48, causal) that is ~160 flops per byte, below the bf16
// tensor-core ridge (~295), so the bound is bytes; longer sequences
// cross over to operations.  In practice the products are small per tile
// (64 x 64 x hd), so what decides is how the tensor cores are fed: the
// copies, the exponentials and the trips through shared memory.  Each
// tile step is a dependent chain run by one warp a scheduler: at the
// training shape the heaviest block's chain (the first kv tile's 8 query
// tiles) sets the time, at long sequences the mma.sync issue rate
// (PERF.md has the numbers).
//
// Design: three launches, no atomics, so the result is deterministic.
//  1. a pre-pass writes D = rowsum(dO * O) (bf16: eight lanes a row,
//     16-byte loads; f32: one warp a row);
//  2. one block per (64-row kv tile, kv head, batch row) walks every
//     query head of its GQA group and every query tile at or below the
//     diagonal, and accumulates its rows' dK and dV in registers: the
//     rep heads' contributions are summed inside the block;
//  3. one block per (64-row query tile, query head, batch row) walks the
//     kv tiles up to the diagonal and accumulates its rows' dQ.
// Tiles wholly above the diagonal are never visited; inside a tile the
// masks give P = 0.  Inputs may be strided (last dim contiguous), like
// the forward's.
//
// The bf16 kernels (flash_bwd_*_mma_kernel), the path training runs, use
// the tensor cores (flash_mma.cuh): four warps, each owning 16 rows of
// the block's tile; the tile is the slowest grid index, so the heaviest
// tiles of every head start first.  Tiles stay bf16 in shared memory (rows padded
// against ldmatrix bank conflicts), filled by 16-byte cp.async; the tiles
// the block walks over (Q, dO, lse and D in step 2; K and V in step 3)
// have two buffers, so the next tile's copy runs under this tile's
// products, with one barrier a tile.  Products are mma.sync m16n8k16 (bf16 in, f32 sums),
// operands by ldmatrix (.trans where a tile is used transposed).  In
// step 2 a warp computes S^T = K Q^T and dP^T = V dO^T for its 16 kv
// rows in f32 registers, takes P^T = exp2(S^T scale log2(e) - L log2(e))
// and dS^T = P^T (dP^T - D) with L and D read by column from shared
// memory, and accumulates dV += P^T dO and dK += dS^T Q, the A fragments
// packed to bf16 straight from its registers (the C layout of one
// product is the A layout of the next): P and dS never touch shared
// memory.  Step 3 does the same per query tile: S, dP and dS in
// registers, then dQ += dS K.  dS and P are rounded to bf16 for the
// second products, dP and every sum stay f32.
//
// f32 inputs keep the first kernels (flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel): f32 on the CUDA cores, P and dS tiles built in
// shared memory by outer products.  They are exact enough for the
// card-vs-CPU f32 checks, which TF32 would not be.
//
// Every kernel takes a V head dim HDV of its own (deepseek-v3's MLA: QK
// 192, V 128): Q, K, S, dQ and dK run over HD; V, dO, O, dP's product,
// dV and the pre-pass rowsum over HDV, so nothing is padded to the QK
// width in memory.  A QK width that is not a multiple of 16 (24 at MLA's
// SMOKE shape) is zero-filled to one in shared memory for the tensor
// cores (flash_mma.cuh), and only its HD columns of dQ and dK are
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

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

template <int HD, int HDV>
constexpr size_t smem_floats() {
  // qs [BQ][HD+1], dos [BQ][HDV+1]; ks [BK][HD+1], vs [BK][HDV+1];
  // ps, dss [BQ][BK+1]; lse, D [BQ]
  return (size_t)kBQ * (HD + 1) + (size_t)kBQ * (HDV + 1) +
         (size_t)kBK * (HD + 1) + (size_t)kBK * (HDV + 1) +
         2 * (size_t)kBQ * kLP + 2 * (size_t)kBQ;
}

// Rows [r0, r0 + 64) of a (., ., s, W) tensor into a [64][W+1] f32
// tile, times mul; rows past s read as zero.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int s,
                                          float mul) {
  constexpr int LD = W + 1;
  for (int i = threadIdx.x; i < 64 * W; i += kThreads) {
    const int rr = i / W, d = i - rr * W;
    const int r = r0 + rr;
    dst[rr * LD + d] = r < s ? to_f32(src[r * stride + d]) * mul : 0.f;
  }
}

// One (64 x 64) tile of P (into ps, unless null) and dS (into dss) from
// the scaled queries qs, dO tile dos, K tile ks and V tile vs.  Thread t
// owns column t % 64 and rows i0 .. i0 + 31, i0 = (t / 64) * 32.
template <int HD, int HDV>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, float* ps, float* dss, int q0,
    int k0, int sq, int skv, int shift) {
  constexpr int LD = HD + 1, LDV = HDV + 1;
  constexpr int NR = kBQ / 2;
  const int c = threadIdx.x % kBK;
  const int i0 = (threadIdx.x / kBK) * NR;
  float s[NR], dp[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) s[i] = dp[i] = 0.f;
  const float* kr = ks + c * LD;
  const float* vr = vs + c * LDV;
  const float* qb = qs + i0 * LD;
  const float* db = dos + i0 * LDV;
#pragma unroll 2
  for (int d = 0; d < HD; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int i = 0; i < NR; ++i) s[i] = fmaf(qb[i * LD + d], kd, s[i]);
  }
#pragma unroll 2
  for (int d = 0; d < HDV; ++d) {
    const float vd = vr[d];
#pragma unroll
    for (int i = 0; i < NR; ++i) dp[i] = fmaf(db[i * LDV + d], vd, dp[i]);
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

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int h, int hkv, int sq, int skv,
                      int shift, Strides st, float scale) {
  constexpr int LD = HD + 1, LDV = HDV + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LDV;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LDV;
  float* dss = ps + kBQ * kLP;
  float* lse_s = dss + kBQ * kLP;
  float* d_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int rep = h / hkv;
  const int c = threadIdx.x >> 1;     // this thread's kv row in the tile
  const int half = threadIdx.x & 1;   // which half of the head dims

  load_tile<T, HD>(ks, k + bi * st.ksb + g * st.ksh, st.kss, k0, skv, 1.f);
  load_tile<T, HDV>(vs, v + bi * st.vsb + g * st.vsh, st.vss, k0, skv, 1.f);

  float adk[HD / 2], adv[HDV / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) adk[j] = 0.f;
#pragma unroll
  for (int j = 0; j < HDV / 2; ++j) adv[j] = 0.f;

  // the first query row that sees column k0 is k0 - shift
  const int q_start = (max(0, k0 - shift) / kBQ) * kBQ;
  for (int hi = 0; hi < rep; ++hi) {
    const int hq = g * rep + hi;
    const size_t base = ((size_t)bi * h + hq) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kBQ) {
      __syncthreads();   // K/V loaded / previous tiles consumed
      load_tile<T, HD>(qs, q + bi * st.qsb + hq * st.qsh, st.qss, q0, sq,
                       scale);
      load_tile<T, HDV>(dos, dout + bi * st.gsb + hq * st.gsh, st.gss, q0,
                        sq, 1.f);
      load_rows(lse_s, d_s, lse, dsum, base, q0, sq);
      __syncthreads();
      tile_p_ds<HD, HDV>(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, sq,
                         skv, shift);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        const float p = ps[i * kLP + c];
        const float ds = dss[i * kLP + c];
        const float* dor = dos + i * LDV + half;
        const float* qr = qs + i * LD + half;
#pragma unroll
        for (int j = 0; j < HDV / 2; ++j) adv[j] = fmaf(p, dor[2 * j], adv[j]);
#pragma unroll
        for (int j = 0; j < HD / 2; ++j)   // qs holds the scale
          adk[j] = fmaf(ds, qr[2 * j], adk[j]);
      }
    }
  }
  const int row = k0 + c;
  if (row < skv) {
    const size_t r = ((size_t)bi * hkv + g) * skv + row;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j)
      dk[r * HD + half + 2 * j] = from_f32<T>(adk[j]);
#pragma unroll
    for (int j = 0; j < HDV / 2; ++j)
      dv[r * HDV + half + 2 * j] = from_f32<T>(adv[j]);
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int h, int hkv, int sq, int skv, int shift, Strides st,
                    float scale) {
  constexpr int LD = HD + 1, LDV = HDV + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LDV;
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LDV;
  float* lse_s = dss + kBQ * kLP;
  float* d_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hq / (h / hkv);
  const int r = threadIdx.x >> 1;     // this thread's query row in the tile
  const int half = threadIdx.x & 1;

  load_tile<T, HD>(qs, q + bi * st.qsb + hq * st.qsh, st.qss, q0, sq, scale);
  load_tile<T, HDV>(dos, dout + bi * st.gsb + hq * st.gsh, st.gss, q0, sq,
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
    load_tile<T, HDV>(vs, v + bi * st.vsb + g * st.vsh, st.vss, k0, skv,
                      1.f);
    __syncthreads();
    tile_p_ds<HD, HDV>(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, q0, k0, sq,
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

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* dsum, void* dq,
           void* dk, void* dv, int b, int h, int hkv, int sq, int skv,
           int shift, const Strides& st, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const long long rows = (long long)b * h * sq;
  const long long pre_blocks = (rows * 32 + kThreads - 1) / kThreads;
  row_dot_kernel<T><<<(unsigned)pre_blocks, kThreads, 0, stream>>>(
      dt, static_cast<const T*>(o), dsum, h, sq, HDV, st.gsb, st.gsh, st.gss,
      rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t smem = smem_floats<HD, HDV>() * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD, HDV>;
  auto q_kernel = flash_bwd_dq_kernel<T, HD, HDV>;
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
      hkv, sq, skv, shift, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid((sq + kBQ - 1) / kBQ, h, b);
  q_kernel<<<q_grid, kThreads, smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<T*>(dq), h, hkv, sq, skv, shift,
      st, scale);
  return (int)cudaGetLastError();
}

// The (QK, V) head dim pairs instantiated: the equal dims, and MLA's at
// deepseek-v3's published widths (192, 128) and its SMOKE config (24, 16)
#define FLASH_HEAD_DIMS(X) \
  X(16, 16) X(32, 32) X(48, 48) X(64, 64) X(80, 80) X(112, 112) \
  X(128, 128) X(192, 128) X(24, 16)

template <typename T>
int dispatch_hd(int hd, int hdv, const void* q, const void* k,
                const void* v, const void* o, const float* lse,
                const void* dout, float* dsum, void* dq, void* dk, void* dv,
                int b, int h, int hkv, int sq, int skv, int shift,
                const Strides& st, float scale, cudaStream_t s) {
#define FLASH_BWD_CASE(HD, HDV)                                             \
  if (hd == HD && hdv == HDV)                                             \
    return launch<T, HD, HDV>(q, k, v, o, lse, dout, dsum, dq, dk, dv, b, \
                              h, hkv, sq, skv, shift, st, scale, s);
  FLASH_HEAD_DIMS(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------ bf16: tensor cores
namespace fm = flash_mma;
// buffers of the streamed tiles: one copy in flight under a tile's
// products (two in flight read slower on the H100)
constexpr int kStages = 2;
using bf16 = __nv_bfloat16;

// D[i] = sum_d dO[i, d] * O[i, d] for the (b, h, sq) rows; eight lanes a
// row, each reading 16-byte chunks of dO and O.
template <int HD>
__global__ void __launch_bounds__(fm::kThreads)
row_dot_mma_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                   float* __restrict__ dsum, int h, int sq, long long gsb,
                   long long gsh, long long gss, long long rows) {
  const long long i = ((long long)blockIdx.x * fm::kThreads + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (i < rows) {
    const int r = (int)(i % sq);
    const long long bh = i / sq;
    const int hq = (int)(bh % h);
    const long long bi = bh / h;
    const bf16* dr = dout + bi * gsb + hq * gsh + r * gss;
    const bf16* orow = o + i * HD;
    for (int c = sub; c < HD / 8; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(dr + 8 * c);
      const uint4 b = *reinterpret_cast<const uint4*>(orow + 8 * c);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(pa[j]);
        const float2 fb = __bfloat1622float2(pb[j]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (i < rows && sub == 0) dsum[i] = acc;
}

template <int HD, int HDV>
constexpr size_t dkdv_mma_smem_bytes() {
  // K, V; kStages each of the Q and dO tiles and of the lse and D rows
  return (1 + kStages) * ((size_t)fm::Tile<HD>::kBytes +
                          (size_t)fm::Tile<HDV>::kBytes) +
         2 * kStages * fm::kRows * sizeof(float);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(fm::kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int h, int hkv, int sq, int skv, int shift,
                          Strides st, float scale) {
  static_assert(HDV % 16 == 0, "v head dim must be a multiple of 16");
  constexpr int E = fm::Tile<HD>::kElems;
  constexpr int EV = fm::Tile<HDV>::kElems;
  constexpr int NB = fm::Tile<HD>::kPad / 8;   // dK blocks (stored width)
  constexpr int NBV = HDV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + E;
  bf16* qs = vs + EV;                                       // [kStages]
  bf16* dos = qs + kStages * E;                             // [kStages]
  float* ls = reinterpret_cast<float*>(dos + kStages * EV); // [kStages][64]
  float* ds_ = ls + kStages * fm::kRows;                    // [kStages][64]

  // the tile is the slowest grid index, so the heaviest tiles (most
  // query tiles) of every head start first and the light ones fill the tail
  const int k0 = blockIdx.z * fm::kRows;
  const int g = blockIdx.x;
  const int bi = blockIdx.y;
  const int rep = h / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;

  // the first query row that sees column k0 is k0 - shift
  const int q_start = (max(0, k0 - shift) / fm::kRows) * fm::kRows;
  const int n_qt = (sq - q_start + fm::kRows - 1) / fm::kRows;
  const int total = rep * n_qt;          // (query head, query tile) steps

  // queue the copies of step it into buffer it % kStages: the Q and dO
  // tiles and the tile's lse and D (threads 0-63 and 64-127, 4 bytes
  // each); kStages - 1 steps are in flight
  auto issue = [&](int it) {
    if (it >= total) {
      fm::cp_async_commit();   // empty past the end: the count stays uniform
      return;
    }
    const int buf = it % kStages;
    const int hi = it / n_qt;
    const int q0 = q_start + (it - hi * n_qt) * fm::kRows;
    const int hq = g * rep + hi;
    fm::load_tile<HD>(qs + buf * E, q + bi * st.qsb + hq * st.qsh, st.qss,
                      q0, sq);
    fm::load_tile<HDV>(dos + buf * EV, dout + bi * st.gsb + hq * st.gsh,
                       st.gss, q0, sq);
    const size_t base = ((size_t)bi * h + hq) * sq;
    const int t = threadIdx.x & (fm::kRows - 1);
    const int r = q0 + t;
    const float* src = threadIdx.x < fm::kRows ? lse : dsum;
    float* dst = (threadIdx.x < fm::kRows ? ls : ds_) + buf * fm::kRows + t;
    fm::cp_async4(dst, r < sq ? src + base + r : src, r < sq ? 4 : 0);
    fm::cp_async_commit();
  };

  fm::load_tile<HD>(ks, k + bi * st.ksb + g * st.ksh, st.kss, k0, skv);
  fm::load_tile<HDV>(vs, v + bi * st.vsb + g * st.vsh, st.vss, k0, skv);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float adk[NB][4], adv[NBV][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NBV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[j][e] = 0.f;
  const float sl2 = scale * fm::kLog2e;
  const int c_lo = k0 + 16 * warp + quad;  // this lane's kv rows c_lo, +8

  for (int it = 0; it < total; ++it) {
    const int buf = it % kStages;
    fm::cp_async_wait<kStages - 2>();   // step it has landed
    // ... for every thread, and every warp is done with step it - 1,
    // whose buffers the next copy refills
    __syncthreads();
    issue(it + kStages - 1);
    const int hi = it / n_qt;
    const int q0 = q_start + (it - hi * n_qt) * fm::kRows;
    const bf16* qt = qs + buf * E;
    const bf16* dot = dos + buf * EV;
    const float* lt = ls + buf * fm::kRows;
    const float* dt = ds_ + buf * fm::kRows;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
    float pt[8][4], dst[8][4];
    fm::mma_abt_64<HD>(pt, ks, 16 * warp, qt);
    fm::mma_abt_64<HDV>(dst, vs, 16 * warp, dot);

    const bool need_mask = k0 + fm::kRows - 1 > q0 + shift ||
                           q0 + fm::kRows > sq || k0 + fm::kRows > skv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;               // query column in the tile
      const float2 lc = *reinterpret_cast<const float2*>(lt + c);
      const float2 dc = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = ((e & 1) ? lc.y : lc.x) * fm::kLog2e;
        float p = fm::ex2(fmaf(pt[j][e], sl2, -l2));
        if (need_mask) {
          const int col = q0 + c + (e & 1);
          const int row = c_lo + 8 * (e >> 1);
          if (col >= sq || row >= skv || row > col + shift) p = 0.f;
        }
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - ((e & 1) ? dc.y : dc.x));
      }
    }
    // dV += P^T dO, dK += dS^T Q: A fragments from registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      fm::c_to_a(a, pt[2 * kk], pt[2 * kk + 1]);
      fm::mma_a_bt<HDV, NBV>(adv, a, dot, 16 * kk);
      fm::c_to_a(a, dst[2 * kk], dst[2 * kk + 1]);
      fm::mma_a_bt<HD, NB>(adk, a, qt, 16 * kk);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c_lo + 8 * r;
    if (row >= skv) continue;
    const size_t rr = ((size_t)bi * hkv + g) * skv + row;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dk + rr * HD + 2 * tq + 8 * j) =
          __floats2bfloat162_rn(adk[j][2 * r] * scale,
                                adk[j][2 * r + 1] * scale);
#pragma unroll
    for (int j = 0; j < NBV; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dv + rr * HDV + 2 * tq + 8 * j) =
          __floats2bfloat162_rn(adv[j][2 * r], adv[j][2 * r + 1]);
  }
}

template <int HD, int HDV>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO; kStages each of the K and V tiles
  return (1 + kStages) * ((size_t)fm::Tile<HD>::kBytes +
                          (size_t)fm::Tile<HDV>::kBytes);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(fm::kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        bf16* __restrict__ dq, int h, int hkv, int sq,
                        int skv, int shift, Strides st, float scale) {
  constexpr int E = fm::Tile<HD>::kElems;
  constexpr int EV = fm::Tile<HDV>::kElems;
  constexpr int NB = fm::Tile<HD>::kPad / 8;   // dQ blocks (stored width)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + E;
  bf16* ks = dos + EV;             // [kStages] tiles
  bf16* vs = ks + kStages * E;     // [kStages] tiles

  // the heaviest query tiles (most kv tiles) of every head start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * fm::kRows;
  const int hq = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = hq / (h / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const bf16* kb = k + bi * st.ksb + g * st.ksh;
  const bf16* vb = v + bi * st.vsb + g * st.vsh;

  const int last_row = min(q0 + fm::kRows, sq) - 1;
  const int kv_end = min(skv, last_row + shift + 1);
  const int n_kv = (kv_end + fm::kRows - 1) / fm::kRows;

  // K/V tile i goes to buffer i % kStages; kStages - 1 tiles in flight
  auto issue = [&](int i) {
    if (i < n_kv) {
      const int buf = i % kStages;
      fm::load_tile<HD>(ks + buf * E, kb, st.kss, i * fm::kRows, skv);
      fm::load_tile<HDV>(vs + buf * EV, vb, st.vss, i * fm::kRows, skv);
    }
    fm::cp_async_commit();   // empty past the end: the count stays uniform
  };
  fm::load_tile<HD>(qs, q + bi * st.qsb + hq * st.qsh, st.qss, q0, sq);
  fm::load_tile<HDV>(dos, dout + bi * st.gsb + hq * st.gsh, st.gss, q0, sq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // lse (log2 units) and D of this lane's rows r_lo and r_lo + 8
  const size_t base = ((size_t)bi * h + hq) * sq;
  const int r_lo = q0 + 16 * warp + quad;
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    l2[r] = row < sq ? lse[base + row] * fm::kLog2e : 0.f;
    dr[r] = row < sq ? dsum[base + row] : 0.f;
  }
  float adq[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) adq[j][0] = adq[j][1] = adq[j][2] = adq[j][3] = 0.f;
  const float sl2 = scale * fm::kLog2e;

  for (int it = 0; it < n_kv; ++it) {
    const int buf = it % kStages;
    const int k0 = it * fm::kRows;
    fm::cp_async_wait<kStages - 2>();   // tile it has landed
    // ... for every thread, and every warp is done with tile it - 1,
    // whose buffer the next copy refills
    __syncthreads();
    issue(it + kStages - 1);
    const bf16* kt = ks + buf * E;
    const bf16* vt = vs + buf * EV;

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    float s[8][4], dp[8][4];
    fm::mma_abt_64<HD>(s, qs, 16 * warp, kt);
    fm::mma_abt_64<HDV>(dp, dos, 16 * warp, vt);

    const bool need_mask =
        k0 + fm::kRows - 1 > q0 + shift || k0 + fm::kRows > skv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fm::ex2(fmaf(s[j][e], sl2, -l2[e >> 1]));
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = r_lo + 8 * (e >> 1);
          if (col >= skv || col > row + shift) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);      // dS
      }
    }
    // dQ += dS K: A fragments from registers, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      fm::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
      fm::mma_a_bt<HD, NB>(adq, a, kt, 16 * kk);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= sq) continue;
    bf16* out = dq + (base + row) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          adq[j][2 * r] * scale, adq[j][2 * r + 1] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD, int HDV>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* dsum, void* dq,
               void* dk, void* dv, int b, int h, int hkv, int sq, int skv,
               int shift, const Strides& st, float scale,
               cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  const long long rows = (long long)b * h * sq;
  const long long pre_blocks = (rows * 8 + fm::kThreads - 1) / fm::kThreads;
  row_dot_mma_kernel<HDV><<<(unsigned)pre_blocks, fm::kThreads, 0, stream>>>(
      dt, static_cast<const bf16*>(o), dsum, h, sq, st.gsb, st.gsh, st.gss,
      rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t kv_smem = dkdv_mma_smem_bytes<HD, HDV>();
  constexpr size_t q_smem = dq_mma_smem_bytes<HD, HDV>();
  auto kv_kernel = flash_bwd_dkdv_mma_kernel<HD, HDV>;
  auto q_kernel = flash_bwd_dq_mma_kernel<HD, HDV>;
  if ((e = allow_smem(kv_kernel, kv_smem)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(q_kernel, q_smem)) != cudaSuccess) return (int)e;
  const dim3 kv_grid(hkv, b, (skv + fm::kRows - 1) / fm::kRows);
  kv_kernel<<<kv_grid, fm::kThreads, kv_smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, hkv, sq, skv, shift, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid(h, b, (sq + fm::kRows - 1) / fm::kRows);
  q_kernel<<<q_grid, fm::kThreads, q_smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<bf16*>(dq), h, hkv, sq, skv,
      shift, st, scale);
  return (int)cudaGetLastError();
}

int dispatch_mma(int hd, int hdv, const void* q, const void* k,
                 const void* v, const void* o, const float* lse,
                 const void* dout, float* dsum, void* dq, void* dk, void* dv,
                 int b, int h, int hkv, int sq, int skv, int shift,
                 const Strides& st, float scale, cudaStream_t s) {
#define FLASH_BWD_MMA_CASE(HD, HDV)                                         \
  if (hd == HD && hdv == HDV)                                             \
    return launch_mma<HD, HDV>(q, k, v, o, lse, dout, dsum, dq, dk, dv, b, \
                               h, hkv, sq, skv, shift, st, scale, s);
  FLASH_HEAD_DIMS(FLASH_BWD_MMA_CASE)
#undef FLASH_BWD_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (b, h, sq, hd), k: (b, hkv, skv, hd), v: (b, hkv, skv, hdv), dout:
// (b, h, sq, hdv), each with element strides (batch, head, row) given and
// the last dim contiguous; o: contiguous (b, h, sq, hdv), the forward's
// output; lse: contiguous (b, h, sq) f32, the forward's log-sum-exp;
// dsum: (b, h, sq) f32 scratch; dq: contiguous (b, h, sq, hd), dk:
// contiguous (b, hkv, skv, hd), dv: contiguous (b, hkv, skv, hdv).
// dtype code: 0 = float32, 1 = bfloat16 (every tensor but lse and dsum).
// causal: the forward's mask flag (1 needs skv >= sq).  Returns the
// cudaError_t of the launches.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dsum, void* dq, void* dk,
    void* dv, int b, int h, int hkv, int sq, int skv, int hd, int hdv,
    long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long gsb, long long gsh, long long gss, float scale, int dtype,
    int causal, void* stream) {
  if (hkv < 1 || h % hkv || (causal && skv < sq) || sq < 1 || skv < 1)
    return (int)cudaErrorInvalidValue;
  // no column reaches row + skv: the causal mask never applies
  const int shift = causal ? skv - sq : skv;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss};
  auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch_hd<float>(hd, hdv, q, k, v, o, l, dout, ds, dq, dk, dv,
                              b, h, hkv, sq, skv, shift, st, scale, s);
  if (dtype == 1) {
    const void* ptrs[5] = {q, k, v, o, dout};
    const long long strides[12] = {qsb, qsh, qss, ksb, ksh, kss,
                                   vsb, vsh, vss, gsb, gsh, gss};
    if (!fm::rows_aligned(ptrs, 5, strides, 12))
      return (int)cudaErrorMisalignedAddress;
    return dispatch_mma(hd, hdv, q, k, v, o, l, dout, ds, dq, dk, dv, b, h,
                        hkv, sq, skv, shift, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
