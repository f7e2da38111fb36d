// Flash-attention prefill (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention.py:63
// (flash_attention / _flash_kernel), in the GQA-aware form of its twin
// repro/models/layers.py:blocked_attention: online-softmax attention with
// f32 m/l/acc, causal mask cols <= rows + (skv - sq), ragged mask
// cols < skv, -1e30 for masked scores, output acc / max(l, 1e-30).  The
// non-causal mode (the Pallas kernel's causal=False: whisper's encoder and
// cross-attention, any sq and skv) is the same code with the shift set to
// skv, which no column reaches: every row then sees every column < skv,
// each query tile visits every K/V tile, and only the ragged end masks.  For
// training it also writes each row's log-sum-exp m + log l (f32), which
// the backward (flash_attention_bwd.cu) rebuilds the probabilities from;
// serving passes a null pointer and writes none.  Inputs may be strided
// (last dim contiguous), so the model's transposed views need no copy.
//
// What bounds it on the H100: at the model's shapes (hd 48, a few hundred
// tokens) the work is 4 * hd flops per visible (row, column) pair against
// 4 * s * hd * itemsize bytes a head, tens of flops per byte: below the
// bf16 tensor-core ridge (~295), so the bound is bytes; long prompts
// cross over to operations.  What keeps a kernel far from either is
// feeding the tensor cores: S = Q K^T and O = P V are small products per
// tile, so the loads, the softmax and the barriers between them decide.
// Each tile step is a dependent chain (S, softmax, P V) run by one warp
// a scheduler: with few tiles a block's chain of steps sets the time,
// with many the mma.sync issue rate (PERF.md has the numbers).
//
// Design of the bf16 kernel (flash_fwd_mma_kernel), the path the model
// runs: one block of four warps per (64-row query tile, query head, batch
// row), each warp owning 16 query rows; GQA native (kv head = q head /
// rep, no repeat).  The tile is the slowest grid index, so the heaviest
// query tiles of every head start first.  The Q tile and the K/V tiles
// stay bf16 in shared memory (rows padded against ldmatrix bank
// conflicts, flash_mma.cuh), filled by 16-byte cp.async into three K/V
// buffers, two copies in flight, so the next tiles' copies run under
// this tile's products, with one barrier a tile.  A warp computes its
// 16 x 64 block of S with mma.sync m16n8k16 (bf16 in, f32 sums; operands
// by ldmatrix), scales it into the log2 domain (ex2 with log2(e) folded
// into the scale), keeps the online softmax in registers (row max and sum
// over the lane quad that shares a row, by shuffles), packs P to bf16
// A fragments in registers (the C layout of S is the A layout of P) and
// accumulates O += P V with V read by ldmatrix.trans.  Tiles wholly above
// the causal diagonal are never loaded; masks are applied only in tiles
// that cross the diagonal or the ragged end.  Query rows past sq are
// computed on zero rows and not stored.
//
// f32 inputs keep the first kernel (flash_attention_kernel): f32 on the
// CUDA cores, two threads a query row, K/V widened into f32 shared tiles.
// It is exact enough for the card-vs-CPU f32 checks, which TF32 would
// not be.
//
// Both take a V head dim HDV of their own (deepseek-v3's MLA: QK 192 =
// 128 + 64 rope dims, V 128): Q and K tiles and the scores run over HD,
// V, the accumulators and O over HDV, so O is written HDV wide and no
// V column is padded.  A QK width that is not a multiple of 16 (24 at
// MLA's SMOKE shape) is zero-filled to one in shared memory for the
// tensor cores (flash_mma.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

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

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  // qs[BQ][HD+1], ks[BK][HD+1], vs[BK][HDV], ps[BQ][BK+1]
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HDV + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int h,
                       int hkv, int sq, int skv, int shift, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, float scale) {
  static_assert(HDV % 2 == 0, "v head dim must be even");
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * HDV;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hq / (h / hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 1;       // this thread's query row in the tile
  const int half = tid & 1;     // which half of the columns / head dims
  const int row = q0 + r;

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
  float acc[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q tile loaded / previous K,V tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD;
      const int col = k0 + j;
      ks[j * LD + d] = col < skv ? to_f32(kb[col * kss + d]) : 0.f;
    }
    for (int i = tid; i < kBK * HDV; i += kThreads) {
      const int j = i / HDV, d = i - j * HDV;
      const int col = k0 + j;
      vs[j * HDV + d] = col < skv ? to_f32(vb[col * vss + d]) : 0.f;
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
    for (int i = 0; i < HDV / 2; ++i) acc[i] *= alpha;
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i)
        acc[i] = fmaf(p, vh[j * HDV + 2 * i], acc[i]);
    }
  }

  if (row < sq) {
    T* orow = out + (((size_t)bi * h + hq) * sq + row) * HDV;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i)
      orow[half + 2 * i] = from_f32<T>(acc[i] / den);
    if (lse != nullptr && half == 0)
      lse[((size_t)bi * h + hq) * sq + row] = m + logf(den);
  }
}

// ------------------------------------------------ bf16: tensor cores
namespace fm = flash_mma;
// K/V tile buffers: two copies in flight under a tile's products (three
// read faster than two at t 256 and 512 on the H100)
constexpr int kStages = 3;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD, int HDV>
constexpr size_t mma_smem_bytes() {
  // Q; kStages K tiles and kStages V tiles
  return (1 + kStages) * (size_t)fm::Tile<HD>::kBytes +
         kStages * (size_t)fm::Tile<HDV>::kBytes;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(fm::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int h, int hkv, int sq,
                     int skv, int shift, long long qsb, long long qsh,
                     long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     float scale) {
  using Tl = fm::Tile<HD>;
  using Tv = fm::Tile<HDV>;
  static_assert(HDV % 16 == 0, "v head dim must be a multiple of 16");
  constexpr int NB = HDV / 8;              // 8-wide blocks of the v head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + Tl::kElems;             // [kStages] tiles
  __nv_bfloat16* vs = ks + kStages * Tl::kElems;   // [kStages] tiles

  // the tile is the slowest grid index, so the heaviest tiles (most kv
  // tiles) of every head start first and the light ones fill the tail
  const int q0 = (gridDim.z - 1 - blockIdx.z) * fm::kRows;
  const int hq = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = hq / (h / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* kb = k + bi * ksb + g * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + g * vsh;

  const int last_row = min(q0 + fm::kRows, sq) - 1;
  const int kv_end = min(skv, last_row + shift + 1);
  const int n_kv = (kv_end + fm::kRows - 1) / fm::kRows;

  // K/V tile i goes to buffer i % kStages; kStages - 1 tiles in flight
  auto issue = [&](int i) {
    if (i < n_kv) {
      const int buf = i % kStages;
      fm::load_tile<HD>(ks + buf * Tl::kElems, kb, kss, i * fm::kRows, skv);
      fm::load_tile<HDV>(vs + buf * Tv::kElems, vb, vss, i * fm::kRows, skv);
    }
    fm::cp_async_commit();   // empty past the end: the count stays uniform
  };
  fm::load_tile<HD>(qs, q + bi * qsb + hq * qsh, qss, q0, sq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const float sl2 = scale * fm::kLog2e;        // scores in log2 units
  const int r_lo = q0 + 16 * warp + quad;  // this lane's rows r_lo, r_lo + 8
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int buf = it % kStages;
    const int k0 = it * fm::kRows;
    fm::cp_async_wait<kStages - 2>();   // tile it has landed
    // ... for every thread, and every warp is done with tile it - 1,
    // whose buffer the next copy refills
    __syncthreads();
    issue(it + kStages - 1);
    const __nv_bfloat16* kt = ks + buf * Tl::kElems;
    const __nv_bfloat16* vt = vs + buf * Tv::kElems;

    float s[8][4];
    fm::mma_abt_64<HD>(s, qs, 16 * warp, kt);

    // mask only where the tile crosses the diagonal or the ragged end
    const bool need_mask =
        k0 + fm::kRows - 1 > q0 + shift || k0 + fm::kRows > skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (need_mask) {
          const int col = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = r_lo + 8 * (e >> 1);
          if (col >= skv || col > row + shift) x = -1e30f;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fm::ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fm::ex2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;          // this lane's columns; the quad sums last
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V: P from registers, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      fm::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
      fm::mma_a_bt<HDV, NB>(o, a, vt, 16 * kk);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t base = ((size_t)bi * h + hq) * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / den;
    __nv_bfloat16* orow = out + (base + row) * HDV + 2 * tq;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && tq == 0) lse[base + row] = m[r] * kLn2 + logf(den);
  }
}

template <int HD, int HDV>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int h, int hkv, int sq, int skv, int shift,
               const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD, HDV>();
  auto kernel = flash_fwd_mma_kernel<HD, HDV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(h, b, (sq + fm::kRows - 1) / fm::kRows);
  kernel<<<grid, fm::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, h, hkv, sq, skv, shift, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

// The (QK, V) head dim pairs instantiated: the equal dims, and MLA's at
// deepseek-v3's published widths (192, 128) and its SMOKE config (24, 16)
#define FLASH_HEAD_DIMS(X) \
  X(16, 16) X(32, 32) X(48, 48) X(64, 64) X(80, 80) X(112, 112) \
  X(128, 128) X(192, 128) X(24, 16)

int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int h, int hkv, int sq, int skv,
                 int shift, int hd, int hdv, const long long* st, float scale,
                 cudaStream_t s) {
#define FLASH_FWD_MMA_CASE(HD, HDV)                                          \
  if (hd == HD && hdv == HDV)                                              \
    return launch_mma<HD, HDV>(q, k, v, out, lse, b, h, hkv, sq, skv,      \
                               shift, st, scale, s);
  FLASH_HEAD_DIMS(FLASH_FWD_MMA_CASE)
#undef FLASH_FWD_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------ f32: CUDA cores
template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int h, int hkv, int sq, int skv, int shift,
           const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, HDV>();
  auto kernel = flash_attention_kernel<T, HD, HDV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, h, hkv, sq, skv,
      shift, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int h, int hkv, int sq, int skv, int shift,
                int hd, int hdv, const long long* st, float scale,
                cudaStream_t s) {
#define FLASH_FWD_CASE(HD, HDV)                                              \
  if (hd == HD && hdv == HDV)                                              \
    return launch<T, HD, HDV>(q, k, v, out, lse, b, h, hkv, sq, skv, shift, \
                              st, scale, s);
  FLASH_HEAD_DIMS(FLASH_FWD_CASE)
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (b, h, sq, hd), k: (b, hkv, skv, hd), v: (b, hkv, skv, hdv) with
// element strides (batch, head, row) given and the last dim contiguous;
// out: contiguous (b, h, sq, hdv); lse: contiguous (b, h, sq) f32, or
// null to skip it.  dtype code: 0 = float32, 1 = bfloat16 (all four
// tensors).  causal: 1 masks row r to columns <= r + (skv - sq) (needs
// skv >= sq), 0 lets every row see every column.  Returns the
// cudaError_t of the launch (0 = success); an uninstantiated (hd, hdv)
// pair, a dtype or a causal skv < sq returns cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int h,
                                   int hkv, int sq, int skv, int hd, int hdv,
                                   long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   float scale, int dtype, int causal,
                                   void* stream) {
  if (causal && skv < sq) return (int)cudaErrorInvalidValue;
  // no column reaches row + skv: the causal mask never applies
  const int shift = causal ? skv - sq : skv;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, static_cast<float*>(lse), b, h,
                              hkv, sq, skv, shift, hd, hdv, st, scale, s);
  if (dtype == 1) {
    const void* ptrs[3] = {q, k, v};
    if (!fm::rows_aligned(ptrs, 3, st, 9))
      return (int)cudaErrorMisalignedAddress;
    return dispatch_mma(q, k, v, out, static_cast<float*>(lse), b, h, hkv,
                        sq, skv, shift, hd, hdv, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
