// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (paged_attention / _paged_attention_kernel): one pending query per slot
// attends over that slot's pages of the shared KV pool in place, steered
// by the slot's page-table row; positions >= length get zero weight;
// online softmax with f32 m/l/acc; output acc / max(l, 1e-30).
//
// What bounds it on the H100: latency.  The bytes (each slot's valid K
// and V rows once) take well under a microsecond at 3.35 TB/s, and 4
// flops a byte-pair are far below the ridge; what a decode step waits for
// is the chain page table -> K/V rows -> scores -> softmax -> output,
// and how many SMs walk it at once.
//
// Design (flash-decoding): the grid is (split, kv head x row chunk,
// slot).  A split is a whole number of pages (the wrapper's plan picks
// it so that the grid fills the card); a block reads its slot's length
// and page-table entries itself and exits at once when its split starts
// at or past the length, so a short slot costs one load per empty split.
// The length, the q values and the split's first page ids load together
// (the page ids need only the table's bound), and each iteration loads
// the next one's page ids, so the chain to the K/V rows is one load deep.
// Inside a split, a group of G lanes (a power of two) owns one position
// at a time: lane c of the group loads the c-th W-byte chunk of the K row
// and of the V row straight from the pool into registers (W = 16 where
// the row allows: a bf16 row of hd 48 is six 16-byte loads), widens it to
// f32 exactly, and holds the q values of that chunk for each of the
// block's RC query rows, so the rows of one kv head share every K/V load
// (GQA).  Each group loads four positions before it computes, the scores
// are summed over the group by warp shuffle, and the online softmax
// stays in registers.  Groups then merge by shuffle, warps through one
// shared-memory exchange (the block's only barrier), and the split
// writes (m, l, acc[hd]) in f32 to the wrapper's workspace.  A second
// small kernel, launched by the same C entry as a programmatic dependent
// launch (it starts while the splits finish and waits on
// griddepcontrol.wait before it reads them), merges the valid splits of
// each (slot, head) in split order: M = max m_i, l = sum l_i e^(m_i - M),
// o = sum acc_i e^(m_i - M) / max(l, 1e-30).  Only splits that hold a
// valid position are read, so every m_i is a real score and an empty
// split can give neither NaN nor M; a slot of length 0 has no valid
// split and gets zeros.  With one split the first kernel writes the
// output itself.  Every reduction runs in a fixed order, so a call gives
// the same bits every time.  The only integer divisions are two a
// position (its page and its row in the page), none per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // positions a group loads before it computes
constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - m) == 0
constexpr unsigned kFull = 0xffffffffu;

// W bytes of one row chunk as 32-bit words (a 2-byte chunk in the low half)
template <int W> struct Words {
  unsigned int w[W >= 4 ? W / 4 : 1];
};

template <int W>
__device__ __forceinline__ Words<W> load_chunk(const char* p) {
  Words<W> r;
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x; r.w[1] = v.y;
  } else if constexpr (W == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

template <int W>
__device__ __forceinline__ Words<W> zero_chunk() {
  Words<W> r;
#pragma unroll
  for (int i = 0; i < (W >= 4 ? W / 4 : 1); ++i) r.w[i] = 0u;
  return r;
}

// the chunk's W / sizeof(TKV) elements widened to f32 (exact: a bf16 is
// the high half of the f32 of the same value)
template <typename TKV, int W>
__device__ __forceinline__ void widen(const Words<W>& c, float* f) {
  if constexpr (std::is_same<TKV, float>::value) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) f[i] = __uint_as_float(c.w[i]);
  } else if constexpr (W == 2) {
    f[0] = __uint_as_float(c.w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      f[2 * i] = __uint_as_float(c.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(c.w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, int q_bf16,
                                        size_t i) {
  return q_bf16 ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(q)[i])
                : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, int q_bf16, size_t i,
                                          float x) {
  if (q_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

// the page ids of positions p, p + ng, ... (kUnroll of them) below end;
// the rest 0 (never used)
__device__ __forceinline__ void load_pages(int* pg, const int* pt, int p,
                                           int ng, int end, int ps,
                                           bool has) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int pu = p + u * ng;
    pg[u] = (has && pu < end) ? __ldg(pt + pu / ps) : 0;
  }
}

// One (split, kv head x row chunk, slot) of the decode: the split's
// (m, l, acc[hd]) of each of the block's query rows into part, or, with
// one split, the output rows themselves.
template <typename TKV, int W, int RC>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const void* __restrict__ q, int q_bf16,
                   const TKV* __restrict__ kp, const TKV* __restrict__ vp,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths, float* __restrict__ part,
                   void* __restrict__ out, int h, int hkv, int ps, int hd,
                   int nb, int split, int n_splits, int row_chunks,
                   int log2g, float scale) {
  constexpr int V = W / (int)sizeof(TKV);  // elements of a lane's chunk
  extern __shared__ float smem[];          // [kWarps][RC][hd + 2]
  const int sp = blockIdx.x;
  const int slot = blockIdx.z;
  const int g = blockIdx.y / row_chunks;
  const int r0 = (blockIdx.y - g * row_chunks) * RC;
  const int rep = h / hkv;
  const int nrow = min(RC, rep - r0);
  const size_t head0 = (size_t)slot * h + (size_t)g * rep + r0;
  // the combine kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int G = 1 << log2g;
  const int sub = lane & (G - 1);          // the row chunk this lane holds
  const int ng = kWarps << (5 - log2g);    // groups a block
  const int grp = (warp << (5 - log2g)) + (lane >> log2g);
  const bool has = sub * V < hd;
  const int step = ng * kUnroll;           // positions a block iteration
  const int* pt = page_table + (size_t)slot * nb;
  // the length, the q chunks and the first iteration's page ids are
  // loaded together: the page ids only need the table's bound, so the
  // chain length -> page id -> K/V has one load fewer
  const int len_in = __ldg(lengths + slot);
  const int p0 = sp * split;
  int pg[kUnroll];
  load_pages(pg, pt, p0 + grp, ng, min(p0 + split, nb * ps), ps, has);
  float qr[RC][V], acc[RC][V], m[RC], l[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[r][e] = (r < nrow && has)
                     ? load_q(q, q_bf16, (head0 + r) * hd + sub * V + e) *
                           scale
                     : 0.f;
      acc[r][e] = 0.f;
    }
  }
  // positions beyond the page table do not exist (the gathered view of the
  // plain version is nb * ps long)
  const int len = min(len_in, nb * ps);
  if (p0 >= len) {
    if (n_splits == 1)                      // a pad slot of length 0
      for (int r = 0; r < nrow; ++r)
        for (int d = tid; d < hd; d += kThreads)
          store_out(out, q_bf16, (head0 + r) * hd + d, 0.f);
    return;
  }
  const int p1 = min(p0 + split, len);

  const size_t row_bytes = (size_t)hd * sizeof(TKV);
  const char* kb = reinterpret_cast<const char*>(kp) + sub * W;
  const char* vb = reinterpret_cast<const char*>(vp) + sub * W;
  // the whole block runs the same iterations, so every warp stays
  // converged for its shuffles; positions past p1 are masked
  for (int it = p0; it < p1; it += step) {
    Words<W> kc[kUnroll], vc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = it + grp + u * ng;
      ok[u] = p < p1;
      kc[u] = zero_chunk<W>();
      vc[u] = zero_chunk<W>();
      if (ok[u] && has) {
        const size_t row =
            ((size_t)pg[u] * hkv + g) * ps + (p - (p / ps) * ps);
        kc[u] = load_chunk<W>(kb + row * row_bytes);
        vc[u] = load_chunk<W>(vb + row * row_bytes);
      }
    }
    // the next iteration's page ids load while this one computes
    load_pages(pg, pt, it + step + grp, ng, p1, ps, has);
    float s[kUnroll][RC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[V];
      widen<TKV, W>(kc[u], kf);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        s[u][r] = dot;
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < RC; ++r)
          s[u][r] += __shfl_xor_sync(kFull, s[u][r], o);
    float vf[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) widen<TKV, W>(vc[u], vf[u]);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][r]);
      const float alpha = expf(m[r] - mx);
      float p[kUnroll], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(s[u][r] - mx) : 0.f;
        sum += p[u];
      }
      m[r] = mx;
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[r][e] = a;
      }
    }
  }

  // the groups of a warp (lanes G apart hold the same chunk)
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = expf(m[r] - mn), b = expf(mo - mn);
      l[r] = l[r] * a + lo * b;
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(kFull, acc[r][e], o) * b;
      m[r] = mn;
    }
  }
  // the warps, through shared memory, in warp order
  const int pitch = hd + 2;
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      float* sw = smem + (warp * RC + r) * pitch;
      if (lane == 0) {
        sw[0] = m[r];
        sw[1] = l[r];
      }
      if (has)
#pragma unroll
        for (int e = 0; e < V; ++e) sw[2 + sub * V + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int r = 0; r < nrow; ++r) {
    float wt[kWarps];
    float mm = smem[r * pitch];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mm = fmaxf(mm, smem[(w * RC + r) * pitch]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = smem + (w * RC + r) * pitch;
      wt[w] = expf(sw[0] - mm);
      ll += sw[1] * wt[w];
    }
    const size_t at = ((head0 + r) * n_splits + sp) * pitch;
    for (int d = tid; d < hd; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fmaf(smem[(w * RC + r) * pitch + 2 + d], wt[w], a);
      if (n_splits == 1)
        store_out(out, q_bf16, (head0 + r) * hd + d, a / fmaxf(ll, 1e-30f));
      else
        part[at + 2 + d] = a;
    }
    if (tid == 0 && n_splits > 1) {
      part[at] = mm;
      part[at + 1] = ll;
    }
  }
}

// One warp a (slot, head): the valid splits' partials merged in split
// order into the output row.
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ lengths, void* __restrict__ out,
                     int q_bf16, int rows, int h, int hd, int nb, int ps,
                     int split, int n_splits) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int len = min(lengths[row / h], nb * ps);
  const int nv = len > 0 ? (len + split - 1) / split : 0;
  const int pitch = hd + 2;
  // launched early (programmatic dependent launch): the split kernel's
  // partials are complete and visible after this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* pr = part + (size_t)row * n_splits * pitch;
  float mm = kNegInf;
  for (int i = 0; i < nv; ++i) mm = fmaxf(mm, pr[i * pitch]);
  float ll = 0.f;
  for (int i = 0; i < nv; ++i)
    ll += pr[i * pitch + 1] * expf(pr[i * pitch] - mm);
  const float den = fmaxf(ll, 1e-30f);
  for (int d = lane; d < hd; d += 32) {
    float a = 0.f;
    for (int i = 0; i < nv; ++i)
      a = fmaf(pr[i * pitch + 2 + d], expf(pr[i * pitch] - mm), a);
    store_out(out, q_bf16, (size_t)row * hd + d, a / den);
  }
}

template <typename TKV, int W, int RC>
int launch_split(const void* q, int q_bf16, const void* kp, const void* vp,
                 const int* pt, const int* lengths, float* part, void* out,
                 int b, int h, int hkv, int ps, int hd, int nb, int split,
                 int n_splits, int row_chunks, int log2g, float scale,
                 cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * RC * (hd + 2) * sizeof(float);
  paged_split_kernel<TKV, W, RC>
      <<<dim3(n_splits, hkv * row_chunks, b), kThreads, smem, stream>>>(
          q, q_bf16, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
          pt, lengths, part, out, h, hkv, ps, hd, nb, split, n_splits,
          row_chunks, log2g, scale);
  return (int)cudaGetLastError();
}

template <typename TKV, int W>
int by_rows(int rows, const void* q, int q_bf16, const void* kp,
            const void* vp, const int* pt, const int* lengths, float* part,
            void* out, int b, int h, int hkv, int ps, int hd, int nb,
            int split, int n_splits, int row_chunks, int log2g, float scale,
            cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch_split<TKV, W, 1>(q, q_bf16, kp, vp, pt, lengths, part,
                                     out, b, h, hkv, ps, hd, nb, split,
                                     n_splits, row_chunks, log2g, scale, s);
    case 2:
      return launch_split<TKV, W, 2>(q, q_bf16, kp, vp, pt, lengths, part,
                                     out, b, h, hkv, ps, hd, nb, split,
                                     n_splits, row_chunks, log2g, scale, s);
    case 4:
      return launch_split<TKV, W, 4>(q, q_bf16, kp, vp, pt, lengths, part,
                                     out, b, h, hkv, ps, hd, nb, split,
                                     n_splits, row_chunks, log2g, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  The launch (split positions,
// number of splits, bytes a lane loads of a K/V row, query rows a block)
// comes from the wrapper's plan (kernels/paged_attention.py); a launch
// whose conditions fail is refused with cudaErrorInvalidValue.  part:
// n_splits * (hd + 2) f32 a (slot, head), unused (may be null) with one
// split.  Returns the cudaError_t of the launches (0 = success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* page_table,
                                   const void* lengths, void* out, void* part,
                                   int b, int h, int hkv, int ps, int hd,
                                   int nb, float scale, int q_dtype,
                                   int kv_dtype, int split, int n_splits,
                                   int vec_bytes, int rows, void* stream) {
  const bool ok_dims = b >= 1 && b <= 65535 && hkv >= 1 && h >= hkv &&
                       h % hkv == 0 && ps >= 1 && hd >= 1 && nb >= 1;
  if (!ok_dims || (q_dtype != 0 && q_dtype != 1) ||
      (kv_dtype != 0 && kv_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int item = kv_dtype == 1 ? 2 : 4;
  const long long width = (long long)nb * ps;
  const int chunks = vec_bytes > 0 ? hd * item / vec_bytes : 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_pool) |
                          reinterpret_cast<uintptr_t>(v_pool);
  const int rep = h / hkv;
  const int row_chunks = rows > 0 ? (rep + rows - 1) / rows : 0;
  if (split < 1 || split % ps || n_splits < 1 ||
      (long long)(n_splits - 1) * split >= width ||
      (long long)n_splits * split < width || width > (1 << 30) ||
      (n_splits > 1 && part == nullptr) ||
      (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 &&
       vec_bytes != 2) ||
      vec_bytes < item || (hd * item) % vec_bytes || chunks > 32 ||
      align % vec_bytes || (rows != 1 && rows != 2 && rows != 4) ||
      (long long)hkv * row_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  int log2g = 0;
  while ((1 << log2g) < chunks) ++log2g;
  auto s = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const int*>(page_table);
  auto ln = static_cast<const int*>(lengths);
  auto pw = static_cast<float*>(part);
  const int qb = q_dtype;
  int err = (int)cudaErrorInvalidValue;
#define PAGED_ARGS                                                         \
  rows, q, qb, k_pool, v_pool, pt, ln, pw, out, b, h, hkv, ps, hd, nb,     \
      split, n_splits, row_chunks, log2g, scale, s
  if (kv_dtype == 0) {
    if (vec_bytes == 16) err = by_rows<float, 16>(PAGED_ARGS);
    else if (vec_bytes == 8) err = by_rows<float, 8>(PAGED_ARGS);
    else if (vec_bytes == 4) err = by_rows<float, 4>(PAGED_ARGS);
  } else {
    if (vec_bytes == 16) err = by_rows<__nv_bfloat16, 16>(PAGED_ARGS);
    else if (vec_bytes == 8) err = by_rows<__nv_bfloat16, 8>(PAGED_ARGS);
    else if (vec_bytes == 4) err = by_rows<__nv_bfloat16, 4>(PAGED_ARGS);
    else err = by_rows<__nv_bfloat16, 2>(PAGED_ARGS);
  }
#undef PAGED_ARGS
  if (err || n_splits == 1) return err;
  const int rows_out = b * h;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows_out * 32 + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_combine_kernel, pw, ln, out, qb,
                                 rows_out, h, hd, nb, ps, split, n_splits);
}
