// Dense ONN layer for Hopper (sm_90a): y = act(d * (x W^T) + b).
//
// Replaces the TPU kernel repro/kernels/onn_layer.py::onn_layer
// (_onn_layer_kernel): a tiled product of x (rows, n) with W^T, W (m, n),
// accumulated in f32, with the diagonal scale d, the bias b and the ReLU
// fused into the store, so the layer writes its output once.  In the port
// every dense layer of the in-network ONN (photonics/onn.py apply) runs
// through it, with d = 1 and ReLU on all layers but the last.
//
// What bounds it on the H100: one row per group of gradient symbols, so
// rows run to 1,048,576 a bucket while n and m are 1 to 256.  The wide
// layers (128 -> 256, 256 -> 128) do 2 n m flops for 4 (n + m) bytes a
// row, 43 flops a byte, above the f32 ridge of the card (67 TFLOP/s over
// 3.35 TB/s = 20): bound by operations.  The narrow ones (4 -> 64,
// 64 -> 4, and the exact-identity 1 -> 4 -> 1) are bound by bytes.
//
// Every form sums each output over k = 0 .. n-1 in order, one fmaf a
// product from 0, then multiplies by d and adds b with the correctly
// rounded intrinsics and takes the ReLU: the forms give the same bits,
// and with d = 1 the plain version's x W^T + b to rounding.  Plain f32 FMA
// on the CUDA cores: no TF32 and no tensor cores (the exact-identity ONN
// of bits 2 relies on f32 products).  No atomics: two calls give the same
// bits.  The wrapper (kernels/onn_layer.py plan) picks one form from the
// shape and the alignment of x and y:
//
// form 1, wide (n, m > 8, both multiples of 4, x and y 16-byte aligned):
//   one persistent block of 256 threads an SM owns a panel of BN = 128
//   columns (64 when m <= 64 or when 128 do not fit) and keeps W's panel,
//   zero-padded to a multiple of 32 k and laid out chunk by chunk (32 k
//   x BN rows of 36 words), in shared memory for the whole launch; it
//   walks the row tiles of its panel with a stride of the blocks on that
//   panel.  x is contiguous, so a chunk of a row tile (its rows x 32 k)
//   is a run of 128-byte pieces: it streams in by 16-byte cp.async
//   through a ring of three stages that runs on across tiles, so the next tile's first chunks load during
//   this tile's epilogue; one barrier a chunk.  A thread keeps TM rows x
//   TN columns of f32 sums, 8 x 8 at BN 128 (row tiles of 128) and
//   16 x 4 at BN 64 (row tiles of 256): rows tr + 16 i, columns in two
//   halves BN/2 apart of TN/2 neighbours, so the epilogue stores 16-byte
//   (8-byte) runs.  For each 4 k a thread reads TM float4 of x and TN of
//   W and does 4 TM TN FMAs.  A 128-bit shared load costs the SM at
//   least 2 cycles, and more when a quarter warp reads more than 4
//   distinct 16-byte words (measured); so a quarter warp holds 4 row
//   groups x 2 column groups, whose 4 staged rows (36 words apart) and 2
//   panel rows (144 words apart) start on distinct banks.  What bounds
//   it: no FFMA issues while the SM returns a shared load, so an 8 x 8
//   tile fed by its 16 loads a 4 k runs well below the f32 peak
//   (chip_smoke.py onn_issue_probe measures both rates on the card).
// form 2, fan-out (n <= 8): a thread owns 4 output columns (m a multiple
//   of 4 up to 1024, y aligned) or one (m up to 256) for the whole
//   launch, their W, d and b in registers, and walks rows, four in
//   flight; the threads of a row read its n inputs (one L1 line) and
//   write its outputs as neighbouring stores, so a warp stores 512 (128)
//   consecutive bytes.
// form 3, fan-in (m <= 8, n a multiple of 4, x aligned): W, d and b in
//   shared memory; a persistent block streams runs of whole rows (a run
//   of x is contiguous) through a ring of four cp.async stages, rows
//   padded by 4 words so that lanes on neighbouring rows read distinct
//   banks; a thread computes one output of a row, neighbouring threads
//   neighbouring outputs, so the stores are coalesced.
// form 0, general (any shape, any alignment): the simple tiled product.
//   One block of 256 threads per (row tile, column tile); over a K loop in
//   steps of 8, the x tile and the W tile are staged in shared memory
//   (transposed, padded by 4 words); each thread keeps a TM x TN register
//   tile over the rows tr + RG i and the columns tc + CG j.  Three tile
//   shapes by m: 128 x 128, 128 x 64 for m <= 64, 256 x 4 for m <= 8;
//   every edge is masked.
//
// Row offsets are 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float epilogue(float acc, float dc, float bc,
                                          int relu) {
  const float v = __fadd_rn(__fmul_rn(acc, dc), bc);
  return relu ? fmaxf(v, 0.f) : v;
}

// 16 bytes from global to shared, asynchronously; n_src 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n_src)
               : "memory");
}

// 4 bytes from global to shared, asynchronously; n_src 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int n_src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ------------------------------------------------------ form 0: general
constexpr int kBK = 8;       // depth of one K step
constexpr int kPad = 4;      // words of padding per staged row

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
onn_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ d, const float* __restrict__ b,
                 float* __restrict__ y, long long rows, int n, int m,
                 int relu) {
  constexpr int RG = BM / TM;  // row groups: thread rows tr + RG * i
  constexpr int CG = BN / TN;  // column groups: columns tc + CG * j
  static_assert(RG * CG == kThreads, "one register tile per thread");
  __shared__ float xs[kBK][BM + kPad];
  __shared__ float ws[kBK][BN + kPad];

  const int tid = threadIdx.x;
  const int tc = tid % CG;
  const int tr = tid / CG;
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    // neighbouring threads read neighbouring k of one row: 32-byte runs
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const long long gr = row0 + r;
      xs[k][r] = (gr < rows && k0 + k < n) ? x[gr * n + k0 + k] : 0.f;
    }
    for (int e = tid; e < BN * kBK; e += kThreads) {
      const int c = e / kBK, k = e % kBK;
      ws[k][c] = (col0 + c < m && k0 + k < n)
                     ? w[(long long)(col0 + c) * n + k0 + k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], bw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][tr + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bw[j] = ws[k][tc + CG * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col0 + tc + CG * j;
    if (c >= m) continue;
    const float dc = d[c], bc = b[c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long r = row0 + tr + RG * i;
      if (r >= rows) continue;
      y[r * m + c] = epilogue(acc[i][j], dc, bc, relu);
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch_general(const float* x, const float* w, const float* d,
                   const float* b, float* y, long long rows, int n, int m,
                   int relu, cudaStream_t stream) {
  const long long row_tiles = (rows + BM - 1) / BM;
  const long long col_tiles = (m + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  onn_layer_kernel<BM, BN, TM, TN>
      <<<dim3((unsigned)row_tiles, (unsigned)col_tiles), kThreads, 0,
         stream>>>(x, w, d, b, y, rows, n, m, relu);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- form 1: wide
constexpr int kWideBK = 32;        // k of a chunk
constexpr int kWideStages = 3;     // chunks in the ring
constexpr int kLdx = kWideBK + 4;  // words a staged row: 36, 4 mod 32

// W's panel, chunk by chunk (for each 32 k, BN rows of 36 words, so that
// a column's offset inside a chunk is a constant), and the ring of
// chunks of BM rows.
size_t wide_smem(int bm, int bn, int n) {
  const size_t nk = (n + kWideBK - 1) / kWideBK;
  return sizeof(float) * kLdx * (nk * bn + (size_t)kWideStages * bm);
}

// A thread keeps TM rows x TN columns of sums, rows tr + 16 i and
// columns in two halves of TN / 2 neighbours BN / 2 apart: a block tile
// of BM = 16 TM rows by BN = 16 TN columns.
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
onn_layer_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ d,
                      const float* __restrict__ b, float* __restrict__ y,
                      long long rows, int n, int m, int relu) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int CQ = TN / 2;          // neighbouring columns in each half
  constexpr int HALF = BN / 2;
  static_assert(TM % 8 == 0 && TN % 2 == 0, "tile");
  extern __shared__ __align__(16) float smem[];
  const int nk = (n + kWideBK - 1) / kWideBK;   // chunks a row tile
  float* ws = smem;                             // nk x BN x kLdx
  float* xs = smem + nk * BN * kLdx;            // stages x BM x kLdx

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // 16 row groups x 16 column groups; a quarter warp holds 4 row groups
  // x 2 column groups, so that each 128-bit shared load reads 4 (x) or 2
  // (W) distinct 16-byte words a quarter: 2 cycles, the least there is
  const int tr = (lane & 3) + 4 * ((lane >> 4) & 1) + 8 * (warp & 1);
  const int tc = ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) + 4 * (warp >> 1);
  const int col0 = blockIdx.y * BN;
  const long long row_tiles = (rows + BM - 1) / BM;

  // the resident panel, zero outside (m, n) so padded k add 0; it lands
  // with the first chunk's commit group
  for (int c = warp; c < BN; c += kThreads / 32) {
    const bool in = col0 + c < m;
    const float* wr = w + (long long)(col0 + c) * n;
    for (int k = lane; k < nk * kWideBK; k += 32) {
      const bool ok = in && k < n;
      cp_async4(ws + (k / kWideBK * BN + c) * kLdx + k % kWideBK,
                ok ? wr + k : w, ok ? 4 : 0);
    }
  }

  // the loader: chunk (tile lt, k chunk lk) into stage ls, one commit
  // group a chunk (empty past the last tile, so the counts stay even).
  // A thread copies 16 bytes at k 4 q of rows lq + 32 i.
  constexpr int kPieces = kWideBK / 4;
  constexpr int kRowsAPass = kThreads / kPieces;
  const int q = tid % kPieces, lq = tid / kPieces;
  const long long row_step = (long long)kRowsAPass * n;
  long long lt = blockIdx.x, lrow = lt * BM + lq;
  const float* lsrc = x + lrow * n + 4 * q;
  int lk = 0, ls = 0;
  auto load_next = [&]() {
    if (lt < row_tiles) {
      float* dst = xs + (ls * BM + lq) * kLdx + 4 * q;
      const bool k_in = lk * kWideBK + 4 * q < n;
#pragma unroll
      for (int i = 0; i < BM / kRowsAPass; ++i) {
        const bool ok = k_in && lrow + kRowsAPass * i < rows;
        cp_async16(dst + kRowsAPass * i * kLdx,
                   ok ? lsrc + i * row_step + lk * kWideBK : x, ok ? 16 : 0);
      }
    }
    cp_async_commit();
    if (++lk == nk) {
      lk = 0;
      lt += gridDim.x;
      lrow += (long long)gridDim.x * BM;
      lsrc += (long long)gridDim.x * BM * n;
    }
    if (++ls == kWideStages) ls = 0;
  };
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) load_next();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int kc = 0, stage = 0;
  for (long long t = blockIdx.x; t < row_tiles;) {
    cp_async_wait<kWideStages - 2>();
    __syncthreads();   // chunk visible; the stage it replaces is consumed
    load_next();
    const float* xb = xs + (stage * BM + tr) * kLdx;
    const float* wb = ws + (kc * BN + tc * CQ) * kLdx;
    // a group of 4 k: for each 8 of a thread's rows, 8 float4 of x and
    // TN float4 of W (its columns), then 32 TN products; each sum is
    // updated once a k.  (At TM 16 W's columns are loaded first, once.
    // Either order is the one that measured fastest for its tile.)
#pragma unroll
    for (int kk = 0; kk < kWideBK; kk += 4) {
      float4 a[8], v[TN];
      auto load_w = [&]() {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          v[j] = *reinterpret_cast<const float4*>(
              wb + (j < CQ ? j : HALF + j - CQ) * kLdx + kk);
      };
      if constexpr (TM > 8) load_w();
#pragma unroll
      for (int i0 = 0; i0 < TM; i0 += 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              xb + (i0 + i) * 16 * kLdx + kk);
        if constexpr (TM == 8) load_w();
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i0 + i][j] = fmaf(a[i].x, v[j].x, acc[i0 + i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i0 + i][j] = fmaf(a[i].y, v[j].y, acc[i0 + i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i0 + i][j] = fmaf(a[i].z, v[j].z, acc[i0 + i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i0 + i][j] = fmaf(a[i].w, v[j].w, acc[i0 + i][j]);
      }
    }
    if (++stage == kWideStages) stage = 0;
    if (++kc < nk) continue;

    // the tile's epilogue, while the ring loads the next tile's chunks
    const long long r0 = t * BM + tr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * HALF + tc * CQ;
      if (c >= m) continue;   // m % 4 == 0: a run is all in or all out
      float dc[CQ], bc[CQ];
#pragma unroll
      for (int e = 0; e < CQ; ++e) {
        dc[e] = __ldg(d + c + e);
        bc[e] = __ldg(b + c + e);
      }
      float* out = y + r0 * m + c;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (r0 + 16 * i >= rows) break;
        float v[CQ];
#pragma unroll
        for (int e = 0; e < CQ; ++e)
          v[e] = epilogue(acc[i][h * CQ + e], dc[e], bc[e], relu);
        if constexpr (CQ == 4)
          *reinterpret_cast<float4*>(out + 16LL * i * m) =
              make_float4(v[0], v[1], v[2], v[3]);
        else
          *reinterpret_cast<float2*>(out + 16LL * i * m) =
              make_float2(v[0], v[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    kc = 0;
    t += gridDim.x;
  }
  cp_async_wait<0>();
}

template <int TM, int TN>
int launch_wide(const float* x, const float* w, const float* d,
                const float* b, float* y, long long rows, int n, int m,
                int relu, int blocks, cudaStream_t stream) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  const long long row_tiles = (rows + BM - 1) / BM;
  const long long col_tiles = (m + BN - 1) / BN;
  if (blocks < 1 || blocks > row_tiles || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = wide_smem(BM, BN, n);
  const void* kernel = (const void*)onn_layer_wide_kernel<TM, TN>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  onn_layer_wide_kernel<TM, TN>
      <<<dim3((unsigned)blocks, (unsigned)col_tiles), kThreads, smem,
         stream>>>(x, w, d, b, y, rows, n, m, relu);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ form 2: fan-out
constexpr int kFanOutRows = 4;   // rows a thread has in flight

// N inputs; a thread owns CPT neighbouring output columns (4: one
// 16-byte store a row; 1: any m) for the whole launch.
template <int N, int CPT>
__global__ void __launch_bounds__(kThreads)
onn_layer_fan_out_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ d,
                         const float* __restrict__ b,
                         float* __restrict__ y, long long rows, int m,
                         int relu) {
  const int groups = m / CPT;                // threads a row
  const int per_pass = blockDim.x / groups;  // rows a block a pass
  const int c = CPT * (threadIdx.x % groups);
  float wr[CPT][N], dc[CPT], bc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
#pragma unroll
    for (int k = 0; k < N; ++k) wr[j][k] = __ldg(w + (c + j) * N + k);
    dc[j] = __ldg(d + c + j);
    bc[j] = __ldg(b + c + j);
  }
  const long long step = (long long)gridDim.x * per_pass;
  for (long long r0 = (long long)blockIdx.x * per_pass +
                      threadIdx.x / groups;
       r0 < rows; r0 += kFanOutRows * step) {
    float xv[kFanOutRows][N];
#pragma unroll
    for (int u = 0; u < kFanOutRows; ++u) {
      const long long r = r0 + u * step;
#pragma unroll
      for (int k = 0; k < N; ++k)
        xv[u][k] = r < rows ? __ldg(x + r * N + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFanOutRows; ++u) {
      const long long r = r0 + u * step;
      if (r >= rows) break;
      float v[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) s = fmaf(xv[u][k], wr[j][k], s);
        v[j] = epilogue(s, dc[j], bc[j], relu);
      }
      if constexpr (CPT == 4)
        *reinterpret_cast<float4*>(y + r * m + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        y[r * m + c] = v[0];
    }
  }
}

template <int N>
int launch_fan_out_n(const float* x, const float* w, const float* d,
                     const float* b, float* y, long long rows, int m,
                     int relu, int cpt, int blocks, cudaStream_t stream) {
  const int groups = m / cpt;
  const int threads = kThreads / groups * groups;
  if (cpt == 4)
    onn_layer_fan_out_kernel<N, 4><<<blocks, threads, 0, stream>>>(
        x, w, d, b, y, rows, m, relu);
  else
    onn_layer_fan_out_kernel<N, 1><<<blocks, threads, 0, stream>>>(
        x, w, d, b, y, rows, m, relu);
  return (int)cudaGetLastError();
}

int launch_fan_out(const float* x, const float* w, const float* d,
                   const float* b, float* y, long long rows, int n, int m,
                   int relu, int cpt, int blocks, cudaStream_t stream) {
  switch (n) {
#define ONN_FAN_OUT(N)                                                     \
  case N:                                                                  \
    return launch_fan_out_n<N>(x, w, d, b, y, rows, m, relu, cpt, blocks, \
                               stream);
    ONN_FAN_OUT(1) ONN_FAN_OUT(2) ONN_FAN_OUT(3) ONN_FAN_OUT(4)
    ONN_FAN_OUT(5) ONN_FAN_OUT(6) ONN_FAN_OUT(7) ONN_FAN_OUT(8)
#undef ONN_FAN_OUT
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------- form 3: fan-in
constexpr int kFanInStages = 4;

// W (m rows, pitch n + 4), d and b (8 words each), then the ring of
// `tile` rows a stage at pitch n + 4.
size_t fan_in_smem(int n, int m, int tile) {
  return sizeof(float) * ((size_t)(m + kFanInStages * tile) * (n + 4) + 16);
}

__global__ void __launch_bounds__(kThreads)
onn_layer_fan_in_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ d,
                        const float* __restrict__ b, float* __restrict__ y,
                        long long rows, int n, int m, int relu, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int ld = n + 4;
  float* ws = smem;              // m x ld
  float* ds = ws + m * ld;       // 8
  float* bs = ds + 8;            // 8
  float* xs = bs + 8;            // kFanInStages x tile x ld
  const int tid = threadIdx.x;
  for (int e = tid; e < m * n; e += kThreads)
    ws[(e / n) * ld + e % n] = w[e];
  if (tid < m) {
    ds[tid] = d[tid];
    bs[tid] = b[tid];
  }
  const long long tiles = (rows + tile - 1) / tile;
  const int q4 = n / 4;          // 16-byte pieces a row

  long long lt = blockIdx.x;
  int ls = 0;
  auto load_next = [&]() {
    if (lt < tiles) {
      float* dst = xs + ls * tile * ld;
      const long long r0 = lt * tile;
      for (int g = tid; g < tile * q4; g += kThreads) {
        const int r = g / q4, q = g - r * q4;
        const bool ok = r0 + r < rows;
        cp_async16(dst + r * ld + 4 * q, ok ? x + (r0 + r) * n + 4 * q : x,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
    lt += gridDim.x;
    if (++ls == kFanInStages) ls = 0;
  };
#pragma unroll
  for (int s = 0; s < kFanInStages - 1; ++s) load_next();

  int stage = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    cp_async_wait<kFanInStages - 2>();
    __syncthreads();   // tile visible; the stage it replaces is consumed
    load_next();
    const float* xb = xs + stage * tile * ld;
    const long long r0 = t * tile;
    for (int e = tid; e < tile * m; e += kThreads) {
      const int r = e / m, c = e - r * m;
      if (r0 + r >= rows) break;
      const float* xr = xb + r * ld;
      const float* wr = ws + c * ld;
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xr + k);
        const float4 v = *reinterpret_cast<const float4*>(wr + k);
        s = fmaf(a.x, v.x, s);
        s = fmaf(a.y, v.y, s);
        s = fmaf(a.z, v.z, s);
        s = fmaf(a.w, v.w, s);
      }
      y[r0 * m + e] = epilogue(s, ds[c], bs[c], relu);
    }
    if (++stage == kFanInStages) stage = 0;
  }
  cp_async_wait<0>();
}

int launch_fan_in(const float* x, const float* w, const float* d,
                  const float* b, float* y, long long rows, int n, int m,
                  int relu, int tile, int blocks, cudaStream_t stream) {
  const long long tiles = (rows + tile - 1) / tile;
  if (blocks > tiles) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = fan_in_smem(n, m, tile);
  cudaError_t e = allow_smem((const void*)onn_layer_fan_in_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  onn_layer_fan_in_kernel<<<blocks, kThreads, smem, stream>>>(
      x, w, d, b, y, rows, n, m, relu, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (rows, n) f32; w: contiguous (m, n) f32; d, b: (m,) f32;
// y: contiguous (rows, m) f32.  y = d * (x w^T) + b, then max(y, 0) when
// relu != 0.  `form` is 0 general, 1 wide, 2 fan-out, 3 fan-in, as the
// wrapper's plan picks it; `tile` is the wide form's panel columns (64 or
// 128), the fan-out form's columns a thread (4 or 1) and the fan-in
// form's rows a stage; `blocks` the persistent
// blocks (the wide form: a column panel).  A form whose conditions do not
// hold is refused, never replaced.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int onn_layer(const void* x, const void* w, const void* d,
                         const void* b, void* y, long long rows, int n,
                         int m, int relu, int form, int tile, int blocks,
                         void* stream) {
  if (rows < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* df = static_cast<const float*>(d);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      if (m <= 8)
        return launch_general<256, 4, 1, 4>(xf, wf, df, bf, yf, rows, n, m,
                                            relu, s);
      if (m <= 64)
        return launch_general<128, 64, 8, 4>(xf, wf, df, bf, yf, rows, n,
                                             m, relu, s);
      return launch_general<128, 128, 8, 8>(xf, wf, df, bf, yf, rows, n, m,
                                            relu, s);
    case 1:
      if (n <= 8 || m <= 8 || n % 4 || m % 4 || !aligned16(x) ||
          !aligned16(y))
        return (int)cudaErrorInvalidValue;
      // tile: the panel's columns; 128 (rows of 128, 8 x 8 a thread) or
      // 64 (rows of 256, 16 x 4 a thread)
      if (tile == 128)
        return launch_wide<8, 8>(xf, wf, df, bf, yf, rows, n, m, relu,
                                 blocks, s);
      if (tile == 64)
        return launch_wide<16, 4>(xf, wf, df, bf, yf, rows, n, m, relu,
                                  blocks, s);
      return (int)cudaErrorInvalidValue;
    case 2:   // tile: the columns a thread owns
      if (n > 8 || blocks < 1 ||
          !(tile == 4 ? m % 4 == 0 && m <= 4 * kThreads && aligned16(y)
                      : tile == 1 && m <= kThreads))
        return (int)cudaErrorInvalidValue;
      return launch_fan_out(xf, wf, df, bf, yf, rows, n, m, relu, tile,
                            blocks, s);
    case 3:
      if (m > 8 || n % 4 || tile < 1 || blocks < 1 || !aligned16(x))
        return (int)cudaErrorInvalidValue;
      return launch_fan_in(xf, wf, df, bf, yf, rows, n, m, relu, tile,
                           blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
