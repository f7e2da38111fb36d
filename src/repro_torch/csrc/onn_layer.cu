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
// Design: the simple tiled product.  One block of 256 threads per
// (row tile, column tile); over a K loop in steps of 8, the x tile and
// the W tile are staged in shared memory (transposed, so that each k is a
// row of the tile, and padded by 4 words so that the staging stores do
// not collide on a bank); each thread keeps a TM x TN register tile of
// f32 accumulators over the rows tr + RG i and the columns tc + CG j of
// the block tile, so that the shared loads of one warp are broadcasts or
// consecutive words and the stores of one warp are consecutive columns.
// Three tile shapes by m: 128 x 128 for the wide layers, 128 x 64 for
// m <= 64, 256 x 4 for m <= 8; every edge (rows, n and m of any size) is
// masked, and row offsets are 64-bit.  Plain f32 FMA on the CUDA cores,
// not TF32 and not the tensor cores, so that the layer agrees with the
// f32 plain version to rounding; the epilogue multiplies by d and adds b
// with the correctly rounded intrinsics, so with d = 1 it is the plain
// version's x W^T + b.  Shared memory is at most 8.6 KB a block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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
      float v = __fadd_rn(__fmul_rn(acc[i][j], dc), bc);
      if (relu) v = fmaxf(v, 0.f);
      y[r * m + c] = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const float* x, const float* w, const float* d, const float* b,
           float* y, long long rows, int n, int m, int relu,
           cudaStream_t stream) {
  const long long row_tiles = (rows + BM - 1) / BM;
  const long long col_tiles = (m + BN - 1) / BN;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  onn_layer_kernel<BM, BN, TM, TN>
      <<<dim3((unsigned)row_tiles, (unsigned)col_tiles), kThreads, 0,
         stream>>>(x, w, d, b, y, rows, n, m, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (rows, n) f32; w: contiguous (m, n) f32; d, b: (m,) f32;
// y: contiguous (rows, m) f32.  y = d * (x w^T) + b, then max(y, 0) when
// relu != 0.  Returns the cudaError_t of the launch (0 = success).
extern "C" int onn_layer(const void* x, const void* w, const void* d,
                         const void* b, void* y, long long rows, int n,
                         int m, int relu, void* stream) {
  if (rows < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* df = static_cast<const float*>(d);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8)
    return launch<256, 4, 1, 4>(xf, wf, df, bf, yf, rows, n, m, relu, s);
  if (m <= 64)
    return launch<128, 64, 8, 4>(xf, wf, df, bf, yf, rows, n, m, relu, s);
  return launch<128, 128, 8, 8>(xf, wf, df, bf, yf, rows, n, m, relu, s);
}
