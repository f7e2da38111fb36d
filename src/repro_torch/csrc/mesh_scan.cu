// The MZI-mesh cascade for Hopper (sm_90a): B stacked Clements programs,
// each L rotation layers y <- ca * y + sa * y[perm] between two diagonals.
//
// Replaces the TPU kernel repro/kernels/mesh_scan.py::mesh_scan_blocks
// (_mesh_scan_blocks_kernel; mesh_scan is its B = 1 case).  In the port
// every rotation mesh of the in-network ONN at fidelity 'mesh' runs
// through it (photonics/mesh.py), whichever --mesh-backend is asked for.
//
// What it computes, per mesh block b and row r (x shared by the blocks or
// one slice per block; out (rows, B, m)):
//   y = x * pre;  for each layer: y_w = fma(ca_w, y_w, s_w * y_perm[w]);
//   out = y * post
// forward: pre = signs, s = sa, post = post_scale (or 1); transpose: the
// layers in reverse, s = -sa, pre = 1, post = signs * post_scale.  Each
// layer is one fmaf of a correctly rounded product, the form XLA
// compiles the JAX scan into, so the kernel, its plain version
// (kernels/ref.py mesh_scan_blocks_ref) and the JAX executors agree bit
// for bit; the diagonals are __fmul_rn, never contracted.
//
// The theta drift (kDrift) is the JAX kernel's: per wire w of layer l a
// standard normal g(l, w) from two splitmix32 hashes of the counter
// (l * k + w) * 0x9E3779B9 + seed (k = m rounded up to 128, the JAX
// field's row width) and Box-Muller; the partner's g(l, perm[w]) is
// hashed again rather than read from a stored (L, m) field;
// eps = theta_std * (sqrt(1/2) * (g_w + g_p)) * sign(w - perm[w]) rotates
// (ca, sa) by eps, so a wire with no partner gets eps = 0 exactly.  The
// precise logf, sqrtf, cosf and sinf (no fast-math flag), and no
// contraction in the rotation, so it differs from the plain version by
// libm ulps only.
//
// What bounds it on the H100: per update one fma and one product (3
// flops) on 12 bytes of shared memory (two reads, one write), against
// 8 bytes of device memory per row and wire for the whole mesh.  With
// L up to 509 layers the device-memory bytes are negligible, and at
// ~33 TB/s of shared-memory bandwidth across the card the shared
// traffic, not the 67 TFLOP/s f32 peak, sets the pace: 12 B per 3
// flops is 4 B a flop, ~8 TFLOP/s at most.
//
// Design: the simple one.  One CUDA block per (row tile, mesh block);
// a block of m x G threads, thread (w, g) owns wire w for the tile rows
// g, g + G, ...; the row tile lives in shared memory in two ping-pong
// buffers of tile x m f32 (64 KB by default, up to 227 KB, set by
// cudaFuncSetAttribute above 48 KB), so one __syncthreads() ends a
// layer.  Each thread loads its wire's perm, ca and sa of the next
// layer while it computes this one (the (B, L, m) stacks, 1.5 MiB at
// m = 256, L = 509, stay in L2).  The programs are Givens eliminations
// on adjacent planes, so perm[w] is w - 1, w or w + 1 and a warp's
// reads of y[perm] fall within one word of its own 32-word window: at
// most a two-way bank conflict, between its two edge threads.
// Global loads and stores walk the row's m contiguous wires.  The TPU
// kernel's one-hot matmul for y[perm] and its 128-lane padding were
// workarounds for the TPU and are not here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the standard normal of wire w at layer l (JAX: _normal_field)
__device__ __forceinline__ float drift_normal(uint32_t seed, int l, int k,
                                              int w) {
  const uint32_t c =
      ((uint32_t)l * (uint32_t)k + (uint32_t)w) * 0x9E3779B9u + seed;
  const uint32_t h1 = mix32(c), h2 = mix32(c ^ 0x85EBCA6Bu);
  const float two24 = 5.9604644775390625e-8f;   // 2^-24
  const float u1 = __fmul_rn(__fadd_rn((float)(h1 >> 8), 1.0f), two24);
  const float u2 = __fmul_rn((float)(h2 >> 8), two24);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318548202514648f, u2)));
}

template <bool kDrift>
__global__ void mesh_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ signs,
    const int* __restrict__ perm, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ post_scale,
    const uint32_t* __restrict__ seeds, float* __restrict__ out,
    long long rows, int n_blocks, int n_layers, int m, int x_blocked,
    int transpose, float theta_std, int tile) {
  extern __shared__ float smem[];
  float* src = smem;
  float* dst = smem + (long long)tile * m;
  const int w = threadIdx.x;
  const int g = threadIdx.y;
  const int G = blockDim.y;
  const int b = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * tile;
  const int nr = (int)min((long long)tile, rows - row0);

  const float sg = signs[b * m + w];
  const float pre = transpose ? 1.0f : sg;
  float post = transpose ? sg : 1.0f;
  if (post_scale != nullptr) post = __fmul_rn(post, post_scale[b * m + w]);

  const long long x_stride = x_blocked ? (long long)n_blocks * m : m;
  const float* xb = x + (x_blocked ? (long long)b * m : 0) + row0 * x_stride;
  for (int r = g; r < nr; r += G)
    src[r * m + w] = __fmul_rn(xb[r * x_stride + w], pre);

  const long long stack = (long long)b * n_layers * m;
  const int* pb = perm + stack;
  const float* cb = ca + stack;
  const float* sb = sa + stack;
  uint32_t seed = 0;
  int k = 0;
  if (kDrift) {
    seed = seeds[b];
    k = (m + 127) / 128 * 128;
  }
  int l = transpose ? n_layers - 1 : 0;
  long long o = (long long)l * m + w;
  int p_next = pb[o];
  float c_next = cb[o], s_next = sb[o];
  __syncthreads();

  for (int i = 0; i < n_layers; ++i) {
    const int p = p_next;
    float c = c_next, s = s_next;
    const int li = l;
    if (i + 1 < n_layers) {          // the next layer's coefficients
      l = transpose ? n_layers - 2 - i : i + 1;
      o = (long long)l * m + w;
      p_next = pb[o];
      c_next = cb[o];
      s_next = sb[o];
    }
    if (kDrift) {
      const float gw = drift_normal(seed, li, k, w);
      const float gp = drift_normal(seed, li, k, p);
      const float sgn = w > p ? 1.0f : (w < p ? -1.0f : 0.0f);
      const float delta = __fmul_rn(0.70710678118654752f, __fadd_rn(gw, gp));
      const float eps = __fmul_rn(__fmul_rn(theta_std, delta), sgn);
      const float ce = cosf(eps), se = sinf(eps);
      const float c2 = __fsub_rn(__fmul_rn(c, ce), __fmul_rn(s, se));
      s = __fadd_rn(__fmul_rn(s, ce), __fmul_rn(c, se));
      c = c2;
    }
    if (transpose) s = -s;
    for (int r = g; r < nr; r += G) {
      const float* yr = src + r * m;
      dst[r * m + w] = fmaf(c, yr[w], __fmul_rn(s, yr[p]));
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  float* ob = out + row0 * n_blocks * m + (long long)b * m;
  for (int r = g; r < nr; r += G)
    ob[(long long)r * n_blocks * m + w] = __fmul_rn(src[r * m + w], post);
}

template <bool kDrift>
int launch(const float* x, const float* signs, const int* perm,
           const float* ca, const float* sa, const float* post_scale,
           const uint32_t* seeds, float* out, long long rows, int n_blocks,
           int n_layers, int m, int x_blocked, int transpose,
           float theta_std, int tile, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mesh_scan_kernel<kDrift>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int groups = max(1, min(256 / m, tile));
  const long long tiles = (rows + tile - 1) / tile;
  const size_t smem = 2 * (size_t)tile * m * sizeof(float);
  mesh_scan_kernel<kDrift>
      <<<dim3((unsigned)tiles, (unsigned)n_blocks), dim3(m, groups), smem,
         stream>>>(x, signs, perm, ca, sa, post_scale, seeds, out, rows,
                   n_blocks, n_layers, m, x_blocked, transpose, theta_std,
                   tile);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous (rows, m) f32, or (rows, B, m) with x_blocked; signs,
// post_scale (nullable): (B, m) f32; perm: (B, L, m) int32; ca, sa:
// (B, L, m) f32; seeds: (B,) uint32, read only when theta_std > 0; out:
// contiguous (rows, B, m) f32.  tile: rows a block holds in shared
// memory (a multiple of 8; 2 * tile * m * 4 bytes at most 232448).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mesh_scan_blocks(const void* x, const void* signs,
                                const void* perm, const void* ca,
                                const void* sa, const void* post_scale,
                                const void* seeds, void* out,
                                long long rows, int n_blocks, int n_layers,
                                int m, int x_blocked, int transpose,
                                float theta_std, int tile, void* stream) {
  if (rows < 1 || n_blocks < 1 || n_blocks > 65535 || n_layers < 1 ||
      m < 1 || m > 1024 || tile < 8 || tile % 8 ||
      2LL * tile * m * (long long)sizeof(float) > kMaxSmem ||
      (rows + tile - 1) / tile > 0x7fffffffLL ||
      (theta_std > 0.0f && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* sg = static_cast<const float*>(signs);
  const int* pm = static_cast<const int*>(perm);
  const float* cf = static_cast<const float*>(ca);
  const float* sf = static_cast<const float*>(sa);
  const float* ps = static_cast<const float*>(post_scale);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (theta_std > 0.0f)
    return launch<true>(xf, sg, pm, cf, sf, ps, sd, of, rows, n_blocks,
                        n_layers, m, x_blocked, transpose, theta_std, tile,
                        s);
  return launch<false>(xf, sg, pm, cf, sf, ps, sd, of, rows, n_blocks,
                       n_layers, m, x_blocked, transpose, 0.0f, tile, s);
}
