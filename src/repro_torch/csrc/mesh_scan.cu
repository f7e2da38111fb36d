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
// field's row width) and Box-Muller; a lane draws g for its own wires
// and takes the partner's from the neighbouring register or lane;
// eps = theta_std * (sqrt(1/2) * (g_w + g_p)) * sign(w - perm[w]) rotates
// (ca, sa) by eps, so a wire with no partner gets eps = 0 exactly.  The
// precise logf, sqrtf, cosf and sinf (no fast-math flag), and no
// contraction in the rotation, so it differs from the plain version by
// libm ulps only.
//
// Design: a warp owns whole rows in registers.  The programs are Givens
// eliminations on adjacent planes (photonics/mzi.py), so every partner
// is a neighbour: perm[w] is w - 1, w or w + 1, perm is an involution,
// a wire with perm[w] = w has sa = 0, and a layer pairs either even-
// aligned wires (2i, 2i + 1) or odd-aligned ones (2i + 1, 2i + 2), never
// both (kernels/mesh_scan.py check_program refuses any other program).
// Lane i holds the W adjacent wires i*W .. i*W + W - 1 (W = m / 32
// rounded up to a power of two; wires >= m are padding that stays 0 and
// is never stored) of R rows (warp_rows: 16 up to W = 8, 128 / W above),
// in y[R][W], indexed by compile-time constants only.  No warp depends
// on another: no shared memory, no barrier.
//
// W is even, so an even-aligned layer pairs registers inside a lane,
// partner j ^ 1: per update one product and one fma, no select, no
// shuffle.  An odd-aligned layer pairs registers inside a lane too,
// except the lane's two edge wires, whose partners come by one
// __shfl_up_sync and one __shfl_down_sync a row.  A warp vote on the
// layer's lower wires picks the form.  A wire with no partner (s = 0)
// takes the partner its form gives, fma(c, y, 0 * y_p) = c y for finite
// values; the inputs must be finite (a non-finite neighbour makes it NaN
// where the plain version keeps c y).  At W = 1 a lane is a wire and its
// partner is lane perm[w], one __shfl_sync a row.  A lane reads its W
// entries of perm, ca and sa once a layer, one layer ahead (vector loads
// where m is a multiple of W and the pointers are aligned), for R rows;
// the (B, L, m) stacks (1.5 MiB at m = 256, L = 509) stay in L2.  A
// block is ceil(tile / R) warps (at most 8) over tile rows; a warp's rows
// past the end are computed as zeros and neither loaded nor stored, and
// every lane takes part in every shuffle.
//
// What bounds it on the H100: instruction throughput.  The function
// needs one product and one fma for each wire of each rotation, n_rot
// rotations a program (m (m - 1) / 2 for a full one, 50.1% of the L m
// slots at m = 256): 3.1 ms at the 67 TFLOP/s f32 peak for the 256-wire
// mesh over a 1,048,576-row bucket, 4.1 ms at 2 of the 4 x 32 lane-
// instructions an SM dispatches a clock.  The kernel spends those two
// instructions on every slot, identities included (8.2 ms at that rate),
// plus per layer a lane's loads, copies and vote and per odd layer 2
// shuffles a row.  Device-memory bytes (x and out once, the stacks once)
// are negligible against L = 509 layers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;        // 8 x 32 threads x 255 registers fit an SM
constexpr unsigned kFull = 0xffffffffu;

// R, the rows a warp holds in registers at W wires a lane
__host__ __device__ constexpr int warp_rows(int w) {
  return w <= 8 ? 16 : 128 / w;
}

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

// the built-in vector type of N values of T
template <typename T, int N> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 1> { using type = int; };
template <> struct Vec<int, 2> { using type = int2; };
template <> struct Vec<int, 4> { using type = int4; };

// v[j] = p[w0 + j] for a lane's W wires, pad + j * step for wires >= m.
// With vec (m a multiple of W, p aligned to the vector) a lane is whole
// or empty and loads in vectors of up to 16 bytes.
template <int W, typename T>
__device__ __forceinline__ void load_wires(T (&v)[W], const T* __restrict__ p,
                                           int w0, int m, bool vec, T pad,
                                           T step) {
  constexpr int N = W < 4 ? W : 4;
  if (vec && w0 < m) {
#pragma unroll
    for (int q = 0; q < W / N; ++q) {
      using V = typename Vec<T, N>::type;
      const V t = reinterpret_cast<const V*>(p + w0)[q];
      const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
      for (int i = 0; i < N; ++i) v[q * N + i] = e[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      v[j] = w0 + j < m ? p[w0 + j] : pad + (T)j * step;
  }
}

// One layer's perm, ca and sa of a lane's wires (identities past m),
// under one branch.
template <int W>
__device__ __forceinline__ void load_layer(int (&p)[W], float (&c)[W],
                                           float (&s)[W],
                                           const int* __restrict__ pl,
                                           const float* __restrict__ cl,
                                           const float* __restrict__ sl,
                                           int w0, int m, bool vec) {
  if (vec && w0 < m) {
    load_wires<W>(p, pl, w0, m, true, 0, 0);
    load_wires<W>(c, cl, w0, m, true, 0.0f, 0.0f);
    load_wires<W>(s, sl, w0, m, true, 0.0f, 0.0f);
  } else {
    load_wires<W>(p, pl, w0, m, false, w0, 1);
    load_wires<W>(c, cl, w0, m, false, 1.0f, 0.0f);
    load_wires<W>(s, sl, w0, m, false, 0.0f, 0.0f);
  }
}

template <int W>
__device__ __forceinline__ void store_wires(float* __restrict__ p,
                                            const float (&v)[W], int w0,
                                            int m, bool vec) {
  constexpr int N = W < 4 ? W : 4;
  if (vec) {
    if (w0 < m) {
#pragma unroll
      for (int q = 0; q < W / N; ++q) {
        using V = typename Vec<float, N>::type;
        V t;
        float* e = reinterpret_cast<float*>(&t);
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = v[q * N + i];
        reinterpret_cast<V*>(p + w0)[q] = t;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (w0 + j < m) p[w0 + j] = v[j];
  }
}

// y_w <- fma(c_w, y_w, s_w * partner), each wire's partner from the old
// row.  The two forms of one layer over a lane's R rows of W >= 2 wires:
// rotations on even-aligned pairs (2i, 2i + 1) stay inside a lane;
// odd-aligned pairs (2i + 1, 2i + 2) cross to the lanes either side at
// the lane's edge wires.  A wire with no partner has s = 0 and takes the
// neighbour its form gives.
template <int W, int R>
__device__ __forceinline__ void layer_even(float (&y)[R][W],
                                           const float (&c)[W],
                                           const float (&s)[W]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
      const float a = y[r][j], b = y[r][j + 1];
      y[r][j] = fmaf(c[j], a, __fmul_rn(s[j], b));
      y[r][j + 1] = fmaf(c[j + 1], b, __fmul_rn(s[j + 1], a));
    }
  }
}

template <int W, int R>
__device__ __forceinline__ void layer_odd(float (&y)[R][W],
                                          const float (&c)[W],
                                          const float (&s)[W]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // every lane shuffles: lane 0's up and lane 31's down are its own
    // values, read only by a wire with no partner there (times 0)
    const float up = __shfl_up_sync(kFull, y[r][W - 1], 1);
    const float down = __shfl_down_sync(kFull, y[r][0], 1);
#pragma unroll
    for (int j = 1; j + 1 < W; j += 2) {
      const float a = y[r][j], b = y[r][j + 1];
      y[r][j] = fmaf(c[j], a, __fmul_rn(s[j], b));
      y[r][j + 1] = fmaf(c[j + 1], b, __fmul_rn(s[j + 1], a));
    }
    y[r][0] = fmaf(c[0], y[r][0], __fmul_rn(s[0], up));
    y[r][W - 1] = fmaf(c[W - 1], y[r][W - 1], __fmul_rn(s[W - 1], down));
  }
}

// W = 1: a lane is a wire, so its partner is lane perm[w]
template <int R>
__device__ __forceinline__ void layer_lanes(float (&y)[R][1], float c, float s,
                                            int p) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    y[r][0] = fmaf(c, y[r][0], __fmul_rn(s, __shfl_sync(kFull, y[r][0], p)));
}

// One layer l of a lane's R rows: the theta drift of (c, s) when on,
// s negated for the transpose, then the layer's form by a warp vote.
template <int W, int R, bool kDrift, bool kTranspose>
__device__ __forceinline__ void apply_layer(float (&y)[R][W], const int (&p)[W],
                                            float (&c)[W], float (&s)[W],
                                            int w0, int l, int k,
                                            uint32_t seed, float theta_std) {
  if (kDrift) {
    float g[W];
#pragma unroll
    for (int j = 0; j < W; ++j) g[j] = drift_normal(seed, l, k, w0 + j);
    const float g_up = __shfl_up_sync(kFull, g[W - 1], 1);
    const float g_dn = __shfl_down_sync(kFull, g[0], 1);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = w0 + j;
      const float gl = j > 0 ? g[j - 1] : g_up;
      const float gr = j + 1 < W ? g[j + 1] : g_dn;
      const float gp = p[j] > w ? gr : (p[j] < w ? gl : g[j]);
      const float sgn = w > p[j] ? 1.0f : (w < p[j] ? -1.0f : 0.0f);
      const float delta = __fmul_rn(0.70710678118654752f, __fadd_rn(g[j], gp));
      const float eps = __fmul_rn(__fmul_rn(theta_std, delta), sgn);
      const float ce = cosf(eps), se = sinf(eps);
      const float c2 = __fsub_rn(__fmul_rn(c[j], ce), __fmul_rn(s[j], se));
      s[j] = __fadd_rn(__fmul_rn(s[j], ce), __fmul_rn(c[j], se));
      c[j] = c2;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (kTranspose) s[j] = -s[j];
  if constexpr (W == 1) {
    layer_lanes<R>(y, c[0], s[0], p[0]);
  } else {
    // is the lower wire of any rotation odd?  w0 is even, so wire w0 + j
    // has the parity of j (perm is an involution, so the lower wires name
    // every rotation, and no layer mixes the two alignments)
    bool odd = false;
#pragma unroll
    for (int j = 1; j < W; j += 2) odd |= p[j] > w0 + j;
    if (__any_sync(kFull, odd))
      layer_odd<W, R>(y, c, s);
    else
      layer_even<W, R>(y, c, s);
  }
}

// Blocks of kMaxWarps warps that must fit an SM at once, which caps the
// registers: without the drift four up to W = 2 (64 registers) and two
// at W = 4 (128, 16 warps an SM; left free, the compiler takes 130-141
// there and fits 12 warps); one above, where a lane's rows need more.
template <int W, bool kDrift>
constexpr int min_blocks = kDrift ? 1 : W <= 2 ? 4 : W == 4 ? 2 : 1;

template <int W, bool kDrift, bool kTranspose>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks<W, kDrift>)
    mesh_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ signs,
    const int* __restrict__ perm, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ post_scale,
    const uint32_t* __restrict__ seeds, float* __restrict__ out,
    long long rows, int n_blocks, int n_layers, int m, int x_blocked,
    float theta_std, int tile, int vec_io) {
  constexpr int R = warp_rows(W);
  const int w0 = (threadIdx.x & 31) * W;
  const int b = blockIdx.y;
  const bool vec = vec_io != 0;
  const long long tile0 = (long long)blockIdx.x * tile;
  const long long row0 = tile0 + (long long)(threadIdx.x >> 5) * R;
  const int nr = (int)max(0LL, min((long long)R, min(tile0 + tile, rows) -
                                                     row0));

  float pre[W], post[W];
  load_wires<W>(post, signs + (long long)b * m, w0, m, vec, 1.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    pre[j] = kTranspose ? 1.0f : post[j];
    if (!kTranspose) post[j] = 1.0f;
  }
  if (post_scale != nullptr) {
    float ps[W];
    load_wires<W>(ps, post_scale + (long long)b * m, w0, m, vec, 1.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < W; ++j) post[j] = __fmul_rn(post[j], ps[j]);
  }

  const long long x_stride = x_blocked ? (long long)n_blocks * m : m;
  const float* xb = x + (x_blocked ? (long long)b * m : 0) + row0 * x_stride;
  float y[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      load_wires<W>(y[r], xb + r * x_stride, w0, m, vec, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < W; ++j) y[r][j] = __fmul_rn(y[r][j], pre[j]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) y[r][j] = 0.0f;
    }
  }

  const long long stack = (long long)b * n_layers * m;
  const long long step = kTranspose ? -(long long)m : m;
  int l = kTranspose ? n_layers - 1 : 0;
  const int* pl = perm + stack + (long long)l * m;
  const float* cl = ca + stack + (long long)l * m;
  const float* sl = sa + stack + (long long)l * m;
  uint32_t seed = 0;
  int k = 0;
  if (kDrift) {
    seed = seeds[b];
    k = (m + 127) / 128 * 128;
  }
  // each layer's coefficients go to registers one layer ahead of use
  int p_next[W];
  float c_next[W], s_next[W];
  load_layer<W>(p_next, c_next, s_next, pl, cl, sl, w0, m, vec);
  for (int i = 0; i < n_layers; ++i, l += kTranspose ? -1 : 1) {
    int p[W];
    float c[W], s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      p[j] = p_next[j];
      c[j] = c_next[j];
      s[j] = s_next[j];
    }
    if (i + 1 < n_layers) {
      pl += step;
      cl += step;
      sl += step;
      load_layer<W>(p_next, c_next, s_next, pl, cl, sl, w0, m, vec);
    }
    apply_layer<W, R, kDrift, kTranspose>(y, p, c, s, w0, l, k, seed,
                                          theta_std);
  }

  const long long o_stride = (long long)n_blocks * m;
  float* ob = out + row0 * o_stride + (long long)b * m;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      float o[W];
#pragma unroll
      for (int j = 0; j < W; ++j) o[j] = __fmul_rn(y[r][j], post[j]);
      store_wires<W>(ob + r * o_stride, o, w0, m, vec);
    }
  }
}

struct Args {
  const float *x, *signs;
  const int* perm;
  const float *ca, *sa, *post_scale;
  const uint32_t* seeds;
  float* out;
  long long rows;
  int n_blocks, n_layers, m, x_blocked;
  float theta_std;
  int tile;
};

int lane_wires(int m) {
  int w = 1;
  while (32 * w < m) w *= 2;
  return w;
}

template <int W, bool kDrift, bool kTranspose>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int R = warp_rows(W);
  constexpr uintptr_t kAlign = sizeof(float) * (W < 4 ? W : 4);
  const void* ptrs[] = {a.x, a.signs, a.perm, a.ca, a.sa, a.post_scale,
                        a.out};
  int vec = a.m % W == 0;
  for (const void* q : ptrs) vec &= (uintptr_t)q % kAlign == 0;
  const long long tiles = (a.rows + a.tile - 1) / a.tile;
  const int warps = (a.tile + R - 1) / R;
  mesh_scan_kernel<W, kDrift, kTranspose>
      <<<dim3((unsigned)tiles, (unsigned)a.n_blocks), dim3(32 * warps), 0,
         stream>>>(a.x, a.signs, a.perm, a.ca, a.sa, a.post_scale, a.seeds,
                   a.out, a.rows, a.n_blocks, a.n_layers, a.m, a.x_blocked,
                   a.theta_std, a.tile, vec);
  return (int)cudaGetLastError();
}

template <bool kDrift, bool kTranspose>
int launch_width(const Args& a, cudaStream_t stream) {
  switch (lane_wires(a.m)) {
    case 1: return launch<1, kDrift, kTranspose>(a, stream);
    case 2: return launch<2, kDrift, kTranspose>(a, stream);
    case 4: return launch<4, kDrift, kTranspose>(a, stream);
    case 8: return launch<8, kDrift, kTranspose>(a, stream);
    case 16: return launch<16, kDrift, kTranspose>(a, stream);
    default: return launch<32, kDrift, kTranspose>(a, stream);
  }
}

}  // namespace

// x: contiguous (rows, m) f32, or (rows, B, m) with x_blocked; signs,
// post_scale (nullable): (B, m) f32; perm: (B, L, m) int32, an
// involution with every perm[w] in {w - 1, w, w + 1}, sa = 0 where
// perm[w] = w and no layer with pairs of both alignments
// (check_program); ca, sa: (B, L, m) f32; seeds:
// (B,) uint32, read only when theta_std > 0; out: contiguous (rows, B, m)
// f32.  tile: rows a CUDA block holds (a multiple of 8, at most 8 warps
// of warp_rows(W) rows, W = m / 32 rounded up to a power of two).
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
      (tile + warp_rows(lane_wires(m)) - 1) / warp_rows(lane_wires(m)) >
          kMaxWarps ||
      (rows + tile - 1) / tile > 0x7fffffffLL ||
      (theta_std > 0.0f && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(signs),
               static_cast<const int*>(perm),
               static_cast<const float*>(ca),
               static_cast<const float*>(sa),
               static_cast<const float*>(post_scale),
               static_cast<const uint32_t*>(seeds),
               static_cast<float*>(out),
               rows, n_blocks, n_layers, m, x_blocked,
               theta_std > 0.0f ? theta_std : 0.0f, tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (theta_std > 0.0f)
    return transpose ? launch_width<true, true>(a, s)
                     : launch_width<true, false>(a, s);
  return transpose ? launch_width<false, true>(a, s)
                   : launch_width<false, false>(a, s);
}
