// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) for Hopper (sm_90a):
// 16-byte cp.async tile copies into padded bf16 shared tiles, ldmatrix
// fragment loads, and mma.sync m16n8k16 with bf16 operands and f32 sums.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of bf16 pairs:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, cols 2t, 2t+1),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, column major), 2 registers: b0 (rows 2t, 2t+1, col g),
//     b1 (rows 2t+8, 2t+9, col g);
//   C (16 x 8 f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C tiles of two neighbouring 8-column blocks, packed to bf16, are
// the A fragment of one 16-deep k-step: a product's result feeds the next
// product from registers, with no trip through shared memory.
//
// A tile is 64 rows of HD bf16 (HD a multiple of 8), stored KPAD wide,
// HD rounded up to a multiple of 16 (the mma k-step), the columns past
// HD zero-filled by the copy (so they add nothing to a product over
// them), and each row padded by 16 bytes more (KPAD + 8 elements).  With
// the row pitch 2 KPAD + 16 bytes an odd multiple of 16 bytes modulo 128
// (HD 16, 24, 32, 48, 64, 128, 192 give 48, 80, 80, 112, 144, 272, 400),
// the 8 row addresses of one 8 x 8 ldmatrix matrix land on 8 distinct
// 16-byte bank groups: no bank conflict.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr int kRows = 64;        // rows of a tile
constexpr int kThreads = 128;    // four warps of 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int kPad = (HD + 15) / 16 * 16;    // stored columns
  static constexpr int kPitch = kPad + 8;             // elements a row
  static constexpr int kElems = kRows * kPitch;
  static constexpr int kBytes = kElems * 2;
  static constexpr int kChunks = kPad / 8;            // 16-byte chunks a row
  static constexpr int kReal = HD / 8;                // of them read
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; n_src 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n_src)
               : "memory");
}

// 4 bytes from global to shared, asynchronously; n_src 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int n_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
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

// The largest row pitch (elements) the tile copies take: offsets inside
// a 64-row tile stay 32-bit.
constexpr long long kMaxRowStride = 1LL << 24;

// Rows [r0, r0 + 64) of a (., s, HD) bf16 view with row pitch `stride`
// elements (16-byte aligned, below kMaxRowStride) into a padded shared
// tile; rows past s and columns past HD are zero.  Every thread of the
// block takes part.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int s) {
  using T = Tile<HD>;
  static_assert(kRows * T::kChunks % kThreads == 0, "whole passes");
  const __nv_bfloat16* base = src + r0 * stride;
  const int left = s - r0;
#pragma unroll
  for (int it = 0; it < kRows * T::kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int rr = c / T::kChunks, ch = c - rr * T::kChunks;
    const bool in = rr < left && ch < T::kReal;
    cp_async16(dst + rr * T::kPitch + ch * 8,
               base + (in ? rr * (int)stride + ch * 8 : 0), in ? 16 : 0);
  }
}

// Whether the tile copies can read these views in place: every data
// pointer and every (batch, head, row) stride triple keeps rows 16-byte
// aligned, and each row stride (every third entry) stays below
// kMaxRowStride.  Host side, before a launch.
inline bool rows_aligned(const void* const* ptrs, int n_ptrs,
                         const long long* strides, int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 || (i % 3 == 2 && strides[i] >= kMaxRowStride))
      return false;
  return true;
}

// 2^x, flushing results below the normal range to zero (P and the
// online-softmax factors; a subnormal probability adds nothing in f32).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The shared address this lane gives ldmatrix for the 16 x 16 block at
// (row, col) of a tile.  frag_a: the block read as an A fragment (rows m,
// cols k), or with .trans as the B fragments of the two n blocks col and
// col + 8 of a tile stored (k rows, n cols): lane i reads row + i % 16,
// col + 8 (i / 16).
template <int HD>
__device__ __forceinline__ uint32_t frag_a(const __nv_bfloat16* tile,
                                           int row, int col) {
  const int i = threadIdx.x & 31;
  return smem_addr(tile + (row + (i & 15)) * Tile<HD>::kPitch + col +
                   ((i >> 4) << 3));
}
// frag_b: the B fragments of the two n blocks row and row + 8 of a tile
// stored (n rows, k cols), k = col .. col + 15: lane i reads row + i % 8 +
// 8 (i / 16), col + 8 (i / 8 % 2).  Registers: b0, b1 of the first n
// block, b0, b1 of the second.
template <int HD>
__device__ __forceinline__ uint32_t frag_b(const __nv_bfloat16* tile,
                                           int row, int col) {
  const int i = threadIdx.x & 31;
  return smem_addr(tile + (row + (i & 7) + ((i >> 4) << 3)) *
                              Tile<HD>::kPitch +
                   col + (((i >> 3) & 1) << 3));
}

// d += a b, m16n8k16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from the f32 C tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// acc (16 x 8 n blocks) += A (16 x 16 k) B, B the 16 x (8 NB) block at
// rows k0 of a tile stored (k rows, n cols), read by ldmatrix.trans.
template <int HD, int NB>
__device__ __forceinline__ void mma_a_bt(float (&acc)[NB][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int k0) {
#pragma unroll
  for (int p = 0; p < NB / 2; ++p) {
    uint32_t b[4];
    ldsm_x4_t(b, frag_a<HD>(tile, k0, 16 * p));
    mma(acc[2 * p], a, b[0], b[1]);
    mma(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// s (16 x 64) = A rows [row, row + 16) of tile a_tile (16 x HD) times the
// transpose of the 64 x HD tile b_tile: both read by ldmatrix (k over the
// stored width, whose zero columns past HD add nothing).
template <int HD>
__device__ __forceinline__ void mma_abt_64(float (&s)[8][4],
                                           const __nv_bfloat16* a_tile,
                                           int row,
                                           const __nv_bfloat16* b_tile) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Tile<HD>::kPad / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, frag_a<HD>(a_tile, row, 16 * kk));
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, frag_b<HD>(b_tile, 16 * p, 16 * kk));
      mma(s[2 * p], a, b[0], b[1]);
      mma(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace flash_mma
