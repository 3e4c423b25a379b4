// Pieces of the input layer's GEMM kernel (gemm_maxout.cu): cp.async copies
// and the epilogue that turns a block's fp32 accumulator tile into the bf16
// maxout output and its masked InstanceNorm partial sums. (The block conv,
// conv5x5_maxout.cu, has its own epilogue from wgmma's registers.)
//
// A block's tile is kTileM = 128 output pixels by 32 whole maxout groups
// (32 * pool accumulator columns, torch channel order c = g * pool + p), so
// bias, maxout and statistics finish inside the block and only the
// pool-times-narrower bf16 result reaches device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maxout_tile {

constexpr int kTileM = 128;    // output pixels per block
constexpr int kGroups = 32;    // maxout groups per block: one per lane
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

// 16-byte global -> shared copy; src_bytes 0 writes zeros (no read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bias + maxout + bf16 store + masked statistics of one tile.
//
// acc:     [kTileM][ld] fp32 accumulators in shared memory, column
//          g * kPool + p of this block's kGroups * kPool columns
// bias:    this block's kGroups * kPool biases (global)
// pixel:   pixel(r, i, j) sets the map position of tile row r; i >= L marks
//          a row past the image
// out:     this target's (L, L, c_groups) bf16 output; the block writes
//          channels [g0, g0 + kGroups)
// partial: this (target, pixel tile)'s [2][c_groups] fp32 partial sums of
//          the pre-rounding maxout over rows and columns < nres: sums, then
//          sums of squares
// red:     2 * kThreads floats of shared scratch (not overlapping acc)
//
// Sums are taken in a fixed order (per thread over its rows, then over the
// 8 warps in order), with no atomics: the same inputs give the same bits.
template <int kPool, typename PixelFn>
__device__ __forceinline__ void epilogue(const float* acc, int ld, const float* __restrict__ bias,
                                         PixelFn pixel, int L, int nres,
                                         __nv_bfloat16* __restrict__ out, int c_groups, int g0,
                                         float* __restrict__ partial, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float b[kPool];
#pragma unroll
  for (int p = 0; p < kPool; ++p) b[p] = bias[lane * kPool + p];
  float s = 0.0f, ss = 0.0f;
  for (int r = warp; r < kTileM; r += kWarps) {
    int i, j;
    pixel(r, i, j);
    if (i >= L) continue;
    const float* a = acc + r * ld + lane * kPool;
    float v = a[0] + b[0];
#pragma unroll
    for (int p = 1; p < kPool; ++p) v = fmaxf(v, a[p] + b[p]);
    out[((size_t)i * L + j) * c_groups + g0 + lane] = __float2bfloat16(v);
    if (i < nres && j < nres) {
      s += v;
      ss += v * v;
    }
  }
  red[warp * 32 + lane] = s;
  red[kThreads + warp * 32 + lane] = ss;
  __syncthreads();
  if (warp == 0) {
    float ts = 0.0f, tss = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ts += red[w * 32 + lane];
      tss += red[kThreads + w * 32 + lane];
    }
    partial[g0 + lane] = ts;
    partial[c_groups + g0 + lane] = tss;
  }
}

}  // namespace maxout_tile
