// Trunk block conv: same-padded 5x5 conv + bias + maxout, with the masked
// InstanceNorm partial sums of the result (stats mode) or the index of the
// winning pool slice (argmax mode).
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/conv_block.py:conv5x5_maxout
// in its two modes: with_stats=True, as conv5x5_maxout_stats calls it (the
// bf16 engine), and with_argmax=True, as the forward of conv5x5_maxout_diff
// calls it (bf16 training). Per target: out[i, j, g] = max_p (b[c] +
// sum_{dy,dx,ci} x[i+dy-2, j+dx-2, ci] * w[dy, dx, ci, c]) with c = g * 4 + p,
// x zero outside [0, L)^2; bf16 operands, fp32 accumulation, bf16 output.
// Stats mode adds the fp32 sum and sum of squares of the pre-rounding maxout
// over [0, nres)^2, per target and channel; argmax mode adds, per output, the
// int8 slice p that won (the first on a tie), which the backward routes the
// cotangent by. The two modes share everything up to the epilogue, so their
// outputs are the same bits.
//
// What bounds it on an H100: operations. An implicit GEMM with M = L^2
// pixels, K = 25 * 128 = 3200 and N = 512: at PF10963's 88 x 88 that is
// 25.4 GFLOP against about 7.3 MB moved, 26 us at the 989 TFLOP/s bf16
// tensor-core peak. So it must run on the tensor cores, and the 512-channel
// intermediate (4x the output) must not reach device memory.
//
// Design: a block owns an 8 x 16 patch of one target's pixels (M tile 128,
// never crossing targets) and 32 whole maxout groups (N tile 128 columns in
// torch order, all 4 pool slices of each group). It loads the patch with its
// 2-pixel halo once into shared memory (12 x 20 pixels x 128 channels; the
// halo rows are shared by the 25 taps, and the conv's zero padding is a
// zero-filled copy of what lies outside the image) and streams the packed
// weights (K-major, [3200][512]) through a two-stage cp.async ring, 64 K rows
// at a time. Eight warps run wmma 16x16x16 bf16 products (mma.sync on the
// tensor cores) into fp32 accumulators: 4 warps along M (two patch rows of 16
// pixels each) by 2 along N (64 columns). An A fragment is 16 consecutive
// pixels of one patch row shifted by (dy, dx), read straight from the patch.
// The epilogue (maxout_tile.cuh) adds the bias, takes the max over the pool
// slices, writes bf16 and per-block partial sums (the wrapper reduces them
// per target) or the int8 index. wgmma, TMA and a persistent schedule are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "maxout_tile.cuh"

namespace {

using namespace nvcuda;
using maxout_tile::kThreads;
using maxout_tile::kTileM;

constexpr int kCin = 128;
constexpr int kPool = 4;
constexpr int kN = maxout_tile::kGroups * kPool;  // 128 accumulator columns
constexpr int kTileRows = 8, kTileCols = 16;      // kTileRows * kTileCols == kTileM
constexpr int kPatchRows = kTileRows + 4, kPatchCols = kTileCols + 4;
constexpr int kCS = kCin + 16;  // patch pixel stride (elements): rows stay 32-byte aligned
constexpr int kKChunk = 64;     // K rows per pipeline stage
constexpr int kBS = kN + 16;    // weight-tile row stride (elements)
constexpr int kSteps = 25 * kCin / kKChunk;
constexpr int kAccLd = kN + 4;
constexpr int kPatchBytes = kPatchRows * kPatchCols * kCS * 2;
constexpr int kStageBytes = kKChunk * kBS * 2;
constexpr int kAccBytes = kTileM * kAccLd * 4;
constexpr int kRedBytes = 2 * kThreads * 4;
constexpr int kMainBytes = kPatchBytes + 2 * kStageBytes;
constexpr int kSmem =
    (kMainBytes > kAccBytes + kRedBytes) ? kMainBytes : kAccBytes + kRedBytes;
static_assert(kTileRows * kTileCols == kTileM, "tile");
static_assert(kCin % kKChunk == 0, "K chunks must not cross taps");

// One block's tile; kArgmax selects the epilogue (index, or partial sums).
template <bool kArgmax>
__device__ __forceinline__ void conv5x5_maxout_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ nres,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
    signed char* __restrict__ index, int L, int c_out, int tiles_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + kPatchBytes);

  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.z, mt = blockIdx.x;
  const int r0 = (mt / tiles_c) * kTileRows, c0 = (mt % tiles_c) * kTileCols;
  const int n0 = blockIdx.y * kN;
  const int c_groups = c_out / kPool;
  const __nv_bfloat16* xb = x + (size_t)b * L * L * kCin;

  // K rows [s * kKChunk, (s + 1) * kKChunk) of this block's kN columns
  auto load_w = [&](int s, int buf) {
    const __nv_bfloat16* src = w + (size_t)s * kKChunk * c_out + n0;
    __nv_bfloat16* dst = wbuf + buf * (kKChunk * kBS);
    for (int v = tid; v < kKChunk * (kN / 8); v += kThreads) {
      const int row = v / (kN / 8), col = (v % (kN / 8)) * 8;
      maxout_tile::cp_async16(dst + row * kBS + col, src + (size_t)row * c_out + col, 16);
    }
  };

  load_w(0, 0);
  maxout_tile::cp_async_commit();
  // the patch and its halo; zeros outside the image (the conv's padding)
  for (int v = tid; v < kPatchRows * kPatchCols * (kCin / 8); v += kThreads) {
    const int pix = v / (kCin / 8), ch = (v % (kCin / 8)) * 8;
    const int gr = r0 + pix / kPatchCols - 2, gc = c0 + pix % kPatchCols - 2;
    const bool inside = gr >= 0 && gr < L && gc >= 0 && gc < L;
    const __nv_bfloat16* src = inside ? xb + ((size_t)gr * L + gc) * kCin + ch : xb;
    maxout_tile::cp_async16(patch + pix * kCS + ch, src, inside ? 16 : 0);
  }
  maxout_tile::cp_async_commit();

  const int wm = warp % 4, wn = warp / 4;  // patch rows 2wm, 2wm+1; columns 64wn..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < kSteps; ++s) {
    if (s + 1 < kSteps) {
      load_w(s + 1, (s + 1) & 1);
      maxout_tile::cp_async_commit();
      maxout_tile::cp_async_wait<1>();
    } else {
      maxout_tile::cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = s / (kCin / kKChunk), ci0 = (s % (kCin / kKChunk)) * kKChunk;
    const int dy = tap / 5, dx = tap % 5;
    const __nv_bfloat16* wt = wbuf + (s & 1) * (kKChunk * kBS);
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], patch + ((2 * wm + i + dy) * kPatchCols + dx) * kCS + ci0 + kk, kCS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], wt + kk * kBS + wn * 64 + j * 16, kBS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the stage is read before it is refilled
  }

  // accumulators to shared memory, over the patch and the weight ring
  float* accs = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + kAccBytes);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(accs + (wm * 32 + i * 16) * kAccLd + wn * 64 + j * 16, acc[i][j],
                              kAccLd, wmma::mem_row_major);
  __syncthreads();

  const int tiles = gridDim.x;
  auto pixel = [&](int r, int& i, int& j) {
    i = r0 + r / kTileCols;
    j = c0 + r % kTileCols;
    if (j >= L) i = L;
  };
  if constexpr (kArgmax) {
    const size_t o = (size_t)b * L * L * c_groups;
    maxout_tile::epilogue<kPool, true>(accs, kAccLd, bias + n0, pixel, L, L, out + o, c_groups,
                                       n0 / kPool, nullptr, nullptr, index + o);
  } else {
    maxout_tile::epilogue<kPool>(accs, kAccLd, bias + n0, pixel, L, nres[b],
                                 out + (size_t)b * L * L * c_groups, c_groups, n0 / kPool,
                                 partial + ((size_t)b * tiles + mt) * 2 * c_groups, red);
  }
}

// The two modes as two kernels, so that a profile tells them apart by name.
__global__ void __launch_bounds__(kThreads, 2) conv5x5_maxout_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ nres,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int L, int c_out,
    int tiles_c) {
  conv5x5_maxout_tile<false>(x, w, bias, nres, out, partial, nullptr, L, c_out, tiles_c);
}

__global__ void __launch_bounds__(kThreads, 2) conv5x5_maxout_argmax_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    signed char* __restrict__ index, int L, int c_out, int tiles_c) {
  conv5x5_maxout_tile<true>(x, w, bias, nullptr, out, nullptr, index, L, c_out, tiles_c);
}

// The launch shared by both entry points: grid, shared memory, error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, int L, int c_in, int c_out, void* stream, Args... args) {
  if (batch <= 0 || L <= 0 || c_in != kCin || c_out <= 0 || c_out % kN != 0 ||
      batch > 65535 || c_out / kN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_r = (L + kTileRows - 1) / kTileRows, tiles_c = (L + kTileCols - 1) / kTileCols;
  const dim3 grid(tiles_r * tiles_c, c_out / kN, batch);
  kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(args..., L, c_out, tiles_c);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, L, L, 128) bf16; w: (3200, c_out) bf16 with row (dy * 5 + dx) *
// 128 + ci and column c (torch order g * 4 + p); bias: (c_out,) fp32; nres:
// (batch,) int32; out: (batch, L, L, c_out / 4) bf16; partial: (batch,
// tiles, 2, c_out / 4) fp32 with tiles = ceil(L / 8) * ceil(L / 16). c_in must
// be 128 and c_out a multiple of 128. All pointers 16-byte aligned.
extern "C" int conv5x5_maxout_stats(const void* x, const void* w, const float* bias,
                                    const int* nres, void* out, float* partial, int batch, int L,
                                    int c_in, int c_out, void* stream) {
  return launch(conv5x5_maxout_kernel, batch, L, c_in, c_out, stream,
                static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                bias, nres, static_cast<__nv_bfloat16*>(out), partial);
}

// Argmax mode: x, w, bias, out as above; index: (batch, L, L, c_out / 4) int8,
// the slice p in 0..3 whose value out holds (the first on a tie).
extern "C" int conv5x5_maxout_argmax(const void* x, const void* w, const float* bias, void* out,
                                     void* index, int batch, int L, int c_in, int c_out,
                                     void* stream) {
  return launch(conv5x5_maxout_argmax_kernel, batch, L, c_in, c_out, stream,
                static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                bias, static_cast<__nv_bfloat16*>(out), static_cast<signed char*>(index));
}
