// Trunk input layer: 1x1 conv as a GEMM + bias + maxout, with the masked
// InstanceNorm partial sums of the result (stats mode).
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/conv_block.py:gemm_maxout
// (its _gemm_kernel, with_stats=True, as gemm_maxout_norm calls it). Per
// target: out[q, g] = max_p (b[c] + sum_k x[q, k] * w[k, c]) with c = g * 3 + p
// over the L^2 pixels q; bf16 operands, fp32 accumulation, bf16 output; and
// the fp32 sum and sum of squares of the pre-rounding maxout over
// [0, nres)^2, per target and channel.
//
// What bounds it on an H100: both about equally. At PF10963's 88 x 88 with
// K = 955 (padded once, upstream, to 960) and N = 384 it does 5.7 GFLOP
// (5.7 us at the 989 TFLOP/s bf16 tensor-core peak) and must read 14.8 MB of
// bf16 input (4.4 us at 3.35 TB/s). So x is read as bf16, once from device
// memory, and the 384-channel intermediate (3x the output) stays on chip.
//
// Design: a block owns 128 consecutive pixels of one target (never crossing
// targets; the last tile of a target is partial) and 32 whole maxout groups
// (N tile 96 columns in torch order, all 3 pool slices of each group). A and
// B tiles of 64 K columns stream through a two-stage cp.async ring (rows
// past the target are zero-filled, not read). Eight warps run wmma 16x16x16
// bf16 products (mma.sync on the tensor cores) into fp32 accumulators: 4
// warps along M (32 pixels) by 2 along N (48 columns). The epilogue
// (maxout_tile.cuh) adds the bias, takes the max over the pool slices,
// writes bf16 and per-block partial sums; the wrapper reduces the partials
// per target.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "maxout_tile.cuh"

namespace {

using namespace nvcuda;
using maxout_tile::kThreads;
using maxout_tile::kTileM;

constexpr int kPool = 3;
constexpr int kN = maxout_tile::kGroups * kPool;  // 96 accumulator columns
constexpr int kKChunk = 64;                       // K columns per pipeline stage
constexpr int kAS = kKChunk + 16;                 // A-tile row stride (elements)
constexpr int kBS = kN + 16;                      // B-tile row stride (elements)
constexpr int kAStage = kTileM * kAS * 2;
constexpr int kStage = kAStage + kKChunk * kBS * 2;
constexpr int kAccLd = kN + 4;
constexpr int kAccBytes = kTileM * kAccLd * 4;
constexpr int kRedBytes = 2 * kThreads * 4;
constexpr int kSmem =
    (2 * kStage > kAccBytes + kRedBytes) ? 2 * kStage : kAccBytes + kRedBytes;

__global__ void __launch_bounds__(kThreads, 2) gemm_maxout_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ nres,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int L, int k_pad, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.z, mt = blockIdx.x;
  const int npix = L * L, q0 = mt * kTileM, n0 = blockIdx.y * kN;
  const int c_groups = c_out / kPool;
  const __nv_bfloat16* xb = x + (size_t)b * npix * k_pad;

  auto a_tile = [&](int buf) { return reinterpret_cast<__nv_bfloat16*>(smem + buf * kStage); };
  auto b_tile = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf * kStage + kAStage);
  };
  // K columns [s * kKChunk, (s + 1) * kKChunk): A rows of this tile's pixels,
  // B rows of this block's kN columns
  auto load = [&](int s, int buf) {
    __nv_bfloat16* da = a_tile(buf);
    for (int v = tid; v < kTileM * (kKChunk / 8); v += kThreads) {
      const int row = v / (kKChunk / 8), col = (v % (kKChunk / 8)) * 8;
      const bool inside = q0 + row < npix;
      const __nv_bfloat16* src =
          inside ? xb + (size_t)(q0 + row) * k_pad + s * kKChunk + col : xb;
      maxout_tile::cp_async16(da + row * kAS + col, src, inside ? 16 : 0);
    }
    __nv_bfloat16* db = b_tile(buf);
    for (int v = tid; v < kKChunk * (kN / 8); v += kThreads) {
      const int row = v / (kN / 8), col = (v % (kN / 8)) * 8;
      maxout_tile::cp_async16(db + row * kBS + col,
                              w + (size_t)(s * kKChunk + row) * c_out + n0 + col, 16);
    }
  };

  const int wm = warp % 4, wn = warp / 4;  // pixels 32wm.., columns 48wn..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = k_pad / kKChunk;
  load(0, 0);
  maxout_tile::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      maxout_tile::cp_async_commit();
      maxout_tile::cp_async_wait<1>();
    } else {
      maxout_tile::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* at = a_tile(s & 1);
    const __nv_bfloat16* bt = b_tile(s & 1);
#pragma unroll
    for (int kk = 0; kk < kKChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[3];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], at + (wm * 32 + i * 16) * kAS + kk, kAS);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wmma::load_matrix_sync(bf[j], bt + kk * kBS + wn * 48 + j * 16, kBS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the stage is read before it is refilled
  }

  float* accs = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + kAccBytes);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wmma::store_matrix_sync(accs + (wm * 32 + i * 16) * kAccLd + wn * 48 + j * 16, acc[i][j],
                              kAccLd, wmma::mem_row_major);
  __syncthreads();

  const int tiles = gridDim.x;
  auto pixel = [&](int r, int& i, int& j) {
    const int q = q0 + r;
    i = q < npix ? q / L : L;
    j = q % L;
  };
  maxout_tile::epilogue<kPool>(accs, kAccLd, bias + n0, pixel, L, nres[b],
                               out + (size_t)b * npix * c_groups, c_groups, n0 / kPool,
                               partial + ((size_t)b * tiles + mt) * 2 * c_groups, red);
}

}  // namespace

// x: (batch, L, L, k_pad) bf16, channels past the layer's inputs zero; w:
// (k_pad, c_out) bf16, column c in torch order g * 3 + p; bias: (c_out,)
// fp32; nres: (batch,) int32; out: (batch, L, L, c_out / 3) bf16; partial:
// (batch, tiles, 2, c_out / 3) fp32 with tiles = ceil(L^2 / 128). k_pad must
// be a multiple of 64 and c_out of 96. All pointers 16-byte aligned.
extern "C" int gemm_maxout_stats(const void* x, const void* w, const float* bias,
                                 const int* nres, void* out, float* partial, int batch, int L,
                                 int k_pad, int c_out, void* stream) {
  if (batch <= 0 || L <= 0 || k_pad <= 0 || k_pad % kKChunk != 0 || c_out <= 0 ||
      c_out % kN != 0 || batch > 65535 || c_out / kN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_maxout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L * L + kTileM - 1) / kTileM, c_out / kN, batch);
  gemm_maxout_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias, nres,
      static_cast<__nv_bfloat16*>(out), partial, L, k_pad, c_out);
  return (int)cudaGetLastError();
}
