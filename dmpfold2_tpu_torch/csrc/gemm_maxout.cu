// Trunk input layer: 1x1 conv as a GEMM + bias + maxout, with the masked
// InstanceNorm partial sums of the result (stats mode).
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/conv_block.py:gemm_maxout
// (its _gemm_kernel, with_stats=True, as gemm_maxout_norm calls it). Per
// target: out[q, g] = max_p (b[c] + sum_k x[q, k] * w[c, k]) with c = g * 3 + p
// over the L^2 pixels q; bf16 operands, fp32 accumulation, bf16 output; and
// the fp32 sum and sum of squares of the pre-rounding maxout over
// [0, nres)^2, per target and channel.
//
// Row slabs (residue-axis sharding): x may hold rows r0 .. r0 + H - 1 of a
// larger map of width W, the H x W pixels walked as above, and r0 places
// the stats mask. A square map is H = W, r0 = 0. A slab whose first pixel
// r0 * W is a multiple of 128 has its tiles and partials where the square
// launch has them.
//
// What bounds it on an H100: both about equally. At PF10963's 88 x 88 with
// K = 955 (padded once, upstream, to 960) and N = 384 it does 5.7 GFLOP
// (5.7 us at the 989 TFLOP/s bf16 tensor-core peak) and must read 14.8 MB of
// bf16 input (4.4 us at 3.35 TB/s). So x is read as bf16, once from device
// memory, and the 384-channel intermediate (3x the output) stays on chip.
// Per block, the A and B tiles it streams from L2 (613 KB at K 960) take
// about as long at one SM's L2 rate as its products at one SM's share of the
// tensor-core peak, so the loads must overlap the products.
//
// Design (Hopper): one block per (target, 128-pixel tile, 64 maxout groups).
//   * The weights are packed K-major, (c_out, k_pad), and slice-major within
//     each 192-row N tile: row p * 64 + g holds channel (tile * 64 + g) * 3 +
//     p (conv_block.py:pack_gemm_weights; the bias likewise). A group's three
//     pool slices then land in the same thread's accumulator registers, 64
//     columns apart, so the maxout is two fmaxf with no shuffle.
//   * A producer warp issues TMA loads of the A tile (128 pixels x 64 K, a 3D
//     tensor map over (k_pad, L^2, B), so rows past a target's L^2 are TMA's
//     zero fill and a tile never mixes targets) and the B tile (192 x 64 K)
//     into a 4-stage ring, 128-byte swizzled, with full and empty mbarriers.
//   * Two consumer warpgroups, 64 pixels each, run wgmma.mma_async
//     m64n192k16 with A and B read from shared memory by descriptor into 96
//     fp32 registers per thread; a stage is released once its products are
//     done (wait_group 1), so the next loads run under them.
//   * Epilogue from registers: bias and maxout; the bf16 tile staged in
//     shared memory and written as 16-byte stores, one 128-byte row per
//     pixel; per-group masked sums reduced over a warp's rows by shuffles,
//     then over the 8 warps in order through shared memory: one partial
//     entry per (target, pixel tile), no atomics, the same bits every run.
// At L 88 the grid is 61 x 2 = 122 blocks, one wave on 132 SMs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPool = 3;
constexpr int kGroups = 64;                 // maxout groups per block
constexpr int kN = kGroups * kPool;         // 192 accumulator columns
constexpr int kTileM = 128;                 // pixels per block
constexpr int kKChunk = 64;                 // K per ring stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kABytes = kTileM * kKChunk * 2;  // 16 KB
constexpr int kBBytes = kN * kKChunk * 2;      // 24 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // two consumer warpgroups + a producer warp
constexpr int kAcc = kN / 2;                // fp32 accumulators per consumer thread
constexpr int kOutLd = kGroups + 8;         // bf16 per staged pixel (16-byte aligned rows)
constexpr int kOutBytes = kTileM * kOutLd * 2;
constexpr int kRedBytes = kConsumerWarps * 2 * kGroups * 4;
constexpr int kBarBytes = 2 * kStages * 8;
constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes + kRedBytes + kBarBytes;
static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzled tiles on 1024 B");
static_assert(kSmem <= 232448, "227 KB of shared memory per block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A K-major operand tile with 128-byte swizzle: rows of 128 bytes (64 K
// values), 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 192, fp32, registers) += A (64 x 16, bf16) x B (16 x 192, bf16),
// both K-major in shared memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[kAcc], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1) gemm_maxout_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ bias, const int* __restrict__ nres,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int h, int width, int row0,
    int k_steps, int c_groups) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base;
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(gbase + kStages * kStageBytes);
  float* red = reinterpret_cast<float*>(gbase + kStages * kStageBytes + kOutBytes);
  const uint32_t full = ring + kStages * kStageBytes + kOutBytes + kRedBytes;
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = blockIdx.x, nt = blockIdx.y, b = blockIdx.z;
  const int npix = h * width, q0 = mt * kTileM;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp: one thread issues every TMA load
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(full + 8 * stage, kStageBytes);
      const uint32_t dst = ring + stage * kStageBytes;
      tma_load_3d(dst, &tmap_x, ks * kKChunk, q0, b, full + 8 * stage);
      tma_load_2d(dst + kABytes, &tmap_w, ks * kKChunk, nt * kN, full + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 pixels each
  const int wg = warp / 4;
  float acc[kAcc];
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int ks = 0; ks < k_steps; ++ks) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t a = ring + stage * kStageBytes + wg * (kABytes / 2);
    const uint32_t bt = ring + stage * kStageBytes + kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKChunk / 16; ++kk)
      wgmma_ss(acc, desc_sw128(a + 32 * kk), desc_sw128(bt + 32 * kk), (ks | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // ---- epilogue from registers. Thread (warp, lane) holds rows r0 and
  // r0 + 8 of the tile and, for n8 in 0..7 and e in 0..1, group 8 n8 + 2 q
  // + e in slices 0, 1, 2 at accumulators 4 (n8 + 8 p) + 2 row + e.
  const int g = lane / 4, q = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;
  const int n_lim = nres[b];
  bool counted[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int px = q0 + r0 + 8 * rh;
    counted[rh] = px < npix && row0 + px / width < n_lim && px % width < n_lim;
  }
  const float* bias_t = bias + nt * kN;
#pragma unroll
  for (int n8 = 0; n8 < kGroups / 8; ++n8) {
    float t[2], tt[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gl = 8 * n8 + 2 * q + e;
      const float b0 = __ldg(bias_t + gl), b1 = __ldg(bias_t + kGroups + gl),
                  b2 = __ldg(bias_t + 2 * kGroups + gl);
      t[e] = tt[e] = 0.0f;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int i = 2 * rh + e;
        const float v = fmaxf(fmaxf(acc[4 * n8 + i] + b0, acc[4 * (n8 + 8) + i] + b1),
                              acc[4 * (n8 + 16) + i] + b2);
        acc[4 * n8 + i] = v;  // the maxout, kept for the bf16 store
        if (counted[rh]) {
          t[e] += v;
          tt[e] += v * v;
        }
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      *reinterpret_cast<__nv_bfloat162*>(out_s + (r0 + 8 * rh) * kOutLd + 8 * n8 + 2 * q) =
          __floats2bfloat162_rn(acc[4 * n8 + 2 * rh], acc[4 * n8 + 2 * rh + 1]);
    // sums over the warp's 16 rows: lanes of one q
#pragma unroll
    for (int sh = 4; sh < 32; sh *= 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        t[e] += __shfl_xor_sync(0xffffffffu, t[e], sh);
        tt[e] += __shfl_xor_sync(0xffffffffu, tt[e], sh);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2 + 0) * kGroups + 8 * n8 + 2 * q + e] = t[e];
        red[(warp * 2 + 1) * kGroups + 8 * n8 + 2 * q + e] = tt[e];
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");

  // copy-out: each pixel's 64 groups are one 128-byte row of the output
  constexpr int kChunks = kGroups * 2 / 16;
  const size_t img = (size_t)b * npix;
  for (int v = tid; v < kTileM * kChunks; v += 32 * kConsumerWarps) {
    const int r = v / kChunks, part = v % kChunks;
    if (q0 + r < npix)
      *reinterpret_cast<uint4*>(out + (img + q0 + r) * c_groups + nt * kGroups + part * 8) =
          *reinterpret_cast<const uint4*>(out_s + r * kOutLd + part * 8);
  }
  if (tid < 2 * kGroups) {
    const int stat = tid / kGroups, gi = tid % kGroups;
    float tot = 0.0f;
    for (int w = 0; w < kConsumerWarps; ++w) tot += red[(w * 2 + stat) * kGroups + gi];
    partial[(((size_t)b * gridDim.x + mt) * 2 + stat) * c_groups + nt * kGroups + gi] = tot;
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The two tensor maps: x as (k_pad, H W, B) in 64 x 128 x 1 boxes (zeros
// past H W); w as (k_pad, c_out) in 64 x 192 boxes; both 128-byte swizzled.
int make_maps(const void* x, const void* w, int batch, long long npix, int k_pad, int c_out,
              CUtensorMap* mx, CUtensorMap* mw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t xdim[3] = {(cuuint64_t)k_pad, (cuuint64_t)npix, (cuuint64_t)batch};
  const cuuint64_t xstride[2] = {(cuuint64_t)k_pad * 2, (cuuint64_t)npix * k_pad * 2};
  const cuuint32_t xbox[3] = {kKChunk, kTileM, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = encode(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)k_pad, (cuuint64_t)c_out};
  const cuuint64_t wstride[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t wbox[2] = {kKChunk, kN};
  r = encode(mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Per device, once: the shared-memory opt-in.
constexpr int kMaxDevices = 64;

int set_up_device() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(gemm_maxout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

}  // namespace

// x: (batch, H, W, k_pad) bf16, channels past the layer's inputs zero, rows
// r0 .. r0 + H - 1 of the map (H = W and r0 = 0 for a square map); w:
// (c_out, k_pad) bf16 packed by conv_block.py:pack_gemm_weights (row p * 64 +
// g of N tile t is channel (t * 64 + g) * 3 + p); bias: (c_out,) fp32 in the
// same order; nres: (batch,) int32; out: (batch, H, W, c_out / 3) bf16 in
// group order; partial: (batch, tiles, 2, c_out / 3) fp32 with tiles =
// ceil(H W / 128), over the pixels with global row and column in [0, nres).
// k_pad must be a multiple of 64 and c_out of 192. All pointers 16-byte
// aligned.
extern "C" int gemm_maxout_stats(const void* x, const void* w, const float* bias,
                                 const int* nres, void* out, float* partial, int batch, int h,
                                 int width, int r0, int k_pad, int c_out, void* stream) {
  const long long npix = (long long)h * width;
  if (batch <= 0 || h <= 0 || width <= 0 || r0 < 0 || npix > 0x7fffffff - kTileM ||
      k_pad <= 0 || k_pad % kKChunk != 0 || c_out <= 0 || c_out % kN != 0 || batch > 65535 ||
      c_out / kN > 65535)
    return (int)cudaErrorInvalidValue;
  int err = set_up_device();
  if (err != 0) return err;
  CUtensorMap mx, mw;
  err = make_maps(x, w, batch, npix, k_pad, c_out, &mx, &mw);
  if (err != 0) return err;
  const dim3 grid((unsigned)((npix + kTileM - 1) / kTileM), c_out / kN, batch);
  gemm_maxout_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      mx, mw, bias, nres, static_cast<__nv_bfloat16*>(out), partial, h, width, r0,
      k_pad / kKChunk, c_out / kPool);
  return (int)cudaGetLastError();
}
