// Trunk block conv: same-padded 5x5 conv + bias + maxout, with the masked
// InstanceNorm partial sums of the result (stats mode) or the index of the
// winning pool slice (argmax mode).
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/conv_block.py:conv5x5_maxout
// in its two modes: with_stats=True, as conv5x5_maxout_stats calls it (the
// bf16 engine), and with_argmax=True, as the forward of conv5x5_maxout_diff
// calls it (bf16 training). Per target: out[i, j, g] = max_p (b[c] +
// sum_{dy,dx,ci} x[i+dy-2, j+dx-2, ci] * w[c, dy, dx, ci]) with c = g * 4 + p,
// x zero outside [0, L)^2; bf16 operands, fp32 accumulation, bf16 output.
// Stats mode adds the fp32 sum and sum of squares of the pre-rounding maxout
// over [0, nres)^2, per target and channel, one partial per work item;
// argmax mode adds, per output, the
// int8 slice p that won (the first on a tie), which the backward routes the
// cotangent by. The two modes share everything up to the last stores, so
// their outputs are the same bits.
//
// Row slabs (residue-axis sharding): the map may be a slab of a larger one.
// The input then holds H_out + 4 rows (the owned rows and 2 halo rows on each
// side, zero beyond the map), the output H_out rows ("valid" in rows, "same"
// in columns), and r0, the global row of output row 0, places the stats
// mask. A square map is the slab with H_in = H_out = W and r0 = 0. A shard
// that starts on a multiple of 8 rows has its work items and partials where
// the square launch has them, so the shards' partials, joined in row order,
// are the square launch's bits.
//
// What bounds it on an H100: operations. An implicit GEMM with M = L^2
// pixels, K = 25 * 128 = 3200 and N = 512: 25.4 GFLOP at L 88 (26 us at the
// 989 TFLOP/s bf16 tensor-core peak) and 406 GFLOP at L 352 (0.41 ms). Only
// wgmma reaches that rate; mma.sync tiles with block-wide barriers in the K
// loop stay near a fifth of it.
//
// Design (Hopper): a persistent, warp-specialised block per SM.
//   * Work item: (target, pixel tile, N half): an 8 x 16 patch of pixels
//     (so the (B, tiles, 2, c_groups) partials stay) by 256 columns (64 whole
//     maxout groups). Items are walked in that order, N half fastest, block
//     b taking items b, b + grid, ... (L 88: 66 tiles x 2 = 132 items, one
//     wave; L 352: 1936).
//   * Producer warp: TMA. The item's 12 x 20-pixel halo patch comes in two
//     4-D box loads over the NHWC map (64 channels each, 128-byte swizzle);
//     TMA fills what lies outside the image with zeros, which is the conv's
//     padding. The weights, packed N x K (K contiguous), stream through a
//     4-stage ring of 64 K x 256 N tiles (32 KB, 128-byte swizzle) with
//     full and empty mbarriers. The next item's patch loads while the
//     consumers run the epilogue.
//   * Two consumer warpgroups, 64 pixels (4 patch rows) each: per 16-deep K
//     step, ldmatrix reads each warp's 16 pixels at tap (dy, dx) from the
//     swizzled patch (the 128-byte swizzle keeps 8 consecutive pixels on 8
//     different bank groups, at any shift) into mma's A layout, and
//     wgmma.mma_async m64n256k16 (A in registers, B by descriptor from the
//     ring) accumulates into 128 fp32 registers per thread. Each stage's A
//     registers alternate between two sets, so a stage's wgmmas run while
//     the next stage's A is loaded (wait_group 1). setmaxnreg moves
//     registers from the producer (40) to the consumers (232).
//   * Epilogue from registers: bias; a maxout group's 4 columns lie in lanes
//     l and l ^ 1 (2 each), joined by one shuffle into the same fmaxf chain
//     in both modes. Argmax: strict > within a lane, and the higher lane's
//     slices win only if strictly greater (the first slice wins a tie).
//     The bf16 maxout (and the int8 index) go to a padded staging tile in
//     shared memory, then out as 16-byte stores, one contiguous row per
//     pixel: stored straight from the accumulator layout, each warp store
//     touched 16 rows for 64 useful bytes, and a variant without those
//     stores ran markedly faster. Stats: per channel over the item's pixels
//     inside [0, nres)^2, summed in a fixed order (a thread's row, then
//     lanes by shuffles, then the 8 warps through shared memory), one
//     partial entry per item, no atomics.
// Sizing: an item is 210 MFLOP, 28 us at one SM's share of the bf16 peak;
// its weights are 1.6 MB from L2, 7.5 TB/s across the card at that pace.
// Tried and dropped: a 2-block cluster with each weight stage multicast to
// both blocks (half the L2 traffic) ran slower at L 352 with all 66 clusters
// resident: the pair waits for its slower block at every stage. Not done:
// keeping a patch across an item's two N halves (61 KB of 1.7 MB per item).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 128;
constexpr int kPool = 4;
constexpr int kN = 256;                      // accumulator columns per item
constexpr int kGroups = kN / kPool;          // 64 maxout groups per item
constexpr int kTileRows = 8, kTileCols = 16;  // 128 pixels per item
constexpr int kPatchRows = kTileRows + 4, kPatchCols = kTileCols + 4;
constexpr int kHalfCin = 64;                  // channels per 128-byte swizzle row
constexpr int kPatchHalfBytes = kPatchRows * kPatchCols * kHalfCin * 2;  // 30 KB
constexpr int kPatchBytes = 2 * kPatchHalfBytes;
constexpr int kKChunk = 64;                   // K rows per ring stage
constexpr int kStageBytes = kN * kKChunk * 2;  // 32 KB
constexpr int kStages = 4;
constexpr int kSteps = 25 * kCin / kKChunk;    // 50 stages per item
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 128 + 32 * kConsumerWarps;  // producer warpgroup + 2 consumers
constexpr int kAcc = kN / 2;                  // fp32 accumulators per consumer thread
constexpr int kRedBytes = kConsumerWarps * 2 * kGroups * 4;
// the epilogue's staging of an item's output (bf16) and index (int8), rows
// padded so that a warp's writes meet at most 2-way bank conflicts and each
// pixel's row stays 16-byte aligned for the coalesced copy-out
constexpr int kTileM = kTileRows * kTileCols;
constexpr int kOutLd = kGroups + 8;       // bf16 per staged pixel
constexpr int kIdxLd = kGroups + 16;      // int8 per staged pixel
constexpr int kOutBytes = kTileM * kOutLd * 2;
constexpr int kIdxBytes = kTileM * kIdxLd;
constexpr int kBarBytes = (2 * kStages + 2) * 8;
constexpr int kSmem = 1024 + kPatchBytes + kStages * kStageBytes + kRedBytes + kOutBytes +
                      kIdxBytes + kBarBytes;
static_assert(kPatchHalfBytes % 1024 == 0, "swizzled regions start at 1024-byte boundaries");
static_assert(kSteps % 2 == 0, "stages alternate between two A register sets");
static_assert(kSmem <= 232448, "one block per SM: 227 KB of shared memory");

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
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

// D (64 x 256, fp32, registers) += A (64 x 16, bf16, registers) x B (16 x
// 256, bf16, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

struct Item {
  int b, mt, r0, c0, n0;
};

__device__ __forceinline__ Item decode(int item, int halves, int tiles, int tiles_c) {
  Item it;
  const int rest = item / halves;
  it.n0 = (item % halves) * kN;
  it.mt = rest % tiles;
  it.b = rest / tiles;
  it.r0 = (it.mt / tiles_c) * kTileRows;
  it.c0 = (it.mt % tiles_c) * kTileCols;
  return it;
}

// One ring stage of a consumer warpgroup: A of this warp's 16 pixels at the
// stage's tap from the patch, four m64n256k16 products, then the previous
// stage's release once its products are done.
__device__ __forceinline__ void consume_stage(float (&acc)[kAcc], uint32_t (&a)[4][4], int s,
                                              uint32_t patch, uint32_t ring, uint32_t full,
                                              uint32_t empty, int& stage, uint32_t& phase,
                                              int& prev, int prow, int m, int lane) {
  mbar_wait(full + 8 * stage, phase);
  const int tap = s / 2, dy = tap / 5, dx = tap % 5;
  const int pi = (prow + dy) * kPatchCols + m + dx;  // this lane's pixel in the patch
  const uint32_t row = patch + (s & 1) * kPatchHalfBytes + pi * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = 2 * kk + (lane >> 4);
    ldmatrix_x4(a[kk], row + ((chunk ^ (pi & 7)) << 4));
  }
  const uint32_t b = ring + stage * kStageBytes;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_sw128(b + 32 * kk), (s | kk) != 0);
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

template <bool kArgmax>
__device__ __forceinline__ void conv5x5_maxout_items(
    const CUtensorMap* tmap_x, const CUtensorMap* tmap_w, const float* __restrict__ bias,
    const int* __restrict__ nres, __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
    signed char* __restrict__ index, int h_out, int width, int r0, int row_shift, int c_out,
    int tiles_c, int tiles, int items) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t patch = base;
  const uint32_t ring = patch + kPatchBytes;
  float* red = reinterpret_cast<float*>(gbase + kPatchBytes + kStages * kStageBytes);
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(red) +
                                                          kRedBytes);
  signed char* idx_s = reinterpret_cast<signed char*>(out_s) + kOutBytes;
  const uint32_t bars = ring + kStages * kStageBytes + kRedBytes + kOutBytes + kIdxBytes;
  const uint32_t full = bars, empty = bars + 8 * kStages;
  const uint32_t patch_full = bars + 16 * kStages, patch_empty = patch_full + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int halves = c_out / kN, c_groups = c_out / kPool;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(patch_full, 1);
    mbar_init(patch_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0, pphase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = decode(item, halves, tiles, tiles_c);
      mbar_wait(patch_empty, pphase ^ 1);
      mbar_expect_tx(patch_full, kPatchBytes);
      tma_load_4d(patch, tmap_x, 0, it.c0 - 2, it.r0 + row_shift, it.b, patch_full);
      tma_load_4d(patch + kPatchHalfBytes, tmap_x, kHalfCin, it.c0 - 2, it.r0 + row_shift, it.b,
                  patch_full);
      pphase ^= 1;
      for (int s = 0; s < kSteps; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, kStageBytes);
        tma_load_2d(ring + stage * kStageBytes, tmap_w, s * kKChunk, it.n0, full + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cwarp = warp - 4;                  // 0..7
  const int prow = cwarp;                      // this warp's patch row: 4 per warpgroup
  const int m = (lane & 7) + 8 * ((lane >> 3) & 1);  // this lane's ldmatrix pixel
  const int g = lane / 4, q = (lane % 4) / 2, odd = lane & 1;
  int stage = 0, prev = -1;
  uint32_t phase = 0, pphase = 0;
  float acc[kAcc];
  uint32_t a0[4][4], a1[4][4];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = decode(item, halves, tiles, tiles_c);
    mbar_wait(patch_full, pphase);
    pphase ^= 1;
#pragma unroll 1
    for (int s = 0; s < kSteps; s += 2) {
      consume_stage(acc, a0, s, patch, ring, full, empty, stage, phase, prev, prow, m, lane);
      consume_stage(acc, a1, s + 1, patch, ring, full, empty, stage, phase, prev, prow, m, lane);
    }
    if (lane == 0) mbar_arrive(patch_empty);  // the item's last ldmatrix is done
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    prev = -1;

    // ---- epilogue from registers
    const int i = it.r0 + prow;  // the row in this launch's output
    const int n_lim = kArgmax ? 0 : nres[it.b];
    const size_t img = (size_t)it.b * h_out * width;
    const int ct = tid - 128;  // consumer thread 0..255
    // the previous item's copy-out has read the staging and the sums
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
#pragma unroll
    for (int n8 = 0; n8 < kAcc / 4; ++n8) {
      const int col = it.n0 + 8 * n8 + 2 * (lane % 4);
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
      const int grp = 2 * n8 + q;  // within the item's 64 groups
      float mine_v = 0.0f;
      int mine_w = 0;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float v0 = acc[4 * n8 + 2 * rh] + b0, v1 = acc[4 * n8 + 2 * rh + 1] + b1;
        const float mv = fmaxf(v0, v1);
        const int mw = (v1 > v0) ? 1 : 0;
        const float ov = __shfl_xor_sync(0xffffffffu, mv, 1);
        const int ow = __shfl_xor_sync(0xffffffffu, mw, 1);
        const float lo_v = odd ? ov : mv, hi_v = odd ? mv : ov;
        const int lo_w = odd ? ow : mw, hi_w = odd ? mw : ow;
        const float v = fmaxf(lo_v, hi_v);
        const int w = (hi_v > lo_v) ? 2 + hi_w : lo_w;
        if (rh == odd) {  // the even lane stores row g, the odd lane row g + 8
          mine_v = v;
          mine_w = w;
        }
      }
      const int j = it.c0 + g + 8 * odd;
      const int px = prow * kTileCols + g + 8 * odd;  // pixel within the tile
      out_s[px * kOutLd + grp] = __float2bfloat16(mine_v);
      if constexpr (kArgmax) idx_s[px * kIdxLd + grp] = static_cast<signed char>(mine_w);
      if constexpr (!kArgmax) {
        const bool counted = i < h_out && r0 + i < n_lim && j < n_lim;
        float t = counted ? mine_v : 0.0f, tt = counted ? mine_v * mine_v : 0.0f;
        // lanes of one group: the two rows (xor 1), then the 8 pixel columns
#pragma unroll
        for (int sh = 1; sh <= 16; sh = (sh == 1) ? 4 : 2 * sh) {
          t += __shfl_xor_sync(0xffffffffu, t, sh);
          tt += __shfl_xor_sync(0xffffffffu, tt, sh);
        }
        if (lane == 0 || lane == 2) {
          red[(cwarp * 2 + 0) * kGroups + 2 * n8 + q] = t;
          red[(cwarp * 2 + 1) * kGroups + 2 * n8 + q] = tt;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
    // copy-out: each pixel's 64 groups are one contiguous row of the output
    // (128 bytes) and of the index (64 bytes), written 16 bytes a thread
    constexpr int kOutChunks = kGroups * 2 / 16, kIdxChunks = kGroups / 16;
    for (int v = ct; v < kTileM * kOutChunks; v += 32 * kConsumerWarps) {
      const int px = v / kOutChunks, part = v % kOutChunks;
      const int pi = it.r0 + px / kTileCols, pj = it.c0 + px % kTileCols;
      if (pi < h_out && pj < width)
        *reinterpret_cast<uint4*>(out + (img + (size_t)pi * width + pj) * c_groups + it.n0 / kPool +
                                  part * 8) =
            *reinterpret_cast<const uint4*>(out_s + px * kOutLd + part * 8);
    }
    if constexpr (kArgmax) {
      for (int v = ct; v < kTileM * kIdxChunks; v += 32 * kConsumerWarps) {
        const int px = v / kIdxChunks, part = v % kIdxChunks;
        const int pi = it.r0 + px / kTileCols, pj = it.c0 + px % kTileCols;
        if (pi < h_out && pj < width)
          *reinterpret_cast<uint4*>(index + (img + (size_t)pi * width + pj) * c_groups +
                                    it.n0 / kPool + part * 16) =
              *reinterpret_cast<const uint4*>(idx_s + px * kIdxLd + part * 16);
      }
    } else if (ct < 2 * kGroups) {
      const int stat = ct / kGroups, gi = ct % kGroups;
      float tot = 0.0f;
      for (int w = 0; w < kConsumerWarps; ++w) tot += red[(w * 2 + stat) * kGroups + gi];
      partial[(((size_t)it.b * tiles + it.mt) * 2 + stat) * c_groups + it.n0 / kPool + gi] = tot;
    }
  }
}

// The two modes as two kernels, so that a profile tells them apart by name.
__global__ void __launch_bounds__(kThreads, 1) conv5x5_maxout_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ bias, const int* __restrict__ nres,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int h_out, int width, int r0,
    int row_shift, int c_out, int tiles_c, int tiles, int items) {
  conv5x5_maxout_items<false>(&tmap_x, &tmap_w, bias, nres, out, partial, nullptr, h_out, width,
                              r0, row_shift, c_out, tiles_c, tiles, items);
}

__global__ void __launch_bounds__(kThreads, 1) conv5x5_maxout_argmax_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    signed char* __restrict__ index, int h_out, int width, int r0, int row_shift, int c_out,
    int tiles_c, int tiles, int items) {
  conv5x5_maxout_items<true>(&tmap_x, &tmap_w, bias, nullptr, out, nullptr, index, h_out, width,
                             r0, row_shift, c_out, tiles_c, tiles, items);
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

// The two tensor maps: x as (128 ch, W, H_in, B) in 12 x 20-pixel boxes of
// 64 channels; w as (3200 K, c_out N) in 64 x 256 boxes; both 128-byte
// swizzled, zeros outside.
int make_maps(const void* x, const void* w, int batch, int h_in, int width, int c_out,
              CUtensorMap* mx, CUtensorMap* mw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t xdim[4] = {(cuuint64_t)kCin, (cuuint64_t)width, (cuuint64_t)h_in,
                              (cuuint64_t)batch};
  const cuuint64_t xstride[3] = {(cuuint64_t)kCin * 2, (cuuint64_t)width * kCin * 2,
                                 (cuuint64_t)h_in * width * kCin * 2};
  const cuuint32_t xbox[4] = {kHalfCin, kPatchCols, kPatchRows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)25 * kCin, (cuuint64_t)c_out};
  const cuuint64_t wstride[1] = {(cuuint64_t)25 * kCin * 2};
  const cuuint32_t wbox[2] = {kKChunk, kN};
  r = encode(mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Per device and kernel, once: the shared-memory opt-in and the SM count
// (the bf16 trunk is bound by the host, so a launch does no more than it must).
constexpr int kMaxDevices = 64;

template <auto kKernel>
int device_sms() {
  static int sms[kMaxDevices] = {};  // 0: not set up on that device yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    if ((e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return -(int)e;
    sms[dev] = n;
  }
  return sms[dev];
}

// The launch shared by both entry points: maps, persistent grid, error code.
// h_in is h_out (a square map, zero rows around it) or h_out + 4 (a slab
// with its halo rows).
template <auto kKernel, typename... Args>
int launch(const void* x, const void* w, int batch, int h_in, int h_out, int width, int r0,
           int c_in, int c_out, void* stream, Args... args) {
  if (batch <= 0 || h_out <= 0 || width <= 0 || r0 < 0 || (h_in != h_out && h_in != h_out + 4) ||
      c_in != kCin || c_out <= 0 || c_out % kN != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  int err = make_maps(x, w, batch, h_in, width, c_out, &mx, &mw);
  if (err != 0) return err;
  const int sms = device_sms<kKernel>();
  if (sms < 0) return -sms;
  const int tiles_r = (h_out + kTileRows - 1) / kTileRows;
  const int tiles_c = (width + kTileCols - 1) / kTileCols;
  const int tiles = tiles_r * tiles_c;
  const long long items = (long long)batch * tiles * (c_out / kN);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  // the patch of output row r starts at input row r - 2 + (h_in - h_out) / 2
  const int row_shift = (h_in - h_out) / 2 - 2;
  kKernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      mx, mw, args..., h_out, width, r0, row_shift, c_out, tiles_c, tiles, (int)items);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, h_in, W, 128) bf16, h_in = h_out (a square map) or h_out + 4
// (a row slab with 2 halo rows on each side); w: (c_out, 3200) bf16 with row
// c (torch order g * 4 + p) and column (dy * 5 + dx) * 128 + ci; bias:
// (c_out,) fp32; nres: (batch,) int32; r0: the global row of output row 0
// (0 for a square map); out: (batch, h_out, W, c_out / 4) bf16; partial:
// (batch, tiles, 2, c_out / 4) fp32 with tiles = ceil(h_out / 8) *
// ceil(W / 16), over the pixels with global row and column in [0, nres).
// c_in must be 128 and c_out a multiple of 256. All pointers 16-byte aligned.
extern "C" int conv5x5_maxout_stats(const void* x, const void* w, const float* bias,
                                    const int* nres, void* out, float* partial, int batch,
                                    int h_in, int h_out, int width, int r0, int c_in, int c_out,
                                    void* stream) {
  return launch<conv5x5_maxout_kernel>(x, w, batch, h_in, h_out, width, r0, c_in, c_out, stream,
                                       bias, nres, static_cast<__nv_bfloat16*>(out), partial);
}

// Argmax mode: x, w, bias, out as above; index: (batch, h_out, W, c_out / 4)
// int8, the slice p in 0..3 whose value out holds (the first on a tie).
extern "C" int conv5x5_maxout_argmax(const void* x, const void* w, const float* bias, void* out,
                                     void* index, int batch, int h_in, int h_out, int width,
                                     int c_in, int c_out, void* stream) {
  return launch<conv5x5_maxout_argmax_kernel>(x, w, batch, h_in, h_out, width, 0, c_in, c_out,
                                              stream, bias, static_cast<__nv_bfloat16*>(out),
                                              static_cast<signed char*>(index));
}
