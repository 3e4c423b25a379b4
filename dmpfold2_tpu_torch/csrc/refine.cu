// CA-trace refinement: the whole Euler loop of the reference force field, for
// a batch of traces with per-target lengths.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/refine.py:refine_coords_pallas
// (its _refine_kernel; the JAX package vmaps it over a batch). Each step: all-
// pairs repulsion below 3.0 A (k = 100, distances clipped to [0.01, 10])
// between valid residues, a spring toward 3.78 A between adjacent CAs (i, i+1
// both below nres), the acceleration clipped to +-100 and a step of 0.001.
// Positions at or past nres feel no force and exert none. The arithmetic is
// dmpfold2_tpu/models/geometry.py:_refine_step, each force rounded as the
// port's plain version rounds it (k viol (d / dist): three IEEE divisions a
// pair, not the Pallas kernel's one, since only the few pairs closer than
// 3 A pay for them; squared norms, products and the update without FMA;
// IEEE sqrtf; NaN kept through every clip as by torch.clamp); only the
// order of the repulsion sum differs. That order alone parts two fp32
// versions of this chaotic map: after 100 steps of a long random walk the
// plain version on the CPU and on the card can lie about 1e-4 A apart, and
// farther from fp64 (chip_smoke.py records both beside each check).
//
// What bounds it on an H100: the dependent chain of steps. A step is
// O(nres^2) work (about 6.7e3 pairs at PF10963's nres = 82, 2.4e6 at L 1536)
// that depends on the whole previous step. Within a step, on an H100 80GB
// HBM3 at 700 W (PERF.md, Findings): at L 1536 the throughput of the pair
// screening; below L 200 or so a floor of about 2.5 us a step, the latency
// of the screening and the forces of the close pairs, two barriers, the
// partial sums and the update.
//
// Design (Hopper):
//   * One thread-block cluster of 16 CTAs per target (grid y; 16 is a
//     non-portable cluster size). At B 1 no smaller cluster was faster at
//     any L from 88 to 1536 on an H100 (PERF.md, Findings). Each CTA keeps the
//     whole trace in shared memory as float4, double-buffered (32 B per
//     residue), and owns a contiguous share of the valid rows j < nres.
//   * Pair loop: lanes hold rows j, warps hold slices of the partners i, so
//     every load of c[i] is a shared-memory broadcast. Most pairs are farther
//     apart than 3 A and feel no force: a block of 8 partners is screened
//     branch-free (a difference, a squared norm and one compare each; dist <
//     3 iff sq < 9, as sqrtf is correctly rounded) into a bit mask, and only
//     the pairs it marks take the IEEE sqrtf and division, in partner order.
//     c[j] - c[i] comes from the same shared-memory words on both sides, so
//     the self-difference is exactly 0: its force is 0 and it is left out.
//   * Meanwhile the warps without a pair slice compute the CTA's springs.
//     After a CTA barrier one thread per row adds the slices' partial sums
//     in slice order (no atomics: a second launch gives the same bits), then
//     the two springs, applies the update and stores the new position into
//     the next buffer of every CTA of the cluster through distributed shared
//     memory. One cluster barrier (arrive.release / wait.acquire) per step
//     makes the stores visible; double buffering makes that one barrier
//     enough, since a CTA writes a buffer only after every CTA has passed the
//     barrier that ends its reads.
//   * A target with nres <= 1 or n_steps 0 feels no force: its trace is
//     copied through.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kVdwDist = 3.0f;
constexpr float kCovDist = 3.78f;
constexpr float kVdw = 100.0f;
constexpr float kCov = 100.0f;
constexpr float kStep = 0.001f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMinPartners = 8;  // fewest partners a slice is given
constexpr int kBlock = 8;        // partners screened per step of the pair loop
constexpr int kCtas = 16;  // CTAs per target's cluster
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

// two trace buffers of n float4, then kThreads float4 each of partial sums
// and springs
int smem_for(int n) { return (2 * n + 2 * kThreads) * (int)sizeof(float4); }

// torch.clamp's halves: a NaN stays NaN (fmaxf and fminf would drop it)
__device__ __forceinline__ float at_least(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float at_most(float v, float hi) { return v > hi ? hi : v; }
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return at_most(at_least(v, lo), hi);
}

// (dx^2 + dy^2) + dz^2, each operation rounded as in the plain version (no FMA)
__device__ __forceinline__ float norm2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the spring force on a from the spring toward b (a's next residue); b gets -f
__device__ __forceinline__ float3 spring(float4 a, float4 b) {
  const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
  const float dist = at_least(sqrtf(at_least(norm2(dx, dy, dz), 1e-12f)), 0.1f);
  const float k = kCov * at_most(dist - kCovDist, 3.0f);
  return make_float3(k * (dx / dist), k * (dy / dist), k * (dz / dist));
}

// c + clip(a) * step, each operation rounded as in the plain version (no FMA)
__device__ __forceinline__ float moved(float c, float a) {
  return __fadd_rn(c, __fmul_rn(clampf(a, -100.0f, 100.0f), kStep));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    refine_kernel(const float* __restrict__ in, const int* __restrict__ nres_b,
                  float* __restrict__ out, int n, int n_steps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.y * n * 3;
  const int nres = min(max(nres_b[blockIdx.y], 0), n);  // the plain version's masks read it so
  const int span = (n + kCtas - 1) / kCtas;  // rows this CTA writes out
  const int o0 = rank * span, o1 = min(o0 + span, n);

  if (nres <= 1 || n_steps == 0) {
    for (int k = 3 * o0 + tid; k < 3 * o1; k += kThreads) out[base + k] = in[base + k];
    return;
  }

  extern __shared__ __align__(16) float4 smem[];
  // the trace buffers are smem[0, n) and smem[n, 2n); then the partial sums
  // and the springs. The pair loop may read up to kBlock - 1 entries past a
  // buffer's end (into the next region) and masks them out.
  float4* part = smem + 2 * n;
  float4* spr = part + kThreads;
  for (int j = tid; j < n; j += kThreads) {
    const float* src = in + base + 3 * j;
    smem[j] = smem[n + j] = make_float4(src[0], src[1], src[2], 0.0f);
  }

  // this CTA's rows [r0, r1) of the valid ones; row warps x partner slices of
  // a multiple of kBlock partners, leaving at least one warp for the springs
  const int share = (nres + kCtas - 1) / kCtas;
  const int r0 = min(rank * share, nres), r1 = min(r0 + share, nres), rows = r1 - r0;
  const int row_warps = (rows + 31) / 32;
  const int want = row_warps == 0 || row_warps >= kWarps
                       ? 1
                       : max(1, min((kWarps - 1) / row_warps, nres / kMinPartners));
  const int chunk = ((nres + want - 1) / want + kBlock - 1) / kBlock * kBlock;
  const int slices = (nres + chunk - 1) / chunk;
  const int items = row_warps * slices, part_ld = row_warps * 32;

  cluster.sync();  // every CTA of the cluster runs and holds the trace

  // the spring between i and i + 1 (both valid), else 0
  auto spring_at = [&](const float4* cur, int i) {
    return i >= 0 && i + 1 < nres ? spring(cur[i], cur[i + 1]) : make_float3(0.0f, 0.0f, 0.0f);
  };
  // row j's new position from its repulsion sum and its two springs, stored
  // into every CTA's next buffer
  auto finish = [&](const float4* cur, float4* next, int j, float3 rep, float3 fa, float3 fb) {
    const float4 cj = cur[j];
    const float4 v = make_float4(moved(cj.x, (rep.x + fa.x) + -fb.x),
                                 moved(cj.y, (rep.y + fa.y) + -fb.y),
                                 moved(cj.z, (rep.z + fa.z) + -fb.z), 0.0f);
#pragma unroll
    for (int r = 0; r < kCtas; ++r) *cluster.map_shared_rank(next + j, r) = v;
  };

  int p = 0;
  for (int step = 0; step < n_steps; ++step) {
    const float4* cur = smem + p * n;
    float4* next = smem + (p ^ 1) * n;
    // repulsion: warp item (row warp, slice); rows on lanes, partners broadcast
    for (int item = warp; item < items; item += kWarps) {
      const int rw = item % row_warps, s = item / row_warps;
      const int j = r0 + rw * 32 + lane;
      const float4 cj = cur[j < r1 ? j : r0];
      const int lo = s * chunk, hi = min(lo + chunk, nres);
      float3 rep = make_float3(0.0f, 0.0f, 0.0f);
      for (int i0 = lo; i0 < hi; i0 += kBlock) {
        // screen the block: the pairs closer than 3 A (or NaN), as a bit mask.
        // The screen's squared norm may round differently from the plain
        // version's (FMA); a pair it passes gets its force from norm2 and the
        // plain version's own dist < 3 test, so only a pair within an ulp of
        // 3 A, whose force rounds to about 0, can be screened out wrongly.
        unsigned close = 0;
#pragma unroll
        for (int k = 0; k < kBlock; ++k) {
          const float4 ci = cur[i0 + k];
          const float dx = cj.x - ci.x, dy = cj.y - ci.y, dz = cj.z - ci.z;
          if (!(dx * dx + dy * dy + dz * dz >= kVdwDist * kVdwDist)) close |= 1u << k;
        }
        // leave out partners past hi, the self-pair and rows past r1
        const int left = hi - i0;
        const unsigned self = (unsigned)(j - i0);
        close &= left >= kBlock ? ~0u : (1u << left) - 1u;
        if (self < kBlock) close &= ~(1u << self);
        if (j >= r1) close = 0;
        while (close) {  // the force of each, in partner order
          const int i = i0 + __ffs(close) - 1;
          close &= close - 1;
          const float4 ci = cur[i];
          const float dx = cj.x - ci.x, dy = cj.y - ci.y, dz = cj.z - ci.z;  // c[j] - c[i]
          const float dist = clampf(sqrtf(at_least(norm2(dx, dy, dz), 1e-12f)), 0.01f, 10.0f);
          const float k = kVdw * (dist < kVdwDist ? kVdwDist - dist : 0.0f);
          // k (d / dist) as the plain version rounds it, without FMA
          rep.x = __fadd_rn(rep.x, __fmul_rn(k, dx / dist));
          rep.y = __fadd_rn(rep.y, __fmul_rn(k, dy / dist));
          rep.z = __fadd_rn(rep.z, __fmul_rn(k, dz / dist));
        }
      }
      if (slices == 1) {
        if (j < r1) finish(cur, next, j, rep, spring_at(cur, j), spring_at(cur, j - 1));
      } else {
        part[s * part_ld + rw * 32 + lane] = make_float4(rep.x, rep.y, rep.z, 0.0f);
      }
    }
    if (slices > 1) {
      // the warps without a pair item: the springs i = r0 - 1 ... r1 - 1
      for (int t = (warp - items) * 32 + lane; warp >= items && t <= rows;
           t += (kWarps - items) * 32) {
        const float3 f = spring_at(cur, r0 - 1 + t);
        spr[t] = make_float4(f.x, f.y, f.z, 0.0f);
      }
      __syncthreads();  // every slice's partial sums and every spring are in
      for (int t = tid; t < rows; t += kThreads) {
        float3 rep = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int s = 0; s < kWarps; ++s) {  // in slice order
          if (s < slices) {
            const float4 q = part[s * part_ld + t];
            rep.x += q.x;
            rep.y += q.y;
            rep.z += q.z;
          }
        }
        const float4 fa = spr[t + 1], fb = spr[t];
        finish(cur, next, r0 + t, rep, make_float3(fa.x, fa.y, fa.z),
               make_float3(fb.x, fb.y, fb.z));
      }
    }
    cluster_barrier();  // the new positions are in every CTA; cur, part and spr are free again
    p ^= 1;
  }

  // after the last barrier no CTA touches another's shared memory
  for (int k = 3 * o0 + tid; k < 3 * o1; k += kThreads) {
    const float4 v = smem[p * n + k / 3];
    const int c = k % 3;
    out[base + k] = c == 0 ? v.x : (c == 1 ? v.y : v.z);
  }
}

// a launch of `batch` clusters; attr must outlive it
cudaLaunchConfig_t launch_config(int batch, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Per device, once for each shared-memory size larger than the last one
// checked: whether one cluster can be resident. A refusal is returned as an
// error; the kernel is never launched to hang.
int check_cluster_fits(int smem) {
  static int checked[kMaxDevices] = {};  // the largest smem that fits
  static bool attrs_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attrs_set[dev]) {
    if ((e = cudaFuncSetAttribute(refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaFuncSetAttribute(refine_kernel,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
        cudaSuccess)
      return (int)e;
    attrs_set[dev] = true;
  }
  if (smem <= checked[dev]) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, smem, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, refine_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  checked[dev] = smem;
  return 0;
}

}  // namespace

// coords, out: (batch, n, 3) contiguous fp32; nres: (batch,) int32 on the
// device, each clamped to [0, n]; n_steps >= 0. n is bounded by shared
// memory: 32 B per residue plus 32 KB, at most 227 KB, so n <= 6240. Returns
// a CUDA error code (cudaErrorLaunchOutOfResources when the card cannot hold
// one cluster of 16 CTAs).
extern "C" int refine_coords_batched(const void* coords, const void* nres, void* out, int batch,
                                     int n, int n_steps, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > kMaxSmem || n_steps < 0 ||
      smem_for(n) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_for(n);
  const int fits = check_cluster_fits(smem);
  if (fits != 0) return fits;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(batch, smem, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, refine_kernel, static_cast<const float*>(coords),
                                           static_cast<const int*>(nres),
                                           static_cast<float*>(out), n, n_steps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
