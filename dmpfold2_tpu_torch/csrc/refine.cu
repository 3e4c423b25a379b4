// CA-trace refinement: the whole Euler loop of the reference force field.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/refine.py:refine_coords_pallas
// (its _refine_kernel). Each step: all-pairs repulsion below 3.0 A (k = 100,
// distances clipped to [0.01, 10]) between valid residues, a spring toward
// 3.78 A between adjacent CAs (i, i+1 both below nres), the acceleration
// clipped to +-100 and a step of 0.001. Positions at or past nres feel no
// force and exert none. The arithmetic follows
// dmpfold2_tpu/models/geometry.py:_refine_step.
//
// What bounds it on an H100: the dependent chain of steps. A step is
// O(nres^2) work (about 7e3 pairs at PF10963's nres = 82) that depends on the
// whole previous step, so one step's latency, not FLOPs or bytes, sets the
// pace.
//
// Design: one block runs the whole loop with the coordinates in shared memory
// (24 bytes per residue with the accelerations: 36 KB at L = 1536), one
// thread per residue j (or several when L exceeds the block), and a
// __syncthreads() between reading the old coordinates and writing the new.
// c[j] - c[i] is formed from the same shared-memory values on both sides, so
// the self-difference is exactly 0 and never meets the 0.01 clip with a
// nonzero direction.

#include <cuda_runtime.h>

namespace {

constexpr float kVdwDist = 3.0f;
constexpr float kCovDist = 3.78f;
constexpr float kVdw = 100.0f;
constexpr float kCov = 100.0f;
constexpr float kStep = 0.001f;
constexpr int kMaxThreads = 1024;

// the spring force f[i] between i and i+1: acts +f on i and -f on i+1
__device__ __forceinline__ void spring(const float* x, const float* y, const float* z, int i,
                                       int nres, float& fx, float& fy, float& fz) {
  const float dx = x[i + 1] - x[i], dy = y[i + 1] - y[i], dz = z[i + 1] - z[i];
  const float dist = fmaxf(sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f)), 0.1f);
  const float viol = (i + 1 < nres) ? fminf(dist - kCovDist, 3.0f) : 0.0f;
  const float k = kCov * viol;
  fx = k * (dx / dist);
  fy = k * (dy / dist);
  fz = k * (dz / dist);
}

__global__ void __launch_bounds__(kMaxThreads) refine_kernel(const float* __restrict__ in,
                                                             float* __restrict__ out, int n,
                                                             int n_steps, int nres) {
  extern __shared__ float smem[];
  float* x = smem;
  float* y = x + n;
  float* z = y + n;
  float* ax = z + n;
  float* ay = ax + n;
  float* az = ay + n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    x[j] = in[3 * j];
    y[j] = in[3 * j + 1];
    z[j] = in[3 * j + 2];
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      if (j < nres) {
        const float xj = x[j], yj = y[j], zj = z[j];
        for (int i = 0; i < nres; ++i) {
          const float dx = xj - x[i], dy = yj - y[i], dz = zj - z[i];  // c[j] - c[i]
          const float dist =
              fminf(fmaxf(sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f)), 0.01f), 10.0f);
          if (dist < kVdwDist) {
            const float k = kVdw * (kVdwDist - dist);
            sx += k * (dx / dist);
            sy += k * (dy / dist);
            sz += k * (dz / dist);
          }
        }
      }
      float fx, fy, fz;
      if (j + 1 < n) {
        spring(x, y, z, j, nres, fx, fy, fz);
        sx += fx;
        sy += fy;
        sz += fz;
      }
      if (j > 0) {
        spring(x, y, z, j - 1, nres, fx, fy, fz);
        sx += -fx;
        sy += -fy;
        sz += -fz;
      }
      ax[j] = sx;
      ay[j] = sy;
      az[j] = sz;
    }
    __syncthreads();  // every read of the old coordinates is done
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      x[j] += fminf(fmaxf(ax[j], -100.0f), 100.0f) * kStep;
      y[j] += fminf(fmaxf(ay[j], -100.0f), 100.0f) * kStep;
      z[j] += fminf(fmaxf(az[j], -100.0f), 100.0f) * kStep;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    out[3 * j] = x[j];
    out[3 * j + 1] = y[j];
    out[3 * j + 2] = z[j];
  }
}

}  // namespace

// coords, out: (n, 3) contiguous fp32; 0 <= nres <= n; n_steps >= 0.
extern "C" int refine_coords(const float* coords, float* out, int n, int n_steps, int nres,
                             void* stream) {
  if (n <= 0 || nres < 0 || nres > n || n_steps < 0) return (int)cudaErrorInvalidValue;
  const int smem = 6 * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(refine_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (n + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  refine_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(coords, out, n, n_steps, nres);
  return (int)cudaGetLastError();
}
