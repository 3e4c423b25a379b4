// Residue GRU: one GRU layer-direction over a precomputed input projection.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/rgru.py:gru_seq_pallas (its
// _kernel). Input xproj = x @ W_i + b_i, (T, B, 3H), computed outside by
// torch.matmul; this kernel runs the recurrence h' = GRU(xproj[t], h) for
// every step and writes every step's state. Masking per batch column: a
// forward pass freezes the state once t >= valid; a reverse pass holds it at
// zero there, so the first valid step sees a fresh zero state.
//
// What bounds it on an H100: the dependent chain. Each step needs the whole
// previous state, so the T steps run one after another, and each is a GEMV
// (B x 256) @ (256 x 768) over W_hh, 768 KB of fp32. The FLOPs (2 * 256 * 768
// per step and column) and the bytes (xproj, W_hh, the output, each once)
// would take well under a microsecond at the card's peaks.
//
// Design: one block per kCols batch columns runs the whole time loop with the
// state in shared memory. W_hh does not fit one SM's shared memory, so each
// step streams it from L2, coalesced along the hidden unit j. To keep enough
// loads in flight, the block has 1024 threads: thread (s, j) sums the three
// gate rows of unit j over the s-th slice of k; thread (0, j) adds the slices
// and applies the gates. Steps where every column of the block is masked skip
// the product: the masking rule alone gives the state.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 2;         // batch columns per block
constexpr int kThreads = 1024;   // threads per block: hidden x k-slices

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads) rgru_kernel(
    const float* __restrict__ xproj, const float* __restrict__ wh,
    const float* __restrict__ bh, const int* __restrict__ valid, int seq_len, int batch,
    int hidden, int reverse, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int slices = blockDim.x / hidden;
  float* h = smem;                      // [kCols][hidden]
  float* part = smem + kCols * hidden;  // [slices][kCols][3][hidden]

  const int j = threadIdx.x % hidden;
  const int s = threadIdx.x / hidden;
  const int k_len = hidden / slices;
  const int k0 = s * k_len;
  const int g = 3 * hidden;
  const int b0 = blockIdx.x * kCols;

  int col_valid[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) col_valid[c] = (b0 + c < batch) ? valid[b0 + c] : 0;
  if (s == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) h[c * hidden + j] = 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < seq_len; ++step) {
    const int t = reverse ? seq_len - 1 - step : step;
    bool any = false;
#pragma unroll
    for (int c = 0; c < kCols; ++c) any |= t < col_valid[c];

    if (any) {  // uniform across the block
      float ar[kCols], az[kCols], an[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) ar[c] = az[c] = an[c] = 0.0f;
#pragma unroll 8
      for (int k = k0; k < k0 + k_len; ++k) {
        const float* w = wh + (size_t)k * g;
        const float wr = __ldg(w + j), wz = __ldg(w + hidden + j), wn = __ldg(w + 2 * hidden + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float hk = h[c * hidden + k];
          ar[c] = fmaf(hk, wr, ar[c]);
          az[c] = fmaf(hk, wz, az[c]);
          an[c] = fmaf(hk, wn, an[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float* p = part + ((size_t)(s * kCols + c) * 3) * hidden + j;
        p[0] = ar[c];
        p[hidden] = az[c];
        p[2 * hidden] = an[c];
      }
    }
    __syncthreads();  // partial sums written; every read of h is done

    if (s == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (b0 + c >= batch) continue;
        const float h_old = h[c * hidden + j];
        float h_val;
        if (t < col_valid[c]) {
          float hr = 0.0f, hz = 0.0f, hn = 0.0f;
          for (int q = 0; q < slices; ++q) {
            const float* p = part + ((size_t)(q * kCols + c) * 3) * hidden + j;
            hr += p[0];
            hz += p[hidden];
            hn += p[2 * hidden];
          }
          const float* xp = xproj + ((size_t)t * batch + b0 + c) * g;
          const float r = sigmoid(xp[j] + (hr + bh[j]));
          const float z = sigmoid(xp[hidden + j] + (hz + bh[hidden + j]));
          const float n = tanhf(xp[2 * hidden + j] + r * (hn + bh[2 * hidden + j]));
          h_val = (1.0f - z) * n + z * h_old;
        } else {
          h_val = reverse ? 0.0f : h_old;
        }
        h[c * hidden + j] = h_val;
        out[((size_t)t * batch + b0 + c) * hidden + j] = h_val;
      }
    }
    __syncthreads();  // the new state is visible before the next step reads it
  }
}

}  // namespace

// xproj: (T, B, 3H); wh: (H, 3H); bh: (3H,); valid: (B,) int32;
// out: (T, B, H). All contiguous fp32 except valid.
extern "C" int rgru_seq(const float* xproj, const float* wh, const float* bh, const int* valid,
                        int seq_len, int batch, int hidden, int reverse, float* out,
                        void* stream) {
  if (hidden % 32 != 0 || hidden > kThreads || batch <= 0 || seq_len <= 0)
    return (int)cudaErrorInvalidValue;
  const int slices = kThreads / hidden;
  if (hidden % slices != 0) return (int)cudaErrorInvalidValue;
  const int smem = kCols * hidden * (1 + 3 * slices) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rgru_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + kCols - 1) / kCols;
  rgru_kernel<<<blocks, slices * hidden, smem, (cudaStream_t)stream>>>(
      xproj, wh, bh, valid, seq_len, batch, hidden, reverse, out);
  return (int)cudaGetLastError();
}
