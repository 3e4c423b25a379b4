// Vertical GRU: the 2-layer GRU scanned over MSA rows, final state of layer 2.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/vgru.py:vgru_final_cols_pallas
// (its _kernel). For each column (a residue position) the state of both
// layers runs over the alignment rows; a column freezes once the row index
// reaches its own valid depth. Layer 0's input is one-hot(22), so its input
// projection is a row gather of wi1 plus bi1, with no product.
//
// What bounds it on an H100: the three 512x1536 fp32 matrices (wh1, wi2, wh2;
// 9.4 MB) are needed in full for every row, and rows are sequential. The
// arithmetic is 3 * 2 * 512 * 1536 FLOP per row and column (about 105 GFLOP
// for PF10963, 252 rows x 88 columns: 1.6 ms at the 67 TFLOP/s fp32 peak).
//
// Design: blocks run in no order, so the row loop sits inside the block. Each
// block owns kCols columns and keeps both hidden states of those columns in
// shared memory (8 x 512 x 2 fp32 = 32 KB). One thread per hidden unit j
// computes the three gate sums of unit j for all kCols columns; the weights
// are too large for shared memory and stream from L2 every row, read once per
// row per block, coalesced along j. At PF10963's 88 columns only 11 blocks
// exist, so at most 11 of the 132 SMs work and each is limited by how fast it
// can pull 9.4 MB per row from L2. Splitting the hidden dimension across a
// thread-block cluster is the way to use the rest of the card.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 8;     // alignment columns per block
constexpr int kClasses = 22;  // residue classes of the one-hot input

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(512) vgru_kernel(
    const int* __restrict__ aln, const int* __restrict__ valid, int n_rows, int n_cols,
    int hidden,
    const float* __restrict__ wi1, const float* __restrict__ wh1,
    const float* __restrict__ wi2, const float* __restrict__ wh2,
    const float* __restrict__ bi1, const float* __restrict__ bh1,
    const float* __restrict__ bi2, const float* __restrict__ bh2,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* h1 = smem;                   // [kCols][hidden]
  float* h2 = smem + kCols * hidden;  // [kCols][hidden]
  __shared__ int tok[kCols];
  __shared__ int col_valid[kCols];

  const int j = threadIdx.x;  // hidden unit
  const int g = 3 * hidden;
  const int c0 = blockIdx.x * kCols;

  if (j < kCols) col_valid[j] = (c0 + j < n_cols) ? valid[c0 + j] : 0;
  for (int c = 0; c < kCols; ++c) {
    h1[c * hidden + j] = 0.0f;
    h2[c * hidden + j] = 0.0f;
  }
  __syncthreads();

  // rows past every column's depth change nothing: stop there
  int rows = 0;
  for (int c = 0; c < kCols; ++c) rows = max(rows, col_valid[c]);
  rows = min(rows, n_rows);

  for (int t = 0; t < rows; ++t) {
    if (j < kCols) tok[j] = (c0 + j < n_cols) ? aln[(size_t)t * n_cols + c0 + j] : 0;
    __syncthreads();

    // ---- layer 1: hp = h1 @ wh1 + bh1, xp = wi1[token] + bi1
    float hr[kCols], hz[kCols], hn[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) hr[c] = hz[c] = hn[c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < hidden; ++k) {
      const float* w = wh1 + (size_t)k * g;
      const float wr = __ldg(w + j), wz = __ldg(w + hidden + j), wn = __ldg(w + 2 * hidden + j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float hk = h1[c * hidden + k];
        hr[c] = fmaf(hk, wr, hr[c]);
        hz[c] = fmaf(hk, wz, hz[c]);
        hn[c] = fmaf(hk, wn, hn[c]);
      }
    }
    float h1_new[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      // a class outside [0, 22) one-hots to zeros, as in the JAX kernel
      const bool in_range = (unsigned)tok[c] < (unsigned)kClasses;
      const float* x = wi1 + (size_t)(in_range ? tok[c] : 0) * g;
      const float xr = (in_range ? __ldg(x + j) : 0.0f) + bi1[j];
      const float xz = (in_range ? __ldg(x + hidden + j) : 0.0f) + bi1[hidden + j];
      const float xn = (in_range ? __ldg(x + 2 * hidden + j) : 0.0f) + bi1[2 * hidden + j];
      const float r = sigmoid(xr + (hr[c] + bh1[j]));
      const float z = sigmoid(xz + (hz[c] + bh1[hidden + j]));
      const float n = tanhf(xn + r * (hn[c] + bh1[2 * hidden + j]));
      const float h_old = h1[c * hidden + j];
      const float h_upd = (1.0f - z) * n + z * h_old;
      h1_new[c] = (t < col_valid[c]) ? h_upd : h_old;
    }
    __syncthreads();  // every thread is done reading h1
#pragma unroll
    for (int c = 0; c < kCols; ++c) h1[c * hidden + j] = h1_new[c];
    __syncthreads();

    // ---- layer 2: xp = h1 @ wi2 + bi2, hp = h2 @ wh2 + bh2
    float xr[kCols], xz[kCols], xn[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) xr[c] = xz[c] = xn[c] = hr[c] = hz[c] = hn[c] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < hidden; ++k) {
      const float* wi = wi2 + (size_t)k * g;
      const float* wh = wh2 + (size_t)k * g;
      const float ir = __ldg(wi + j), iz = __ldg(wi + hidden + j), in = __ldg(wi + 2 * hidden + j);
      const float wr = __ldg(wh + j), wz = __ldg(wh + hidden + j), wn = __ldg(wh + 2 * hidden + j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float a = h1[c * hidden + k];
        const float b = h2[c * hidden + k];
        xr[c] = fmaf(a, ir, xr[c]);
        xz[c] = fmaf(a, iz, xz[c]);
        xn[c] = fmaf(a, in, xn[c]);
        hr[c] = fmaf(b, wr, hr[c]);
        hz[c] = fmaf(b, wz, hz[c]);
        hn[c] = fmaf(b, wn, hn[c]);
      }
    }
    float h2_new[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float r = sigmoid((xr[c] + bi2[j]) + (hr[c] + bh2[j]));
      const float z = sigmoid((xz[c] + bi2[hidden + j]) + (hz[c] + bh2[hidden + j]));
      const float n = tanhf((xn[c] + bi2[2 * hidden + j]) + r * (hn[c] + bh2[2 * hidden + j]));
      const float h_old = h2[c * hidden + j];
      const float h_upd = (1.0f - z) * n + z * h_old;
      h2_new[c] = (t < col_valid[c]) ? h_upd : h_old;
    }
    __syncthreads();  // every thread is done reading h1 and h2
#pragma unroll
    for (int c = 0; c < kCols; ++c) h2[c * hidden + j] = h2_new[c];
    // the next row's first __syncthreads orders these writes before any read
  }
  __syncthreads();
  for (int c = 0; c < kCols; ++c) {
    if (c0 + c < n_cols) out[(size_t)(c0 + c) * hidden + j] = h2[c * hidden + j];
  }
}

}  // namespace

// aln: (n_rows, n_cols) int32; valid: (n_cols,) int32; wi1: (22, 3H);
// wh1, wi2, wh2: (H, 3H); biases: (3H,); out: (n_cols, H). All contiguous.
extern "C" int vgru_final_cols(const int* aln, const int* valid, int n_rows, int n_cols,
                               int hidden, const float* wi1, const float* wh1,
                               const float* wi2, const float* wh2, const float* bi1,
                               const float* bh1, const float* bi2, const float* bh2,
                               float* out, void* stream) {
  if (hidden % 32 != 0 || hidden > 512 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const int smem = 2 * kCols * hidden * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(vgru_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_cols + kCols - 1) / kCols;
  vgru_kernel<<<blocks, hidden, smem, (cudaStream_t)stream>>>(
      aln, valid, n_rows, n_cols, hidden, wi1, wh1, wi2, wh2, bi1, bh1, bi2, bh2, out);
  return (int)cudaGetLastError();
}
