// Vertical GRU: the 2-layer GRU scanned over MSA rows, final state of layer 2.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/vgru.py:vgru_final_cols_pallas
// (its _kernel). For each column (a residue position) the state of both
// layers runs over the alignment rows; a column freezes once the row index
// reaches its own valid depth. Layer 0's input is one-hot(22), so its input
// projection is a row gather of wi1 plus bi1, with no product.
//
// What bounds it on an H100: the rows are sequential, and every row needs
// all three 512 x 1536 fp32 matrices (wh1, wi2, wh2; 9.4 MB). The arithmetic
// is 3 * 2 * 512 * 1536 FLOP per row and column: 104.6 GFLOP for PF10963
// (252 rows x 88 columns), 1.56 ms at the 67 TFLOP/s fp32 peak. With the
// row loop inside blocks that own columns, 88 columns fill few SMs and each
// block pulls the 9.4 MB from L2 for every row.
//
// Design: one persistent cooperative grid, the hidden units split across
// it, the weights resident in shared memory for the whole scan.
//   * Block b owns kUnits = 4 hidden units j0 = 4b .. 4b + 3: the 3 gates x
//     4 units of wh1, wi2 and wh2 over all H rows k (3 * 512 * 12 * 4 B =
//     72 KB), its 22 x 12 slice of wi1 and its biases. H / 4 = 128 blocks at
//     H = 512, one per SM; the 9.4 MB then cross L2 once per launch.
//   * The hidden states of both layers live in global memory, k-major
//     ([H][C], 180 KB per layer at C = 88, L2-resident), double-buffered by
//     phase parity. A block writes only its own units' rows and reads every
//     row after a grid barrier, with ld.global.cg (through L2, never the
//     non-coherent path, which may hold a line another SM has since
//     rewritten).
//   * A wavefront: phase p computes layer 1 at row p and layer 2 at row
//     p - 1; both read h1(p - 1), layer 2 also h2(p - 2). So one grid
//     barrier per row: rows + 1 in all (253 for PF10963), the first after the
//     buffers are zeroed.
//   * In a phase, warp w sums over its slice k in [w H / 8, (w + 1) H / 8)
//     for 96 columns (3 per lane: lane, lane + 32, lane + 64) and all 36
//     gate sums of the block's units, the weights read as float4
//     broadcasts from shared memory. The states of 4 rows k load together
//     (one L2 round trip per 4 rows), and the loop is unrolled by 2 so that
//     the next batch's loads can issue before this batch's products. The 8
//     slices are then added in a fixed order through shared memory (no
//     atomics: a second launch gives the same bits) and each (unit, column)
//     finishes its gates from inputs (token, depth, old states) loaded at
//     the start of the phase. Wider C loops over chunks of 96 columns inside
//     the block.
//   * The early end at the deepest column and the per-column freeze (t <
//     valid[c]) are as in the first port.
// Sizing at 256 x 88, H 512 (before measuring): a block does 3.2 MFLOP per
// phase, about 7 us at one SM's fp32 rate (9 us with the 88-of-96 column
// slots); it reads 360 KB of states per phase from L2, 46 MB across the
// grid; a grid barrier costs 1-2 us. Expected 3-5 ms for the 253 phases.
// Measured (PERF.md): about 4.9 ms, some 19 us per phase against the 9 us of
// products sized above; the rest is L2 latency in the state loads and the
// finalize, which 8 warps of 250 registers cannot hide, and the barrier.
// Tried and dropped: a cp.async ring of states in shared memory, and
// register double-buffering of the loads: both slower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClasses = 22;             // residue classes of the one-hot input
constexpr int kUnits = 4;                // hidden units per block
constexpr int kGateCols = 3 * kUnits;    // r, z, n gates of the block's units
constexpr int kSums = 3 * kGateCols;     // per column: wh1, wi2, wh2 gate sums
constexpr int kThreads = 256;
constexpr int kSlices = kThreads / 32;   // k slices, one per warp
constexpr int kColsPerLane = 3;
constexpr int kChunk = 32 * kColsPerLane;  // columns per pass
constexpr int kBatch = 4;                // k rows whose states load together
constexpr int kPairs = (kUnits * kChunk + kThreads - 1) / kThreads;  // per thread
static_assert(kSums % 4 == 0, "weights are read as float4");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Shared memory, in floats: w[H][kSums] (column m * 12 + g * 4 + u: matrix m
// of wh1, wi2, wh2; gate g; unit u), wi1[22][12], biases 4 x 12, then
// red[kSlices][kSums][kChunk].
__host__ __device__ constexpr int smem_floats(int hidden) {
  return hidden * kSums + kClasses * kGateCols + 4 * kGateCols + kSlices * kSums * kChunk;
}

__global__ void __launch_bounds__(kThreads, 1) vgru_kernel(
    const int* __restrict__ aln, const int* __restrict__ valid, int n_rows, int n_cols,
    int hidden,
    const float* __restrict__ wi1, const float* __restrict__ wh1,
    const float* __restrict__ wi2, const float* __restrict__ wh2,
    const float* __restrict__ bi1, const float* __restrict__ bh1,
    const float* __restrict__ bi2, const float* __restrict__ bh2,
    float* __restrict__ state, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* wi1_s = w_s + hidden * kSums;
  float* b_s = wi1_s + kClasses * kGateCols;  // bi1, bh1, bi2, bh2: 12 each
  float* red = b_s + 4 * kGateCols;
  __shared__ int rows_s;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = blockIdx.x * kUnits;
  const int g3 = 3 * hidden;
  const size_t plane = (size_t)hidden * n_cols;
  // state: h1 parity 0, h1 parity 1, h2 parity 0, h2 parity 1, each [H][C]
  float* h1buf[2] = {state, state + plane};
  float* h2buf[2] = {state + 2 * plane, state + 3 * plane};

  // ---- this block's weights to shared memory, once
  const float* mats[3] = {wh1, wi2, wh2};
  for (int v = tid; v < hidden * kSums; v += kThreads) {
    const int k = v / kSums, col = v % kSums;
    const int m = col / kGateCols, g = (col % kGateCols) / kUnits, u = col % kUnits;
    w_s[v] = mats[m][(size_t)k * g3 + g * hidden + j0 + u];
  }
  for (int v = tid; v < kClasses * kGateCols; v += kThreads) {
    const int cls = v / kGateCols, g = (v % kGateCols) / kUnits, u = v % kUnits;
    wi1_s[v] = wi1[(size_t)cls * g3 + g * hidden + j0 + u];
  }
  if (tid < 4 * kGateCols) {
    const float* bs[4] = {bi1, bh1, bi2, bh2};
    const int g = (tid % kGateCols) / kUnits, u = tid % kUnits;
    b_s[tid] = bs[tid / kGateCols][g * hidden + j0 + u];
  }
  // the own units' rows of every state buffer start at zero
  for (int v = tid; v < kUnits * n_cols; v += kThreads) {
    const size_t o = (size_t)(j0 + v / n_cols) * n_cols + v % n_cols;
    h1buf[0][o] = h1buf[1][o] = h2buf[0][o] = h2buf[1][o] = 0.0f;
  }
  // rows past every column's depth change nothing: stop there
  if (tid == 0) rows_s = 0;
  __syncthreads();
  int deepest = 0;
  for (int c = tid; c < n_cols; c += kThreads) deepest = max(deepest, valid[c]);
  atomicMax(&rows_s, deepest);  // a maximum: the same in any order
  __syncthreads();
  const int rows = min(rows_s, n_rows);
  grid.sync();

  const int slice = hidden / kSlices;
  const int k0 = warp * slice;
  for (int p = 0; p <= rows; ++p) {
    const float* h1_prev = h1buf[(p + 1) & 1];
    const float* h2_prev = h2buf[(p + 1) & 1];
    float* h1_next = h1buf[p & 1];
    float* h2_next = h2buf[p & 1];
    for (int c0 = 0; c0 < n_cols; c0 += kChunk) {
      // the finalize inputs of this thread's (unit, column) pairs, loaded
      // first so that their latency hides behind the products
      int tokp[kPairs], depthp[kPairs];
      float h1p[kPairs], h2p[kPairs];
#pragma unroll
      for (int e = 0; e < kPairs; ++e) {
        const int v = tid + e * kThreads, c = c0 + v % kChunk;
        const bool mine = v < kUnits * kChunk && c < n_cols;
        const size_t o = (size_t)(j0 + v / kChunk) * n_cols + c;
        tokp[e] = (mine && p < rows) ? aln[(size_t)p * n_cols + c] : 0;
        depthp[e] = mine ? valid[c] : 0;
        h1p[e] = mine ? __ldcg(h1_prev + o) : 0.0f;
        h2p[e] = mine ? __ldcg(h2_prev + o) : 0.0f;
      }
      // ---- partial gate sums over this warp's k slice
      float acc[kColsPerLane][kSums];
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i)
#pragma unroll
        for (int o = 0; o < kSums; ++o) acc[i][o] = 0.0f;
      int cols[kColsPerLane];
      bool live[kColsPerLane];
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        cols[i] = c0 + lane + 32 * i;
        live[i] = cols[i] < n_cols;
      }
      // the states of kBatch rows k are loaded together: one L2 round trip
      // for kBatch rows of products
#pragma unroll 2
      for (int kb = k0; kb < k0 + slice; kb += kBatch) {
        float a[kBatch][kColsPerLane], b[kBatch][kColsPerLane];
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
#pragma unroll
          for (int i = 0; i < kColsPerLane; ++i) {
            const size_t o = (size_t)(kb + r) * n_cols + cols[i];
            a[r][i] = live[i] ? __ldcg(h1_prev + o) : 0.0f;
            b[r][i] = live[i] ? __ldcg(h2_prev + o) : 0.0f;
          }
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const float4* wk = reinterpret_cast<const float4*>(w_s + (kb + r) * kSums);
#pragma unroll
          for (int q = 0; q < kSums / 4; ++q) {
            const float4 wq = wk[q];
            const float ws[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int o = 4 * q + e;
#pragma unroll
              for (int i = 0; i < kColsPerLane; ++i)
                acc[i][o] = fmaf(o < 2 * kGateCols ? a[r][i] : b[r][i], ws[e], acc[i][o]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i)
#pragma unroll
        for (int o = 0; o < kSums; ++o)
          red[(warp * kSums + o) * kChunk + lane + 32 * i] = acc[i][o];
      __syncthreads();

      // ---- each (unit, column): the slices in order, then the gates
#pragma unroll
      for (int e = 0; e < kPairs; ++e) {
        const int v = tid + e * kThreads;
        const int u = v / kChunk, cl = v % kChunk, c = c0 + cl;
        if (v >= kUnits * kChunk || c >= n_cols) continue;
        float s[9];  // wh1 r z n, wi2 r z n, wh2 r z n of unit u
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const int o = (q / 3) * kGateCols + (q % 3) * kUnits + u;
          float t = 0.0f;
          for (int w = 0; w < kSlices; ++w) t += red[(w * kSums + o) * kChunk + cl];
          s[q] = t;
        }
        const int j = j0 + u;
        const size_t o = (size_t)j * n_cols + c;
        const int depth = depthp[e];
        const float h1_old = h1p[e];
        if (p < rows) {  // layer 1 at row p
          const int tok = tokp[e];
          // a class outside [0, 22) one-hots to zeros, as in the JAX kernel
          const bool in_range = (unsigned)tok < (unsigned)kClasses;
          const float* x = wi1_s + (in_range ? tok : 0) * kGateCols;
          const float xr = (in_range ? x[u] : 0.0f) + b_s[u];
          const float xz = (in_range ? x[kUnits + u] : 0.0f) + b_s[kUnits + u];
          const float xn = (in_range ? x[2 * kUnits + u] : 0.0f) + b_s[2 * kUnits + u];
          const float* bh = b_s + kGateCols;
          const float r = sigmoid(xr + (s[0] + bh[u]));
          const float z = sigmoid(xz + (s[1] + bh[kUnits + u]));
          const float n = tanhf(xn + r * (s[2] + bh[2 * kUnits + u]));
          const float h_upd = (1.0f - z) * n + z * h1_old;
          h1_next[o] = (p < depth) ? h_upd : h1_old;
        }
        if (p >= 1) {  // layer 2 at row p - 1, from h1(p - 1) and h2(p - 2)
          const float* bi = b_s + 2 * kGateCols;
          const float* bh = b_s + 3 * kGateCols;
          const float h2_old = h2p[e];
          const float r = sigmoid((s[3] + bi[u]) + (s[6] + bh[u]));
          const float z = sigmoid((s[4] + bi[kUnits + u]) + (s[7] + bh[kUnits + u]));
          const float n = tanhf((s[5] + bi[2 * kUnits + u]) + r * (s[8] + bh[2 * kUnits + u]));
          const float h_upd = (1.0f - z) * n + z * h2_old;
          const float h2 = (p - 1 < depth) ? h_upd : h2_old;
          h2_next[o] = h2;
          if (p == rows) out[(size_t)c * hidden + j] = h2;
        } else if (p == rows) {  // no row at all: the initial state
          out[(size_t)c * hidden + j] = 0.0f;
        }
      }
      __syncthreads();  // red is read before the next chunk rewrites it
    }
    if (p < rows) grid.sync();
  }
}

}  // namespace

// aln: (n_rows, n_cols) int32; valid: (n_cols,) int32; wi1: (22, 3H);
// wh1, wi2, wh2: (H, 3H); biases: (3H,); state: scratch of 4 * H * n_cols
// fp32; out: (n_cols, H). All contiguous. Launched cooperatively with one
// block per 4 hidden units; returns cudaErrorCooperativeLaunchTooLarge when
// those blocks cannot all be resident at once (nothing runs then).
extern "C" int vgru_final_cols(const int* aln, const int* valid, int n_rows, int n_cols,
                               int hidden, const float* wi1, const float* wh1,
                               const float* wi2, const float* wh2, const float* bi1,
                               const float* bh1, const float* bi2, const float* bh2,
                               float* state, float* out, void* stream) {
  static_assert(32 % (kSlices * kBatch) == 0, "a k slice is whole batches");
  if (hidden % 32 != 0 || hidden <= 0 || hidden > 512 || n_cols <= 0 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(hidden) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(vgru_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vgru_kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  const int blocks = hidden / kUnits;
  if (!coop || blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&aln, &valid, &n_rows, &n_cols, &hidden, &wi1, &wh1, &wi2, &wh2,
                  &bi1, &bh1, &bi2, &bh2, &state, &out};
  err = cudaLaunchCooperativeKernel((const void*)vgru_kernel, dim3(blocks), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
