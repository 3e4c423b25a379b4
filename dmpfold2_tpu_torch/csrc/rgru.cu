// Residue GRU: one biGRU layer (both directions) or one layer-direction over
// a precomputed input projection, in one launch.
//
// Replaces the TPU kernel dmpfold2_tpu/kernels/rgru.py:gru_seq_pallas (its
// _kernel). Input xproj = x @ W_i + b_i, (T, B, 3H) per direction, computed
// outside by torch.matmul; this kernel runs the recurrence h' = GRU(xproj[t],
// h) for every step and writes every step's state. Masking per batch column:
// a forward pass freezes the state once t >= valid; a reverse pass holds it
// at zero there, so the first valid step sees a fresh zero state.
//
// What bounds it on an H100: the dependent chain. Each step needs the whole
// previous state, so the T steps run one after another, and each is a GEMV
// (B x H) @ (H x 3H) over W_hh (768 KB of fp32 at H 256). The FLOPs and bytes
// would take well under a microsecond at the card's peaks. W_hh does not fit
// one SM: streamed from L2 into one SM at every step, it takes about 7 us a
// step at that SM's L2 port, so the weights are spread over several SMs.
//
// Design (Hopper): a thread-block cluster of 8 CTAs per direction (and per
// chunk of up to 8 batch columns); the two directions are two clusters of
// the same launch (grid z).
//   * CTA r owns the hidden units [r U, (r + 1) U), U = H / 8. Its 3U gate
//     columns of W_hh (96 KB at H 256) are loaded once into registers, 64
//     floats a thread: thread (column, s) holds the column's rows k = 4 (s +
//     4 q) + e. Shared memory would bound a step at 96 KB / 128 B per clock;
//     registers leave only the state to read, as float4 broadcasts.
//   * Each CTA keeps the whole state of its columns in shared memory, double
//     buffered. Per step: the 3U x H products (4 partial sums a thread, 2
//     shuffles), one CTA barrier, the gates for the CTA's U units, and the
//     new values stored into every CTA's next buffer through distributed
//     shared memory (map_shared_rank) and to global memory; then one cluster
//     barrier (arrive.release / wait.acquire) makes the stores visible.
//     Double buffering makes that one barrier enough: a CTA writes a buffer
//     only after every CTA has passed the barrier that ends its reads.
//   * xproj for the next step is loaded into registers while the current
//     step runs.
//   * Steps where every column of the cluster is masked skip the product
//     and the barrier: the masking rule alone gives the state.
//   * A single column (B 1, the fold) has its own instantiation: the
//     8-column one took 0.240 ms a layer there against 0.110 ms.
// What bounds it now: the latency of each step's chain (products, CTA
// barrier, gates, DSMEM stores, cluster barrier): on an H100 a biGRU layer
// at T 88, B 1, H 256 takes 0.109 ms, 1.33 us per valid step (82), against
// well under a microsecond of FLOPs and bytes for the whole layer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRanks = 8;      // CTAs per cluster: the hidden units split 8 ways
constexpr int kSlices = 4;     // threads (k slices) per gate column
constexpr int kMaxHidden = 256;
constexpr int kMaxQ = kMaxHidden / (4 * kSlices);  // float4 weight groups a thread
constexpr int kMaxThreads = 3 * (kMaxHidden / kRanks) * kSlices;  // 384

struct Dir {
  const float* xproj;  // (T, B, 3H)
  const float* wh;     // (H, 3H)
  const float* bh;     // (3H,)
  float* out;          // out + this direction's column offset; rows of out_stride
  int reverse;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

int threads_for(int hidden) { return (3 * (hidden / kRanks) * kSlices + 31) / 32 * 32; }

template <int kCols>
int smem_for(int hidden) {
  return (2 * kCols * hidden + kCols * 3 * (hidden / kRanks)) * (int)sizeof(float);
}

template <int kCols>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rgru_cluster_kernel(Dir d0, Dir d1, const int* __restrict__ valid, int seq_len, int batch,
                        int hidden, int out_stride) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Dir d = blockIdx.z ? d1 : d0;
  const int H = hidden, U = H / kRanks, G = 3 * U, g3 = 3 * H, nq = H / (4 * kSlices);
  const int b0 = blockIdx.y * kCols;
  const int cols = min(kCols, batch - b0);
  float* buf = smem;                 // [2][kCols][H] state, double-buffered
  float* hs = smem + 2 * kCols * H;  // [kCols][G] the step's recurrent sums

  const int tid = threadIdx.x, lane = tid & 31;
  const int s = lane & (kSlices - 1);
  const int col = (tid >> 5) * (32 / kSlices) + lane / kSlices;  // gate column in the CTA
  const bool has_col = col < G;
  const int wcol = has_col ? (col / U) * H + rank * U + col % U : 0;  // its column of W_hh

  float4 w[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    w[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (has_col && q < nq) {
      const float* src = d.wh + (size_t)(4 * (s + kSlices * q)) * g3 + wcol;
      w[q] = make_float4(__ldg(src), __ldg(src + g3), __ldg(src + 2 * g3), __ldg(src + 3 * g3));
    }
  }
  int vc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) vc[c] = c < cols ? valid[b0 + c] : 0;

  // the gate phase: thread (gc, gu) updates unit j = rank U + gu of column gc
  const bool gate_thread = tid < cols * U;
  const int gc = gate_thread ? tid / U : 0, gu = tid % U, gj = rank * U + gu;
  float bhr = 0.0f, bhz = 0.0f, bhn = 0.0f, xr = 0.0f, xz = 0.0f, xn = 0.0f;
  auto load_x = [&](int t) {
    const float* xp = d.xproj + ((size_t)t * batch + b0 + gc) * g3 + gj;
    xr = __ldg(xp);
    xz = __ldg(xp + H);
    xn = __ldg(xp + 2 * H);
  };
  if (gate_thread) {
    bhr = __ldg(d.bh + gj);
    bhz = __ldg(d.bh + H + gj);
    bhn = __ldg(d.bh + 2 * H + gj);
    load_x(d.reverse ? seq_len - 1 : 0);
  }

  for (int i = tid; i < 2 * kCols * H; i += blockDim.x) buf[i] = 0.0f;
  cluster.sync();  // every CTA of the cluster runs and holds a zero state

  int p = 0;
  for (int step = 0; step < seq_len; ++step) {
    const int t = d.reverse ? seq_len - 1 - step : step;
    bool any = false;
#pragma unroll
    for (int c = 0; c < kCols; ++c) any |= t < vc[c];
    const float* cur = buf + p * kCols * H;
    float* out_row = d.out + ((size_t)t * batch + b0 + gc) * out_stride + gj;

    if (any) {  // uniform across the cluster
      float acc[kCols][4];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q < nq) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (c < cols) {
              const float4 h4 =
                  *reinterpret_cast<const float4*>(cur + c * H + 4 * (s + kSlices * q));
              acc[c][0] = fmaf(h4.x, w[q].x, acc[c][0]);
              acc[c][1] = fmaf(h4.y, w[q].y, acc[c][1]);
              acc[c][2] = fmaf(h4.z, w[q].z, acc[c][2]);
              acc[c][3] = fmaf(h4.w, w[q].w, acc[c][3]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float v = (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (s == 0 && has_col && c < cols) hs[c * G + col] = v;
      }
      __syncthreads();  // the step's sums are in hs

      if (gate_thread) {
        const float h_old = cur[gc * H + gj];
        float hv;
        if (t < vc[gc]) {
          const float* hsc = hs + gc * G + gu;
          const float r = sigmoid(xr + (hsc[0] + bhr));
          const float z = sigmoid(xz + (hsc[U] + bhz));
          const float n = tanhf(xn + r * (hsc[2 * U] + bhn));
          hv = (1.0f - z) * n + z * h_old;
        } else {
          hv = d.reverse ? 0.0f : h_old;
        }
        float* next = buf + (p ^ 1) * kCols * H + gc * H + gj;
#pragma unroll
        for (int r = 0; r < kRanks; ++r) *cluster.map_shared_rank(next, r) = hv;
        *out_row = hv;
      }
      p ^= 1;
      cluster_barrier();  // the new state is in every CTA; hs and cur are free
    } else if (gate_thread) {
      // every column of the cluster lies past its length: a forward pass
      // keeps its state, a reverse pass holds zero
      *out_row = d.reverse ? 0.0f : cur[gc * H + gj];
    }
    if (gate_thread && step + 1 < seq_len) load_x(d.reverse ? t - 1 : t + 1);
  }
  cluster.sync();  // no CTA exits while another may still store into it
}

// Per device and kernel, once: whether one cluster of the largest
// configuration (H 256) can be resident.
constexpr int kMaxDevices = 64;

template <int kCols>
int check_cluster_fits() {
  static int state[kMaxDevices] = {};  // 0 unknown, 1 fits, else the error code
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (state[dev] == 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kRanks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kRanks, 1, 1);
    cfg.blockDim = dim3(threads_for(kMaxHidden), 1, 1);
    cfg.dynamicSmemBytes = smem_for<kCols>(kMaxHidden);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, rgru_cluster_kernel<kCols>, &cfg);
    if (e != cudaSuccess) return (int)e;
    state[dev] = clusters >= 1 ? 1 : (int)cudaErrorLaunchOutOfResources;
  }
  return state[dev] == 1 ? 0 : state[dev];
}

template <int kCols>
int launch(Dir d0, Dir d1, const int* valid, int seq_len, int batch, int hidden, int dirs,
           int out_stride, cudaStream_t stream) {
  const int fits = check_cluster_fits<kCols>();
  if (fits != 0) return fits;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kRanks, (batch + kCols - 1) / kCols, dirs);
  cfg.blockDim = dim3(threads_for(hidden), 1, 1);
  cfg.dynamicSmemBytes = smem_for<kCols>(hidden);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, rgru_cluster_kernel<kCols>, d0, d1, valid, seq_len,
                                     batch, hidden, out_stride);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for `dirs` layer-directions (1 or 2) of one layer.
// xproj_*: (T, B, 3H); wh_*: (H, 3H); bh_*: (3H,); valid: (B,) int32; all
// contiguous fp32 except valid. dirs 1: (xproj_f, wh_f, bh_f) with reverse
// = first_reverse into out (T, B, H). dirs 2: the forward pass (the *_f
// arguments) into out[..., :H] and the reverse pass (*_b) into out[..., H:]
// of out (T, B, 2H). H must be a multiple of 32 and at most 256. Returns a
// CUDA error code (cudaErrorLaunchOutOfResources when the card cannot hold
// one cluster of 8 blocks).
extern "C" int rgru_seq(const void* xproj_f, const void* xproj_b, const void* wh_f,
                        const void* wh_b, const void* bh_f, const void* bh_b, const void* valid,
                        void* out, int seq_len, int batch, int hidden, int dirs,
                        int first_reverse, void* stream) {
  if (hidden % 32 != 0 || hidden <= 0 || hidden > kMaxHidden || batch <= 0 || seq_len <= 0 ||
      (dirs != 1 && dirs != 2) || batch > 65535 * 8)
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  const int out_stride = dirs * hidden;
  Dir d0{static_cast<const float*>(xproj_f), static_cast<const float*>(wh_f),
         static_cast<const float*>(bh_f), o, dirs == 2 ? 0 : first_reverse};
  Dir d1{static_cast<const float*>(xproj_b), static_cast<const float*>(wh_b),
         static_cast<const float*>(bh_b), o + hidden, 1};
  const int* v = static_cast<const int*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return launch<1>(d0, d1, v, seq_len, batch, hidden, dirs, out_stride, s);
  return launch<8>(d0, d1, v, seq_len, batch, hidden, dirs, out_stride, s);
}
