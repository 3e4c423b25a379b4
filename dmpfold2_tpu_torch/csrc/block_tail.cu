// The bf16 trunk's residual block tail: sSE, InstanceNorm, cSE gate,
// residual and mask, in one pass over the map.
//
// Replaces no TPU kernel: the JAX package leaves this tail of
// dmpfold2_tpu/models/trunk.py:_resnet_block_fused_norm to XLA, which fuses
// it into one read of (z, x, mask) and one write. Per target b and pixel q,
// from the conv's bf16 maxout z, the carry x, the bf16 mask and the norm's
// fp32 (scale, shift):
//   w_eff[c]  = bf16(scale[b, c] * sse_w[c])            (rounded as JAX does)
//   s_bias    = sum_c shift[b, c] * sse_w[c] + sse_b
//   s[q]      = sum_c z[q, c] * w_eff[c] + s_bias
//   out[q, c] = bf16(((z[q, c] * scale[b, c] + shift[b, c])
//                     * (cse_gate[c] + sigmoid(s[q]))) + x[q, c]) * mask[q]
// Each product and sum is rounded on its own (no contraction), as the
// elementwise chain computes it; only the two channel sums are in this
// kernel's own fixed order: each of 16 lanes takes 8 channels in order, then
// a 4-step xor-shuffle tree. Per pixel, so a row slab gives the unsharded
// rows' bits.
//
// What bounds it on an H100: bytes. Per pixel it reads z and x (256 bytes
// each) and the mask (2) and writes 256: 770 bytes and about 1.2 kFLOP, so
// at 1 x 736^2 pixels 417 MB, 0.125 ms at 3.35 TB/s. So no fp32 map reaches
// device memory, and the design keeps enough loads in flight:
//   * 16 lanes a pixel, one 16-byte load of z and of x each (8 channels),
//     with the streaming cache hint (read once), and a streaming 16-byte
//     store; a 256-thread block holds 16 pixels a step, 4 steps unrolled, so
//     each thread has 8 loads outstanding;
//   * grid (blocks, B): a block walks one target's pixels, strided by the
//     grid, so the per-target constants (w_eff, s_bias and each lane's 8
//     scales, shifts and gates) sit in registers; blocks per target from the
//     SM count and the occupancy, one wave;
//   * a pixel whose mask is 0 writes zeros without reading z or x, so padded
//     rows cost a third of the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                    // channels: the conv's maxout width
constexpr int kLanes = 16;                 // lanes a pixel
constexpr int kVec = kC / kLanes;          // 8 channels a lane: one 16-byte load
constexpr int kThreads = 256;
constexpr int kPixPerStep = kThreads / kLanes;  // 16 pixels a block step
constexpr int kUnroll = 4;                 // steps in flight
constexpr int kChunk = kPixPerStep * kUnroll;   // 64 pixels a block iteration
static_assert(kVec == 8, "one uint4 of bf16 a lane");

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// The sum over a pixel's 16 lanes, in a fixed order; every lane gets the
// same bits (each step adds two values that commute).
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
block_tail_kernel(const uint4* __restrict__ z, const uint4* __restrict__ x,
                  const unsigned short* __restrict__ mask, const float* __restrict__ scale,
                  const float* __restrict__ shift, const float* __restrict__ sse_w,
                  const float* __restrict__ sse_b, const float* __restrict__ cse_gate,
                  uint4* __restrict__ out, long long npix) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const int c0 = lane * kVec;

  // per-target constants, once a block
  float sc[kVec], sh[kVec], we[kVec], gt[kVec];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float w = sse_w[c0 + i];
    sc[i] = scale[b * kC + c0 + i];
    sh[i] = shift[b * kC + c0 + i];
    gt[i] = cse_gate[c0 + i];
    we[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(sc[i], w)));
    part = __fmaf_rn(sh[i], w, part);
  }
  const float s_bias = __fadd_rn(lane_sum(part), sse_b[0]);

  const long long first = (long long)b * npix;  // the target's first pixel
  const long long stride = (long long)gridDim.x * kChunk;
  for (long long base = (long long)blockIdx.x * kChunk; base < npix; base += stride) {
    float m[kUnroll];
    uint4 zv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + u * kPixPerStep + slot;
      m[u] = p < npix ? __uint_as_float((uint32_t)__ldg(mask + first + p) << 16) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      zv[u] = xv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (m[u] != 0.f) {
        const long long q = (first + base + u * kPixPerStep + slot) * kLanes + lane;
        zv[u] = __ldcs(z + q);
        xv[u] = __ldcs(x + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float zf[kVec], xf[kVec];
      unpack(zv[u], zf);
      unpack(xv[u], xf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = __fmaf_rn(zf[i], we[i], dot);
      const float s = __fadd_rn(lane_sum(dot), s_bias);
      const float sig = 1.0f / (1.0f + expf(-s));
      float o[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float y = __fadd_rn(__fmul_rn(zf[i], sc[i]), sh[i]);
        const float r = __fadd_rn(__fmul_rn(y, __fadd_rn(gt[i], sig)), xf[i]);
        // the carry rounded to bf16, then masked in bf16
        o[i] = __fmul_rn(__bfloat162float(__float2bfloat16_rn(r)), m[u]);
      }
      const long long p = base + u * kPixPerStep + slot;
      if (p < npix) {
        const uint4 v = m[u] != 0.f
                            ? make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                                         pack2(o[4], o[5]), pack2(o[6], o[7]))
                            : make_uint4(0u, 0u, 0u, 0u);
        __stcs(out + (first + p) * kLanes + lane, v);
      }
    }
  }
}

// Per device, once: the blocks resident at a time, SMs x blocks an SM.
constexpr int kMaxDevices = 64;

int resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_tail_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms <= 0 || per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *blocks = cached[dev];
  return 0;
}

}  // namespace

// z, x, out: (batch, rows, width, channels) bf16; mask: (batch, rows, width)
// bf16; scale, shift: (batch, channels) fp32; sse_w, cse_gate: (channels,)
// fp32; sse_b: (1,) fp32. channels must be 128; z, x and out 16-byte
// aligned. Rows may be a row slab of a larger map: the tail is per pixel.
extern "C" int block_tail(const void* z, const void* x, const void* mask, const float* scale,
                          const float* shift, const float* sse_w, const float* sse_b,
                          const float* cse_gate, void* out, int batch, int rows, int width,
                          int channels, void* stream) {
  if (batch <= 0 || batch > 65535 || rows <= 0 || width <= 0 || channels != kC)
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  const long long npix = (long long)rows * width;
  const long long chunks = (npix + kChunk - 1) / kChunk;
  // rounded down, so the grid is one wave: a block past it would start as
  // the first wave ends and double the time
  long long per_target = resident / batch;
  if (per_target < 1) per_target = 1;
  if (per_target > chunks) per_target = chunks;
  const dim3 grid((unsigned)per_target, (unsigned)batch);
  block_tail_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(z), static_cast<const uint4*>(x),
      static_cast<const unsigned short*>(mask), scale, shift, sse_w, sse_b, cse_gate,
      static_cast<uint4*>(out), npix);
  return (int)cudaGetLastError();
}
