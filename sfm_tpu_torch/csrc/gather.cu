// Kernel K2: slab-gather patch sampler — gather, bilinear-sample and
// normalize one (2*wid+1)^2 patch per sample.
//
// Replaces: sfm_tpu/ops/gather.py, _make_kernel -> kernel (the Pallas TPU
// kernel behind sample_normalized_patches).  Per sample (image, cx, cy):
// base = clip(floor(c) - wid, 0, dim - (2*wid+2)); read the (2*wid+2)^2
// window of the bf16 stack; interpolate with (fx, fy) = frac(c); subtract
// the mean; divide by max(||.||_2, 1e-8); write bf16.  The in-bounds mask is
// computed by the wrapper, as in the JAX package.
//
// Bounds on Hopper: memory latency.  Each sample reads a 12 x 12 bf16
// window (12 rows of 24 bytes) at a data-dependent address and writes 242
// bytes; the arithmetic is ~8 flops per output value.  The TPU kernel DMA'd
// 8-row-aligned slabs into VMEM to beat XLA's per-index gather; on the GPU
// the window is read straight from global memory (the 29 MB stack of a
// 48 x 480 x 640 run sits in the 50 MB L2), so there is no slab, no row /
// lane packing and no sample chunking.  Design: one warp per sample, 4
// samples per 128-thread block; lane j holds output pixels j, j+32, ...;
// the sum and the centred sum of squares are warp-shuffle reductions.
//
// Rounding: the interpolation uses round-to-nearest intrinsics in the
// plain version's expression order (p00 (1-fy)(1-fx) + p01 (1-fy) fx +
// p10 fy (1-fx) + p11 fy fx), so interpolated values equal the plain
// PyTorch version's bit for bit; only the order of the two sums differs,
// which moves the final bf16 value by at most one unit in the last place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSamplesPerBlock = 4;
constexpr int kMaxWid = 8;
constexpr int kPerLane = ((2 * kMaxWid + 1) * (2 * kMaxWid + 1) + 31) / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void gather_kernel(const __nv_bfloat16* __restrict__ gray,
                              const int* __restrict__ img_idx,
                              const float* __restrict__ centers,
                              __nv_bfloat16* __restrict__ out, int m, int n,
                              int h, int w, int wid) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kSamplesPerBlock + (threadIdx.x >> 5);
  if (s >= m) return;  // uniform per warp
  const int side = 2 * wid + 1;
  const int win = side + 1;
  const int npix = side * side;

  const float x = centers[2 * s];
  const float y = centers[2 * s + 1];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = __fsub_rn(x, x0);
  const float fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int bx = min(max(static_cast<int>(x0) - wid, 0), w - win);
  const int by = min(max(static_cast<int>(y0) - wid, 0), h - win);
  const int img = min(max(img_idx[s], 0), n - 1);
  const __nv_bfloat16* base =
      gray + (static_cast<size_t>(img) * h + by) * w + bx;

  float v[kPerLane];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = lane + 32 * j;
    v[j] = 0.0f;
    if (p < npix) {
      const int r = p / side, c = p - (p / side) * side;
      const __nv_bfloat16* q = base + static_cast<size_t>(r) * w + c;
      const float p00 = __bfloat162float(q[0]);
      const float p01 = __bfloat162float(q[1]);
      const float p10 = __bfloat162float(q[w]);
      const float p11 = __bfloat162float(q[w + 1]);
      float a = __fmul_rn(__fmul_rn(p00, gy), gx);
      a = __fadd_rn(a, __fmul_rn(__fmul_rn(p01, gy), fx));
      a = __fadd_rn(a, __fmul_rn(__fmul_rn(p10, fy), gx));
      a = __fadd_rn(a, __fmul_rn(__fmul_rn(p11, fy), fx));
      v[j] = a;
      sum = __fadd_rn(sum, a);
    }
  }
  // mean = sum * (1/npix), as the plain version (and XLA's jnp.mean) take it.
  const float mean = __fmul_rn(warp_sum(sum), __frcp_rn(static_cast<float>(npix)));
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (lane + 32 * j < npix) {
      v[j] = __fsub_rn(v[j], mean);
      ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  }
  const float nrm = fmaxf(__fsqrt_rn(warp_sum(ss)), 1e-8f);
  __nv_bfloat16* o = out + static_cast<size_t>(s) * npix;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = lane + 32 * j;
    if (p < npix) o[p] = __float2bfloat16_rn(__fdiv_rn(v[j], nrm));
  }
}

}  // namespace

extern "C" int sample_normalized_patches_bf16(
    const void* gray, const int* img_idx, const float* centers, void* out,
    int m, int n, int h, int w, int wid, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || wid < 0 || wid > kMaxWid || h < 2 * wid + 2 ||
      w < 2 * wid + 2)
    return cudaErrorInvalidValue;
  const int blocks = (m + kSamplesPerBlock - 1) / kSamplesPerBlock;
  gather_kernel<<<blocks, 32 * kSamplesPerBlock, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(gray), img_idx, centers,
      static_cast<__nv_bfloat16*>(out), m, n, h, w, wid);
  return static_cast<int>(cudaGetLastError());
}
