// Kernel K2: slab-gather patch sampler — gather, bilinear-sample and
// normalize one (2*wid+1)^2 patch per sample.
//
// Replaces: sfm_tpu/ops/gather.py, _make_kernel -> kernel (the Pallas TPU
// kernel behind sample_normalized_patches).  Per sample (image, cx, cy):
// base = clip(floor(c) - wid, 0, dim - (2*wid+2)) (taken in float, so any
// centre, NaN and +-inf included, reads inside the stack); read the (2*wid+2)^2
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
// Rounding, the float clamp of the window origin, the interpolation and the
// normalisation are the device functions of gather_common.cuh, shared with
// K3 (gather_tile.cu), which differs only in where a window is read from.

#include "gather_common.cuh"

namespace {

using namespace sfm_gather;

constexpr int kSamplesPerBlock = 4;

__global__ void gather_kernel(const __nv_bfloat16* __restrict__ gray,
                              const int* __restrict__ img_idx,
                              const float* __restrict__ centers,
                              __nv_bfloat16* __restrict__ out, int m, int n,
                              int h, int w, int wid) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kSamplesPerBlock + (threadIdx.x >> 5);
  if (s >= m) return;  // uniform per warp
  const int npix = (2 * wid + 1) * (2 * wid + 1);
  const Window o =
      window_of(img_idx[s], centers[2 * s], centers[2 * s + 1], n, h, w, wid);
  const __nv_bfloat16* base =
      gray + (static_cast<size_t>(o.img) * h + o.by) * w + o.bx;
  interpolate_normalize_store(
      [&](int r, int c) {
        return __bfloat162float(base[static_cast<size_t>(r) * w + c]);
      },
      o.fx, o.fy, wid, lane, out + static_cast<size_t>(s) * npix);
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
