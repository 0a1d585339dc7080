// Kernel K1: fused Harris corner response for a stack of grayscale images.
//
// Replaces: sfm_tpu/ops/harris.py, _harris_kernel (the Pallas TPU kernel
// launched by harris_response).  Computes, per pixel, Sobel Ix and Iy with
// unnormalized taps, 3x3 box sums of Ix^2, Iy^2 and Ix*Iy, and
// R = det - k * trace^2.
//
// Border convention: exactly the plain version (_harris_math in
// ops/harris.py): every neighbour outside the image is zero, for the gray
// values AND for the gradient products the box sums read.  The TPU kernel
// additionally forced columns 0, 1, W-2, W-1 to zero; that is not carried
// over, because detect_corners thresholds against the max over the whole
// image.
//
// Bounds on Hopper: memory.  One f32 read and one f32 write per pixel
// (about 118 MB at 48 x 480 x 640) against ~60 flops per pixel.  Design: one
// pass.  Each 256-thread block loads a 16 x 32 output tile plus a 2-pixel
// halo into shared memory (zero fill outside the image), forms the three
// gradient products on the (tile+2)^2 ring, then box-sums and writes R.
// The halo re-read costs 1.4x the tile's bytes.
//
// Rounding: for integer gray values (0..255, as the pipeline feeds) the
// Sobel and box sums are exact in f32; only det and R round.  They are two
// explicit fused multiply-adds, det = fma(sxx, syy, -round(sxy^2)) and
// R = fma(-round(k trace), trace, det) -- the rounding of the JAX package's
// _harris_math as XLA:CPU compiles it, and of the plain PyTorch version --
// and every other operation is an explicit round-to-nearest intrinsic
// (built with -fmad=false), so the response is bit-equal to the plain
// version on the card.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // output tile width
constexpr int TY = 16;  // output tile height

__device__ __forceinline__ float sum3x3(const float (*p)[TX + 2], int r, int c) {
  // _box3's order: top row, middle row, bottom row, left to right.
  float s = p[r][c];
  s = __fadd_rn(s, p[r][c + 1]);
  s = __fadd_rn(s, p[r][c + 2]);
  s = __fadd_rn(s, p[r + 1][c]);
  s = __fadd_rn(s, p[r + 1][c + 1]);
  s = __fadd_rn(s, p[r + 1][c + 2]);
  s = __fadd_rn(s, p[r + 2][c]);
  s = __fadd_rn(s, p[r + 2][c + 1]);
  s = __fadd_rn(s, p[r + 2][c + 2]);
  return s;
}

__global__ void harris_kernel(const float* __restrict__ img,
                              float* __restrict__ out, int h, int w, float k) {
  __shared__ float g[TY + 4][TX + 4];
  __shared__ float pxx[TY + 2][TX + 2];
  __shared__ float pyy[TY + 2][TX + 2];
  __shared__ float pxy[TY + 2][TX + 2];

  const size_t plane = static_cast<size_t>(h) * w;
  const float* im = img + blockIdx.z * plane;
  float* o = out + blockIdx.z * plane;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < (TY + 4) * (TX + 4); i += nthreads) {
    const int r = i / (TX + 4), c = i % (TX + 4);
    const int y = y0 - 2 + r, x = x0 - 2 + c;
    g[r][c] = (y >= 0 && y < h && x >= 0 && x < w)
                  ? im[static_cast<size_t>(y) * w + x] : 0.0f;
  }
  __syncthreads();

  // Gradient products on the ring; pixel (y0-1+r, x0-1+c) sits at
  // g[r+1][c+1].  Products outside the image are zero (the box sums'
  // zero fill).
  for (int i = tid; i < (TY + 2) * (TX + 2); i += nthreads) {
    const int r = i / (TX + 2), c = i % (TX + 2);
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float xx = 0.0f, yy = 0.0f, xy = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float tl = g[r][c], tc = g[r][c + 1], tr = g[r][c + 2];
      const float ml = g[r + 1][c], mr = g[r + 1][c + 2];
      const float bl = g[r + 2][c], bc = g[r + 2][c + 1], br = g[r + 2][c + 2];
      // ix = (tr + 2 mr + br) - (tl + 2 ml + bl); iy likewise.
      const float ix = __fsub_rn(
          __fadd_rn(__fadd_rn(tr, __fmul_rn(2.0f, mr)), br),
          __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, ml)), bl));
      const float iy = __fsub_rn(
          __fadd_rn(__fadd_rn(bl, __fmul_rn(2.0f, bc)), br),
          __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, tc)), tr));
      xx = __fmul_rn(ix, ix);
      yy = __fmul_rn(iy, iy);
      xy = __fmul_rn(ix, iy);
    }
    pxx[r][c] = xx;
    pyy[r][c] = yy;
    pxy[r][c] = xy;
  }
  __syncthreads();

  for (int i = tid; i < TY * TX; i += nthreads) {
    const int r = i / TX, c = i % TX;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float sxx = sum3x3(pxx, r, c);
    const float syy = sum3x3(pyy, r, c);
    const float sxy = sum3x3(pxy, r, c);
    const float det = __fmaf_rn(sxx, syy, -__fmul_rn(sxy, sxy));
    const float trace = __fadd_rn(sxx, syy);
    o[static_cast<size_t>(y) * w + x] =
        __fmaf_rn(-__fmul_rn(k, trace), trace, det);
  }
}

}  // namespace

extern "C" int harris_response_f32(const float* img, float* out, int n, int h,
                                   int w, float k, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, n);
  harris_kernel<<<grid, block, 0, stream>>>(img, out, h, w, k);
  return static_cast<int>(cudaGetLastError());
}
