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
// Bounds on Hopper: bytes in the end (one f32 read and one f32 write per
// pixel, about 118 MB at 48 x 480 x 640, against ~50 flops per pixel), but
// the first version of this kernel was bound by shared-memory instructions:
// a 16 x 32 tile staged in shared memory, three passes and two block
// barriers, ~40 shared-memory accesses per pixel: 0.144 ms at that shape on
// an NVIDIA H100 80GB HBM3 at 700 W against a bytes bound of 0.035 ms (this
// version: 0.052 ms; with _box3's order of additions 0.074 ms).
//
// Design: march down the rows in registers, no shared memory, no barrier.
// A warp owns a strip of 128 columns and a band of rows of one image (the
// bands as tall as still fills the card with one resident set of warps); a
// thread owns 4 adjacent columns X..X+3.  Per gray row it makes one 16-byte
// load, takes the two columns on either side from its neighbour lanes by
// shuffle (the strip's edge lanes load them; zero outside the image), forms
// the gradient products at columns X-1..X+4 of the row above and sums them
// three by three; it keeps three gray rows (columns X-2..X+5) and three
// rows of those sums in a rolling register window, and the loop is unrolled
// by three so the window rotates by renaming, not by moves.  The loads of
// the next three rows are in flight while a row is computed.  Per row a
// thread writes four responses with one 16-byte store.  The re-read is the
// 4-row prologue of each band.  Where the width is not a multiple of 4 or a
// pointer is not 16-byte aligned, the same kernel runs with 4-byte loads and
// stores (VEC = false).
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (built with -fmad=false).  Sobel keeps the plain version's expression
// tree: ix = V(x+1) - V(x-1) with the column sums V = (t + 2 m) + b, and
// iy = H(y+1) - H(y-1) with the row sums H = (l + 2 c) + r, each sum formed
// once and reused.  The 3x3 box sums are taken separably -- along the row
// first, ((l + c) + r), then down the rows, ((t + m) + b) -- NOT in _box3's
// order (top row, middle, bottom, left to right): twelve additions a pixel
// instead of twenty-four, and a third fewer registers.  det and R are two
// explicit fused multiply-adds, det = fma(sxx, syy, -round(sxy^2)) and
// R = fma(-round(k trace), trace, det) -- the rounding of the JAX package's
// _harris_math as XLA:CPU compiles it, and of the plain PyTorch version.
// On integer gray 0..255, as the pipeline feeds, every Sobel and box sum is
// exact in f32 (|Ix| <= 1020, products <= 1,040,400, nine-sums < 2^24), so
// no order of additions can change a bit and the response is bit-equal to
// the plain version.  On other input the box sums may differ from _box3's
// in their last bit, which det = sxx syy - sxy^2 amplifies where it cancels:
// chip_smoke.py holds the response to 1e-5 of the largest |R| there.

#include <cuda_runtime.h>

namespace {

constexpr int kMinBand = 16;       // fewest output rows per warp
constexpr int kWarpsPerBlock = 4;  // independent warps; a block shares nothing
constexpr int kMinBlocks = 4;      // resident blocks per SM the compiler aims at
constexpr unsigned kFull = 0xffffffffu;

// One gray row around a thread's columns: g[i] is column X-2+i, hs[i] the
// horizontal Sobel sum (l + 2 c) + r centred on column X-1+i.
struct GrayRow {
  float g[8];
  float hs[6];
};

// Horizontal 3-sums of one row's gradient products, centred on columns
// X..X+3.
struct SumRow {
  float xx[4], yy[4], xy[4];
};

// What a thread loads of one gray row: its four columns, and for the strip's
// edge lanes the two columns beyond (lane 0: X-2, X-1; lane 31: X+4, X+5).
struct RawRow {
  float4 own;
  float2 edge;
};

__device__ __forceinline__ float at(const float* __restrict__ im, int y, int x,
                                    int w) {
  return (x >= 0 && x < w) ? im[static_cast<size_t>(y) * w + x] : 0.0f;
}

template <bool VEC>
__device__ __forceinline__ RawRow fetch(const float* __restrict__ im, int y,
                                        int h, int w, int X, int lane) {
  RawRow r;
  r.own = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  r.edge = make_float2(0.0f, 0.0f);
  if (y < 0 || y >= h) return r;  // uniform per warp
  if (VEC) {
    // w % 4 == 0, so X < w puts all four columns inside.
    if (X < w)
      r.own = *reinterpret_cast<const float4*>(
          im + static_cast<size_t>(y) * w + X);
  } else {
    r.own = make_float4(at(im, y, X, w), at(im, y, X + 1, w),
                        at(im, y, X + 2, w), at(im, y, X + 3, w));
  }
  // One predicated load on both edge lanes rather than a branch for each.
  const int ex = lane == 0 ? X - 2 : X + 4;
  if (lane == 0 || lane == 31) {
    if (VEC) {
      // ex is even and w a multiple of 4: both columns inside, or neither.
      if (ex >= 0 && ex < w)
        r.edge = *reinterpret_cast<const float2*>(
            im + static_cast<size_t>(y) * w + ex);
    } else {
      r.edge = make_float2(at(im, y, ex, w), at(im, y, ex + 1, w));
    }
  }
  return r;
}

// Complete a row: neighbours' columns by shuffle, then the row sums.
__device__ __forceinline__ void finish(const RawRow& raw, int lane, GrayRow& r) {
  float l0 = __shfl_up_sync(kFull, raw.own.z, 1);
  float l1 = __shfl_up_sync(kFull, raw.own.w, 1);
  float r0 = __shfl_down_sync(kFull, raw.own.x, 1);
  float r1 = __shfl_down_sync(kFull, raw.own.y, 1);
  if (lane == 0) { l0 = raw.edge.x; l1 = raw.edge.y; }
  if (lane == 31) { r0 = raw.edge.x; r1 = raw.edge.y; }
  r.g[0] = l0; r.g[1] = l1;
  r.g[2] = raw.own.x; r.g[3] = raw.own.y; r.g[4] = raw.own.z; r.g[5] = raw.own.w;
  r.g[6] = r0; r.g[7] = r1;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    r.hs[i] = __fadd_rn(__fadd_rn(r.g[i], __fmul_rn(2.0f, r.g[i + 1])),
                        r.g[i + 2]);
}

// Gradient products of row y (the row of `m`) from the gray rows above, at
// and below it, zero outside the image, summed over each output column's
// three neighbours.
__device__ __forceinline__ void row_sums(const GrayRow& t, const GrayRow& m,
                                         const GrayRow& b, int y, int h, int w,
                                         int X, SumRow& s) {
  const bool row_in = y >= 0 && y < h;  // uniform per warp
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = __fadd_rn(__fadd_rn(t.g[i], __fmul_rn(2.0f, m.g[i])), b.g[i]);
  float xx[6], yy[6], xy[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int x = X - 1 + i;
    // ix = (tr + 2 mr + br) - (tl + 2 ml + bl); iy likewise over rows.
    const bool in = row_in && x >= 0 && x < w;
    const float ix = in ? __fsub_rn(v[i + 2], v[i]) : 0.0f;
    const float iy = in ? __fsub_rn(b.hs[i], t.hs[i]) : 0.0f;
    xx[i] = __fmul_rn(ix, ix);
    yy[i] = __fmul_rn(iy, iy);
    xy[i] = __fmul_rn(ix, iy);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.xx[j] = __fadd_rn(__fadd_rn(xx[j], xx[j + 1]), xx[j + 2]);
    s.yy[j] = __fadd_rn(__fadd_rn(yy[j], yy[j + 1]), yy[j + 2]);
    s.xy[j] = __fadd_rn(__fadd_rn(xy[j], xy[j + 1]), xy[j + 2]);
  }
}

// The four responses of row y from the row sums above, at and below it.
template <bool VEC>
__device__ __forceinline__ void emit(const SumRow& t, const SumRow& m,
                                     const SumRow& b, float* __restrict__ o,
                                     int y, int w, int X, float k) {
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float sxx = __fadd_rn(__fadd_rn(t.xx[j], m.xx[j]), b.xx[j]);
    const float syy = __fadd_rn(__fadd_rn(t.yy[j], m.yy[j]), b.yy[j]);
    const float sxy = __fadd_rn(__fadd_rn(t.xy[j], m.xy[j]), b.xy[j]);
    const float det = __fmaf_rn(sxx, syy, -__fmul_rn(sxy, sxy));
    const float trace = __fadd_rn(sxx, syy);
    res[j] = __fmaf_rn(-__fmul_rn(k, trace), trace, det);
  }
  float* row = o + static_cast<size_t>(y) * w + X;
  if (VEC) {
    if (X < w)
      *reinterpret_cast<float4*>(row) =
          make_float4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (X + j < w) row[j] = res[j];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kMinBlocks)
harris_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
              int w, float k, int strips, int bands, int band_rows,
              int total) {
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (job >= total) return;  // uniform per warp; warps share nothing
  const int strip = job % strips;
  const int band = (job / strips) % bands;
  const int image = job / (strips * bands);
  const size_t plane = static_cast<size_t>(h) * w;
  const float* im = img + image * plane;
  float* o = out + image * plane;
  const int X = 128 * strip + 4 * lane;
  const int y0 = band * band_rows;
  const int y1 = min(y0 + band_rows, h);

  // Gray rows ga, gb, gc and row sums pa, pb, pc rotate roles every row;
  // three steps bring every name back to its role.
  GrayRow ga, gb, gc;
  SumRow pa, pb, pc;
  finish(fetch<VEC>(im, y0 - 2, h, w, X, lane), lane, ga);
  finish(fetch<VEC>(im, y0 - 1, h, w, X, lane), lane, gb);
  // Three rows of loads are in flight ahead of the row being computed; a
  // row past the band's last (y1 + 1) is not fetched (row h reads nothing).
  const int last = y1 + 1;
  RawRow na = fetch<VEC>(im, y0, h, w, X, lane);
  RawRow nb = fetch<VEC>(im, y0 + 1 <= last ? y0 + 1 : h, h, w, X, lane);
  RawRow nc = fetch<VEC>(im, y0 + 2 <= last ? y0 + 2 : h, h, w, X, lane);

  // One step: gray row g, loaded into `raw` three steps ago, completes
  // `bot`; the row sums of row g-1 go to `pnew`; with the two rows of sums
  // before it, row g-2 is emitted.
#define HARRIS_STEP(raw, top, mid, bot, pold, pmid, pnew)                \
  if (g <= last) {                                                       \
    finish(raw, lane, bot);                                              \
    raw = fetch<VEC>(im, g + 3 <= last ? g + 3 : h, h, w, X, lane);      \
    row_sums(top, mid, bot, g - 1, h, w, X, pnew);                        \
    if (g >= y0 + 2) emit<VEC>(pold, pmid, pnew, o, g - 2, w, X, k);     \
    ++g;                                                                 \
  }
  int g = y0;
  while (g <= last) {
    HARRIS_STEP(na, ga, gb, gc, pb, pc, pa)
    HARRIS_STEP(nb, gb, gc, ga, pc, pa, pb)
    HARRIS_STEP(nc, gc, ga, gb, pa, pb, pc)
  }
#undef HARRIS_STEP
}

}  // namespace

extern "C" int harris_response_f32(const float* img, float* out, int n, int h,
                                   int w, float k, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const bool vec =
      w % 4 == 0 &&
      ((reinterpret_cast<unsigned long long>(img) |
        reinterpret_cast<unsigned long long>(out)) & 15ull) == 0ull;
  auto kernel = vec ? harris_kernel<true> : harris_kernel<false>;
  // Bands as tall as still fills the card once: every band re-reads 4 rows,
  // and warps beyond one resident set would wait for a second round.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 32 * kWarpsPerBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = (w + 127) / 128;
  const long long resident =
      static_cast<long long>(sms) * per_sm * kWarpsPerBlock;
  long long bands = resident / (strips * n);
  if (bands > (h + kMinBand - 1) / kMinBand) bands = (h + kMinBand - 1) / kMinBand;
  if (bands < 1) bands = 1;
  const int band_rows = static_cast<int>((h + bands - 1) / bands);
  bands = (h + band_rows - 1) / band_rows;
  const long long total = strips * bands * n;
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks =
      static_cast<int>((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      img, out, h, w, k, static_cast<int>(strips), static_cast<int>(bands),
      band_rows, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}
