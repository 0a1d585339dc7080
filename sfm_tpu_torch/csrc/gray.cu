// Kernel K4: ITU-R BT.601 grayscale of a uint8 RGB stack, rounded to whole
// numbers, written as float32.
//
// Replaces: the host conversion of sfm_tpu_torch/io/images.py:gray_tensor
// (np.rint(to_gray(images)).astype(np.uint8), then .float() on the device).
// Input: contiguous uint8 (N, H, W, 3); output: contiguous float32 (N, H, W).
//
// Rounding: per pixel, exactly NumPy's float32 arithmetic -- each product
// and each sum rounded on its own, in to_gray's order:
//   p = (r * 0.299f + g * 0.587f) + b * 0.114f,  out = rintf(p)
// with the explicit round-to-nearest intrinsics, so no product is contracted
// into a fused multiply-add (the library is built with -fmad=false as well).
// A contraction changes the rounded value of about 1,400 of the 2^24 RGB
// triples, and one flipped gray value moves a Harris corner.  rintf rounds
// half to even, as np.rint does; p lies in [0, 255.00002], so no clamp is
// needed before the uint8 cast that the host version makes.
//
// Bounds on Hopper: bytes. 3 bytes in and 4 bytes out a pixel, 103.2 MB at
// 48 x 480 x 640: 0.0308 ms at 3.35 TB/s; five operations a pixel.  A
// first version (each thread three 16-byte loads of its own 48-byte run of
// 16 pixels, four 16-byte stores 64 bytes apart, a grid of one resident set
// of blocks striding over the groups) took 0.0698 ms there on an NVIDIA
// H100 80GB HBM3 at 700 W, each load and store instruction of a warp
// reaching 32-byte sectors only half used; this design 0.0362 ms (85 % of
// the bound), the two timed in turns in one process.
//
// Design: a warp converts a chunk of 512 pixels at a time, with every
// global access coalesced.  It reads the chunk's 1,536 bytes as three
// 16-byte loads a lane, consecutive lanes on consecutive addresses, into
// its own strip of shared memory (no block barrier: __syncwarp only).
// Then lane l converts pixels 4q..4q+3 for q = l, l+32, l+64, l+96: three
// 4-byte reads of the strip (words 3q..3q+2; 3 is prime to the 32 banks,
// so no conflict) and one 16-byte store, consecutive lanes on consecutive
// addresses.  The grid has a warp for each chunk, so the block scheduler
// balances the work and no warp waits for a second round; the pixels past
// the last whole chunk (fewer than 512) are done one by one.  Where either
// pointer is not 16-byte aligned, every pixel takes the one-by-one path.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block; they share nothing
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 512;                 // pixels a warp converts at once
constexpr int kChunkWords = kChunk * 3 / 16;  // its RGB as 16-byte words: 96

__device__ __forceinline__ float gray_of(unsigned r, unsigned g, unsigned b) {
  float p = __fmul_rn(static_cast<float>(r), 0.299f);
  p = __fadd_rn(p, __fmul_rn(static_cast<float>(g), 0.587f));
  p = __fadd_rn(p, __fmul_rn(static_cast<float>(b), 0.114f));
  return rintf(p);
}

__global__ void __launch_bounds__(kThreads)
gray_kernel(const unsigned char* __restrict__ rgb, float* __restrict__ out,
            long long pixels, long long chunks) {
  __shared__ uint4 strip[kWarps][kChunkWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned* words = reinterpret_cast<const unsigned*>(strip[warp]);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
       c < chunks; c += warps) {
    const uint4* in = reinterpret_cast<const uint4*>(rgb) + c * kChunkWords;
    const uint4 w0 = __ldcs(in + lane);
    const uint4 w1 = __ldcs(in + 32 + lane);
    const uint4 w2 = __ldcs(in + 64 + lane);
    __syncwarp();  // the last chunk's reads of the strip are done
    strip[warp][lane] = w0;
    strip[warp][32 + lane] = w1;
    strip[warp][64 + lane] = w2;
    __syncwarp();
    float4* o = reinterpret_cast<float4*>(out + c * kChunk);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 32 * k + lane;
      // Little-endian bytes: a = r0 g0 b0 r1, b = g1 b1 r2 g2, d = b2 r3 g3 b3.
      const unsigned a = words[3 * q], b = words[3 * q + 1],
                     d = words[3 * q + 2];
      o[q] = make_float4(
          gray_of(a & 0xffu, (a >> 8) & 0xffu, (a >> 16) & 0xffu),
          gray_of(a >> 24, b & 0xffu, (b >> 8) & 0xffu),
          gray_of((b >> 16) & 0xffu, b >> 24, d & 0xffu),
          gray_of((d >> 8) & 0xffu, (d >> 16) & 0xffu, d >> 24));
    }
  }
  // The pixels after the last whole chunk, one by one.
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = chunks * kChunk +
                     static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < pixels; i += threads)
    out[i] = gray_of(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
}

}  // namespace

extern "C" int rgb_to_gray_f32(const unsigned char* rgb, float* out, int n,
                               int h, int w, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(n) * h * w;
  const bool vec = ((reinterpret_cast<unsigned long long>(rgb) |
                     reinterpret_cast<unsigned long long>(out)) & 15ull) == 0ull;
  const long long chunks = vec ? pixels / kChunk : 0;
  // A warp a chunk, or a thread a pixel where there is no chunk; the loops
  // stride over whatever a grid capped at 2^20 blocks leaves.
  long long blocks = chunks > 0 ? (chunks + kWarps - 1) / kWarps
                                : (pixels + kThreads - 1) / kThreads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;
  gray_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      rgb, out, pixels, chunks);
  return static_cast<int>(cudaGetLastError());
}
