// Kernel K2: slab-gather patch sampler -- gather, bilinear-sample and
// normalize one (2*wid+1)^2 patch per sample, and say whether the patch lies
// inside the image.
//
// Replaces: sfm_tpu/ops/gather.py, _make_kernel -> kernel (the Pallas TPU
// kernel behind sample_normalized_patches).  Per sample (image, cx, cy):
// base = clip(floor(c) - wid, 0, dim - (2*wid+2)) (taken in float, so any
// centre, NaN and +-inf included, reads inside the stack); read the (2*wid+2)^2
// window of the bf16 stack; interpolate with (fx, fy) = frac(c); subtract
// the mean; divide by max(||.||_2, 1e-8); write bf16; write the in-bounds
// byte (wid+1 <= c <= dim-wid-2 on both axes, the plain version's
// _inbounds).  One launch does all of it.
//
// Bounds on Hopper: instruction issue and shared-memory traffic, not bytes.
// The bytes bound (stack or windows once, 254 bytes per sample out and in)
// is 0.02 ms at 163,840 samples, and the 29 MB stack of a 48 x 480 x 640 run
// sits in the 50 MB L2, so a window read is an L2 hit.  On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/bench_kernels.py) the kernel takes 0.050 ms
// there, ~215 instructions and ~40 shared-memory or shuffle wavefronts per
// sample; without its prefetch 0.065 ms, without its loop 0.075 ms.  The
// design below cuts what is executed per sample and keeps loads in flight
// inside a warp; PERF.md holds the variants that were measured and dropped.
//
// Design: a resident grid of warps that share nothing, each looping over
// pairs of samples, 16 lanes per sample; wid a template parameter; no block
// barrier, no asynchronous copy.
//  - What depends on the lane only -- which window chunks it loads, which
//    strip elements its pixels read -- is computed once, before the loop.
//  - The window is read once: per window row the 8-byte-aligned span that
//    covers its 2*wid+2 columns, one 8-byte load per (row, chunk) item (48
//    items for wid 5: three loads a lane), stored as it is, bf16, in the
//    sample's own strip of shared memory, guarded by __syncwarp() only.  A
//    strip row is one span (32 bytes for wid 5), so the rows that a sample's
//    lanes read at once lie in different banks and the 8-byte stores are
//    dense; a warp's two samples read the same rows and columns of their
//    strips at once, so the strips start 16 banks apart.  A sample whose
//    spans could leave the stack (the stack's first elements or its last
//    row) reads 2-byte elements instead, zero outside.
//  - Two strips a sample: while sample i is interpolated from one, the loads
//    of sample i+1's window are in flight (stored to the other strip after
//    sample i's results are written), and the centre of sample i+2 is read.
//    With its loads overlapped inside the warp, the kernel needs no more
//    than the 32 warps an SM that its 64 registers a thread allow.
//  - Each lane interpolates pixels lane, lane+16, ... from four 2-byte
//    reads of the strip (gather_common.cuh: bilinear -- the plain version's
//    operations in its order).
//  - The sums and the division are gather_common.cuh's, shared with K3: a
//    lane adds its pixels as the two lanes of a 32-lane warp that it stands
//    for would, so the results equal a warp-per-sample kernel's bit for bit.
//  - Stores go straight to global memory, 32 contiguous bytes a sample and
//    instruction.  Where m is odd the last warp's second half works on the
//    last sample again and writes nothing.
//
// Rounding, the float clamp of the window origin, the interpolation and the
// normalisation are the device functions of gather_common.cuh, shared with
// K3 (gather_tile.cu), which differs only in where a window is read from.

#include <atomic>

#include "gather_common.cuh"

namespace {

using namespace sfm_gather;

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 16;         // lanes per sample
constexpr int kSub = 32 / kLanes;  // samples a warp works on at once
constexpr int kChunk = 8;          // bytes per window load

// The shared-memory strip of one sample for half-width WID: the window's
// rows as they lie in the stack, each with the 8-byte-aligned span that
// covers its 2*WID+2 columns wherever the row starts.
template <int WID>
struct Strip {
  using P = Patch<WID>;
  // 8-byte chunks per row, (row, chunk) items per window, loads per lane.
  static constexpr int kRowChunks =
      (kChunk - 2 + 2 * P::kWin + kChunk - 1) / kChunk;
  static constexpr int kItems = P::kWin * kRowChunks;
  static constexpr int kLoads = (kItems + kLanes - 1) / kLanes;
  static constexpr int kRowEl = 4 * kRowChunks;  // elements per row
  static constexpr int kPixels = kSub * P::kPerLane;  // pixels per lane
  // uint2 slots between the strips of a warp's samples: the strip, padded so
  // that the strips of a warp start 32 / kSub banks apart (the samples'
  // lanes read the same rows and columns of their strips at once).
  static constexpr int pad() {
    int p = 0;
    while ((2 * (kItems + p)) % 32 != (32 / kSub) % 32) ++p;
    return p;
  }
  static constexpr int kSlot = kItems + pad();
};

template <int WID>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __nv_bfloat16* __restrict__ gray,
              const int* __restrict__ img_idx,
              const float* __restrict__ centers,
              __nv_bfloat16* __restrict__ out, bool* __restrict__ inb, int m,
              int n, int h, int w) {
  using P = Patch<WID>;
  using S = Strip<WID>;
  // Per warp two sets of strips (these samples', the next ones'), a strip
  // for each half of the warp.
  __shared__ uint2 strips[kWarps][2][kSub * S::kSlot];

  const int lane = threadIdx.x & (kLanes - 1);  // within the sample's lanes
  const int half = (threadIdx.x & 31) / kLanes;  // which of the warp's samples
  const int warp = threadIdx.x >> 5;
  const int step = kSub * gridDim.x * kWarps;
  // The warp's first sample, and this half's.  A half past the last sample
  // (the second half, where m is odd) works on the last sample again and
  // writes nothing, so that the warp stays together.
  int first_s = kSub * (blockIdx.x * kWarps + warp);
  if (first_s >= m) return;  // uniform per warp; warps share nothing
  const int last = m - 1;

  // Every row starts equally far into its span.
  const bool same_rem = (w & 3) == 0;
  const int rows = n * h;

  // What a lane does for every sample: its (row, chunk) items -- chunk
  // `lane + kLanes k` of the strip -- and the strip element above and left of
  // each of its pixels.
  int item_row[S::kLoads], item_off[S::kLoads];
#pragma unroll
  for (int k = 0; k < S::kLoads; ++k) {
    const int it = lane + kLanes * k;
    const int r = it / S::kRowChunks, ch = it - r * S::kRowChunks;
    item_row[k] = r * w;
    item_off[k] = r * w + 4 * ch;
  }
  int pixel_at[S::kPixels];
#pragma unroll
  for (int i = 0; i < S::kPixels; ++i) {
    const int p = lane + kLanes * i;
    const int r = p / P::kSide;
    pixel_at[i] = r * S::kRowEl + (p - r * P::kSide);
  }
  __nv_bfloat16* const out_lane = out + lane;

  // A sample as its lanes know it before its window arrives.
  struct Located {
    float fx, fy;
    const __nv_bfloat16* first;  // the window's first element
    int rem0;     // elements between its 8-byte span's start and `first`
    bool inside;  // no span of the window leaves the stack
  };
  auto locate = [&](int s, bool live, int img, float x, float y) {
    const Window o = window_of(img, x, y, n, h, w, WID);
    if (lane == 0 && live) inb[s] = inbounds_of(x, y, h, w, WID);
    Located t;
    t.fx = o.fx;
    t.fy = o.fy;
    // The window's first row among the stack's n*h rows.
    const int row0 = o.img * h + o.by;
    t.first = gray + (static_cast<long long>(row0) * w + o.bx);
    t.rem0 = static_cast<int>(
        static_cast<unsigned>(reinterpret_cast<unsigned long long>(t.first) >>
                              1) & 3u);
    // A span starts up to 3 elements before its row and ends up to kRowEl
    // after the row's start, so only the stack's first elements and its last
    // row can fall short.
    t.inside = w >= 8 && !(row0 == 0 && o.bx < 3) &&
               !(row0 + P::kWin == rows && o.bx + S::kRowEl > w);
    return t;
  };
  // Ask for the window: one 8-byte chunk of a row's span per item.
  auto fetch = [&](const Located& t, uint2 (&raw)[S::kLoads]) {
#pragma unroll
    for (int k = 0; k < S::kLoads; ++k) {
      raw[k] = make_uint2(0u, 0u);
      if (kLanes * k + kLanes - 1 < S::kItems ||
          lane + kLanes * k < S::kItems) {
        // The row's span starts `rem` elements before the row.
        const int rem = same_rem ? t.rem0 : ((t.rem0 + item_row[k]) & 3);
        const int off = item_off[k] - rem;
        if (t.inside) {
          raw[k] = __ldg(reinterpret_cast<const uint2*>(t.first + off));
        } else {
          const long long total = static_cast<long long>(rows) * w;
          const long long e = (t.first - gray) + off;
          unsigned v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = (e + q >= 0 && e + q < total)
                       ? __bfloat16_as_ushort(gray[e + q]) : 0u;
          raw[k] = make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
        }
      }
    }
  };
  auto stage = [&](uint2* strip, const uint2 (&raw)[S::kLoads]) {
#pragma unroll
    for (int k = 0; k < S::kLoads; ++k)
      if (kLanes * k + kLanes - 1 < S::kItems ||
          lane + kLanes * k < S::kItems)
        strip[lane + kLanes * k] = raw[k];
  };
  // Interpolate, normalize and write sample s from its staged window.
  auto extract = [&](int s, bool live, const Located& t, const uint2* strip) {
    const unsigned short* el = reinterpret_cast<const unsigned short*>(strip);
    const float gx = __fsub_rn(1.0f, t.fx);
    const float gy = __fsub_rn(1.0f, t.fy);
    float v[S::kPixels];
#pragma unroll
    for (int i = 0; i < S::kPixels; ++i) {
      v[i] = 0.0f;
      if (kLanes * i + kLanes - 1 < P::kPix || lane + kLanes * i < P::kPix) {
        const unsigned short* e0 = el + pixel_at[i] + t.rem0;
        const unsigned short* e1 = e0 + S::kRowEl;
        if (!same_rem) {
          const int r = (lane + kLanes * i) / P::kSide;
          e0 = el + pixel_at[i] + ((t.rem0 + r * w) & 3);
          e1 = el + pixel_at[i] + S::kRowEl + ((t.rem0 + (r + 1) * w) & 3);
        }
        // bf16 -> f32 is the 16 bits moved up.
        v[i] = bilinear(
            __uint_as_float(static_cast<unsigned>(e0[0]) << 16),
            __uint_as_float(static_cast<unsigned>(e0[1]) << 16),
            __uint_as_float(static_cast<unsigned>(e1[0]) << 16),
            __uint_as_float(static_cast<unsigned>(e1[1]) << 16), t.fx, t.fy,
            gx, gy);
      }
    }
    __nv_bfloat16* dst = out_lane + static_cast<long long>(s) * P::kPix;
    normalize_values<WID, kLanes>(v, lane, [&](int p, __nv_bfloat16 q) {
      if (live) dst[p - lane] = q;
    });
  };

  uint2* const strip0 = strips[warp][0] + half * S::kSlot;
  uint2 raw[S::kLoads];
  // Two strips: while sample i is extracted from one, the window of sample
  // i+1 is on its way to the other, and the centre of sample i+2 is read.
  int s = min(first_s + half, last);
  bool live = first_s + half <= last;
  Located cur = locate(s, live, img_idx[s], centers[2 * s], centers[2 * s + 1]);
  fetch(cur, raw);
  first_s += step;
  int s1 = min(first_s + half, last);
  float x1 = centers[2 * s1], y1 = centers[2 * s1 + 1];
  int img1 = img_idx[s1];
  stage(strip0, raw);
  int buf = 0;
  while (true) {
    __syncwarp();
    const bool more = first_s < m;  // uniform per warp
    const bool live1 = first_s + half <= last;
    Located nxt = cur;
    if (more) {
      nxt = locate(s1, live1, img1, x1, y1);
      fetch(nxt, raw);
      const int s2 = min(first_s + step + half, last);
      x1 = centers[2 * s2];
      y1 = centers[2 * s2 + 1];
      img1 = img_idx[s2];
    }
    extract(s, live, cur, strip0 + buf * kSub * S::kSlot);
    if (!more) break;
    buf ^= 1;
    stage(strip0 + buf * kSub * S::kSlot, raw);
    cur = nxt;
    s = s1;
    live = live1;
    first_s += step;
    s1 = min(first_s + half, last);
  }
}

// Blocks of gather_kernel<WID> that the current device holds at once (0 and
// the runtime's error in *err if it cannot say): asked of the runtime once
// per device and half-width, since the answer costs several microseconds
// of a call that launches one kernel.
template <int WID>
int resident_blocks(cudaError_t* err) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int device = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  const bool kept = device >= 0 && device < kDevices;
  if (kept) {
    const int blocks = known[device].load(std::memory_order_relaxed);
    if (blocks > 0) return blocks;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_kernel<WID>, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (kept) known[device].store(sms * per_sm, std::memory_order_relaxed);
  return sms * per_sm;
}

}  // namespace

extern "C" int sample_normalized_patches_bf16(
    const void* gray, const int* img_idx, const float* centers, void* out,
    void* inbounds, int m, int n, int h, int w, int wid,
    cudaStream_t stream) {
  if (m <= 0 || n <= 0 || wid < 0 || wid > kMaxWid || h < 2 * wid + 2 ||
      w < 2 * wid + 2 || static_cast<long long>(n) * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  dispatch_wid(wid, [&](auto wid_c) {
    constexpr int kWid = decltype(wid_c)::value;
    // One resident set of warps, each looping over its samples.
    const long long fit = resident_blocks<kWid>(&err);
    if (err != cudaSuccess) return;
    const long long want =
        (static_cast<long long>(m) + kSub * kWarps - 1) / (kSub * kWarps);
    const int blocks = static_cast<int>(fit < want ? fit : want);
    gather_kernel<kWid><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(gray), img_idx, centers,
        static_cast<__nv_bfloat16*>(out), static_cast<bool*>(inbounds), m, n,
        h, w);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
