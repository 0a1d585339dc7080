// Kernel K3: tile-resident patch sampler -- K2's function with each sample's
// window staged in shared memory by the copy engine.
//
// Replaces: tools/prof_tile.py, make_gather_kernel (the Pallas TPU kernel of
// the tile-resident gather experiments: per grid step, S samples' slabs are
// brought into VMEM by S outstanding async copies, optionally double-buffered
// across steps, then extracted and normalised there).  Per sample
// (image, cx, cy) it computes what K2 (gather.cu) computes, with the device
// functions of gather_common.cuh: origin = clip(floor(c) - wid, 0,
// dim - (2*wid+2)) in float, bilinear interpolation, mean, norm, bf16.
//
// Three modes, the tool's three experiments:
//   copy only        stage, then write the window's first side x side values
//                    unchanged (no arithmetic): the cost of the copies alone;
//   single-buffered  a ring of one stage: a step's S windows are staged,
//                    extracted and normalised before the next step's copies;
//   double-buffered  a ring of two stages: step i+1's copies are in flight
//                    while step i is processed.
//
// What bounds it on Hopper: not bytes.  The bytes bound (the windows once,
// 12 bytes of operands and 242 of output a sample) is 0.0133 ms at 81,920
// samples, and the 29 MB stack of a 48 x 480 x 640 run sits in the 50 MB
// L2.  K2 reads its windows from L2 straight into registers and strips; K3
// adds a trip through shared memory and a barrier round trip a step, so it
// is bound by the staging: the copies' issue and latency (the TMA unit
// takes one 576-byte box in ~57 ns per SM at wid 5, about the rate 16-byte
// cp.async spans reach; PERF.md), and how many producers and consumers an
// SM holds.  Taking the copies' issue off the threads that extract, and
// the block barriers out of the step loop, is what the design below does
// about it.
//
// Design: producer warps stage, consumer warps extract, and nothing but an
// mbarrier ring stands between them.
//  - Two routes, by pitch and alignment alone (ops/gather_tile.py:tile_route
//    states the rule), two kernels, so a profile shows which one ran:
//     "tma" (gather_tile_tma_kernel), where the stack starts 16-byte aligned
//       and a row is a multiple of 16 bytes (w % 8 == 0), as a Tensor Memory
//       Accelerator map requires: one tensor copy a window, from a 2-D map
//       over the stack's n*h rows (the window's row, img*h + by, is its
//       second coordinate; a window never crosses an image).  The box is
//       box_width(win) x win elements and starts at the window's column
//       rounded down to 8 elements: a box whose first element is not
//       16-byte aligned faults on the H100 this was measured on (PERF.md),
//       aligned ones run.  The window lies at a fixed row pitch, bx % 8
//       elements into its box; a box past column w is zero-filled by TMA
//       and those columns are never read.  The map is encoded per call on
//       the host (cuTensorMapEncodeTiled, looked up once through the
//       runtime's cudaGetDriverEntryPointByVersion, so no -lcuda) and
//       passed as a __grid_constant__ parameter.  A failed encode returns
//       the driver's error; it never changes the route.
//     "rows" (gather_tile_rows_kernel), any other stack: each window row is
//       copied as its 16-byte-aligned span (the chunks from the one holding
//       its first element to the one holding its last) with 16-byte
//       cp.async, into a slot of round_up(2*win + 14, 16) bytes; the reader
//       adds the row's offset into its span.  Every chunk holds an element
//       of its row, so no copy reaches memory the stack does not share a
//       chunk with.  Each producer lane's cp.async.mbarrier.arrive marks its
//       copies on the stage's `full` barrier.
//  - A ring of one or two stages per block, each with a `full` and an `empty`
//    mbarrier.  The first kProducerWarps warps produce: each waits for a
//    stage to be empty, derives its share of the next step's S origins and
//    fractions with its lanes side by side, writes their records, arrives
//    on `full` from one lane (which releases the records; on the tma route
//    with the share's box bytes as its expected transaction count), and
//    issues the copies.  The other warps are consumers: each waits on
//    `full` (try_wait with the stage's parity), takes pairs of samples of
//    the step from shared memory, 16 lanes a sample (as K2, with
//    gather_common.cuh's normalize_values, so the results are K2's bit for
//    bit), and arrives on `empty`.  No block barrier in the step loop; the
//    one __syncthreads publishes the barriers.  A phase that never
//    completes traps instead of holding the card.
//  - A persistent grid, blocks = SMs x occupancy, asked of the runtime once
//    per device, kernel and shared-memory size.
//  - The shared memory a launch needs is planned before it (shared_bytes);
//    a plan over a block's 227 KB is refused with cudaErrorInvalidValue, and
//    the wrapper (ops/gather_tile.py) raises on the same plan first.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "gather_common.cuh"

namespace {

using namespace sfm_gather;

constexpr int kProducerWarps = 4;
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kProducerWarps + kConsumerWarps);
constexpr int kMaxSamplesPerBlock = 256;
constexpr int kTileAlign = 128;       // bytes: start of the records and tiles
constexpr int kParamBytes = 16;       // one Sample
constexpr int kBarrierBytes = 128;    // full[2] and empty[2], padded
constexpr int kMaxSharedBytes = 232448;  // a block's 227 KB on Hopper

__host__ __device__ constexpr int round_up(int x, int a) {
  return (x + a - 1) / a * a;
}
// Elements of a TMA box row: a window row from its column rounded down to 8
// elements (16 bytes).
__host__ __device__ constexpr int box_width(int win) {
  return round_up(win + 7, 8);
}
// Bytes of a tile row.  tma: a box row.  rows: a slot, the largest
// 16-byte-aligned span of a row of `win` bf16 that starts at any even byte.
__host__ __device__ constexpr int row_bytes(int win, bool tma) {
  return tma ? 2 * box_width(win) : round_up(2 * win + 14, 16);
}
// Bytes from one sample's tile to the next: its win rows, rounded up to
// the 128 bytes a tensor copy's destination is aligned to (tma), or 16-byte
// multiples as a 16-byte cp.async's destination is (rows).
__host__ __device__ constexpr int tile_bytes(int wid, bool tma) {
  return tma ? round_up(row_bytes(2 * wid + 2, true) * (2 * wid + 2), kTileAlign)
             : row_bytes(2 * wid + 2, false) * (2 * wid + 2);
}
// Dynamic shared memory of one block: alignment slack, barriers, the
// stages' Sample records, the stages' tiles.
size_t shared_bytes(int wid, int S, int stages, bool tma) {
  return kTileAlign + kBarrierBytes +
         static_cast<size_t>(round_up(stages * S * kParamBytes, kTileAlign)) +
         static_cast<size_t>(stages) * S * tile_bytes(wid, tma);
}

// What the producer records about one sample: the interpolation fractions
// and the window's origin (column, and row among the stack's n*h rows).
struct Sample {
  float fx, fy;
  int x, row;
};
static_assert(sizeof(Sample) == kParamBytes, "Sample layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, P1;\n\t"
      "}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the phase of parity `parity` of the barrier has completed.  A
// phase that has not completed after ~4 s of SM clock is a fault (an
// arrival that never comes): trap, so that the launch fails instead of
// holding the card.
constexpr long long kStallCycles = 1ll << 33;
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try_wait(bar, parity))
    if (clock64() - t0 > kStallCycles) __trap();
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// An arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void bar_arrive_expect(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// One tensor copy: the box at (x, row) of `map` into shared memory at
// `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void copy_box(uint32_t dst, const CUtensorMap* map,
                                         int x, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(row), "r"(bar)
      : "memory");
}
// One 16-byte asynchronous copy (both addresses 16-byte aligned).
__device__ __forceinline__ void copy16(uint32_t dst, unsigned long long src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
// An arrival on `bar` once every cp.async this thread has issued so far has
// landed (the barrier's pending count is raised now, lowered then).
__device__ __forceinline__ void bar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// One K3 block.  tma: the windows come from `map` (gray is unused);
// rows: from `gray` (map is unused).
template <int WID, bool kTma>
__device__ __forceinline__ void gather_tile(
    const CUtensorMap* map, const __nv_bfloat16* __restrict__ gray,
    const int* __restrict__ img_idx, const float* __restrict__ centers,
    __nv_bfloat16* __restrict__ out, int m, int n, int h, int w, int S,
    int n_steps, int stages, int extract) {
  using P = Patch<WID>;
  constexpr int win = P::kWin;
  constexpr int kTile = tile_bytes(WID, kTma);
  constexpr int kRow = row_bytes(win, kTma);
  constexpr uint32_t kBoxBytes = static_cast<uint32_t>(kRow * win);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kTileAlign - 1) &
      ~static_cast<uintptr_t>(kTileAlign - 1));
  Sample* params = reinterpret_cast<Sample*>(smem + kBarrierBytes);
  unsigned char* tiles = smem + kBarrierBytes +
                         round_up(stages * S * kParamBytes, kTileAlign);
  const uint32_t full0 = smem_u32(smem);        // full[stage] at 8 * stage
  const uint32_t empty0 = smem_u32(smem + 16);  // empty[stage] at 16 + 8 * stage
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned long long base = reinterpret_cast<uintptr_t>(gray);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full0 + 8 * i, kProducerWarps);
      bar_init(empty0 + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < kProducerWarps) {
    // Producers.  A producer's first wait on each stage passes: the ring
    // starts empty.
    // rows: what depends on the lane only, the (row, 16-byte chunk) items
    // of a window's spans it copies, lane + 32 k of the win x kChunks.
    constexpr int kChunks = kRow / 16;
    constexpr int kItems = win * kChunks;
    constexpr int kPerLaneItems = (kItems + 31) / 32;
    // For each: bytes from the window's first element to its row's first,
    // its chunk's offset in the span, and where the chunk lands in a tile.
    unsigned long long item_src[kPerLaneItems];
    int item_chunk[kPerLaneItems], item_dst[kPerLaneItems];
    if constexpr (!kTma) {
#pragma unroll
      for (int k = 0; k < kPerLaneItems; ++k) {
        const int it = lane + 32 * k;
        const int r = it / kChunks;
        item_src[k] = 2ull * static_cast<unsigned long long>(r) * w;
        item_chunk[k] = 16 * (it - r * kChunks);
        item_dst[k] = r * kRow + item_chunk[k];
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
      bar_wait(empty0 + 8 * stage, phase ^ 1);
      const int first_s = step * S;
      const int count = min(S, m - first_s);  // the last step may be partial
      Sample* sp = params + stage * S;
      const uint32_t tp = smem_u32(tiles + static_cast<size_t>(stage) * S * kTile);
      const uint32_t full = full0 + 8 * stage;
      // This warp's share of the step: samples [lo, hi).  Its lanes derive
      // them side by side and write their records; slots past `count` get
      // none.
      const int share = (count + kProducerWarps - 1) / kProducerWarps;
      const int lo = min(count, warp * share);
      const int hi = min(count, lo + share);
      for (int j = lo + lane; j < hi; j += 32) {
        const int s = first_s + j;
        const Window o = window_of(img_idx[s], centers[2 * s],
                                   centers[2 * s + 1], n, h, w, WID);
        Sample p;
        p.fx = o.fx;
        p.fy = o.fy;
        p.x = o.bx;
        p.row = o.img * h + o.by;
        sp[j] = p;
      }
      __syncwarp();
      if constexpr (kTma) {
        // One arrival a warp, after its records (releasing them), expecting
        // exactly the bytes of the boxes it then issues: none past `count`.
        if (lane == 0) bar_arrive_expect(full, (hi - lo) * kBoxBytes);
        __syncwarp();
        for (int j = lo + lane; j < hi; j += 32)
          copy_box(tp + j * kTile, map, sp[j].x & ~7, sp[j].row, full);
      } else {
        // Every sample's spans, 16 bytes a lane and copy: each row's span
        // is the 16-byte chunks from the one that holds its first element
        // to the one that holds its last.
#pragma unroll 4
        for (int j = lo; j < hi; ++j) {
          const Sample p = sp[j];
          const uint32_t dst = tp + j * kTile;
          const unsigned long long first =
              base + 2ull * static_cast<unsigned long long>(
                                static_cast<long long>(p.row) * w + p.x);
#pragma unroll
          for (int k = 0; k < kPerLaneItems; ++k) {
            if (32 * k + 31 < kItems || lane + 32 * k < kItems) {
              const unsigned long long row = first + item_src[k];
              const unsigned long long chunk = (row & ~15ull) + item_chunk[k];
              if (chunk < row + 2 * win) copy16(dst + item_dst[k], chunk);
            }
          }
        }
        // `full` completes when every producer lane's copies have landed
        // and each producer's lane 0 has arrived; that arrive, after its
        // warp's records, releases them to the consumers.
        bar_arrive_on_copies(full);
        __syncwarp();
        if (lane == 0) bar_arrive(full);
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: 16 lanes a sample, a warp's halves on two samples at once
  // (gather_common.cuh's normalize_values, as K2).  What depends on the
  // lane only: where each of its pixels' top-left element lies in a tile
  // without the sample's offset into its box or span (bytes), and its row.
  constexpr int kPer = 2 * P::kPerLane;  // pixels l, l + 16, ... of 16 lanes
  const int l16 = lane & 15;
  const int half = lane >> 4;
  auto held = [&](int i) {
    return 16 * i + 15 < P::kPix || l16 + 16 * i < P::kPix;
  };
  int at[kPer], row_of[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = l16 + 16 * i;
    const int r = p / P::kSide;
    row_of[i] = r;
    at[i] = r * kRow + 2 * (p - r * P::kSide);
  }
  const unsigned rem_pitch = (2u * static_cast<unsigned>(w)) & 15u;
  const unsigned base_rem = static_cast<unsigned>(base) & 15u;
  const int cw = warp - kProducerWarps;
  int stage = 0;
  uint32_t phase = 0;
  for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
    bar_wait(full0 + 8 * stage, phase);
    const int first_s = step * S;
    const int count = min(S, m - first_s);
    for (int j0 = 2 * cw; j0 < count; j0 += 2 * kConsumerWarps) {
      // Where `count` is odd the last pair's second half works on the last
      // sample again and writes nothing, so that the warp stays together.
      const bool live = j0 + half < count;
      const int j = live ? j0 + half : count - 1;
      const Sample p = params[stage * S + j];
      const unsigned char* tile =
          tiles + (static_cast<size_t>(stage) * S + j) * kTile;
      // tma: the window's offset into its box, the same on every row.
      // rows: row 0's offset into its span; row r's adds r times the
      // pitch's.
      const unsigned rem0 =
          kTma ? 2u * static_cast<unsigned>(p.x & 7)
               : (base_rem + 2u * (static_cast<unsigned>(p.row) *
                                       static_cast<unsigned>(w) +
                                   static_cast<unsigned>(p.x))) & 15u;
      // Elements (r, c) and (r, c + 1) of pixel i's row r = row_of[i] + dr.
      auto pair = [&](int i, int dr, unsigned short (&e)[2]) {
        unsigned rem = rem0;
        if constexpr (!kTma)
          rem = (rem0 + static_cast<unsigned>(row_of[i] + dr) * rem_pitch) &
                15u;
        const unsigned short* q = reinterpret_cast<const unsigned short*>(
            tile + at[i] + dr * kRow + rem);
        e[0] = q[0];
        e[1] = q[1];
      };
      unsigned short* o = reinterpret_cast<unsigned short*>(out) +
                          static_cast<size_t>(first_s + j) * P::kPix;
      if (extract) {
        const float gx = __fsub_rn(1.0f, p.fx);
        const float gy = __fsub_rn(1.0f, p.fy);
        float v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          v[i] = 0.0f;
          if (held(i)) {
            unsigned short t[2], b[2];
            pair(i, 0, t);
            pair(i, 1, b);
            // bf16 -> f32 is the 16 bits moved up.
            v[i] = bilinear(__uint_as_float(static_cast<unsigned>(t[0]) << 16),
                            __uint_as_float(static_cast<unsigned>(t[1]) << 16),
                            __uint_as_float(static_cast<unsigned>(b[0]) << 16),
                            __uint_as_float(static_cast<unsigned>(b[1]) << 16),
                            p.fx, p.fy, gx, gy);
          }
        }
        normalize_values<WID, 16>(v, l16, [&](int q, __nv_bfloat16 x) {
          if (live) o[q] = __bfloat16_as_ushort(x);
        });
      } else if (live) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (held(i)) {
            unsigned short t[2];
            pair(i, 0, t);
            o[l16 + 16 * i] = t[0];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty0 + 8 * stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int WID>
__global__ void __launch_bounds__(kThreads)
gather_tile_tma_kernel(const __grid_constant__ CUtensorMap map,
                       const int* __restrict__ img_idx,
                       const float* __restrict__ centers,
                       __nv_bfloat16* __restrict__ out, int m, int n, int h,
                       int w, int S, int n_steps, int stages, int extract) {
  gather_tile<WID, true>(&map, nullptr, img_idx, centers, out, m, n, h, w, S,
                         n_steps, stages, extract);
}

template <int WID>
__global__ void __launch_bounds__(kThreads)
gather_tile_rows_kernel(const __nv_bfloat16* __restrict__ gray,
                        const int* __restrict__ img_idx,
                        const float* __restrict__ centers,
                        __nv_bfloat16* __restrict__ out, int m, int n, int h,
                        int w, int S, int n_steps, int stages, int extract) {
  gather_tile<WID, false>(nullptr, gray, img_idx, centers, out, m, n, h, w, S,
                          n_steps, stages, extract);
}

// Blocks of `kernel` that the current device holds at once with `shared`
// bytes of dynamic shared memory (0 and the runtime's error in *err if it
// cannot say): asked of the runtime once per device, kernel and size.
int resident_blocks(const void* kernel, size_t shared, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> known;
  int device = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, kernel, shared);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  if (shared > 48 * 1024) {
    // Above 48 KB a block's shared memory is opted into; always to the
    // same limit, so one size's answer never undoes another's.
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSharedBytes);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, shared);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  known[key] = sms * per_sm;
  return sms * per_sm;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tma route's map over the (n*h, w) bf16 rows at `gray`: boxes of
// box_width(win) x win elements, zero-filled past the stack.  0, or the
// runtime's or the driver's error.
int encode_map(CUtensorMap* map, const void* gray, int n, int h, int w,
               int wid) {
  static std::once_flag once;
  static EncodeTiled encode = nullptr;
  static cudaError_t found = cudaSuccess;
  std::call_once(once, [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    found = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                             12000, cudaEnableDefault, &q);
    if (found == cudaSuccess && q != cudaDriverEntryPointSuccess)
      found = cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  });
  if (found != cudaSuccess) return static_cast<int>(found);
  const int win = 2 * wid + 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(n) * h};
  const cuuint64_t strides[1] = {2ull * w};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_width(win)),
                             static_cast<cuuint32_t>(win)};
  const cuuint32_t unit[2] = {1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(gray), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

extern "C" int sample_normalized_patches_tiled_bf16(
    const void* gray, const int* img_idx, const float* centers, void* out,
    int m, int n, int h, int w, int wid, int samples_per_block,
    int double_buffer, int extract, cudaStream_t stream) {
  const int S = samples_per_block;
  if (m <= 0 || n <= 0 || wid < 0 || wid > kMaxWid || h < 2 * wid + 2 ||
      w < 2 * wid + 2 || S < 1 || S > kMaxSamplesPerBlock ||
      static_cast<long long>(n) * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // The route: a tensor map needs a 16-byte-aligned base and row pitch.
  const bool tma =
      w % 8 == 0 && (reinterpret_cast<uintptr_t>(gray) & 15) == 0;
  const int stages = double_buffer ? 2 : 1;
  const size_t shared = shared_bytes(wid, S, stages, tma);
  if (shared > static_cast<size_t>(kMaxSharedBytes))
    return cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  if (tma) {
    const int res = encode_map(&map, gray, n, h, w, wid);
    if (res != 0) return res;
  }
  const int n_steps = (m + S - 1) / S;
  cudaError_t err = cudaSuccess;
  dispatch_wid(wid, [&](auto wid_c) {
    constexpr int kWid = decltype(wid_c)::value;
    const void* kernel =
        tma ? reinterpret_cast<const void*>(gather_tile_tma_kernel<kWid>)
            : reinterpret_cast<const void*>(gather_tile_rows_kernel<kWid>);
    const int fit = resident_blocks(kernel, shared, &err);
    if (err != cudaSuccess) return;
    const int blocks = n_steps < fit ? n_steps : fit;
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (tma) {
      gather_tile_tma_kernel<kWid><<<blocks, kThreads, shared, stream>>>(
          map, img_idx, centers, o, m, n, h, w, S, n_steps, stages, extract);
    } else {
      gather_tile_rows_kernel<kWid><<<blocks, kThreads, shared, stream>>>(
          static_cast<const __nv_bfloat16*>(gray), img_idx, centers, o, m, n,
          h, w, S, n_steps, stages, extract);
    }
    err = cudaGetLastError();
  });
  return static_cast<int>(err);
}
