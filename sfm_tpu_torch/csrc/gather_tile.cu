// Kernel K3: tile-resident patch sampler -- K2's function with each sample's
// window staged in shared memory by asynchronous copies.
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
//   single-buffered  stage a step's S windows, wait, extract and normalise;
//   double-buffered  start step i+1's copies before processing step i.
//
// Bounds on Hopper: the copies and the block barriers around each step
// (copy-only takes most of a full mode's time), not bytes.  A sample's
// window is 12 rows of 24 bytes at a data-dependent address; the stack of a
// 48 x 480 x 640 run (29 MB) sits in the 50 MB L2, so the copies are L2
// hits.  Design: a
// persistent grid (blocks = SMs x occupancy); a block walks the steps
// blockIdx.x, blockIdx.x + gridDim.x, ...; per step its first S threads derive
// the S window origins and fractions from (image, cx, cy); all 256 threads
// then start 8-byte cp.async copies, one per (sample, row, chunk); after the
// wait each warp takes samples warp, warp + 8, ... of the step from shared
// memory.  Nothing of the TPU kernel's layout is carried over: no 8-row
// slabs, no packed scalar operands, no lane rolls; its three extraction
// variants were ways to make Mosaic shift rows and lanes and collapse to the
// one indexed read here.
//
// Alignment: a window row starts at an arbitrary bf16 column (2-byte
// aligned) while cp.async takes 8 aligned bytes, so each row copies the
// 8-byte-aligned span that covers its 2*wid+2 columns (32 bytes for wid 5)
// and the reader adds the remainder (0-3 elements).  A span that would leave
// the stack (the first or last rows of the allocation) is read with plain
// 2-byte loads instead, element by element, zero outside.

#include <cuda_pipeline_primitives.h>

#include "gather_common.cuh"

namespace {

using namespace sfm_gather;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // bytes per asynchronous copy

struct SampleParams {
  unsigned long long addr;  // byte address of the window's first element
  float fx, fy;
};

// Bytes of one staged window row: the aligned span covering `win` columns.
__host__ __device__ inline int row_bytes_of(int win) {
  return (kChunk - 2 + 2 * win + kChunk - 1) / kChunk * kChunk;
}

template <int WID>
__global__ void gather_tile_kernel(const __nv_bfloat16* __restrict__ gray,
                                   const int* __restrict__ img_idx,
                                   const float* __restrict__ centers,
                                   __nv_bfloat16* __restrict__ out, int m,
                                   int n, int h, int w, int S, int n_steps,
                                   int double_buffer, int extract) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int wid = WID;
  constexpr int side = Patch<WID>::kSide;
  constexpr int win = Patch<WID>::kWin;
  constexpr int npix = Patch<WID>::kPix;
  const int row_bytes = row_bytes_of(win);
  const int row_chunks = row_bytes / kChunk;
  const int tile_bytes = S * win * row_bytes;
  const int nbuf = double_buffer ? 2 : 1;
  unsigned char* tiles = smem;  // [nbuf][S][win][row_bytes]
  SampleParams* params =
      reinterpret_cast<SampleParams*>(smem + nbuf * tile_bytes);  // [nbuf][S]
  const unsigned long long lo = reinterpret_cast<unsigned long long>(gray);
  const unsigned long long hi =
      lo + 2ull * static_cast<unsigned long long>(n) * h * w;
  const unsigned long long pitch = 2ull * w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Origins and fractions of step `step`'s samples, into params[buf].
  auto derive = [&](int step, int buf) {
    if (tid < S) {
      const int s = step * S + tid;
      SampleParams p;
      p.addr = 0ull;  // marks a slot beyond the last sample
      p.fx = p.fy = 0.0f;
      if (s < m) {
        const Window o = window_of(img_idx[s], centers[2 * s],
                                   centers[2 * s + 1], n, h, w, wid);
        p.addr = lo + 2ull * ((static_cast<unsigned long long>(o.img) * h +
                               o.by) * w + o.bx);
        p.fx = o.fx;
        p.fy = o.fy;
      }
      params[buf * S + tid] = p;
    }
  };

  // Start the copies of params[buf]'s windows into tiles[buf].
  auto start_copies = [&](int buf) {
    const int items = S * win * row_chunks;
    for (int it = tid; it < items; it += kThreads) {
      const int c = it % row_chunks;
      const int r = (it / row_chunks) % win;
      const int s = it / (row_chunks * win);
      const unsigned long long addr = params[buf * S + s].addr;
      if (addr == 0ull) continue;
      const unsigned long long span = (addr + r * pitch) & ~7ull;
      unsigned char* dst = tiles + static_cast<size_t>(buf) * tile_bytes +
                           (static_cast<size_t>(s) * win + r) * row_bytes +
                           c * kChunk;
      const unsigned long long src = span + c * kChunk;
      if (span >= lo && span + row_bytes <= hi) {
        __pipeline_memcpy_async(dst, reinterpret_cast<const void*>(src),
                                kChunk);
      } else {
        // The span leaves the stack: plain loads, zero outside.
        for (int k = 0; k < kChunk; k += 2) {
          unsigned short v = 0;
          if (src + k >= lo && src + k + 2 <= hi)
            v = *reinterpret_cast<const unsigned short*>(src + k);
          *reinterpret_cast<unsigned short*>(dst + k) = v;
        }
      }
    }
    __pipeline_commit();
  };

  // Extract (or copy out) the samples of `step` from tiles[buf].
  auto process = [&](int step, int buf) {
    for (int j = warp; j < S; j += kWarps) {
      const int s = step * S + j;
      if (s >= m) break;  // uniform per warp
      const SampleParams p = params[buf * S + j];
      const unsigned char* tile = tiles + static_cast<size_t>(buf) * tile_bytes +
                                  static_cast<size_t>(j) * win * row_bytes;
      auto element = [&](int r, int c) {
        const int rem = static_cast<int>((p.addr + r * pitch) & 7ull);
        return *reinterpret_cast<const __nv_bfloat16*>(
            tile + r * row_bytes + rem + 2 * c);
      };
      __nv_bfloat16* o = out + static_cast<size_t>(s) * npix;
      if (extract) {
        const float gx = __fsub_rn(1.0f, p.fx);
        const float gy = __fsub_rn(1.0f, p.fy);
        normalize_and_emit<WID>(
            [&](int r, int c) {
              return bilinear(__bfloat162float(element(r, c)),
                              __bfloat162float(element(r, c + 1)),
                              __bfloat162float(element(r + 1, c)),
                              __bfloat162float(element(r + 1, c + 1)), p.fx,
                              p.fy, gx, gy);
            },
            lane, [&](int q, __nv_bfloat16 v) { o[q] = v; });
      } else {
        for (int q = lane; q < npix; q += 32) o[q] = element(q / side, q % side);
      }
    }
  };

  if (!double_buffer) {
    for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
      derive(step, 0);
      __syncthreads();
      start_copies(0);
      __pipeline_wait_prior(0);
      __syncthreads();
      process(step, 0);
      __syncthreads();  // tile 0 and params 0 are rewritten next step
    }
    return;
  }
  int buf = 0;
  if (blockIdx.x < n_steps) {
    derive(blockIdx.x, 0);
    __syncthreads();
    start_copies(0);
  }
  for (int step = blockIdx.x; step < n_steps; step += gridDim.x) {
    const int next = step + gridDim.x;
    if (next < n_steps) {
      // The other buffer was processed in the previous iteration, which
      // ended with a barrier, so it is free.
      derive(next, buf ^ 1);
      __syncthreads();
      start_copies(buf ^ 1);
      __pipeline_wait_prior(1);  // this step's copies; the next stay in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    process(step, buf);
    __syncthreads();
    buf ^= 1;
  }
}

}  // namespace

extern "C" int sample_normalized_patches_tiled_bf16(
    const void* gray, const int* img_idx, const float* centers, void* out,
    int m, int n, int h, int w, int wid, int samples_per_block,
    int double_buffer, int extract, cudaStream_t stream) {
  const int S = samples_per_block;
  if (m <= 0 || n <= 0 || wid < 0 || wid > kMaxWid || h < 2 * wid + 2 ||
      w < 2 * wid + 2 || S < 1 || S > kThreads)
    return cudaErrorInvalidValue;
  const int win = 2 * wid + 2;
  const int nbuf = double_buffer ? 2 : 1;
  const size_t shared = static_cast<size_t>(nbuf) *
                        (static_cast<size_t>(S) * win * row_bytes_of(win) +
                         static_cast<size_t>(S) * sizeof(SampleParams));
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_wid(wid, [&](auto wid_c) {
    auto kernel = gather_tile_kernel<decltype(wid_c)::value>;
    if (shared > 48 * 1024) {
      // Above 48 KB a block's shared memory is dynamic and opted into.
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
      if (err != cudaSuccess) return;
    }
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, shared);
    if (err != cudaSuccess) return;
    if (per_sm < 1) {
      err = cudaErrorInvalidConfiguration;
      return;
    }
    const int n_steps = (m + S - 1) / S;
    const int blocks = n_steps < sms * per_sm ? n_steps : sms * per_sm;
    kernel<<<blocks, kThreads, shared, stream>>>(
        static_cast<const __nv_bfloat16*>(gray), img_idx, centers,
        static_cast<__nv_bfloat16*>(out), m, n, h, w, S, n_steps,
        double_buffer, extract);
    err = cudaGetLastError();
  });
  return static_cast<int>(err);
}
