// K2: SALSA noise-floor tracker for Hopper (sm_90a).
//
// Replaces salsa_tpu/features/salsa.py::noise_floor_scan (a lax.scan over frames)
// fed by tracking_magspec_planes; on the TPU both are XLA ops, not Pallas. Per
// (clip, bin) row of channel 0: the 3-frame RMS magnitude
// sqrt(((|x[t]|^2 + |x[t-1]|^2) + |x[t-2]|^2) / 3); the clip-start floor, 0.5 x the
// mean of the first min(5, n_frames) frames summed in frame order with countdown
// 3, or the entering
// state; the up/down tracker (rise x1.02, x1.002 once the 3-frame countdown has
// run out, fall x0.98, floor >= 1e-6); mask = mag > snr_ratio * next floor; and
// the final (floor, countdown).
//
// What bounds it on the H100, at the serving shape (764 rows x 4,807 frames):
// - bytes: 29.4 MB of re/im planes read once and 3.7 MB of mask written, 0.010 ms
//   at 3.35 TB/s;
// - the recurrence, the true floor: 4,807 dependent steps per row, ~16-24 clk
//   each, ~0.04-0.06 ms at 1.98 GHz. Only 24 blocks of 32 rows exist, so each
//   block's copies and magnitudes must keep pace with its own chain.
//
// Design: a block owns 32 rows and walks the frames in tiles of kTile.
// - Producer warps copy each tile's re/im (its frames and the two before them)
//   into shared memory with 4-byte cp.async, neighbouring lanes on neighbouring
//   frames (the rows start at odd offsets, so wider copies would be misaligned).
//   They compute each power once, the magnitudes from neighbouring powers by warp
//   shuffles, and store them transposed as mag[stage][frame][33] (padded: no bank
//   conflicts either way).
// - One consumer warp runs the recurrence, a lane per row, from shared memory
//   only: it reads the next 8 magnitudes into registers, then runs 8 dependent
//   steps with no memory access on the chain, and packs 4 mask flags per 32-bit
//   word into mask[stage][row][kTile/4 + 1]. The producers store the words back
//   as bytes, coalesced along each row.
// - Two stages: while the consumer walks tile k, the producers compute tile k+1's
//   magnitudes (tile k+2's copies in flight) and store tile k-1's mask. Named
//   barriers (bar.sync / bar.arrive with a thread count) hand each stage over. No
//   thread returns early: rows past `rows` and frames past n_frames are masked.
// - kTile and the producer-warp count were picked on an H100 with
//   scripts/bench_noise_floor.py; the producers' copies and magnitudes, not the
//   chain, set the pace (PERF.md).
// restart (`noise_floor_launch`'s, for streaming): a byte per clip; the rows
// of a flagged clip take the clip-start floor from this launch's first frames and
// countdown 3, as with no entering state, while the other rows resume from theirs.
// A stream pool starts a slot's new stream this way in the launch that carries
// the other slots' streams on.
// collect_states (a second instantiation, `noise_floor_states_launch`): the
// consumer holds (floor, countdown) in registers before each step, and stores
// that pre-state to floor_states / countdown_states laid out (clips, n_frames,
// n_bins). The lanes of the consumer warp hold neighbouring (clip, bin) rows, so
// each frame's 32 stores are contiguous within a clip. Training takes the states
// once per clip at setup to checkpoint the tracker at every chunk start; the
// mask-only instantiation that serving launches has none of this code.
//
// Every product, sum, quotient and root is written with __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn so nvcc cannot contract them into FMAs: mask and state
// are bit-equal to the plain PyTorch version, which sums in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

// frames per tile and producer warps per block; a build may override either
#ifndef NF_TILE_FRAMES
#define NF_TILE_FRAMES 128
#endif
#ifndef NF_PRODUCER_WARPS
#define NF_PRODUCER_WARPS 11
#endif

namespace {

constexpr int kRows = 32;
constexpr int kTile = NF_TILE_FRAMES;
constexpr int kProducerWarps = NF_PRODUCER_WARPS;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kProducers + 32;
constexpr int kGroup = 8;               // magnitudes read ahead by the consumer
constexpr int kRawPitch = kTile + 4;    // tile frames plus the 2 before, padded
constexpr int kMagPitch = kRows + 1;
constexpr int kMaskPitch = kTile / 4 + 1;
static_assert(kTile % 32 == 0 && kTile >= 32, "a tile is whole warps of frames");
static_assert(kProducerWarps >= 1 && kThreads <= 1024, "1-31 producer warps");

// named barriers; 0 is __syncthreads'
constexpr int kBarProducers = 1;  // producers only: a tile's copies have landed
constexpr int kBarFull = 2;       // + stage: magnitudes ready for the consumer
constexpr int kBarEmpty = 4;      // + stage: consumer done with magnitudes and mask

struct Smem {
  float raw[2][2][kRows][kRawPitch];  // [stage][re, im][row][frame - tile start + 2]
  float mag[2][kTile][kMagPitch];     // [stage][frame][row]
  uint32_t mask[2][kRows][kMaskPitch];  // [stage][row][4 frames]
};

struct Tracker {
  float snr, up, up_slow, down;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Producers: start the copies of tile k (frames k*kTile - 2 ..) of the block's rows.
__device__ __forceinline__ void copy_tile(Smem& sm, int st, const float* __restrict__ xr,
                                          const float* __restrict__ xi, int row0, int rows,
                                          long long tp, int n_hop, int n_frames, int k,
                                          int pw, int lane) {
  const int f0 = k * kTile;
  const int count = min(kTile + 2, n_frames - f0 + 2);
  for (int r = pw; r < kRows && row0 + r < rows; r += kProducerWarps) {
    const long long base = (long long)(row0 + r) * tp + n_hop + f0 - 2;
    for (int i = lane; i < count; i += 32) {
      cp_async4(&sm.raw[st][0][r][i], xr + base + i);
      cp_async4(&sm.raw[st][1][r][i], xi + base + i);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float power(const float* re, const float* im, int i) {
  return __fadd_rn(__fmul_rn(re[i], re[i]), __fmul_rn(im[i], im[i]));
}

// Producers: a tile's magnitudes from its planes in raw[st], transposed into
// mag[st]. Rows and frames past the data hold whatever the buffers held; nothing
// reads their results.
__device__ __forceinline__ void tile_magnitudes(Smem& sm, int st, int pw, int lane) {
  for (int r = pw; r < kRows; r += kProducerWarps) {
    const float* re = sm.raw[st][0][r];
    const float* im = sm.raw[st][1][r];
    // lanes 0 and 1 hold the powers of the two frames before the chunk
    float before = lane < 2 ? power(re, im, lane) : 0.0f;
#pragma unroll
    for (int c = 0; c < kTile; c += 32) {
      const float p0 = power(re, im, c + lane + 2);  // frame t = tile start + c + lane
      const float up1 = __shfl_up_sync(0xffffffffu, p0, 1);
      const float up2 = __shfl_up_sync(0xffffffffu, p0, 2);
      const float b0 = __shfl_sync(0xffffffffu, before, 0);
      const float b1 = __shfl_sync(0xffffffffu, before, 1);
      const float p1 = lane == 0 ? b1 : up1;                     // frame t - 1
      const float p2 = lane == 0 ? b0 : (lane == 1 ? b1 : up2);  // frame t - 2
      sm.mag[st][c + lane][r] =
          __fsqrt_rn(__fdiv_rn(__fadd_rn(__fadd_rn(p0, p1), p2), 3.0f));
      before = __shfl_sync(0xffffffffu, p0, (lane + 30) & 31);  // lanes 30, 31 -> 0, 1
    }
  }
}

// Producers: tile k's mask words back to the (rows, n_frames) byte mask.
__device__ __forceinline__ void store_mask(const Smem& sm, int st, uint8_t* __restrict__ mask,
                                           int row0, int rows, int n_frames, int k, int pw,
                                           int lane) {
  const int f0 = k * kTile;
  const int count = min(kTile, n_frames - f0);
  for (int r = pw; r < kRows && row0 + r < rows; r += kProducerWarps) {
    uint8_t* dst = mask + (long long)(row0 + r) * n_frames + f0;
    const uint32_t* words = sm.mask[st][r];
    for (int i = lane; i < count; i += 32) dst[i] = (words[i >> 2] >> (8 * (i & 3))) & 0xffu;
  }
}

// One tracker step on magnitude x; returns the mask flag. `slow` is
// countdown < 1: a rise then takes the slow factor (countdown - 1 < 0). The rise
// (chosen by `slow`, known a step ahead) and the fall are formed and clamped while
// x > floor is compared, so the chain from one floor to the next is that compare
// and one select; max(select(a, b), m) = select(max(a, m), max(b, m)).
__device__ __forceinline__ bool track(float x, float& floor, int& countdown, bool& slow,
                                      const Tracker& tr) {
  const float rise = fmaxf(__fmul_rn(floor, slow ? tr.up_slow : tr.up), 1e-6f);
  const float fall = fmaxf(__fmul_rn(floor, tr.down), 1e-6f);
  const bool above = x > floor;
  floor = above ? rise : fall;
  slow = above && countdown < 2;
  countdown = above ? countdown - 1 : 3;
  return x > __fmul_rn(tr.snr, floor);
}

// Consumer: the first n_valid frames of a tile for this lane's row. mag points at
// the lane's column of mag[stage], words at its row of mask[stage]. With kCollect,
// sf/sc point at the tile's first frame of the lane's row in the state outputs,
// frames `stride` apart, and `live` says whether the lane has a row.
template <bool kRagged, bool kCollect>
__device__ __forceinline__ void track_tile(const float* mag, uint32_t* words, int n_valid,
                                           float& floor, int& countdown, bool& slow,
                                           const Tracker& tr, float* sf, int* sc, int stride,
                                           bool live) {
  float x[kGroup];
#pragma unroll
  for (int s = 0; s < kGroup; ++s) x[s] = mag[s * kMagPitch];
#pragma unroll
  for (int g = 0; g < kTile; g += kGroup) {
    if (kRagged && g >= n_valid) break;
    float next[kGroup];
#pragma unroll
    for (int s = 0; s < kGroup; ++s)
      next[s] = g + kGroup < kTile ? mag[(g + kGroup + s) * kMagPitch] : 0.0f;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (!kRagged || g + s < n_valid) {
        if (kCollect && live) {
          sf[(g + s) * stride] = floor;
          sc[(g + s) * stride] = countdown;
        }
        if (track(x[s], floor, countdown, slow, tr)) w[s >> 2] |= 1u << (8 * (s & 3));
      }
    }
    words[g >> 2] = w[0];
    words[(g >> 2) + 1] = w[1];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) x[s] = next[s];
  }
}

// xr0, xi0: (rows, n_frames + 2*n_hop) channel-0 planes, one row per (clip, bin).
// floor0/countdown0: entering state per row, or null for the clip-start state.
// restart: null, or a byte per clip of n_bins rows; a nonzero byte gives its rows
// the clip-start state whatever floor0 holds. n_frames >= 1. mask: (rows, n_frames) bytes; floor_out/countdown_out:
// final state per row. With kCollect, floor_states/countdown_states: the state
// entering every frame, (rows / n_bins, n_frames, n_bins). Warp 0 is the
// consumer, warps 1.. the producers.
template <bool kCollect>
__global__ void __launch_bounds__(kThreads) noise_floor_kernel(
    const float* __restrict__ xr0, const float* __restrict__ xi0,
    const float* __restrict__ floor0, const int* __restrict__ countdown0,
    const uint8_t* __restrict__ restart, uint8_t* __restrict__ mask, float* __restrict__ floor_out,
    int* __restrict__ countdown_out, float* __restrict__ floor_states,
    int* __restrict__ countdown_states, int rows, int n_frames, int n_bins, int n_hop,
    Tracker tr) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int n_tiles = (n_frames + kTile - 1) / kTile;

  if (warp == 0) {
    const int row = row0 + lane;
    const bool live = row < rows;
    bool start = floor0 == nullptr;
    if (!start && restart != nullptr && live) start = restart[row / n_bins] != 0;
    float floor = 0.0f;
    int countdown = 3;
    if (!start && live) {
      floor = floor0[row];
      countdown = countdown0[row];
    }
    bool slow = countdown < 1;  // the clip start's countdown 3 keeps it false
    float* sf = nullptr;
    int* sc = nullptr;
    if (kCollect && live) {
      const long long base =
          (long long)(row / n_bins) * n_frames * n_bins + row % n_bins;
      sf = floor_states + base;
      sc = countdown_states + base;
    }
    for (int k = 0; k < n_tiles; ++k) {
      const int st = k & 1;
      bar_sync(kBarFull + st, kThreads);
      const float* mag = &sm.mag[st][0][lane];
      if (k == 0 && start) {
        // 0.5 * mean of the first min(5, n_frames) frames, summed in frame
        // order; frames past n_frames in the tile hold no data
        const int n0 = min(5, n_frames);
        float s = mag[0];
        for (int t = 1; t < n0; ++t) s = __fadd_rn(s, mag[t * kMagPitch]);
        floor = __fmul_rn(__fdiv_rn(s, (float)n0), 0.5f);
      }
      const int n_valid = min(kTile, n_frames - k * kTile);
      const long long t0 = (long long)k * kTile * n_bins;
      float* tsf = kCollect && live ? sf + t0 : nullptr;
      int* tsc = kCollect && live ? sc + t0 : nullptr;
      if (n_valid == kTile)
        track_tile<false, kCollect>(mag, sm.mask[st][lane], kTile, floor, countdown, slow, tr,
                                    tsf, tsc, n_bins, live);
      else
        track_tile<true, kCollect>(mag, sm.mask[st][lane], n_valid, floor, countdown, slow, tr,
                                   tsf, tsc, n_bins, live);
      bar_arrive(kBarEmpty + st, kThreads);
    }
    if (live) {
      floor_out[row] = floor;
      countdown_out[row] = countdown;
    }
  } else {
    const int pw = warp - 1;
    const long long tp = (long long)n_frames + 2 * n_hop;
    if (n_tiles > 0) copy_tile(sm, 0, xr0, xi0, row0, rows, tp, n_hop, n_frames, 0, pw, lane);
    for (int k = 0; k < n_tiles; ++k) {
      const int st = k & 1;
      cp_async_wait_all();
      // tile k has landed for every producer, and all are done with tile k-1's copies
      bar_sync(kBarProducers, kProducers);
      if (k + 1 < n_tiles)
        copy_tile(sm, st ^ 1, xr0, xi0, row0, rows, tp, n_hop, n_frames, k + 1, pw, lane);
      if (k >= 2) {
        bar_sync(kBarEmpty + st, kThreads);  // the consumer is done with tile k-2
        store_mask(sm, st, mask, row0, rows, n_frames, k - 2, pw, lane);
      }
      tile_magnitudes(sm, st, pw, lane);
      bar_arrive(kBarFull + st, kThreads);
    }
    for (int k = max(n_tiles - 2, 0); k < n_tiles; ++k) {
      bar_sync(kBarEmpty + (k & 1), kThreads);
      store_mask(sm, k & 1, mask, row0, rows, n_frames, k, pw, lane);
    }
  }
}

template <bool kCollect>
int launch(const void* xr0, const void* xi0, const void* floor0, const void* countdown0,
           const void* restart, void* mask, void* floor_out, void* countdown_out, void* floor_states,
           void* countdown_states, int rows, int n_frames, int n_bins, int n_hop,
           const Tracker& tr, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  const cudaError_t err = cudaFuncSetAttribute(
      noise_floor_kernel<kCollect>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + kRows - 1) / kRows;
  noise_floor_kernel<kCollect><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr0), static_cast<const float*>(xi0),
      static_cast<const float*>(floor0), static_cast<const int*>(countdown0),
      static_cast<const uint8_t*>(restart), static_cast<uint8_t*>(mask), static_cast<float*>(floor_out),
      static_cast<int*>(countdown_out), static_cast<float*>(floor_states),
      static_cast<int*>(countdown_states), rows, n_frames, n_bins, n_hop, tr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success). restart: null,
// or a byte per clip of n_bins rows (rows is then a whole number of clips); the
// rows of a clip whose byte is nonzero start the clip at this launch's first frame
// instead of resuming from floor0/countdown0.
extern "C" int noise_floor_launch(const void* xr0, const void* xi0, const void* floor0,
                                  const void* countdown0, const void* restart, void* mask,
                                  void* floor_out, void* countdown_out, int rows, int n_frames,
                                  int n_bins, int n_hop, float snr_ratio, float floor_up,
                                  float floor_up_slow, float floor_down, void* stream) {
  return launch<false>(xr0, xi0, floor0, countdown0, restart, mask, floor_out, countdown_out,
                       nullptr, nullptr, rows, n_frames, n_bins, n_hop,
                       Tracker{snr_ratio, floor_up, floor_up_slow, floor_down}, stream);
}

// As noise_floor_launch, and also the state entering every frame: floor_states
// (f32) and countdown_states (int32), each (rows / n_bins, n_frames, n_bins);
// rows is a whole number of clips of n_bins rows.
extern "C" int noise_floor_states_launch(const void* xr0, const void* xi0, const void* floor0,
                                         const void* countdown0, void* mask, void* floor_out,
                                         void* countdown_out, void* floor_states,
                                         void* countdown_states, int rows, int n_frames,
                                         int n_bins, int n_hop, float snr_ratio,
                                         float floor_up, float floor_up_slow,
                                         float floor_down, void* stream) {
  return launch<true>(xr0, xi0, floor0, countdown0, nullptr, mask, floor_out, countdown_out,
                      floor_states, countdown_states, rows, n_frames, n_bins, n_hop,
                      Tracker{snr_ratio, floor_up, floor_up_slow, floor_down}, stream);
}

// Frames per tile, so that a check can place its ragged lengths around it.
extern "C" int noise_floor_tile_frames() { return kTile; }
