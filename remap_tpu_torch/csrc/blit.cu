// K3: the colour-vote blit into an atlas or fragment canvas (fgm.hpp's
// vote add), in place, over the frames' box only.
//
// Replaces remap_tpu/ops/pallas/blit.py: blit_frames (body
// _make_blit_kernel).  The TPU kernel keeps the atlas in a VMEM scratch
// accumulator across a sequential grid of frame groups, splits positions
// into (8, 128)-aligned bases plus pre-rolled frames, and encodes
// non-voting pixels as colour 16.  GPU blocks run in no order and carry
// nothing between them, so the work is turned around:
//
// - The grid spans a box of the canvas that the caller knows holds every
//   frame (the whole canvas when it knows nothing), one block per tile of
//   128 pixels of one row.  A block first compacts into shared memory
//   the frames whose rectangle meets its tile (one test per frame, warp
//   ballots, one shared atomic per warp); a block that no frame meets
//   exits without touching the canvas, so the canvas is read and written
//   only where frames land.
// - The tile's histogram lives in shared memory: 16 colour bins of 16
//   bits for each of its 128 pixels, two bins to a 32-bit word, laid out
//   so that a warp's 32 lanes hit 32 banks.  The block's 8 warps split
//   the listed frames (each takes every 8th group of 8).  A lane owns 4
//   adjacent pixels: it reads the 4 frame bytes it needs as one 32-bit
//   value (its aligned word, its right neighbour's by a warp shuffle, and
//   a funnel shift; bytes outside the frame masked to "no vote"; no
//   branch, so a group's loads are in flight together), the caller's vote
//   plane the same way, folds the plane into the colours (a barred pixel
//   becomes colour 0xFF, as the TPU kernel's colour 16), and adds each
//   pixel's vote with one shared atomic (an add of 0 where it does not
//   vote).  The
//   listing stores each frame's row offset, so the loop does no 64-bit
//   multiply.  The wrapper caps F below 2^16, so a 16-bit field never
//   carries into its neighbour.
// - The vote plane is read with a polarity: votes where it is != 0
//   (vote_ok), where it is == 0 (foreground masks), or, for a null plane,
//   everywhere.  Colours >= 16 never vote.
// - Then the warps add the histogram into the canvas in place, two bins
//   each: `(dots + count) & 0xFFFF` (the uint16 wraparound of the
//   reference's vote counters, fgm.hpp:12-15, on int32 storage), one
//   16-byte load and store per bin that received a vote among a lane's 4
//   pixels; a bin without a vote keeps its bits, as in the plain version.
//
// Every sum is of integers and every canvas bin has one writer, so the
// result cannot depend on the order of frames, warps or blocks.  Dropped
// designs (times in PERF.md): 64-bit register counters (four 16-bit bins
// each) with one warp per tile row, then with 8 warps splitting the
// frames and meeting at the end (four compare-and-add steps per vote cost
// more than one shared atomic); run-length or group-leader aggregation of
// equal votes before the atomic (the compares cost more than the atomics
// they saved); a second load per lane in place of the shuffle (6%
// slower).  Bound on this card: the per-vote work of the load and count
// path (instruction issue and shared atomics; its time grows with the
// votes, PERF.md), not the bytes (frames and vote plane read once, the
// bins that take a vote in and out), which would take a sixth of its time
// (a quarter with a mask plane).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PX = 4;            // adjacent canvas pixels per lane
constexpr int TX = 32;           // lanes across a tile (one warp)
constexpr int SLICES = 8;        // warps of a block; they split its frames
constexpr int TILE_W = TX * PX;  // 128 canvas pixels of one row
constexpr int CHUNK = 1024;      // frames tested per pass
constexpr int UNROLL = 8;        // frames whose loads are in flight together
constexpr int DEPTH = 16;        // colour bins (fgm.hpp:12)
constexpr int PAIRS = DEPTH / 2; // 32-bit words of two 16-bit bins
constexpr int FAR = 1 << 29;     // a padding entry's x: meets no pixel

// One listed frame of a block's row: the byte offset of the frame row
// that lands on the row (frame * H * W + (y - frame y) * W, as two
// 32-bit halves) and the frame's x on the canvas.
struct alignas(16) Hit {
  uint32_t off_lo, off_hi;
  int x, pad;
};

// Bytes k of a 4-byte group at fx0 with fx0 + k outside [0, W), as a
// mask: __funnelshift_lc / _rc clamp the shift at 32, so 0 and 4 cut
// bytes need no special case.
__device__ __forceinline__ uint32_t outside_mask(int fx0, int W) {
  const int below = min(max(-fx0, 0), PX);         // leading bytes before 0
  const int above = min(max(fx0 + PX - W, 0), PX);  // trailing bytes past W
  return __funnelshift_lc(0xFFFFFFFFu, 0u, 8 * below) |
         __funnelshift_rc(0u, 0xFFFFFFFFu, 8 * above);
}

// The 4 bytes row[fx0 .. fx0 + 3] of a W-byte row, 0xFF where outside it;
// called by a whole warp on one row, lane i at fx0 + 4 i.  ALIGNED (W % 4
// == 0 and 4-byte aligned storage): each lane loads one clamped word, takes
// the next from the lane to its right (the last lane loads its own) and
// funnel-shifts the pair, with no branch around the loads, so a group's
// loads are in flight together; else byte loads.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int fx0, int W, int lane) {
  if (ALIGNED) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
    const int last = (W >> 2) - 1;
    const int a = fx0 >> 2;  // floor, also for fx0 < 0
    const uint32_t lo = __ldg(r + min(max(a, 0), last));
    uint32_t hi = __shfl_down_sync(0xFFFFFFFFu, lo, 1);
    if (lane == TX - 1) hi = __ldg(r + min(max(a + 1, 0), last));
    return __funnelshift_r(lo, hi, 8 * (fx0 & 3)) | outside_mask(fx0, W);
  }
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int fx = fx0 + k;
    const uint32_t b = (fx >= 0 && fx < W) ? __ldg(row + fx) : 0xFFu;
    v |= b << (8 * k);
  }
  return v;
}

// The 4 colours with each pixel that the vote plane bars set to 0xFF, a
// colour that never votes (SWAR over the 4 bytes).  POL: 0 every pixel
// votes, 1 votes where the plane is != 0, 2 where it is == 0.
template <int POL>
__device__ __forceinline__ uint32_t apply_plane(uint32_t colours, uint32_t plane) {
  if (POL == 0) return colours;
  const uint32_t hi = (((plane & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | plane) & 0x80808080u;
  const uint32_t nonzero = (hi >> 7) * 0xFFu;  // 0xFF where the plane's byte != 0
  return colours | (POL == 1 ? ~nonzero : nonzero);
}

// One shared atomic per pixel of a lane's 4: its colour's 16-bit field,
// or 0 into pair 0 where the pixel does not vote (no branch).
__device__ __forceinline__ void count4(uint32_t* lane_hist, uint32_t colours) {
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const uint32_t v = (colours >> (8 * k)) & 0xFFu;
    const uint32_t inc = v < DEPTH ? 1u << (16 * (v & 1)) : 0u;
    atomicAdd(lane_hist + ((v >> 1) & (PAIRS - 1)) * (PX * TX) + k * TX, inc);
  }
}

// (d + n) mod 2^16 where n != 0, d unchanged where n == 0.
__device__ __forceinline__ int add16(int d, int n) {
  return n ? static_cast<int>((static_cast<uint32_t>(d) + n) & 0xFFFFu) : d;
}

template <int POL, bool ALIGNED>
__global__ void __launch_bounds__(TX * SLICES)
blit_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ vote,
            const int2* __restrict__ pos, int F, int H, int W,
            int* __restrict__ dots, int AH, int AW, int bx0, int by0) {
  __shared__ Hit hits[CHUNK + UNROLL];  // the frames meeting the tile
  __shared__ uint32_t hist[PAIRS][PX][TX];
  __shared__ int n_hits;
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int tid = slice * TX + lane;
  const int tx0 = bx0 + blockIdx.y * TILE_W;  // x tiles on grid.y (few)
  const int y = by0 + blockIdx.x;             // rows on grid.x (many)
  const int x0 = tx0 + lane * PX;
  const size_t plane = static_cast<size_t>(H) * W;

  for (int i = tid; i < PAIRS * PX * TX; i += TX * SLICES) (&hist[0][0][0])[i] = 0;
  uint32_t* lane_hist = &hist[0][0][lane];
  int listed = 0;  // frames met over all passes (block-uniform)
  for (int f0 = 0; f0 < F; f0 += CHUNK) {
    const int nf = min(CHUNK, F - f0);
    __syncthreads();  // the previous pass is done with hits and n_hits
    if (tid == 0) n_hits = 0;
    __syncthreads();
    for (int i0 = 0; i0 < nf; i0 += TX * SLICES) {
      const int i = i0 + tid;
      int2 p = make_int2(0, 0);
      bool hit = false;
      if (i < nf) {
        p = pos[f0 + i];
        hit = p.x < tx0 + TILE_W && p.x + W > tx0 && p.y <= y && p.y + H > y;
      }
      const unsigned m = __ballot_sync(0xFFFFFFFFu, hit);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&n_hits, __popc(m));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (hit) {
        const size_t off = static_cast<size_t>(f0 + i) * plane +
                           static_cast<size_t>(y - p.y) * W;
        hits[base + __popc(m & ((1u << lane) - 1))] =
            Hit{static_cast<uint32_t>(off), static_cast<uint32_t>(off >> 32), p.x, 0};
      }
    }
    __syncthreads();
    const int n = n_hits;
    listed += n;
    // pad the list to whole groups with entries whose pixels all fall
    // outside their (valid) row: they vote nowhere
    if (tid < UNROLL) hits[n + tid] = Hit{0u, 0u, -FAR, 0};
    __syncthreads();
    for (int j0 = slice * UNROLL; j0 < n; j0 += SLICES * UNROLL) {
      uint32_t cw[UNROLL], vw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const Hit h = hits[j0 + u];
        const size_t row = (static_cast<size_t>(h.off_hi) << 32) | h.off_lo;
        const int fx0 = x0 - h.x;
        cw[u] = load4<ALIGNED>(frames + row, fx0, W, lane);
        vw[u] = POL != 0 ? load4<ALIGNED>(vote + row, fx0, W, lane) : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) count4(lane_hist, apply_plane<POL>(cw[u], vw[u]));
    }
  }
  if (listed == 0) return;  // block-uniform: no frame meets the tile
  __syncthreads();          // every vote is in hist
  if (y >= AH || x0 >= AW) return;

  // the warps split the bins; AW % 4 == 0, x0 % 4 == 0 and a 16-byte
  // aligned canvas: one int4 per bin of a lane's 4 pixels
  const size_t channel = static_cast<size_t>(AH) * AW;
  int* base = dots + static_cast<size_t>(y) * AW + x0;
  for (int ch = slice; ch < DEPTH; ch += SLICES) {
    int n[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      n[k] = static_cast<int>((hist[ch >> 1][k][lane] >> (16 * (ch & 1))) & 0xFFFFu);
    }
    if ((n[0] | n[1] | n[2] | n[3]) == 0) continue;
    int4* p = reinterpret_cast<int4*>(base + ch * channel);
    int4 d = *p;
    // a bin without a vote keeps its bits, whatever it holds
    d.x = add16(d.x, n[0]);
    d.y = add16(d.y, n[1]);
    d.z = add16(d.z, n[2]);
    d.w = add16(d.w, n[3]);
    *p = d;
  }
}

template <bool ALIGNED>
void launch(int polarity, dim3 grid, cudaStream_t s, const uint8_t* frames,
            const uint8_t* vote, const int2* p, int F, int H, int W, int* dots,
            int AH, int AW, int x_lo, int y_lo) {
  const dim3 block(TX, SLICES);
  if (polarity == 0) {
    blit_kernel<0, ALIGNED><<<grid, block, 0, s>>>(frames, vote, p, F, H, W, dots, AH, AW,
                                                   x_lo, y_lo);
  } else if (polarity == 1) {
    blit_kernel<1, ALIGNED><<<grid, block, 0, s>>>(frames, vote, p, F, H, W, dots, AH, AW,
                                                   x_lo, y_lo);
  } else {
    blit_kernel<2, ALIGNED><<<grid, block, 0, s>>>(frames, vote, p, F, H, W, dots, AH, AW,
                                                   x_lo, y_lo);
  }
}

}  // namespace

// Adds the votes of frames [F, H, W] at pos [F, 2] (x, y) into dots
// [16, AH, AW] in place.  The grid spans the box [x_lo, x_hi) x [y_lo, y_hi)
// of the canvas, which must hold every frame's rectangle; polarity 0: no
// vote plane (vote may be null), 1: vote where vote != 0, 2: where == 0.
extern "C" int remap_blit(const uint8_t* frames, const uint8_t* vote, int polarity,
                          const int32_t* pos, int F, int H, int W, int32_t* dots,
                          int AH, int AW, int x_lo, int y_lo, int x_hi, int y_hi,
                          void* stream) {
  if (F < 0 || F > 0xFFFF || H <= 0 || W <= 0 || AH <= 0 || AW <= 0 ||
      (AW & 3) != 0 || (reinterpret_cast<uintptr_t>(dots) & 15) != 0 ||
      polarity < 0 || polarity > 2 || (polarity != 0 && vote == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  x_lo = max(x_lo, 0) & ~3;  // 4-aligned, so each thread's pixels share an int4
  y_lo = max(y_lo, 0);
  x_hi = min(x_hi, AW);
  y_hi = min(y_hi, AH);
  if (F == 0 || x_hi <= x_lo || y_hi <= y_lo) return static_cast<int>(cudaSuccess);
  const dim3 grid(y_hi - y_lo, (x_hi - x_lo + TILE_W - 1) / TILE_W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* p = reinterpret_cast<const int2*>(pos);
  const bool aligned = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(frames) & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(vote) & 3) == 0;
  if (aligned) {
    launch<true>(polarity, grid, s, frames, vote, p, F, H, W, dots, AH, AW, x_lo, y_lo);
  } else {
    launch<false>(polarity, grid, s, frames, vote, p, F, H, W, dots, AH, AW, x_lo, y_lo);
  }
  return static_cast<int>(cudaGetLastError());
}
