// K2: per-region keypoint tables (kpr.hpp's select + compact).
//
// Replaces remap_tpu/ops/pallas/tables.py: build_tables_pallas (body
// _kernel, helpers _shifted and _inc_cumsum).  On the TPU a gather costs
// ~9 ns a row, so that kernel moves the 4-word code payload through a
// binary-distance shift network of lane/sublane rolls over a padded VMEM
// slab.  A GPU gathers and scatters at memory speed, so the compaction is
// the textbook one instead:
//
// - One block per (frame, grid region).  The block walks the region's
//   pixels in row-major order, 512 at a time; each chunk's keypoint flags
//   (weight > 0) get a block-wide exclusive prefix sum (warp ballots and
//   popcounts, then one pass over the 16 warp totals), and every keypoint
//   whose rank is below K scatters its 16-byte code and (x, y) position to
//   table row `rank`.  Ranks are row-major, so this is the stable
//   first-K selection of ops/tables.py (topk) and of the TPU kernel.
// - Rows at or past the keypoint count take K2's canonical values (the
//   code of the region's first pixel and position (x_lo, y_lo),
//   ops/pallas/tables.py:258-264); `valid` is `row < #w1 + #w2`,
//   `wcounts` is (0, #w1, #w2) over the whole region and `overflow` is
//   `#w1 + #w2 > K`.
//
// Bound on this card: memory and the 2048 small blocks of the NES
// batch.  Each block reads its region's weight bytes once (~9 KB at NES)
// and at most K code words; the scan costs two barriers per 512 pixels.
// Where (frames x regions) cannot fill the card (splice: one region of
// one canvas), `remap_tables_chunked` below splits each region over many
// blocks instead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;     // threads per block = pixels per chunk
constexpr int NWARP = NT / 32;
constexpr int MAX_R = 64;   // regions per layout the by-value spans hold

struct Spans {
  int v[MAX_R][4];  // (x_lo, x_hi, y_lo, y_hi) per region
};

__global__ void __launch_bounds__(NT)
tables_kernel(const uint8_t* __restrict__ weight, const uint4* __restrict__ codes,
              int H, int W, int K, Spans spans,
              uint4* __restrict__ out_codes, int2* __restrict__ out_pos,
              uint8_t* __restrict__ out_valid, int* __restrict__ out_wcounts,
              uint8_t* __restrict__ out_overflow) {
  __shared__ int warp_count[NWARP];
  __shared__ int weight_count[2];

  const int r = blockIdx.x;
  const int R = gridDim.x;
  const int b = blockIdx.y;
  const int x_lo = spans.v[r][0];
  const int x_hi = spans.v[r][1];
  const int y_lo = spans.v[r][2];
  const int y_hi = spans.v[r][3];
  const int rw = x_hi - x_lo;
  const int n = rw * (y_hi - y_lo);
  const size_t frame = static_cast<size_t>(b) * H * W;
  const size_t row0 = (static_cast<size_t>(b) * R + r) * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    weight_count[0] = 0;
    weight_count[1] = 0;
  }
  __syncthreads();

  int w1 = 0, w2 = 0;
  int base = 0;  // keypoints in earlier chunks (the same in every thread)
  for (int start = 0; start < n; start += NT) {
    const int i = start + threadIdx.x;
    int x = 0, y = 0, w = 0;
    if (i < n) {
      y = y_lo + i / rw;
      x = x_lo + i % rw;
      w = weight[frame + static_cast<size_t>(y) * W + x];
    }
    w1 += w == 1;
    w2 += w == 2;
    const bool keypoint = w > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keypoint);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int j = 0; j < NWARP; ++j) {
      const int c = warp_count[j];
      before += j < warp ? c : 0;
      chunk += c;
    }
    const int rank = base + before + __popc(ballot & ((1u << lane) - 1u));
    if (keypoint && rank < K) {
      out_codes[row0 + rank] = codes[frame + static_cast<size_t>(y) * W + x];
      out_pos[row0 + rank] = make_int2(x, y);
    }
    base += chunk;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }

  w1 = __reduce_add_sync(0xffffffffu, w1);
  w2 = __reduce_add_sync(0xffffffffu, w2);
  if (lane == 0) {
    atomicAdd(&weight_count[0], w1);
    atomicAdd(&weight_count[1], w2);
  }
  __syncthreads();
  const int total = weight_count[0] + weight_count[1];

  const uint4 first_code = codes[frame + static_cast<size_t>(y_lo) * W + x_lo];
  for (int s = threadIdx.x; s < K; s += NT) {
    out_valid[row0 + s] = s < total;
    if (s >= base) {
      out_codes[row0 + s] = first_code;
      out_pos[row0 + s] = make_int2(x_lo, y_lo);
    }
  }
  if (threadIdx.x == 0) {
    int* wc = out_wcounts + (static_cast<size_t>(b) * R + r) * 3;
    wc[0] = 0;
    wc[1] = weight_count[0];
    wc[2] = weight_count[1];
    out_overflow[static_cast<size_t>(b) * R + r] = total > K;
  }
}

// ---- the chunked route: few regions, many pixels each ----------------------
//
// One block per region walks the region serially: at splice's shape (one
// whole-canvas region of a single frame, ~1.5M pixels) that is one block
// on one SM for ~3,000 steps.  The chunked route splits every region into
// `chunk`-pixel pieces, row-major, one block each, in two launches:
//
// 1. count: each block counts its piece's weight-1 and weight-2 pixels
//    into counts[b, r, c];
// 2. scatter: each block sums the keypoint counts of the earlier pieces of
//    its region (its rank base) and of all of them (the region's total),
//    then ranks and scatters its own keypoints exactly as the one-block
//    route does, and fills its share of the K rows' `valid` flags and
//    canonical rows.  Block 0 of a region writes `wcounts` and `overflow`.
//
// Ranks are the same row-major ranks, so the tables equal the one-block
// route's (and the plain version's) bit for bit.

__device__ __forceinline__ int block_sum(int v, int* slot) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicAdd(slot, v);
  __syncthreads();
  return *slot;
}

__global__ void __launch_bounds__(NT)
tables_count_kernel(const uint8_t* __restrict__ weight, int H, int W,
                    Spans spans, int chunk, int2* __restrict__ counts) {
  __shared__ int sums[2];
  const int c = blockIdx.x;
  const int C = gridDim.x;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int b = blockIdx.z;
  const int x_lo = spans.v[r][0];
  const int y_lo = spans.v[r][2];
  const int rw = spans.v[r][1] - x_lo;
  const int n = rw * (spans.v[r][3] - y_lo);
  const int start = c * chunk;
  const int end = min(n, start + chunk);
  const size_t frame = static_cast<size_t>(b) * H * W;
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  __syncthreads();
  int w1 = 0, w2 = 0;
  for (int i = start + threadIdx.x; i < end; i += NT) {
    const int w = weight[frame + static_cast<size_t>(y_lo + i / rw) * W +
                         x_lo + i % rw];
    w1 += w == 1;
    w2 += w == 2;
  }
  w1 = block_sum(w1, &sums[0]);
  w2 = block_sum(w2, &sums[1]);
  if (threadIdx.x == 0) {
    counts[(static_cast<size_t>(b) * R + r) * C + c] = make_int2(w1, w2);
  }
}

__global__ void __launch_bounds__(NT)
tables_scatter_kernel(const uint8_t* __restrict__ weight,
                      const uint4* __restrict__ codes, int H, int W, int K,
                      Spans spans, int chunk,
                      const int2* __restrict__ counts,
                      uint4* __restrict__ out_codes, int2* __restrict__ out_pos,
                      uint8_t* __restrict__ out_valid,
                      int* __restrict__ out_wcounts,
                      uint8_t* __restrict__ out_overflow) {
  __shared__ int warp_count[NWARP];
  __shared__ int sums[4];
  const int c = blockIdx.x;
  const int C = gridDim.x;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int b = blockIdx.z;
  const int x_lo = spans.v[r][0];
  const int y_lo = spans.v[r][2];
  const int rw = spans.v[r][1] - x_lo;
  const int n = rw * (spans.v[r][3] - y_lo);
  const int start = c * chunk;
  const int end = min(n, start + chunk);
  const size_t frame = static_cast<size_t>(b) * H * W;
  const size_t region = static_cast<size_t>(b) * R + r;
  const size_t row0 = region * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x < 4) sums[threadIdx.x] = 0;
  __syncthreads();
  int before = 0, w1 = 0, w2 = 0;
  for (int j = threadIdx.x; j < C; j += NT) {
    const int2 v = counts[region * C + j];
    before += j < c ? v.x + v.y : 0;
    w1 += v.x;
    w2 += v.y;
  }
  int base = block_sum(before, &sums[0]);  // keypoints in earlier chunks
  w1 = block_sum(w1, &sums[1]);
  w2 = block_sum(w2, &sums[2]);
  const int total = w1 + w2;

  for (int s0 = start; s0 < end; s0 += NT) {
    const int i = s0 + threadIdx.x;
    int x = 0, y = 0, w = 0;
    if (i < end) {
      y = y_lo + i / rw;
      x = x_lo + i % rw;
      w = weight[frame + static_cast<size_t>(y) * W + x];
    }
    const bool keypoint = w > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keypoint);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int in_block = 0, step = 0;
#pragma unroll
    for (int j = 0; j < NWARP; ++j) {
      const int cnt = warp_count[j];
      in_block += j < warp ? cnt : 0;
      step += cnt;
    }
    const int rank = base + in_block + __popc(ballot & ((1u << lane) - 1u));
    if (keypoint && rank < K) {
      out_codes[row0 + rank] = codes[frame + static_cast<size_t>(y) * W + x];
      out_pos[row0 + rank] = make_int2(x, y);
    }
    base += step;
    __syncthreads();  // warp_count is rewritten by the next step
  }

  // this block's share of the K rows: valid flags and canonical rows
  const int per = (K + C - 1) / C;
  const int s_end = min(K, (c + 1) * per);
  const uint4 first_code = codes[frame + static_cast<size_t>(y_lo) * W + x_lo];
  for (int s = c * per + threadIdx.x; s < s_end; s += NT) {
    out_valid[row0 + s] = s < total;
    if (s >= total) {
      out_codes[row0 + s] = first_code;
      out_pos[row0 + s] = make_int2(x_lo, y_lo);
    }
  }
  if (c == 0 && threadIdx.x == 0) {
    int* wc = out_wcounts + region * 3;
    wc[0] = 0;
    wc[1] = w1;
    wc[2] = w2;
    out_overflow[region] = total > K;
  }
}

}  // namespace

extern "C" int remap_tables_chunked(
    const uint8_t* weight, const int32_t* codes, int B, int H, int W,
    const int32_t* spans, int R, int K, int chunk, int C, int32_t* counts,
    int32_t* out_codes, int32_t* out_pos, uint8_t* out_valid,
    int32_t* out_wcounts, uint8_t* out_overflow, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || R <= 0 || R > MAX_R ||
      B > 65535 || chunk <= 0 || C <= 0 || R > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spans s = {};
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < 4; ++j) s.v[r][j] = spans[4 * r + j];
  }
  const dim3 grid(C, R, B);
  auto st = static_cast<cudaStream_t>(stream);
  tables_count_kernel<<<grid, NT, 0, st>>>(weight, H, W, s, chunk,
                                           reinterpret_cast<int2*>(counts));
  tables_scatter_kernel<<<grid, NT, 0, st>>>(
      weight, reinterpret_cast<const uint4*>(codes), H, W, K, s, chunk,
      reinterpret_cast<const int2*>(counts),
      reinterpret_cast<uint4*>(out_codes), reinterpret_cast<int2*>(out_pos),
      out_valid, out_wcounts, out_overflow);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int remap_tables(const uint8_t* weight, const int32_t* codes,
                            int B, int H, int W, const int32_t* spans, int R,
                            int K, int32_t* out_codes, int32_t* out_pos,
                            uint8_t* out_valid, int32_t* out_wcounts,
                            uint8_t* out_overflow, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || R <= 0 || R > MAX_R ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spans s = {};
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < 4; ++j) s.v[r][j] = spans[4 * r + j];
  }
  const dim3 grid(R, B);
  tables_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      weight, reinterpret_cast<const uint4*>(codes), H, W, K, s,
      reinterpret_cast<uint4*>(out_codes), reinterpret_cast<int2*>(out_pos),
      out_valid, out_wcounts, out_overflow);
  return static_cast<int>(cudaGetLastError());
}
