// K2: per-region keypoint tables (kpr.hpp's select + compact).
//
// Replaces remap_tpu/ops/pallas/tables.py: build_tables_pallas (body
// _kernel, helpers _shifted and _inc_cumsum).  On the TPU a gather costs
// ~9 ns a row, so that kernel moves the 4-word code payload through a
// binary-distance shift network of lane/sublane rolls over a padded VMEM
// slab.  A GPU gathers and scatters at memory speed, so the compaction is
// the textbook one instead.  The function: each region's first K
// keypoints (weight > 0) in row-major order, their 16-byte codes and
// (x, y) positions; rows at or past the keypoint count take the canonical
// values (the code of the region's first pixel and position (x_lo, y_lo),
// ops/pallas/tables.py:258-264); `valid` is `row < #w1 + #w2`, `wcounts`
// is (0, #w1, #w2) over the whole region and `overflow` is
// `#w1 + #w2 > K`.
//
// Bound on this card: bytes.  The weights read once, the codes of the
// keypoints kept (min(count, K) a region) and of each region's first
// pixel, and the tables written once, over 3.35 TB/s: 62.2 MB, 0.0186 ms
// for NES [256,240,256] at K=640 (8 regions); 481 MB, 0.1436 ms for the
// collect batch [128,289,377] at K=16384, where the tables are most of it
// (chip_smoke.py tables_bound_ms).
//
// The old design, one 512-thread block per (frame, region) walking its
// region 512 pixels at a time, was bound by latency: each step made two
// dependent loads (the weight byte, then the code) and two barriers, ~2.1
// us a step.  NES regions take 19 steps and cropped C64 ones 31, in ~3.9
// and ~1.9 waves of blocks: 0.158 and 0.118 ms, shares 0.12 and 0.09.  At
// K=16384 each block then wrote its ~13k canonical rows alone, after its
// walk.  A region much larger than the card's blocks (splice: one 1.97M-px
// region) ran on one SM.  A first tiled version that loaded a tile's
// weights a byte a thread moved 32 bytes a warp load: too few bytes in
// flight, ~0.5 TB/s.
//
// This design takes tiles, not regions, as the unit of work.  A region's
// rows are cut into 16-byte-aligned words of the weight plane (a row of
// rw bytes spans at most (rw + 30) / 16 of them; bytes outside the row's
// span are masked to 0, and an aligned word never leaves the allocation
// that holds its valid byte).  Taken row by row, the words are the
// region's pixels in row-major order.  A tile is TILE consecutive words
// (up to 16 TILE pixels) of one (frame, region), in two launches (scheme:
// counts, then scan and scatter; no block ever waits on another):
//
// 1. count: a block a tile loads the tile's words, M coalesced 16-byte
//    loads a thread all in flight, and writes the tile's (#w1, #w2,
//    #keypoints) (byte-wise SIMD compares).
// 2. scan: a block a tile, M consecutive words a thread, loads them again
//    (from L2) and the region's first code while it sums its region's
//    earlier tiles' counts (its rank base) and all of them (the totals).
//    A tile whose region already holds K keypoints before it stops there.
//    Otherwise one warp-shuffle scan and one pass over the warp totals
//    rank the keypoints row-major, and those ranked below K go, as packed
//    (x, y), into a list in shared memory in rank order; the block gathers
//    their codes together and stores the rows coalesced.  Then each of the
//    G blocks of a region fills its 1/G of the K rows (canonical rows from
//    the keypoint count on, `valid` flags), with 16-byte stores where the
//    row allows, so no block writes a whole 16384- or 131072-row table.
//    Block 0 writes `wcounts` and `overflow`.
//
// A block's work is a few dependent latencies (its loads, three barriers,
// the gathers) whatever the region's size, so every shape fills the card:
// NES has 4 tiles a region, cropped C64 5, splice's one region 485.  The
// tile, 128 threads x 2 words (up to 4096 px), is fixed here; it was the
// only one of four timed (128x2, 256x1, 256x2, 128x4; PERF.md) within 10%
// of the fastest at every main-path shape.  What is left at NES K=640
// (0.059 ms against a bound of 0.0186) is the two passes' fixed costs:
// the count launch, ~0.017 ms, and the scan's loads and barriers, ~0.020
// ms at K=16 (PERF.md).
//
// Ranks are the plain version's row-major ranks, so the tables equal it
// (ops/tables.py build_tables_plain) bit for bit.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;         // threads of a block
constexpr int M = 2;            // words a thread holds
constexpr int TILE = NT * M;    // words a tile
constexpr int LIST = 16 * TILE; // a tile's pixels: every keypoint it can hold
constexpr int NWARP = NT / 32;
constexpr int MAX_R = 64;       // regions per layout the by-value spans hold
constexpr int FILL_ROWS = 2048; // table rows a block fills at most

struct Spans {
  int v[MAX_R][4];  // (x_lo, x_hi, y_lo, y_hi) per region
};

struct Region {
  int x_lo, y_lo, rw, rh;
  int cpr;  // 16-byte words a row of the region can span
};

__host__ __device__ __forceinline__ int words_per_row(int rw) {
  return (rw + 30) / 16;
}

__device__ __forceinline__ Region region_of(const Spans& spans, int r) {
  Region g;
  g.x_lo = spans.v[r][0];
  g.y_lo = spans.v[r][2];
  g.rw = spans.v[r][1] - g.x_lo;
  g.rh = spans.v[r][3] - g.y_lo;
  g.cpr = words_per_row(g.rw);
  return g;
}

// Word q (row-major) of a region: its row, its index k in the row, and
// the address of the row's first region byte.  Its address is that
// byte's 16-byte boundary plus 16 k; `off` is its offset from that byte
// (negative for a row's first word when the byte is not aligned).
struct WordAt {
  int row, k;
  uintptr_t row_at;
  __device__ __forceinline__ uintptr_t at() const {
    return (row_at & ~static_cast<uintptr_t>(15)) + 16u * k;
  }
  __device__ __forceinline__ int off() const {
    return static_cast<int>(static_cast<long long>(at()) -
                            static_cast<long long>(row_at));
  }
};

__device__ __forceinline__ WordAt word_at(const uint8_t* weight, size_t frame,
                                          int W, const Region& g, int q) {
  WordAt p;
  p.row = q / g.cpr;
  p.k = q - p.row * g.cpr;
  p.row_at = reinterpret_cast<uintptr_t>(
      weight + frame + static_cast<size_t>(g.y_lo + p.row) * W + g.x_lo);
  return p;
}

// the word after p
__device__ __forceinline__ WordAt next_word(WordAt p, const Region& g, int W) {
  if (++p.k == g.cpr) {
    p.k = 0;
    ++p.row;
    p.row_at += W;
  }
  return p;
}

// 0xff in bytes [lo, hi) of 8 (lo, hi clamped to 0..8)
__device__ __forceinline__ unsigned long long keep8(int lo, int hi) {
  const int l = min(max(lo, 0), 8);
  const int h = min(max(hi, 0), 8);
  const unsigned long long below_h = h == 8 ? ~0ull : (1ull << (8 * h)) - 1;
  const unsigned long long below_l = l == 8 ? ~0ull : (1ull << (8 * l)) - 1;
  return below_h & ~below_l;
}

// A word's 16 weight bytes as two little-endian halves
struct Word {
  unsigned long long lo, hi;
};

// The word at p, bytes outside the row's span zeroed (all of them when
// `in` is false or the word lies past the row's last byte).  The load is
// unconditional, so a thread's loads are all in flight at once: a word
// with no byte of the region reads the word at `safe` (the region's first
// byte) instead, which lies inside the allocation.
__device__ __forceinline__ Word load_word(const WordAt& p, const Region& g,
                                          bool in, uintptr_t safe) {
  const int off = p.off();
  const int lo = -off;
  const int hi = in ? g.rw - off : 0;
  const uintptr_t at = hi > 0 ? p.at() : safe & ~static_cast<uintptr_t>(15);
  const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(at));
  return Word{v.x & keep8(lo, hi), v.y & keep8(lo - 8, hi - 8)};
}

// 0x80 in each zero byte of x, 0 elsewhere (exact: no carry crosses a byte)
__device__ __forceinline__ unsigned long long zero_bytes(unsigned long long x) {
  constexpr unsigned long long low7 = 0x7f7f7f7f7f7f7f7full;
  return ~(((x & low7) + low7) | x | low7);
}

// (#w1, #w2, #keypoints) of a word's bytes
__device__ __forceinline__ int3 word_counts(const Word& v) {
  constexpr unsigned long long ones = 0x0101010101010101ull;
  int3 n;
  n.x = __popcll(zero_bytes(v.lo ^ ones)) + __popcll(zero_bytes(v.hi ^ ones));
  n.y = __popcll(zero_bytes(v.lo ^ (2 * ones))) +
        __popcll(zero_bytes(v.hi ^ (2 * ones)));
  n.z = 16 - __popcll(zero_bytes(v.lo)) - __popcll(zero_bytes(v.hi));
  return n;
}

// bit b set where byte b of the word is non-zero
__device__ __forceinline__ uint32_t keypoint_bits(const Word& v) {
  // each non-zero byte's top bit, gathered into the top byte (bit j from
  // byte j: the product's partial terms never overlap)
  constexpr unsigned long long gather = 0x0002040810204081ull;
  const unsigned long long nz_lo = ~zero_bytes(v.lo) & (0x80 * 0x0101010101010101ull);
  const unsigned long long nz_hi = ~zero_bytes(v.hi) & (0x80 * 0x0101010101010101ull);
  return static_cast<uint32_t>((nz_lo * gather) >> 56) |
         (static_cast<uint32_t>((nz_hi * gather) >> 56) << 8);
}

// A block a tile, its words NT apart across the threads (each load
// coalesced), all M of a thread's in flight at once.
__global__ void __launch_bounds__(NT)
tables_count_kernel(const uint8_t* __restrict__ weight, int H, int W,
                    Spans spans, int4* __restrict__ counts) {
  __shared__ int sums[NWARP][3];
  const int c = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const Region g = region_of(spans, r);
  const size_t frame = static_cast<size_t>(b) * H * W;
  const int n_words = g.rh * g.cpr;
  const uintptr_t safe = reinterpret_cast<uintptr_t>(
      weight + frame + static_cast<size_t>(g.y_lo) * W + g.x_lo);
  Word v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int q = (c * M + m) * NT + threadIdx.x;
    const bool in = q < n_words;
    v[m] = load_word(word_at(weight, frame, W, g, in ? q : 0), g, in, safe);
  }
  int w1 = 0, w2 = 0, kp = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int3 n = word_counts(v[m]);
    w1 += n.x;
    w2 += n.y;
    kp += n.z;
  }
  w1 = __reduce_add_sync(0xffffffffu, w1);
  w2 = __reduce_add_sync(0xffffffffu, w2);
  kp = __reduce_add_sync(0xffffffffu, kp);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sums[warp][0] = w1;
    sums[warp][1] = w2;
    sums[warp][2] = kp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 t = make_int4(0, 0, 0, 0);
    for (int j = 0; j < NWARP; ++j) {
      t.x += sums[j][0];
      t.y += sums[j][1];
      t.z += sums[j][2];
    }
    counts[(static_cast<size_t>(b) * gridDim.y + r) * gridDim.x + c] = t;
  }
}

// One tile's keypoints ranked row-major and the first `room` of them
// written to rows 0.. of `out_codes` / `out_pos` (the region's rows from
// the tile's rank base on).  Thread t holds the tile's words t M .. t M +
// M - 1, the first at p0.  The kept ones pass through the list `kept`.
__device__ __forceinline__ void scatter_tile(
    const uint4* __restrict__ codes, size_t frame, int W, const Region& g,
    const WordAt& p0, const Word (&v)[M], int room,
    uint4* __restrict__ out_codes, int2* __restrict__ out_pos,
    uint32_t* kept, int* warp_kp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  uint32_t bits[M];
  int cnt = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    bits[m] = keypoint_bits(v[m]);
    cnt += __popc(bits[m]);
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_kp[warp] = incl;
  __syncthreads();
  int rank = incl - cnt, in_tile = 0;
#pragma unroll
  for (int j = 0; j < NWARP; ++j) {
    const int w = warp_kp[j];
    rank += j < warp ? w : 0;
    in_tile += w;
  }

  // the kept keypoints (ranked below n_out) into the list, in rank order,
  // as packed (x, y)
  const int n_out = min(in_tile, room);
  WordAt p = p0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t left = bits[m];
    if (rank < n_out && left != 0u) {
      // (x, y) of the word's first byte, packed; x may be negative, so
      // added, not or-ed: x + k of every kept byte is in the region
      const uint32_t at = (static_cast<uint32_t>(g.y_lo + p.row) << 16) +
                          static_cast<uint32_t>(g.x_lo + p.off());
      for (int j = rank; left != 0u && j < n_out; ++j) {
        const int k = __ffs(left) - 1;
        left &= left - 1u;
        kept[j] = at + k;
      }
    }
    rank += __popc(bits[m]);
    p = next_word(p, g, W);
  }
  __syncthreads();

  // their codes gathered together (every load issued before any store),
  // their rows stored coalesced
  for (int j0 = tid; j0 < n_out; j0 += 4 * NT) {
    uint32_t xy[4];
    uint4 code[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) xy[u] = kept[min(j0 + u * NT, n_out - 1)];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      code[u] = __ldg(codes + frame + static_cast<size_t>(xy[u] >> 16) * W +
                      (xy[u] & 0xffffu));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * NT;
      if (j < n_out) {
        out_codes[j] = code[u];
        out_pos[j] = make_int2(xy[u] & 0xffffu, xy[u] >> 16);
      }
    }
  }
}

// 0x01 in each of the first m bytes (m clamped to 0..4), little endian.
__device__ __forceinline__ uint32_t leading_ones(int m) {
  return m <= 0 ? 0u : m >= 4 ? 0x01010101u : 0x01010101u >> (8 * (4 - m));
}

__global__ void __launch_bounds__(NT)
tables_scan_kernel(const uint8_t* __restrict__ weight,
                   const uint4* __restrict__ codes, int H, int W, int K,
                   Spans spans, int C, const int4* __restrict__ counts,
                   uint4* __restrict__ out_codes, int2* __restrict__ out_pos,
                   uint8_t* __restrict__ out_valid,
                   int* __restrict__ out_wcounts,
                   uint8_t* __restrict__ out_overflow) {
  __shared__ uint32_t kept[LIST];  // x | y << 16 of kept keypoints
  __shared__ int sums[NWARP][4];
  __shared__ int warp_kp[NWARP];

  const int c = blockIdx.x;
  const int G = gridDim.x;
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t region = static_cast<size_t>(b) * R + r;
  const size_t row0 = region * K;
  const size_t frame = static_cast<size_t>(b) * H * W;
  const Region g = region_of(spans, r);

  // the tile's words and the canonical code in flight while the counts
  // are summed: keypoints in earlier tiles (the rank base) and the totals
  const int q0 = (c * NT + tid) * M;
  const int n_words = g.rh * g.cpr;
  const WordAt p0 = word_at(weight, frame, W, g, q0 < n_words ? q0 : 0);
  const size_t first_at = frame + static_cast<size_t>(g.y_lo) * W + g.x_lo;
  const uintptr_t safe = reinterpret_cast<uintptr_t>(weight + first_at);
  Word v[M];
  {
    WordAt p = p0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[m] = load_word(p, g, q0 + m < n_words, safe);
      p = next_word(p, g, W);
    }
  }
  const uint4 first = __ldg(codes + first_at);
  int before = 0, w1 = 0, w2 = 0, kp = 0;
  for (int j = tid; j < C; j += NT) {
    const int4 n = counts[region * C + j];
    before += j < c ? n.z : 0;
    w1 += n.x;
    w2 += n.y;
    kp += n.z;
  }
  before = __reduce_add_sync(0xffffffffu, before);
  w1 = __reduce_add_sync(0xffffffffu, w1);
  w2 = __reduce_add_sync(0xffffffffu, w2);
  kp = __reduce_add_sync(0xffffffffu, kp);
  if (lane == 0) {
    sums[warp][0] = before;
    sums[warp][1] = w1;
    sums[warp][2] = w2;
    sums[warp][3] = kp;
  }
  __syncthreads();
  int base = 0, n1 = 0, n2 = 0, n_kp = 0;
#pragma unroll
  for (int j = 0; j < NWARP; ++j) {
    base += sums[j][0];
    n1 += sums[j][1];
    n2 += sums[j][2];
    n_kp += sums[j][3];
  }
  const int total = n1 + n2;
  const int room = K - base;  // rows left for this tile's keypoints

  // a tile whose region holds K keypoints before it only fills
  if (room > 0 && c * TILE < n_words) {
    scatter_tile(codes, frame, W, g, p0, v, room, out_codes + row0 + base,
                 out_pos + row0 + base, kept, warp_kp);
  }

  // this block's share of the K rows: canonical rows past the keypoint
  // count, and the valid flags
  const int per = ((K + G - 1) / G + 15) & ~15;
  const int lo = static_cast<int>(min(static_cast<long long>(c) * per,
                                      static_cast<long long>(K)));
  const int hi = min(K, lo + per);
  int s = max(lo, n_kp);
  if (s < hi) {
    for (int j = s + tid; j < hi; j += NT) out_codes[row0 + j] = first;
    const int2 p = make_int2(g.x_lo, g.y_lo);
    if (reinterpret_cast<uintptr_t>(out_pos + row0 + s) & 15) {
      if (tid == 0) out_pos[row0 + s] = p;
      ++s;
    }
    const int pairs = (hi - s) >> 1;
    int4* pos2 = reinterpret_cast<int4*>(out_pos + row0 + s);
    for (int j = tid; j < pairs; j += NT) {
      pos2[j] = make_int4(p.x, p.y, p.x, p.y);
    }
    if (((hi - s) & 1) && tid == 0) out_pos[row0 + hi - 1] = p;
  }
  uint8_t* valid = out_valid + row0;
  const int head = min(hi, lo + static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(valid + lo) & 15)) & 15));
  for (int j = lo + tid; j < head; j += NT) valid[j] = j < total;
  const int n16 = (hi - head) >> 4;
  uint4* valid16 = reinterpret_cast<uint4*>(valid + head);
  for (int j = tid; j < n16; j += NT) {
    const int s0 = head + 16 * j;
    valid16[j] = make_uint4(leading_ones(total - s0),
                            leading_ones(total - s0 - 4),
                            leading_ones(total - s0 - 8),
                            leading_ones(total - s0 - 12));
  }
  for (int j = head + 16 * n16 + tid; j < hi; j += NT) valid[j] = j < total;

  if (c == 0 && tid == 0) {
    int* wc = out_wcounts + region * 3;
    wc[0] = 0;
    wc[1] = n1;
    wc[2] = n2;
    out_overflow[region] = total > K;
  }
}

// Tiles of the largest of the R regions: its words over TILE, rounded up.
int tiles_of(const Spans& s, int R) {
  long long most = 0;
  for (int r = 0; r < R; ++r) {
    most = std::max(most, static_cast<long long>(s.v[r][3] - s.v[r][2]) *
                              words_per_row(s.v[r][1] - s.v[r][0]));
  }
  return static_cast<int>((most + TILE - 1) / TILE);
}

Spans spans_of(const int32_t* spans, int R) {
  Spans s = {};
  for (int r = 0; r < R; ++r) {
    for (int j = 0; j < 4; ++j) s.v[r][j] = spans[4 * r + j];
  }
  return s;
}

}  // namespace

// C, the tiles of the largest region: counts, remap_tables' scratch, is
// [B, R, C] int4.  -1 for a layout of more than MAX_R regions.
extern "C" int remap_tables_tiles(const int32_t* spans, int R) {
  if (R <= 0 || R > MAX_R) return -1;
  return tiles_of(spans_of(spans, R), R);
}

extern "C" int remap_tables(const uint8_t* weight, const int32_t* codes,
                            int B, int H, int W, const int32_t* spans, int R,
                            int K, int32_t* counts, int32_t* out_codes,
                            int32_t* out_pos, uint8_t* out_valid,
                            int32_t* out_wcounts, uint8_t* out_overflow,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || R <= 0 || R > MAX_R ||
      B > 65535 || H > 65535 || W > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Spans s = spans_of(spans, R);
  const int C = tiles_of(s, R);
  const int G = std::max(C, (K + FILL_ROWS - 1) / FILL_ROWS);
  auto st = static_cast<cudaStream_t>(stream);
  tables_count_kernel<<<dim3(C, R, B), NT, 0, st>>>(
      weight, H, W, s, reinterpret_cast<int4*>(counts));
  tables_scan_kernel<<<dim3(G, R, B), NT, 0, st>>>(
      weight, reinterpret_cast<const uint4*>(codes), H, W, K, s, C,
      reinterpret_cast<const int4*>(counts),
      reinterpret_cast<uint4*>(out_codes), reinterpret_cast<int2*>(out_pos),
      out_valid, out_wcounts, out_overflow);
  return static_cast<int>(cudaGetLastError());
}
