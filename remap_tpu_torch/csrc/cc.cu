// K4: connected-component labels and per-component stats (cte.hpp's flood
// fill, fde.hpp's component predicate inputs).
//
// Replaces remap_tpu/ops/pallas/cc.py: label_components_batch (_cc_kernel),
// label_components_banded (band + relax kernels, _merge_band_labels) and
// label_stats_batch (_cc_mins_kernel, _cc_maxs_kernel).  The TPU kernels
// alternate Hillis-Steele segmented run-min scans to a fixpoint over a
// VMEM-resident plane because TPU gathers are slow, and split tall frames
// into row bands to fit VMEM.  On the card pointer chasing through L2 is
// cheap, so this is union-find in global memory, with no size ceiling
// (which is why one kernel covers the banded entry point too):
//
// 1. runs: one warp per row; a ballot over each 32-pixel chunk finds the
//    starts of equal-valued runs, and every interior pixel's parent is
//    its run's first pixel.  Rows need no unions.
// 2. unions: one thread per pixel unites it with the pixel above when
//    their values are equal, unless its left neighbour's vertical pair
//    already did (both runs continue to the left), so an all-equal plane
//    pays one union per row.  Union by minimum index: the larger root is
//    linked under the smaller with atomicMin, retried until the link
//    lands on a root (Playne & Hawick 2018).  Parents only decrease, so
//    every root is its tree's minimum flat index.
// 3. flatten: label = root, written in place over the parent array.  The
//    root of a component is its minimum flat index, i.e. its row-major-
//    first pixel: the JAX label.
// 4. stats (remap_cc_stats, run on the labels of 1-3 for K4c):
//    atomicMin/atomicMax of x, y and the
//    changed flag into per-root slots (a warp whose 32 pixels share one
//    root reduces with __reduce_*_sync first and issues one atomic per
//    slot), then each pixel gathers its root's five values.
//
// Border pixels (row 0, the last two rows, the first and last columns;
// cte.hpp:149-166) get label H*W and stats (H*W, H*W, -H*W, -H*W, -H*W),
// the values the JAX kernel leaves there.
//
// Bound on this card: the unions' dependent L2 loads on content with many
// vertical joins (iid noise), and the same-root atomics of the stats pass
// on one large component.  Flat indices are per frame and int32
// (H*W < 2^31); global offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool is_interior(int y, int x, int H, int W) {
  return y >= 1 && y < H - 2 && x >= 1 && x < W - 1;
}

// parent[] changes under other threads; __ldcg reads L2 (L1 is not
// coherent across SMs).  A stale value is still an ancestor, only later.
__device__ __forceinline__ int find_root(const int* parent, int p) {
  int q = __ldcg(parent + p);
  while (q != p) {
    p = q;
    q = __ldcg(parent + p);
  }
  return p;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // link root b under a; if b stopped being a root meanwhile, old is
    // its new parent: go on uniting a with it
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

// 1. one warp per frame row: parent = first pixel of the pixel's run
__global__ void __launch_bounds__(THREADS)
runs_kernel(const uint8_t* __restrict__ img, int* __restrict__ parent,
            long long rows, int H, int W) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int y = static_cast<int>(row % H);
  const long long base = row * W;
  const int big = H * W;
  int carry = 0;          // run start of the previous chunk's last pixel
  int prev_last = -2;     // value of the previous chunk's last pixel
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const bool in = x < W;
    const bool interior = in && is_interior(y, x, H, W);
    const int v = interior ? static_cast<int>(img[base + x]) : -1;
    int left = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) left = prev_last;
    const unsigned starts = __ballot_sync(FULL, in && left != v);
    const unsigned upto = starts & (lane == 31 ? FULL : ((2u << lane) - 1u));
    const int s = upto ? x0 + 31 - __clz(upto) : carry;
    if (in) parent[base + x] = interior ? y * W + s : big;
    carry = __shfl_sync(FULL, s, 31);
    prev_last = __shfl_sync(FULL, v, 31);
  }
}

// 2. vertical unions
__global__ void __launch_bounds__(THREADS)
union_kernel(const uint8_t* __restrict__ img, int* parent, long long n,
             int H, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int big = H * W;
  const long long frame = i / big;
  const int p = static_cast<int>(i - frame * big);
  const int y = p / W;
  const int x = p - y * W;
  if (!is_interior(y, x, H, W) || y < 2) return;  // the row above is border
  const uint8_t* f = img + frame * big;
  const uint8_t v = f[p];
  if (f[p - W] != v) return;
  // the left pair, when both continue the same runs, joined these already
  if (x >= 2 && f[p - 1] == v && f[p - 1 - W] == v) return;
  unite(parent + frame * big, p, p - W);
}

// 3. label = root, in place
__global__ void __launch_bounds__(THREADS)
flatten_kernel(int* labels, long long n, int big) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long frame = i / big;
  const int p = static_cast<int>(i - frame * big);
  int* parent = labels + frame * big;
  const int q = __ldcg(parent + p);
  if (q == big || q == p) return;  // border, or a root
  parent[p] = find_root(parent, q);
}

// 4a. per-root slots, [5, B*H*W]: minx, miny (filled with 0x7f7f7f7f)
// and maxx, maxy, changed (0x80808080) before this pass
__global__ void __launch_bounds__(THREADS)
stats_accumulate_kernel(const int* __restrict__ labels,
                        const uint8_t* __restrict__ changed, int* slots,
                        long long n, int H, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int big = H * W;
  // no early return: every lane of the warp takes part in the votes
  const bool in = i < n;
  const int r = in ? labels[i] : big;
  const bool interior = r != big;
  const long long frame = in ? i / big : 0;
  const int p = static_cast<int>(i - frame * big);
  const int y = p / W;
  const int x = p - y * W;
  const int c = in ? static_cast<int>(changed[i]) : 0;
  int* s = slots + frame * big + r;
  const int r0 = __shfl_sync(FULL, r, 0);
  const long long f0 = __shfl_sync(FULL, frame, 0);
  if (__all_sync(FULL, interior && r == r0 && frame == f0)) {
    // one component fills the warp: reduce first, one atomic per slot
    const int minx = __reduce_min_sync(FULL, x);
    const int miny = __reduce_min_sync(FULL, y);
    const int maxx = __reduce_max_sync(FULL, x);
    const int maxy = __reduce_max_sync(FULL, y);
    const int chg = __reduce_max_sync(FULL, c);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(s, minx);
      atomicMin(s + n, miny);
      atomicMax(s + 2 * n, maxx);
      atomicMax(s + 3 * n, maxy);
      atomicMax(s + 4 * n, chg);
    }
    return;
  }
  if (!interior) return;
  atomicMin(s, x);
  atomicMin(s + n, y);
  atomicMax(s + 2 * n, x);
  atomicMax(s + 3 * n, y);
  atomicMax(s + 4 * n, c);
}

// 4b. each pixel gathers its root's slots into stats [B, 5, H, W]
__global__ void __launch_bounds__(THREADS)
stats_gather_kernel(const int* __restrict__ labels, const int* __restrict__ slots,
                    int* __restrict__ stats, long long n, int big) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long frame = i / big;
  const int p = static_cast<int>(i - frame * big);
  const int r = labels[i];
  int* out = stats + frame * 5 * static_cast<long long>(big) + p;
  if (r == big) {
    out[0] = big;
    out[big] = big;
    out[2LL * big] = -big;
    out[3LL * big] = -big;
    out[4LL * big] = -big;
    return;
  }
  const int* s = slots + frame * big + r;
#pragma unroll
  for (int k = 0; k < 5; ++k) out[k * static_cast<long long>(big)] = s[k * n];
}

}  // namespace

namespace {

// 0 when the sizes are launchable, else the error code to return
int check_sizes(int B, int H, int W) {
  const long long big = static_cast<long long>(H) * W;
  if (B < 0 || H <= 0 || W <= 0 || big >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// K4a: images [B, H, W] uint8 -> labels [B, H, W] int32.
extern "C" int remap_cc_labels(const uint8_t* images, int B, int H, int W,
                               int32_t* labels, void* stream) {
  if (const int err = check_sizes(B, H, W)) return err;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H;
  const long long n = rows * W;
  const unsigned row_blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
  const unsigned px_blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  runs_kernel<<<row_blocks, THREADS, 0, s>>>(images, labels, rows, H, W);
  union_kernel<<<px_blocks, THREADS, 0, s>>>(images, labels, n, H, W);
  flatten_kernel<<<px_blocks, THREADS, 0, s>>>(labels, n, H * W);
  return static_cast<int>(cudaGetLastError());
}

// K4c's stats pass on K4a's labels: labels [B, H, W] int32 and changed
// [B, H, W] uint8 -> stats [B, 5, H, W] int32, through the scratch slots
// [5, B*H*W] int32.
extern "C" int remap_cc_stats(const int32_t* labels, const uint8_t* changed,
                              int B, int H, int W, int32_t* slots,
                              int32_t* stats, void* stream) {
  if (const int err = check_sizes(B, H, W)) return err;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * H * W;
  const unsigned px_blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  // min planes start above any coordinate, max planes below any value
  cudaError_t err = cudaMemsetAsync(slots, 0x7f, 2 * n * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(slots + 2 * n, 0x80, 3 * n * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_accumulate_kernel<<<px_blocks, THREADS, 0, s>>>(labels, changed, slots,
                                                        n, H, W);
  stats_gather_kernel<<<px_blocks, THREADS, 0, s>>>(labels, slots, stats, n,
                                                    H * W);
  return static_cast<int>(cudaGetLastError());
}
