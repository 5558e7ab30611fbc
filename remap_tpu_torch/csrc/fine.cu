// The pyramid matcher's fine level: the [B, 2R+1, 2R+1] shifted agreement
// counts of each frame pair, with the coarse roll folded into the reads
// of `curr`:
//
//   counts[b, dy+R, dx+R] = #{(y, x) : 0 <= y+dy < H, 0 <= x+dx < W,
//       prev[b, y+dy, x+dx] == curr[b, (y - by) mod H, (x - bx) mod W]}
//
// with (bx, by) = base[b].  This is what the plain version
// (ops/correlate.py: correlation_scores_direct of prev and
// shift_frames(curr, base)) counts with one rolled copy of `prev`, one
// equality plane and one int64 sum a shift, after a gathered copy of
// `curr`.
//
// Replaces no TPU kernel: the JAX package's fine pass is jnp.roll and
// slices (remap_tpu/ops/correlate.py: correlation_scores_direct, called
// from remap_tpu/models/pyramid.py after a vmapped jnp.roll of `curr`).
// It was added because those copies were the largest device cost of a VGA
// map build (PERF.md).
//
// Bound on this card: not bytes.  Both frames are read once (2 B a pixel),
// but every pixel is compared (2R+1)^2 times, and each compare takes one
// 16-bit shared-memory load, so the shared-load pipe (132 SMs x 32 lanes
// x 1.98 GHz, about 8.4 T loads/s) limits the kernel before its integer
// lanes do.  The design spends as little as it can a compare:
//
// - One block takes a 64x64 tile of one frame.  It stages the tile of
//   `prev` widened by an R-pixel halo each way in shared memory, as 16-bit
//   values: a pixel outside the frame holds 0x100, which equals no byte,
//   so the frame's edge needs no test inside the loop.  Each thread keeps
//   its 16 pixels of `curr` (one column, 16 rows) in registers, read at
//   their rolled coordinates (-1 for a pixel past the frame's edge: it
//   equals nothing).
// - For each shift a thread does one shared load, one compare and one add
//   a pixel; a warp reduction (__reduce_add_sync) and one shared atomic a
//   warp leave the block's count of the shift in shared memory, and at the
//   end one global atomic a shift adds it into `counts`.  Integer adds are
//   exact in any order, so the result does not depend on the blocks'.
// - Neighbouring lanes read neighbouring 16-bit words, so a warp's load
//   is one shared-memory wavefront.  Nothing is reused across dy: a
//   register window of a thread's 16 + 2R rows, loaded once a dx, would
//   take most of the loads off the pipe if the kernel ever leads a build.
//
// Any radius works while the halo tile and the (2R+1)^2 counts fit in a
// block's 227 KB of shared memory (R <= 86); the launch sizes both and
// asks for more than the default 48 KB where it needs it.  Flat offsets
// are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 64;                  // tile columns, one per thread column
constexpr int ROWS = 16;                    // rows of a thread's column
constexpr int THREAD_ROWS = 4;
constexpr int TILE_H = ROWS * THREAD_ROWS;  // 64
constexpr int THREADS = TILE_W * THREAD_ROWS;
constexpr uint16_t OUTSIDE = 0x100;         // a `prev` pixel outside the frame
constexpr int MAX_SHARED = 232448;          // bytes a block may use on sm_90

__host__ __device__ inline int halo_bytes(int r) {
  return ((TILE_W + 2 * r) * (TILE_H + 2 * r) * 2 + 3) & ~3;
}

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(THREADS)
    fine_counts_kernel(const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
                       const int32_t* __restrict__ base, int H, int W, int R,
                       int32_t* __restrict__ counts) {
  extern __shared__ unsigned char smem[];
  const int n = 2 * R + 1;
  const int sw = TILE_W + 2 * R;
  const int sh = TILE_H + 2 * R;
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  int* block_counts = reinterpret_cast<int*>(smem + halo_bytes(R));

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const size_t frame = static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < n * n; i += THREADS) block_counts[i] = 0;
  for (int i = tid; i < sw * sh; i += THREADS) {
    const int sy = i / sw;
    const int y = y0 - R + sy;
    const int x = x0 - R + (i - sy * sw);
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? prev[frame + static_cast<size_t>(y) * W + x]
                  : OUTSIDE;
  }

  const int tx = tid % TILE_W;
  const int ty = tid / TILE_W;
  const int x = x0 + tx;
  const int cx = wrap(x - base[2 * b], W);
  const int by = base[2 * b + 1];
  int c[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = y0 + ty * ROWS + k;
    c[k] = (x < W && y < H)
               ? curr[frame + static_cast<size_t>(wrap(y - by, H)) * W + cx]
               : -1;
  }
  __syncthreads();

  // the pixel (y0 + ty*ROWS + k, x) meets prev at shift (dy, dx) in the
  // tile's row ty*ROWS + k + dy + R, column tx + dx + R
  const uint16_t* column = tile + ty * ROWS * sw + tx;
  const bool leader = (tid & 31) == 0;
  for (int dy = 0; dy < n; ++dy) {
    for (int dx = 0; dx < n; ++dx) {
      const uint16_t* p = column + dy * sw + dx;
      int count = 0;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) count += static_cast<int>(p[k * sw]) == c[k];
      count = __reduce_add_sync(0xffffffffu, count);
      if (leader && count != 0) atomicAdd(block_counts + dy * n + dx, count);
    }
  }
  __syncthreads();
  int32_t* out = counts + static_cast<size_t>(b) * n * n;
  for (int i = tid; i < n * n; i += THREADS) {
    if (block_counts[i] != 0) atomicAdd(out + i, block_counts[i]);
  }
}

}  // namespace

// prev, curr: [B, H, W] uint8; base: [B, 2] int32 (dx, dy); counts:
// [B, 2R+1, 2R+1] int32, zeroed here on the stream, then added into.
extern "C" int remap_fine_counts(const uint8_t* prev, const uint8_t* curr,
                                 const int32_t* base, int B, int H, int W, int R,
                                 int32_t* counts, void* stream) {
  if (B < 0 || B > 65535 || H < 0 || W < 0 || R < 0 || R > 1000) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 2 * R + 1;
  const int shared = halo_bytes(R) + n * n * 4;
  if (shared > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * B * n * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(fine_counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  fine_counts_kernel<<<grid, THREADS, shared, s>>>(prev, curr, base, H, W, R, counts);
  return static_cast<int>(cudaGetLastError());
}
