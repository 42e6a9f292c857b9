// Blocked-ELL (BELL) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces femus_tpu/algebra/bell.py:_spmv_bell_pallas_frame, the fused
// Pallas TPU kernel, and computes exactly what its XLA reference
// _matvec_xla_frame computes:
//
//   y_frame[t*T + r] = sum over slab rows s of tile t, lanes l of
//                      slab[s, r, l] * x[block_ids[s*pack + l/C]*C + l%C]
//
// The slab is (slab_rows, T, 128): each 128-lane slab row packs pack=128/C
// column blocks of C columns, and every slab row belongs to one row tile.
// The TPU kernel routes x through one-hot MXU matmuls over a window (the TPU
// has no hardware gather); here each thread gathers its x values directly,
// which is exact and needs no window or size cap.
//
// Design: one warp per row tile.  The warp walks its tile's physical slab
// rows (tile_row_ptr/tile_rows from the host plan).  Lane k owns lanes
// 4k..4k+3 of the 128-lane row: it reads the four x values of its column
// block once per slab row, then one 16-byte slab vector per tile row, and
// keeps T running row sums.  A butterfly of warp shuffles reduces the row
// sums, and lane r writes y[t*T + r].  No atomics: the summation order is
// fixed, so results repeat bit for bit from run to run.
//
// Bound: HBM bytes.  Each call reads the slab once (T*128 values per slab
// row; 2 flops per value), plus block_ids, the tile row lists, x and y —
// about 0.25 flop per slab byte in float32, far below the card's balance
// point.  This simple design reads every slab byte once, streams it with
// evict-first loads so x stays in L2, and leaves further speed (wider
// loads per thread, more rows in flight per warp) to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// four consecutive slab values, converted to the accumulation type
template <typename A>
__device__ __forceinline__ void load4(const float* p, A v[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = static_cast<A>(q.x); v[1] = static_cast<A>(q.y);
  v[2] = static_cast<A>(q.z); v[3] = static_cast<A>(q.w);
}

template <typename A>
__device__ __forceinline__ void load4(const double* p, A v[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = static_cast<A>(a.x); v[1] = static_cast<A>(a.y);
  v[2] = static_cast<A>(b.x); v[3] = static_cast<A>(b.y);
}

template <typename A>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, A v[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  const float2 f0 = __bfloat1622float2(lo);
  const float2 f1 = __bfloat1622float2(hi);
  v[0] = static_cast<A>(f0.x); v[1] = static_cast<A>(f0.y);
  v[2] = static_cast<A>(f1.x); v[3] = static_cast<A>(f1.y);
}

constexpr int kWarpsPerBlock = 8;

// S: slab type; X: x/y type, also the accumulation type; T: rows per tile
template <typename S, typename X, int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bell_spmv_kernel(const S* __restrict__ slab, const X* __restrict__ x,
                 X* __restrict__ y, const int* __restrict__ block_ids,
                 const int* __restrict__ tile_row_ptr,
                 const int* __restrict__ tile_rows, long long n, int n_tiles,
                 int col_block) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int pack = 128 / col_block;
  const int l0 = lane * 4;            // this lane's first of 4 slab lanes
  const int q = l0 / col_block;       // packed column block of those lanes
  const int c = l0 % col_block;       // their offset inside the block

  X acc[T];
#pragma unroll
  for (int r = 0; r < T; ++r) acc[r] = X(0);

  const int beg = tile_row_ptr[tile];
  const int end = tile_row_ptr[tile + 1];
  for (int k = beg; k < end; ++k) {
    const long long row = tile_rows[k];
    const long long xb =
        static_cast<long long>(block_ids[row * pack + q]) * col_block + c;
    X xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = (xb + i < n) ? __ldg(x + xb + i) : X(0);
    const S* base = slab + row * (T * 128) + l0;
#pragma unroll
    for (int r = 0; r < T; ++r) {
      X s[4];
      load4<X>(base + r * 128, s);
      acc[r] += s[0] * xv[0] + s[1] * xv[1] + s[2] * xv[2] + s[3] * xv[3];
    }
  }

#pragma unroll
  for (int r = 0; r < T; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  X out = X(0);
#pragma unroll
  for (int r = 0; r < T; ++r)
    if (lane == r) out = acc[r];
  const long long i = static_cast<long long>(tile) * T + lane;
  if (lane < T && i < n) y[i] = out;
}

template <typename S, typename X>
cudaError_t launch(const void* slab, const void* x, void* y,
                   const int* block_ids, const int* tile_row_ptr,
                   const int* tile_rows, long long n, int n_tiles, int tile,
                   int col_block, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (tile == 16)
    bell_spmv_kernel<S, X, 16><<<grid, block, 0, stream>>>(
        static_cast<const S*>(slab), static_cast<const X*>(x),
        static_cast<X*>(y), block_ids, tile_row_ptr, tile_rows, n, n_tiles,
        col_block);
  else if (tile == 8)
    bell_spmv_kernel<S, X, 8><<<grid, block, 0, stream>>>(
        static_cast<const S*>(slab), static_cast<const X*>(x),
        static_cast<X*>(y), block_ids, tile_row_ptr, tile_rows, n, n_tiles,
        col_block);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename X>
cudaError_t dispatch_slab(int slab_dtype, const void* slab, const void* x,
                          void* y, const int* block_ids,
                          const int* tile_row_ptr, const int* tile_rows,
                          long long n, int n_tiles, int tile, int col_block,
                          cudaStream_t stream) {
  switch (slab_dtype) {
    case 0:
      return launch<float, X>(slab, x, y, block_ids, tile_row_ptr, tile_rows,
                              n, n_tiles, tile, col_block, stream);
    case 1:
      return launch<double, X>(slab, x, y, block_ids, tile_row_ptr,
                               tile_rows, n, n_tiles, tile, col_block, stream);
    case 2:
      return launch<__nv_bfloat16, X>(slab, x, y, block_ids, tile_row_ptr,
                                      tile_rows, n, n_tiles, tile, col_block,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype codes: 0 float32,
// 1 float64, 2 bfloat16 (slab only); x and y share x_dtype.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int bell_spmv(const void* slab, int slab_dtype, const void* x,
                         void* y, int x_dtype, const void* block_ids,
                         const void* tile_row_ptr, const void* tile_rows,
                         long long n, int n_tiles, int tile, int col_block,
                         void* stream) {
  if (n_tiles <= 0) return 0;
  if (col_block <= 0 || col_block > 128 || 128 % col_block || col_block % 4)
    return cudaErrorInvalidValue;
  const int* bids = static_cast<const int*>(block_ids);
  const int* ptr = static_cast<const int*>(tile_row_ptr);
  const int* rows = static_cast<const int*>(tile_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_slab<float>(slab_dtype, slab, x, y, bids, ptr, rows, n,
                                n_tiles, tile, col_block, s);
  if (x_dtype == 1)
    return dispatch_slab<double>(slab_dtype, slab, x, y, bids, ptr, rows, n,
                                 n_tiles, tile, col_block, s);
  return cudaErrorInvalidValue;
}
