// Sliced-ELL (SELL-C-sigma, C = 32) sparse matrix-vector product for
// Hopper (sm_90a): the general matvec of the BELL frame (kernel B1).
//
// Replaces femus_tpu/algebra/bell.py:_spmv_bell_pallas_frame, the fused
// Pallas TPU kernel over the blocked-ELL slab, and computes the function of
// its XLA reference _matvec_xla_frame, y_frame = A_frame x_frame, from a
// layout made for this card.  The TPU has no gather, so its slab stores
// dense (16 x 32) blocks and routes x through one-hot MXU matmuls; on the
// 128x128 cavity Jacobian that slab is 12 % nonzeros, 32.8 bytes per
// nonzero.  This card gathers: the layout stores each nonzero's value and
// int32 column and little else (8 bytes per nonzero in float32, times the
// fill of the slices).
//
// Layout (femus_tpu_torch/algebra/bell.py:SellPlan): rows of the frame are
// sorted by length inside windows of sigma rows and cut into slices of 32;
// slice s holds slice_ptr[s+1] - slice_ptr[s] groups of 4 columns; a group
// is 32 lanes x 4 columns, lane-major, so
//
//   slot(s, lane r, column k) = (slice_ptr[s] + k/4) * 128 + r*4 + k%4.
//
// Padding slots hold a zero value and a valid column.  row_order[s*32 + r]
// is the frame row stored at lane r of slice s (-1 beyond the last row).
//
// Design: one warp per slice, lane = row.  Per group a lane makes one
// 16-byte load of 4 columns and one of 4 values (a warp reads two
// contiguous 512-byte runs), gathers its 4 x entries through the read-only
// path (x, 0.7 MB on the cavity, stays in L2 and L1) and adds the products
// to one running sum in column order.  No shuffle reduction, no atomics:
// the order of every sum is fixed, so results repeat bit for bit.  Values
// and columns are read once and marked evict-first so they do not push x
// out of the caches.  Each lane writes its own y[row].
//
// Bound: HBM bytes.  values + columns + slice_ptr + row_order + x + y, two
// flops per stored slot: 0.25 flop per byte in float32, far below the
// card's balance point.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// four consecutive values, converted to the accumulation type
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

constexpr int kWarpsPerBlock = 4;
constexpr int kGroup = 128;            // slots per group: 32 lanes x 4 columns
constexpr int kTurn = 4;               // groups a lane loads before it gathers

// S: value storage type; X: x/y type, also the accumulation type.  A lane
// takes kTurn groups per turn: all of a turn's 2 kTurn streamed loads go out
// before its 4 kTurn x gathers (2, 4 and 8 measured alike); the tail of a
// slice is predicated, uniformly across the warp.
template <typename S, typename X>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sell_spmv_kernel(const S* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ slice_ptr,
                 const int* __restrict__ row_order, const X* __restrict__ x,
                 X* __restrict__ y, int n_slices) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= n_slices) return;
  const int g0 = __ldg(slice_ptr + s);
  const int g1 = __ldg(slice_ptr + s + 1);
  const size_t base = static_cast<size_t>(g0) * kGroup + lane * 4;
  const S* v = vals + base;
  const int* c = cols + base;

  X acc = X(0);
  constexpr int U = kTurn;
  for (int g = g0; g < g1; g += U, v += U * kGroup, c += U * kGroup) {
    int4 ci[U];
    X w[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g + u < g1) {
        ci[u] = __ldcs(reinterpret_cast<const int4*>(c + u * kGroup));
        load4<X>(v + u * kGroup, w[u]);
      } else {
        ci[u] = make_int4(0, 0, 0, 0);
        w[u][0] = w[u][1] = w[u][2] = w[u][3] = X(0);
      }
    }
    X xv[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g + u < g1) {
        xv[u][0] = __ldg(x + ci[u].x); xv[u][1] = __ldg(x + ci[u].y);
        xv[u][2] = __ldg(x + ci[u].z); xv[u][3] = __ldg(x + ci[u].w);
      } else {
        xv[u][0] = xv[u][1] = xv[u][2] = xv[u][3] = X(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += w[u][k] * xv[u][k];
  }
  const int row = __ldg(row_order + s * 32 + lane);
  if (row >= 0) y[row] = acc;
}

template <typename S, typename X>
cudaError_t launch(const void* vals, const int* cols, const int* slice_ptr,
                   const int* row_order, const void* x, void* y, int n_slices,
                   cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_slices + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sell_spmv_kernel<S, X><<<grid, block, 0, stream>>>(
      static_cast<const S*>(vals), cols, slice_ptr, row_order,
      static_cast<const X*>(x), static_cast<X*>(y), n_slices);
  return cudaGetLastError();
}

template <typename X>
cudaError_t dispatch_vals(int val_dtype, const void* vals, const int* cols,
                          const int* slice_ptr, const int* row_order,
                          const void* x, void* y, int n_slices,
                          cudaStream_t stream) {
  switch (val_dtype) {
    case 0:
      return launch<float, X>(vals, cols, slice_ptr, row_order, x, y,
                              n_slices, stream);
    case 1:
      return launch<double, X>(vals, cols, slice_ptr, row_order, x, y,
                               n_slices, stream);
    case 2:
      return launch<__nv_bfloat16, X>(vals, cols, slice_ptr, row_order, x, y,
                                      n_slices, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype codes: 0 float32,
// 1 float64, 2 bfloat16 (values only); x and y share x_dtype.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int sell_spmv(const void* vals, int val_dtype, const void* cols,
                         const void* slice_ptr, const void* row_order,
                         const void* x, void* y, int x_dtype, int n_slices,
                         void* stream) {
  if (n_slices <= 0) return 0;
  const int* ci = static_cast<const int*>(cols);
  const int* ptr = static_cast<const int*>(slice_ptr);
  const int* rows = static_cast<const int*>(row_order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_vals<float>(val_dtype, vals, ci, ptr, rows, x, y,
                                n_slices, s);
  if (x_dtype == 1)
    return dispatch_vals<double>(val_dtype, vals, ci, ptr, rows, x, y,
                                 n_slices, s);
  return cudaErrorInvalidValue;
}
