// 2-D lattice stencil SpMV (kernel B3) for Hopper (sm_90a).
//
// Replaces femus_tpu/algebra/stencil.py:spmv_stencil_pallas, the row-tiled
// Pallas TPU kernel, and computes on an (N, M) dof lattice
//
//   y[i, j] = sum_k data[k, i, j] * x[i + di_k, j + dj_k],
//             x = 0 outside the lattice,
//
// for data (K, N, M) contiguous and K static offsets with |di|, |dj| <= 8.
//
// The TPU kernel pads the lattice to (16, 128) tiles and is fed one
// row-shifted copy of the padded x grid per distinct di, built outside the
// kernel, because a row shift inside it must be tile-aligned there.  None
// of that carries over: here the data keeps its logical shape with no
// padding, one thread owns one lattice point (i, j) with j fastest, and
// reads x[i + di, j + dj] directly.  A warp covers 32 consecutive points,
// so every data and x access of a warp is a contiguous segment (split in
// two where the warp crosses a lattice row); x (4 B per point) is re-read
// K times and stays in L1/L2, the weight slab is streamed once with
// evict-first loads.  The bounds tests on i + di and j + dj, taken
// separately, take the place of the zero halo; a term outside the lattice
// multiplies zero, so its weight is not read.  Each thread writes its own
// point: no atomics, a repeated launch gives the same bits.  Offsets reach
// the kernel by value (a __grid_constant__ struct in the constant bank):
// nothing is copied to the device and nothing is allocated per launch.
// Point and slab indices are 64-bit.
//
// Bound: HBM bytes.  K * N * M values read once (105 MB in f32 at K = 25 on
// a 1025 x 1025 lattice), 2 flops each: 0.5 flop/byte in f32, far below the
// card's balance point.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 289;   // every (di, dj) in [-8, 8]^2

struct StencilOffsets {
  signed char di[kMaxOffsets];
  signed char dj[kMaxOffsets];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, int N, int M, int K,
                    const __grid_constant__ StencilOffsets offs) {
  const long long plane = static_cast<long long>(N) * M;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= plane) return;
  const int i = static_cast<int>(t / M);
  const int j = static_cast<int>(t % M);
  T acc = T(0);
#pragma unroll 5
  for (int k = 0; k < K; ++k) {
    const int di = offs.di[k];
    const int dj = offs.dj[k];
    // one unsigned compare tests both ends of [0, N) and of [0, M)
    if (static_cast<unsigned>(i + di) < static_cast<unsigned>(N) &&
        static_cast<unsigned>(j + dj) < static_cast<unsigned>(M))
      acc += __ldcs(data + k * plane + t) * __ldg(x + t + (di * M + dj));
  }
  y[t] = acc;
}

template <typename T>
cudaError_t launch(const void* data, const void* x, void* y, int N, int M,
                   int K, const StencilOffsets& offs, cudaStream_t stream) {
  const long long plane = static_cast<long long>(N) * M;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads));
  stencil_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), N, M, K, offs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1 float64,
// shared by data, x and y; di, dj: K values each in host memory, within
// [-8, 8].  Returns the CUDA error of the launch (0 = launched).
extern "C" int stencil_spmv(const void* data, const void* x, void* y,
                            int dtype, int N, int M, int K, const int* di,
                            const int* dj, void* stream) {
  // M <= 2^26 keeps di * M + dj inside 32 bits
  if (N <= 0 || M <= 0 || M > (1 << 26) || K < 1 || K > kMaxOffsets)
    return cudaErrorInvalidValue;
  const long long plane = static_cast<long long>(N) * M;
  if ((plane + kThreads - 1) / kThreads > 2147483647LL)
    return cudaErrorInvalidValue;
  StencilOffsets offs = {};
  for (int k = 0; k < K; ++k) {
    if (di[k] < -8 || di[k] > 8 || dj[k] < -8 || dj[k] > 8)
      return cudaErrorInvalidValue;
    offs.di[k] = static_cast<signed char>(di[k]);
    offs.dj[k] = static_cast<signed char>(dj[k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(data, x, y, N, M, K, offs, s);
  if (dtype == 1) return launch<double>(data, x, y, N, M, K, offs, s);
  return cudaErrorInvalidValue;
}
