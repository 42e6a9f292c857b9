// Diagonal-format SpMV (kernel B4) for Hopper (sm_90a).
//
// Replaces femus_tpu/algebra/dia.py:spmv_dia_pallas, the row-tiled Pallas
// TPU kernel, and computes
//
//   y[i] = sum_k data[k, i] * x[i + off_k],   x = 0 outside [0, n),
//
// for data (K, n), n <= 2^30, and K <= 128 static offsets.
//
// The TPU kernel tiles rows by 32768 and copies an overlapping x window per
// tile into on-chip memory, because a shifted read there must be an aligned
// slice of a resident buffer.  None of that carries over: here one thread
// owns one row i and reads x[i + off_k] directly.  The 32 threads of a warp
// hold 32 consecutive rows, so every data[k, i] and x[i + off_k] access of
// a warp is one contiguous 128-byte (f32) segment; x (4 B per row, a few MB
// at a million rows) is re-read K times and stays in L1/L2, the data slab
// is streamed once with evict-first loads.  The bounds test on i + off_k
// takes the place of a padded x; a term outside [0, n) multiplies zero, so
// its weight is not read.  Each thread writes its own row: no atomics, a
// repeated launch gives the same bits.  Offsets reach the kernel by value
// (a __grid_constant__ struct in the constant bank): nothing is copied to
// the device and nothing is allocated per launch.  A row index and an
// offset fit 32 bits (n <= 2^30, so i + off_k cannot wrap, and one unsigned
// compare tests both ends of [0, n)); the slab index k * n + i is 64-bit.
//
// Bound: HBM bytes.  K * n values read once (105 MB in f32 at K = 25,
// n = 1,050,625), 2 flops each: 0.5 flop/byte in f32, far below the card's
// balance point.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiags = 128;

constexpr long long kMaxRows = 1LL << 30;

struct DiaOffsets {
  int off[kMaxDiags];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n, int K,
                const __grid_constant__ DiaOffsets offs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const T* row = data + i;
  T acc = T(0);
#pragma unroll 5
  for (int k = 0; k < K; ++k) {
    const unsigned j = static_cast<unsigned>(i + offs.off[k]);
    if (j < static_cast<unsigned>(n))
      acc += __ldcs(row + static_cast<long long>(k) * n) * __ldg(x + j);
  }
  y[i] = acc;
}

template <typename T>
cudaError_t launch(const void* data, const void* x, void* y, int n, int K,
                   const DiaOffsets& offs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  dia_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n, K, offs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1 float64,
// shared by data, x and y; offsets: K values in host memory.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dia_spmv(const void* data, const void* x, void* y, int dtype,
                        long long n, int K, const long long* offsets,
                        void* stream) {
  if (n <= 0 || n > kMaxRows || K < 1 || K > kMaxDiags)
    return cudaErrorInvalidValue;
  DiaOffsets offs = {};
  for (int k = 0; k < K; ++k) {
    // a diagonal that lies wholly outside the matrix reads nothing: any
    // in-range stand-in that fails the kernel's bounds test for every row
    const long long o = offsets[k];
    offs.off[k] = static_cast<int>(o >= n ? n : (o <= -n ? -n : o));
  }
  const int ni = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(data, x, y, ni, K, offs, s);
  if (dtype == 1) return launch<double>(data, x, y, ni, K, offs, s);
  return cudaErrorInvalidValue;
}
