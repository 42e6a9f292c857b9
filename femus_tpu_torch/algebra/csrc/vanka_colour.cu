// One multiplicative Vanka sweep (femus_tpu_torch/algebra/vanka.py:
// vanka_smoother) for Hopper (sm_90a): per colour, the colour's own residual
// rows, then its blocks' dense solves and the update of x.
//
// Replaces no TPU kernel: the JAX package's Vanka sweep
// (femus_tpu/algebra/vanka.py:vanka_smoother) is XLA ops, which XLA fuses
// into a few programs.  The port ran each colour as a whole-operator SpMV
// (kernel B1) and about ten small PyTorch launches (subtract, pad, gather,
// mask, batched matvec, mask, zeros, index_add, scale, add), so a sweep on
// the card cost its host about 90 launches and the device a full SpMV a
// colour of which only the colour's block rows were read.
//
// For colour c, with dofs[c] (nb_c, bs) the block dof ids (padded with n)
// and ainv[c] (nb_c, bs, bs) the explicit block inverses:
//
//   r[k, i]  = b[d] - sum_j data[d, j] x[cols[d, j]],  d = dofs[c][k, i]
//              (0 where d = n, a padding row)
//   x[d_ki] += omega * sum_j ainv[c][k, i, j] r[k, j]   (d_ki < n)
//
// The blocks of one colour share no dof, but a row of one block can read x
// at a dof that another block of the colour updates.  The sweep is Jacobi
// inside a colour and Gauss-Seidel across colours, so every residual of a
// colour has to be read before any of its updates: two launches a colour,
// in stream order.
//
// vanka_residual_kernel: one warp a block row.  Lanes stride the row's ELL
//   slots (values and int64 columns, read once, coalesced, evict-first) and
//   gather x; a slot whose value is 0 (the ELL padding at a row's end) reads
//   neither its column nor x.  A shuffle tree sums the lanes in a fixed
//   order; lane 0 writes r[k, i] to an (nb_c, bs) scratch array.
// vanka_update_kernel: one thread a block row, 128 // bs Vanka blocks a
//   thread block.  The blocks' residuals go to shared memory; a thread sums
//   its row of the inverse against them in column order.  The inverses are
//   read transposed, as the batched LU solve leaves them, so for each
//   column the threads of a block read one contiguous run (every inverse
//   entry once).  The thread adds omega times its sum to x at its row's
//   dof.  No atomics: the dofs of a colour's blocks are distinct.
//
// Every sum is taken in a fixed order: results repeat bit for bit.
//
// Bound: HBM bytes.  The colour's ELL rows (values, the columns of the
// nonzero slots), its inverses, the x entries gathered, b and the scratch:
// at the DFG channel's finest level in float32 about 1,590 blocks x 42 rows
// of 62 ELL slots (33.7 nonzeros) and 1,590 x 42^2 inverse entries, some
// 42 MB a colour, 12.6 us at 3.35 TB/s (tools/torch_vanka_colour.py counts
// them); two flops per slot and per inverse entry, far below the card's
// balance point.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;      // block rows a residual thread block takes
constexpr int kSolveThreads = 128;  // threads of an update thread block

template <typename A>
__device__ __forceinline__ A value(float v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A value(double v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A value(__nv_bfloat16 v) {
  return static_cast<A>(__bfloat162float(v));
}

template <typename S>
__device__ __forceinline__ S stream_load(const S* p) { return __ldcs(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 stream_load(const __nv_bfloat16* p) {
  const unsigned short u =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return *reinterpret_cast<const __nv_bfloat16*>(&u);
}

template <typename X>
__device__ __forceinline__ X warp_sum(X v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// S: value storage type; X: vector, inverse and accumulation type.
template <typename S, typename X>
__global__ void __launch_bounds__(kRowWarps * 32)
vanka_residual_kernel(const S* __restrict__ data,
                      const long long* __restrict__ cols, int width,
                      const long long* __restrict__ dofs,
                      const X* __restrict__ b, const X* __restrict__ x,
                      X* __restrict__ r, long long rows, long long n) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (g >= rows) return;                 // uniform across the warp
  const long long d = __ldg(dofs + g);
  if (d >= n) {                          // a padding row: uniform too
    if (lane == 0) r[g] = X(0);
    return;
  }
  const S* v = data + d * width;
  const long long* c = cols + d * width;
  X acc = X(0);
  for (int j = lane; j < width; j += 32) {
    const X a = value<X>(stream_load(v + j));
    if (a != X(0)) acc += a * __ldg(x + __ldcs(c + j));
  }
  acc = warp_sum(acc);
  if (lane == 0) r[g] = __ldg(b + d) - acc;
}

// ainv_t holds each block's inverse transposed (ainv_t[k, j, i] =
// Ainv[k, i, j]), the layout the batched LU solve leaves, so the threads of
// a block's rows read one contiguous run for each j.
template <typename X>
__global__ void __launch_bounds__(kSolveThreads)
vanka_update_kernel(const X* __restrict__ ainv_t,
                    const long long* __restrict__ dofs,
                    const X* __restrict__ r, X* __restrict__ x, int bs,
                    int per_cta, long long nb, long long n, X omega) {
  extern __shared__ unsigned char smem[];
  X* rs = reinterpret_cast<X*>(smem);
  const long long k0 = static_cast<long long>(blockIdx.x) * per_cta;
  const int kn = nb - k0 < per_cta ? static_cast<int>(nb - k0) : per_cta;
  for (int t = threadIdx.x; t < kn * bs; t += kSolveThreads)
    rs[t] = r[k0 * bs + t];
  __syncthreads();
  for (int t = threadIdx.x; t < kn * bs; t += kSolveThreads) {
    const int kb = t / bs, i = t - kb * bs;
    const long long k = k0 + kb;
    const X* a = ainv_t + k * bs * bs + i;
    const X* rk = rs + kb * bs;
    X acc = X(0);
    for (int j = 0; j < bs; ++j)
      acc += __ldcs(a + static_cast<long long>(j) * bs) * rk[j];
    const long long d = dofs[k * bs + i];
    if (d < n) x[d] += omega * acc;
  }
}

template <typename S, typename X>
cudaError_t sweep(int n_colours, const void* const* dofs,
                  const void* const* ainv, const long long* n_blocks, int bs,
                  const void* data, const void* cols, int width,
                  const void* b, void* x, void* r, long long n, double omega,
                  int iters, cudaStream_t stream) {
  const S* vals = static_cast<const S*>(data);
  const long long* ci = static_cast<const long long*>(cols);
  const X* bx = static_cast<const X*>(b);
  X* xx = static_cast<X*>(x);
  X* rr = static_cast<X*>(r);
  const int per_cta = bs < kSolveThreads ? kSolveThreads / bs : 1;
  const size_t smem = static_cast<size_t>(per_cta) * bs * sizeof(X);
  for (int it = 0; it < iters; ++it) {
    for (int c = 0; c < n_colours; ++c) {
      const long long nb = n_blocks[c];
      if (nb <= 0) continue;
      const long long* d = static_cast<const long long*>(dofs[c]);
      const long long rows = nb * bs;
      const dim3 grid1(static_cast<unsigned>((rows + kRowWarps - 1) /
                                             kRowWarps));
      vanka_residual_kernel<S, X><<<grid1, kRowWarps * 32, 0, stream>>>(
          vals, ci, width, d, bx, xx, rr, rows, n);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      const unsigned grid2 =
          static_cast<unsigned>((nb + per_cta - 1) / per_cta);
      vanka_update_kernel<X><<<grid2, kSolveThreads, smem, stream>>>(
          static_cast<const X*>(ainv[c]), d, rr, xx, bs, per_cta, nb, n,
          static_cast<X>(omega));
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename X>
cudaError_t dispatch_vals(int val_dtype, int n_colours,
                          const void* const* dofs, const void* const* ainv,
                          const long long* n_blocks, int bs, const void* data,
                          const void* cols, int width, const void* b, void* x,
                          void* r, long long n, double omega, int iters,
                          cudaStream_t s) {
  switch (val_dtype) {
    case 0:
      return sweep<float, X>(n_colours, dofs, ainv, n_blocks, bs, data, cols,
                             width, b, x, r, n, omega, iters, s);
    case 1:
      return sweep<double, X>(n_colours, dofs, ainv, n_blocks, bs, data,
                              cols, width, b, x, r, n, omega, iters, s);
    case 2:
      return sweep<__nv_bfloat16, X>(n_colours, dofs, ainv, n_blocks, bs,
                                     data, cols, width, b, x, r, n, omega,
                                     iters, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): ``iters`` sweeps over the
// colours, two launches a colour on ``stream``, x updated in place.
// dofs[c], ainv[c], n_blocks[c]: colour c's (nb_c, bs) int64 dof ids, its
// (nb_c, bs, bs) inverses and nb_c; data/cols the (n, width) ELL operator;
// r a scratch of max nb_c * bs entries; ainv[c] is transposed
// (ainv[c][k, j, i] = Ainv[k, i, j]).  dtype codes: 0 float32,
// 1 float64, 2 bfloat16 (values only); b, x, r and the inverses share
// x_dtype.  Returns the CUDA error of the first refused launch (0 = all
// launched).
extern "C" int vanka_sweep(int n_colours, const void* const* dofs,
                           const void* const* ainv,
                           const long long* n_blocks, int bs,
                           const void* data, int val_dtype, const void* cols,
                           int width, const void* b, void* x, void* r,
                           int x_dtype, long long n, double omega, int iters,
                           void* stream) {
  if (n_colours < 0 || bs <= 0 || width <= 0 || n <= 0 || iters < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_vals<float>(val_dtype, n_colours, dofs, ainv, n_blocks,
                                bs, data, cols, width, b, x, r, n, omega,
                                iters, s);
  if (x_dtype == 1)
    return dispatch_vals<double>(val_dtype, n_colours, dofs, ainv, n_blocks,
                                 bs, data, cols, width, b, x, r, n, omega,
                                 iters, s);
  return cudaErrorInvalidValue;
}
