// Batched Vanka block inverses (femus_tpu_torch/algebra/vanka.py:
// _invert_blocks) for Hopper (sm_90a): one launch a colour gathers each
// block from the flat operator values, inverts it in shared memory by
// Gauss-Jordan elimination with partial pivoting, and writes its inverse
// transposed, with the block's row mask.
//
// Replaces no TPU kernel: the JAX package inverts the blocks with
// jax.scipy.linalg.lu_factor and lu_solve (femus_tpu/algebra/vanka.py:
// _invert_blocks), which XLA runs as its own batched LU.  The port ran a
// cat, a gather, a mask, an identity pad, torch.linalg.lu_factor (MAGMA or
// cuBLAS) and lu_solve against an expanded identity a colour: about ten
// launches, the LU's error-check read, and, on MAGMA's route, two or three
// stream synchronisations inside, so the set-up of a solve waited on the
// device hundreds of times for a few milliseconds of work.
//
// For block k, with dofs (nb, bs) padded with n and slots (nb, bs, bs)
// indexing the flat values (``miss`` = the values' length marks a zero):
//
//   A[i, j] = data[slots[k, i, j]]   where dofs[k, i] < n and dofs[k, j] < n
//           = (i == j)               where either is padding
//   ainv_t[k, j, i] = inv(A)[i, j];  rv[k, i] = (dofs[k, i] < n)
//
// One thread block a Vanka block.  The block lives in shared memory
// (row-major, an odd leading dimension, so a column is read without bank
// conflicts) and is inverted in place.  At step c warp 0 alone picks the
// pivot, the largest |A[i, c]| over rows i >= c (ties to the lowest row),
// swaps rows c and p, moves column c out as the step's factors (0 for row
// c) and puts the identity's column c in its place, and scales row c by
// the pivot's reciprocal into a cached row u.  After one barrier every
// thread updates its entries, a[i, j] -= f[i] u[j], with no branch (row c's
// factor is 0, column c's entries become -f[i] / pivot), then a second
// barrier.  A thread keeps one column j and every rows-th row, so it reads
// u[j] once a step and does no index arithmetic in the update.  The row
// interchanges are undone at the end as column interchanges folded into
// the write's addressing.  Pivoting is required: a saddle-point block's
// P1dc pressure rows have a zero diagonal.  Sums run in a fixed order, so
// results repeat bit for bit.  A singular block gives non-finite entries
// (a zero pivot's reciprocal) and no error: nothing is checked on the
// device, nothing waits for it.
//
// Bound: HBM bytes.  Each block reads its bs^2 int64 slots and gathers
// bs^2 values, and writes bs^2 inverse entries: at the Boussinesq cavity's
// finest level (60-dof blocks, float32) some 58 kB a block; the
// Gauss-Jordan flops, 2 bs^3 a block, sit below the card's balance point.
// What the card spends is instructions: bs steps of bs^2 updates a block,
// so the update is one shared load, one fused multiply-add and one store
// an entry.  Shared memory: bs (bs | 1) + 2 bs values and 3 bs ints, so up
// to 238 dofs in float32 and 168 in float64 fit the card's 227 kB.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename A>
__device__ __forceinline__ A value(float v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A value(double v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A value(__nv_bfloat16 v) {
  return static_cast<A>(__bfloat162float(v));
}

__device__ __forceinline__ float magnitude(float v) { return fabsf(v); }
__device__ __forceinline__ double magnitude(double v) { return fabs(v); }

template <typename X>
size_t smem_bytes(int bs) {
  const size_t ld = static_cast<size_t>(bs | 1);
  return (bs * ld + 2 * static_cast<size_t>(bs)) * sizeof(X) +
         3 * static_cast<size_t>(bs) * sizeof(int);
}

// S: value storage type; X: inversion and output type.
template <typename S, typename X>
__global__ void __launch_bounds__(kMaxThreads)
vanka_invert_kernel(const S* __restrict__ data, long long miss,
                    const long long* __restrict__ dofs,
                    const long long* __restrict__ slots,
                    X* __restrict__ ainv_t, X* __restrict__ rv, int bs,
                    long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bs | 1;
  X* a = reinterpret_cast<X*>(smem);     // the block, row-major, bs x ld
  X* urow = a + bs * ld;                 // the step's scaled pivot row
  X* fcol = urow + bs;                   // the step's factors, column c
  int* valid = reinterpret_cast<int*>(fcol + bs);
  int* perm = valid + bs;                // the pivot row of each step
  int* col = perm + bs;                  // inv(A)[:, j] = a[:, col[j]]
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long k = blockIdx.x;
  const int nn = bs * bs;
  const long long* d = dofs + k * bs;
  const long long* s = slots + k * nn;

  for (int i = tid; i < bs; i += nt) {
    const int ok = __ldg(d + i) < n;
    valid[i] = ok;
    rv[k * bs + i] = ok ? X(1) : X(0);
  }
  __syncthreads();
  for (int t = tid; t < nn; t += nt) {
    const int i = t / bs, j = t - i * bs;
    const long long sl = __ldcs(s + t);
    X v;
    if (valid[i] && valid[j])
      v = (sl >= 0 && sl < miss) ? value<X>(data[sl]) : X(0);
    else
      v = i == j ? X(1) : X(0);
    a[i * ld + j] = v;
  }
  __syncthreads();

  // each thread updates one column j of the rows r0, r0 + rows, ...: its
  // column's entry of the scaled pivot row stays in a register for a step
  const int rows = nt / bs < bs ? (nt / bs > 0 ? nt / bs : 1) : bs;
  const bool updates = tid < rows * bs;
  const int j = tid % bs, r0 = tid / bs;
  for (int c = 0; c < bs; ++c) {
    if (tid < 32) {
      // pivot: the largest |a[i, c]|, i >= c, the lowest row on a tie; a
      // NaN never wins (a column of NaNs keeps row c)
      X best = X(-1);
      int bi = bs;
      for (int i = c + tid; i < bs; i += 32) {
        const X m = magnitude(a[i * ld + c]);
        if (m > best) {
          best = m;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const X ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int p = bi < bs ? bi : c;
      if (tid == 0) perm[c] = p;
      if (p != c) {                      // the row swap
        for (int k = tid; k < bs; k += 32) {
          const X t = a[p * ld + k];
          a[p * ld + k] = a[c * ld + k];
          a[c * ld + k] = t;
        }
        __syncwarp();
      }
      const X inv = X(1) / a[c * ld + c];
      __syncwarp();
      // column c leaves the elimination's factors and holds the identity's
      // column c, so the update below writes the inverse's column there
      for (int i = tid; i < bs; i += 32) {
        fcol[i] = i == c ? X(0) : a[i * ld + c];
        a[i * ld + c] = i == c ? X(1) : X(0);
      }
      __syncwarp();
      for (int k = tid; k < bs; k += 32) {
        const X u = a[c * ld + k] * inv;
        urow[k] = u;
        a[c * ld + k] = u;
      }
    }
    __syncthreads();
    // every row but c (whose factor is 0) less its factor times the scaled
    // pivot row
    if (updates) {
      const X u = urow[j];
      for (int i = r0; i < bs; i += rows) {
        X* e = a + i * ld + j;
        *e -= fcol[i] * u;
      }
    }
    __syncthreads();
  }

  // the row interchanges of the steps, undone as column interchanges in
  // reverse order: inv(A) = a S_{bs-1} ... S_0
  if (tid == 0) {
    for (int j = 0; j < bs; ++j) col[j] = j;
    for (int c = bs - 1; c >= 0; --c) {
      const int q = perm[c], t = col[c];
      col[c] = col[q];
      col[q] = t;
    }
  }
  __syncthreads();
  X* out = ainv_t + k * nn;
  for (int t = tid; t < nn; t += nt) {
    const int j = t / bs, i = t - j * bs;
    out[t] = a[i * ld + col[j]];
  }
}

template <typename S, typename X>
cudaError_t invert(const void* data, long long miss, const void* dofs,
                   const void* slots, long long nb, int bs, void* ainv_t,
                   void* rv, long long n, cudaStream_t stream) {
  const size_t smem = smem_bytes<X>(bs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vanka_invert_kernel<S, X>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // a thread a column of every rows-th row, as many row groups as fit in
  // kMaxThreads (at most bs); one warp at least, for the pivot search
  int rows = kMaxThreads / bs;
  rows = rows < 1 ? 1 : (rows > bs ? bs : rows);
  const int threads = bs * rows < 32 ? 32 : bs * rows;
  vanka_invert_kernel<S, X><<<static_cast<unsigned>(nb), threads, smem,
                              stream>>>(
      static_cast<const S*>(data), miss,
      static_cast<const long long*>(dofs),
      static_cast<const long long*>(slots), static_cast<X*>(ainv_t),
      static_cast<X*>(rv), bs, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch on ``stream``.
// data: the flat operator values (dtype code 0 float32, 1 float64,
// 2 bfloat16), ``miss`` long (a slot equal to miss reads zero); dofs
// (nb, bs) and slots (nb, bs, bs) int64; ainv_t (nb, bs, bs) and rv
// (nb, bs) written, float64 for float64 values and float32 otherwise,
// ainv_t transposed (ainv_t[k, j, i] = inv(A_k)[i, j]).  Returns the CUDA
// error of a refused launch, or cudaErrorInvalidValue for arguments the
// kernel does not take (0 = launched).
extern "C" int vanka_invert(const void* data, int val_dtype, long long miss,
                            const void* dofs, const void* slots,
                            long long nb, int bs, void* ainv_t, void* rv,
                            long long n, void* stream) {
  if (nb < 0 || nb > 0x7fffffffLL || bs <= 0 || n <= 0 || miss < 0)
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (val_dtype) {
    case 0:
      return invert<float, float>(data, miss, dofs, slots, nb, bs, ainv_t,
                                  rv, n, s);
    case 1:
      return invert<double, double>(data, miss, dofs, slots, nb, bs, ainv_t,
                                    rv, n, s);
    case 2:
      return invert<__nv_bfloat16, float>(data, miss, dofs, slots, nb, bs,
                                          ainv_t, rv, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}
