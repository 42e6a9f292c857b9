// Patch-lattice stencil SpMV (kernel B2) for Hopper (sm_90a).
//
// Replaces femus_tpu/algebra/patchstencil.py:_patch_chunk_call, the fused
// Pallas TPU kernel, and computes what its body computes for one weight
// slab wt (K=25, H, H, Pp):
//
//   X   = the (H+4, H+4) window of patch p: interior xi (E, E, Pp), face
//         lines (E, 4, Pp) and corners cv (4, Pp) in place, a zero ring of
//         2 around the H x H lattice (E = H - 2);
//   Y[i, j, p] = sum_k wt[k, i, j, p] * X[i + di_k, j + dj_k, p],
//         k = 5 (di + 2) + (dj + 2) over [-2, 2]^2;
//   yi, yl, yc = the interior, face-line and corner entries of Y, laid out
//         like xi, lines and cv.
//
// The TPU kernel cuts the slab into 128-patch chunks and offset groups to
// fit VMEM, and assembles X in VMEM scratch.  None of that carries over.
// Here one thread owns one lattice point (i, j, p), with p fastest: the 32
// threads of a warp share (i, j) and read 32 consecutive patches, so every
// wt, X and Y access of a warp is one coalesced 128-byte (f32) line, and
// the branch that maps a window position onto xi / lines / cv / the zero
// ring is uniform across the warp.  X is never written to device memory:
// each thread reads its 25 window values straight from the inputs, which
// (about 4 MB at H=33, P=1024) stay in L1/L2 across the up-to-25 re-reads;
// the weight slab is streamed once with evict-first loads.  Each lattice
// point maps to exactly one output slot, so the kernel writes without
// atomics and repeats bit for bit; with accumulate=1 it adds into the
// outputs (a block operator sums its column-variable pairs).
//
// Bound: HBM bytes.  The slab is K*H*H*Pp values (111.5 MB in f32 at
// H=33, P=1024), 2 flops each: 0.25 flop/byte in f32, far below the
// card's balance point.  A weight whose window position lies in the zero
// ring multiplies zero, so it is not read (warp-uniform skip).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Address of lattice point (i, j) of patch 0 in the interior / line /
// corner arrays (patch p adds p), or nullptr outside the H x H lattice.
// Faces: 0: j=0, 1: i=H-1, 2: j=H-1, 3: i=0; corners (0,0), (H-1,0),
// (H-1,H-1), (0,H-1).
template <typename Ptr>
__device__ __forceinline__ Ptr locate(Ptr in, Ptr ln, Ptr cn, int i, int j,
                                      int H, long long Pp) {
  const int E = H - 2;
  const bool ii = i > 0 && i < H - 1;
  const bool jj = j > 0 && j < H - 1;
  if (ii && jj) return in + (static_cast<long long>(i - 1) * E + (j - 1)) * Pp;
  if (ii) {
    if (j == 0) return ln + (static_cast<long long>(i - 1) * 4 + 0) * Pp;
    if (j == H - 1) return ln + (static_cast<long long>(i - 1) * 4 + 2) * Pp;
    return nullptr;
  }
  if (jj) {
    if (i == H - 1) return ln + (static_cast<long long>(j - 1) * 4 + 1) * Pp;
    if (i == 0) return ln + (static_cast<long long>(j - 1) * 4 + 3) * Pp;
    return nullptr;
  }
  if (j == 0) {
    if (i == 0) return cn;
    if (i == H - 1) return cn + Pp;
  } else if (j == H - 1) {
    if (i == H - 1) return cn + 2 * Pp;
    if (i == 0) return cn + 3 * Pp;
  }
  return nullptr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_stencil_kernel(const T* __restrict__ wt, const T* __restrict__ xi,
                     const T* __restrict__ lines, const T* __restrict__ cv,
                     T* __restrict__ yi, T* __restrict__ yl,
                     T* __restrict__ yc, int H, int Pp, int accumulate) {
  const long long plane = static_cast<long long>(H) * H * Pp;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= plane) return;
  const int p = static_cast<int>(t % Pp);
  const int ij = static_cast<int>(t / Pp);
  const int i = ij / H;
  const int j = ij % H;

  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const T* xs = locate(xi, lines, cv, i + k / 5 - 2, j + k % 5 - 2, H,
                         static_cast<long long>(Pp));
    if (xs != nullptr) acc += __ldcs(wt + k * plane + t) * __ldg(xs + p);
  }
  T* ys = locate(yi, yl, yc, i, j, H, static_cast<long long>(Pp)) + p;
  *ys = accumulate ? *ys + acc : acc;
}

template <typename T>
cudaError_t launch(const void* wt, const void* xi, const void* lines,
                   const void* cv, void* yi, void* yl, void* yc, int H,
                   int Pp, int accumulate, cudaStream_t stream) {
  const long long plane = static_cast<long long>(H) * H * Pp;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads));
  patch_stencil_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(wt), static_cast<const T*>(xi),
      static_cast<const T*>(lines), static_cast<const T*>(cv),
      static_cast<T*>(yi), static_cast<T*>(yl), static_cast<T*>(yc), H, Pp,
      accumulate);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1 float64,
// shared by every array.  Returns the CUDA error of the launch
// (0 = launched).
extern "C" int patch_stencil(const void* wt, const void* xi, const void* lines,
                             const void* cv, void* yi, void* yl, void* yc,
                             int dtype, int H, int Pp, int accumulate,
                             void* stream) {
  if (H < 3 || Pp <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(wt, xi, lines, cv, yi, yl, yc, H, Pp, accumulate, s);
  if (dtype == 1)
    return launch<double>(wt, xi, lines, cv, yi, yl, yc, H, Pp, accumulate,
                          s);
  return cudaErrorInvalidValue;
}
