// Patch-lattice stencil matvec (kernel B2) for Hopper (sm_90a).
//
// Replaces femus_tpu/algebra/patchstencil.py:_patch_chunk_call, the fused
// Pallas TPU kernel, and the one-hot routing matmuls the JAX package puts
// around it (_patch_inputs, _patch_combine): y = A x for
//
//   A = sum_p S_p^T A_p S_p,   A_p a 25-point stencil on patch p's H x H
//   lattice, weights wt[((vr*nv + vc)*25 + k), i, j, p] (p fastest, Pp
//   patches padded to a multiple of 128), k = 5 (di + 2) + (dj + 2).
//
// x and y are global vectors of nv variables, each n long: patch-interior
// rows first (((i-1) E + (j-1)) P + p, E = H - 2), then E rows per coarse
// edge (n_int + t n_edges + e), then one row per coarse vertex.
//
// The TPU has no gather, so the JAX package builds the per-patch window
// (interior, four face lines, four corners, a zero ring of 2) with dense
// one-hot matmuls outside the kernel and sums the skeleton partials with
// two more.  This card gathers, so both move inside:
//
// patch_stencil_kernel: one thread per lattice point and patch, as the
//   lattice kernels of this package have it; a thread block owns a tile of
//   4 consecutive lattice points of one row for 32 consecutive patches of
//   one row variable (4 warps, a warp = the 32 patches of one point, so
//   every weight load and every y store of a warp is one coalesced 128-byte
//   line).  The block first stages the tile's 5 x 8 x 32 window in shared
//   memory straight from x: interior entries by address, face lines through
//   face_code (edge id, flip), corners through corner_vert, zeros in the
//   ring of 2 and beyond patch P.  A warp stages one window position at a
//   time, so the branch on the position is warp-uniform and paid once per
//   window entry, not 25 times per point; the copies are asynchronous
//   (cp.async), so a warp starts all of its copies before it waits
//   once.  Then each thread does 25 multiply-adds of a streamed weight
//   (evict-first: every weight is read once) with a shared-memory value,
//   branch-free inside the lattice; weights that multiply the zero ring
//   are not read.  A block operator loops the column variable inside the
//   kernel (window restaged, the sum stays in a register, ascending vc).
//   Interior results go straight into y; line and corner partials go to
//   the scratch arrays yl (nv, E, 4, Pp) and yc (nv, 4, Pp).
// patch_combine_kernel: one thread per skeleton row sums its at most two
//   (edge) or few (vertex) partials in the side order of the tables and
//   writes y in place.
//
// No atomics, every sum in a fixed order: results repeat bit for bit.
//
// Bound: HBM bytes.  The weights inside the lattice (111.5 MB slab in f32
// at H=33, P=1024; 2 flops per weight, 0.25 flop/byte), x, y and the index
// tables, each once.
//
// Why so small a tile.  Measured on an H100 at H=33, P=1024 in float32
// (bound 0.033 ms): large tiles that read each x entry nearly once (3 x 33
// points, 16-byte loads of 4 patches per thread, one resident wave of
// blocks) took 0.053-0.057 ms, the same walked row by row through a ring
// of window rows with the next row staged behind the weight stream
// 0.050-0.054 ms, and this tile 0.047 ms although it stages every x entry
// ten times: many small independent blocks keep more loads in flight than
// few large ones that wait at their barriers.  Reading x straight from
// device memory instead of staging it (no shared memory at all) took
// 0.19 ms: the 25 window entries of a point lie P entries apart, so a
// block finds nothing of them in L1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCombineThreads = 256;
constexpr int kPG = 32;            // patches per thread block: one warp
constexpr int kTR = 1;             // lattice rows of a block's tile
constexpr int kTC = 4;             // lattice columns of a block's tile
constexpr int kMinBlocks = 8;      // blocks per multiprocessor to aim for
constexpr int kWR = kTR + 4;       // window rows and columns of the tile
constexpr int kWC = kTC + 4;
constexpr int kThreads = kTR * kTC * kPG;   // one thread per point and patch

struct Geom {
  int H, E, P, Pp, n_edges, n_verts, nv;
  int n_ct;            // tiles across the lattice columns
  long long n_int, n;  // interior rows and all rows of one variable
};

// asynchronous copy of one element from device to shared memory
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile's window, kWR x kWC positions x 32 patches, from x of one
// variable.  Faces: 0: j=0, 1: i=H-1, 2: j=H-1, 3: i=0; corners (0,0),
// (H-1,0), (H-1,H-1), (0,H-1).
template <typename T>
__device__ __forceinline__ void stage_window(
    T* X, const T* __restrict__ x, const int* __restrict__ face_code,
    const int* __restrict__ corner_vert, const Geom& g, int i0, int j0,
    int p0) {
  const int lane = threadIdx.x & 31;
  const int H = g.H, E = g.E;
  const int p = p0 + lane;
  const bool live = p < g.P;
  for (int pos = threadIdx.x >> 5; pos < kWR * kWC; pos += kThreads / 32) {
    const int wi = pos / kWC;
    const int gi = i0 + wi - 2;
    const int gj = j0 + (pos - wi * kWC) - 2;
    T* dst = X + pos * kPG + lane;
    if (live && gi >= 0 && gi < H && gj >= 0 && gj < H) {
      const bool ii = gi > 0 && gi < H - 1;
      const bool jj = gj > 0 && gj < H - 1;
      long long idx;
      if (ii && jj) {
        idx = (static_cast<long long>(gi - 1) * E + (gj - 1)) * g.P + p;
      } else if (ii || jj) {
        const int f = ii ? (gj == 0 ? 0 : 2) : (gi == H - 1 ? 1 : 3);
        int r = (ii ? gi : gj) - 1;
        const int code = __ldg(face_code + f * g.Pp + p);
        if (code & 1) r = E - 1 - r;
        idx = g.n_int + static_cast<long long>(r) * g.n_edges + (code >> 1);
      } else {
        const int c = gj == 0 ? (gi == 0 ? 0 : 1) : (gi == 0 ? 3 : 2);
        idx = g.n_int + static_cast<long long>(E) * g.n_edges +
              __ldg(corner_vert + c * g.Pp + p);
      }
      copy_async(dst, x + idx);
    } else {
      *dst = T(0);
    }
  }
  copy_async_wait();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
patch_stencil_kernel(const T* __restrict__ wt, const T* __restrict__ x,
                     T* __restrict__ y, T* __restrict__ yl,
                     T* __restrict__ yc, const int* __restrict__ face_code,
                     const int* __restrict__ corner_vert, const Geom g) {
  __shared__ T X[kWR * kWC * kPG];
  const int p0 = blockIdx.x * kPG;
  if (p0 >= g.P) return;                   // a group of padding patches
  const int rt = blockIdx.y / g.n_ct;
  const int i0 = rt * kTR;
  const int j0 = (blockIdx.y - rt * g.n_ct) * kTC;
  const int vr = blockIdx.z;
  const int H = g.H, E = g.E, nv = g.nv;
  const int lane = threadIdx.x & 31;       // this thread's patch
  const int pt = threadIdx.x >> 5;         // and its point of the tile
  const int il = pt / kTC, jl = pt - il * kTC;
  const int i = i0 + il, j = j0 + jl;
  const int p = p0 + lane;
  const bool active = i < H && j < H && p < g.P;
  const long long plane = static_cast<long long>(H) * H * g.Pp;
  const bool inside = i >= 2 && i < H - 2 && j >= 2 && j < H - 2;
  const T* xs = X + (il * kWC + jl) * kPG + lane;

  T acc = T(0);
  for (int vc = 0; vc < nv; ++vc) {
    if (vc) __syncthreads();               // the window is still being read
    stage_window(X, x + vc * g.n, face_code, corner_vert, g, i0, j0, p0);
    __syncthreads();
    if (!active) continue;
    const T* w = wt + static_cast<long long>(vr * nv + vc) * 25 * plane +
                 (static_cast<long long>(i) * H + j) * g.Pp + p;
    if (inside) {
#pragma unroll
      for (int k = 0; k < 25; ++k)
        acc += __ldcs(w + k * plane) * xs[((k / 5) * kWC + k % 5) * kPG];
    } else {
#pragma unroll
      for (int k = 0; k < 25; ++k) {
        const int a_i = i + k / 5 - 2, a_j = j + k % 5 - 2;
        if (a_i >= 0 && a_i < H && a_j >= 0 && a_j < H)
          acc += __ldcs(w + k * plane) * xs[((k / 5) * kWC + k % 5) * kPG];
      }
    }
  }
  if (!active) return;
  const bool ii = i > 0 && i < H - 1;
  const bool jj = j > 0 && j < H - 1;
  if (ii && jj) {
    y[vr * g.n + (static_cast<long long>(i - 1) * E + (j - 1)) * g.P + p] =
        acc;
  } else if (ii || jj) {
    const int f = ii ? (j == 0 ? 0 : 2) : (i == H - 1 ? 1 : 3);
    const int r = (ii ? i : j) - 1;
    yl[((static_cast<long long>(vr) * E + r) * 4 + f) * g.Pp + p] = acc;
  } else {
    const int c = j == 0 ? (i == 0 ? 0 : 1) : (i == 0 ? 3 : 2);
    yc[(static_cast<long long>(vr) * 4 + c) * g.Pp + p] = acc;
  }
}

// Skeleton rows of y: row t < E n_edges is position t / n_edges of edge
// t % n_edges, the rest are vertices.  edge_sides: 8 patch + 2 face + flip;
// vert_sides: 4 patch + corner; -1 = no side.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
patch_combine_kernel(const T* __restrict__ yl, const T* __restrict__ yc,
                     T* __restrict__ y, const int* __restrict__ edge_sides,
                     const int* __restrict__ vert_sides, const Geom g,
                     int maxval) {
  const int n_edge_rows = g.E * g.n_edges;
  const int t = blockIdx.x * kCombineThreads + threadIdx.x;
  if (t >= n_edge_rows + g.n_verts) return;
  const int vr = blockIdx.y;
  T acc = T(0);
  if (t < n_edge_rows) {
    const int r = t / g.n_edges;
    const int e = t - r * g.n_edges;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int code = __ldg(edge_sides + e * 2 + s);
      if (code < 0) continue;
      const int rr = (code & 1) ? g.E - 1 - r : r;
      acc += yl[((static_cast<long long>(vr) * g.E + rr) * 4 +
                 ((code >> 1) & 3)) * g.Pp + (code >> 3)];
    }
  } else {
    const int v = t - n_edge_rows;
    for (int s = 0; s < maxval; ++s) {
      const int code = __ldg(vert_sides + v * maxval + s);
      if (code < 0) continue;
      acc += yc[(static_cast<long long>(vr) * 4 + (code & 3)) * g.Pp +
                (code >> 2)];
    }
  }
  y[vr * g.n + g.n_int + t] = acc;
}

template <typename T>
cudaError_t launch(const void* wt, const void* x, void* y, void* yl, void* yc,
                   const int* face_code, const int* corner_vert,
                   const int* edge_sides, const int* vert_sides, Geom g,
                   int maxval, int stages, cudaStream_t stream) {
  if (stages & 1) {
    g.n_ct = (g.H + kTC - 1) / kTC;
    const dim3 grid(g.Pp / kPG, (g.H + kTR - 1) / kTR * g.n_ct, g.nv);
    patch_stencil_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(wt), static_cast<const T*>(x),
        static_cast<T*>(y), static_cast<T*>(yl), static_cast<T*>(yc),
        face_code, corner_vert, g);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  if (stages & 2) {
    const int rows = g.E * g.n_edges + g.n_verts;
    const dim3 grid((rows + kCombineThreads - 1) / kCombineThreads, g.nv);
    patch_combine_kernel<T><<<grid, kCombineThreads, 0, stream>>>(
        static_cast<const T*>(yl), static_cast<const T*>(yc),
        static_cast<T*>(y), edge_sides, vert_sides, g, maxval);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1 float64,
// shared by wt, x, y, yl and yc; the four tables are int32.  stages: bit 0
// launches the stencil kernel, bit 1 the combine kernel.  Returns the CUDA
// error of the launches (0 = launched).
extern "C" int patch_matvec(const void* wt, const void* x, void* y, void* yl,
                            void* yc, const void* face_code,
                            const void* corner_vert, const void* edge_sides,
                            const void* vert_sides, int dtype, int H, int P,
                            int Pp, int n_edges, int n_verts, int maxval,
                            int nv, int stages, void* stream) {
  if (H < 3 || P <= 0 || Pp < P || Pp % kPG || nv < 1 || nv > 65535 ||
      n_edges < 0 || n_verts < 0 || maxval < 0 || !(stages & 3))
    return cudaErrorInvalidValue;
  Geom g;
  g.H = H; g.E = H - 2; g.P = P; g.Pp = Pp;
  g.n_edges = n_edges; g.n_verts = n_verts; g.nv = nv;
  g.n_ct = 0;
  g.n_int = static_cast<long long>(g.E) * g.E * P;
  g.n = g.n_int + static_cast<long long>(g.E) * n_edges + n_verts;
  if (g.n >= (1LL << 31)) return cudaErrorInvalidValue;
  const int* fc = static_cast<const int*>(face_code);
  const int* cv = static_cast<const int*>(corner_vert);
  const int* es = static_cast<const int*>(edge_sides);
  const int* vs = static_cast<const int*>(vert_sides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(wt, x, y, yl, yc, fc, cv, es, vs, g, maxval, stages,
                         s);
  if (dtype == 1)
    return launch<double>(wt, x, y, yl, yc, fc, cv, es, vs, g, maxval, stages,
                          s);
  return cudaErrorInvalidValue;
}
