// Native host set-up kernels of femus_tpu_torch (C ABI, loaded via ctypes).
//
// Equivalent of the reference's native host-side machinery: METIS element
// partitioning (MeshMetisPartitioning.cpp:41-99) and the sparsity/dofmap
// construction inside Mesh/LinearEquation (Mesh.hpp:451-543,
// LinearEquation.hpp:161).  These run once at setup but dominate setup time
// for large meshes; they are plain sequential C++ with cache-friendly
// layouts, called with NumPy buffers.
//
// Exposed functions (all extern "C"):
//   rcb_partition        recursive coordinate bisection of element centroids
//   greedy_graph_partition  BFS region growing over the element dual graph
//                        with boundary Kernighan-Lin-style refinement sweeps
//   edge_cut             dual-graph edge cut of a partition (quality metric)
//   csr_from_coo         sorted+deduplicated CSR from COO pairs (two-phase)
//
// Build: g++ -O3 -shared -fPIC into build/ (femus_tpu_torch/native/__init__.py).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Recursive coordinate bisection: split the longest axis at the weighted
// median, recurse with part counts split proportionally.  Produces compact,
// convex-ish shards (small halo surface) for lattice-like meshes.
// ---------------------------------------------------------------------------
static void rcb_rec(const double* cent, int dim, int64_t* ids, int64_t n,
                    int32_t part0, int32_t nparts, int32_t* out) {
  if (nparts <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) out[ids[i]] = part0;
    return;
  }
  // longest axis of the bounding box
  int axis = 0;
  double best = -1.0;
  for (int d = 0; d < dim; ++d) {
    double lo = 1e300, hi = -1e300;
    for (int64_t i = 0; i < n; ++i) {
      double v = cent[ids[i] * dim + d];
      lo = std::min(lo, v);
      hi = std::max(hi, v);
    }
    if (hi - lo > best) { best = hi - lo; axis = d; }
  }
  int32_t nl = nparts / 2, nr = nparts - nl;
  int64_t k = (int64_t)((double)n * nl / nparts);
  k = std::max<int64_t>(1, std::min<int64_t>(n - 1, k));
  std::nth_element(ids, ids + k, ids + n,
                   [cent, dim, axis](int64_t a, int64_t b) {
                     return cent[a * dim + axis] < cent[b * dim + axis];
                   });
  rcb_rec(cent, dim, ids, k, part0, nl, out);
  rcb_rec(cent, dim, ids + k, n - k, part0 + nl, nr, out);
}

void rcb_partition(int64_t ne, int32_t dim, const double* cent,
                   int32_t nparts, int32_t* out) {
  std::vector<int64_t> ids(ne);
  std::iota(ids.begin(), ids.end(), 0);
  rcb_rec(cent, dim, ids.data(), ne, 0, nparts, out);
}

// ---------------------------------------------------------------------------
// Dual-graph edge cut.
// ---------------------------------------------------------------------------
int64_t edge_cut(int64_t ne, int32_t nf, const int32_t* neigh,
                 const int32_t* part) {
  int64_t cut = 0;
  for (int64_t e = 0; e < ne; ++e)
    for (int32_t f = 0; f < nf; ++f) {
      int32_t o = neigh[e * nf + f];
      if (o >= 0 && o > e && part[o] != part[e]) ++cut;
    }
  return cut;
}

// ---------------------------------------------------------------------------
// Greedy BFS region growing over the dual graph (METIS K-way stand-in,
// MeshMetisPartitioning.cpp:84-99 semantics: balanced parts, small cut),
// followed by `sweeps` boundary-refinement passes that move boundary
// elements to the neighboring part with the largest gain subject to
// balance tolerance.
// ---------------------------------------------------------------------------
void greedy_graph_partition(int64_t ne, int32_t nf, const int32_t* neigh,
                            int32_t nparts, int32_t sweeps, int32_t* out) {
  const int64_t target = (ne + nparts - 1) / nparts;
  std::vector<int32_t> part(ne, -1);
  std::vector<int64_t> size(nparts, 0);
  int64_t seed = 0;
  for (int32_t p = 0; p < nparts; ++p) {
    while (seed < ne && part[seed] >= 0) ++seed;
    if (seed >= ne) break;
    // BFS from seed until target size
    std::queue<int64_t> q;
    q.push(seed);
    part[seed] = p;
    ++size[p];
    while (!q.empty() && size[p] < target) {
      int64_t e = q.front();
      q.pop();
      for (int32_t f = 0; f < nf; ++f) {
        int32_t o = neigh[e * nf + f];
        if (o >= 0 && part[o] < 0 && size[p] < target) {
          part[o] = p;
          ++size[p];
          q.push(o);
        }
      }
    }
  }
  // orphans (disconnected leftovers): attach to any assigned neighbor,
  // else smallest part
  for (int64_t e = 0; e < ne; ++e)
    if (part[e] < 0) {
      int32_t best = -1;
      for (int32_t f = 0; f < nf; ++f) {
        int32_t o = neigh[e * nf + f];
        if (o >= 0 && part[o] >= 0) { best = part[o]; break; }
      }
      if (best < 0)
        best = (int32_t)(std::min_element(size.begin(), size.end()) -
                         size.begin());
      part[e] = best;
      ++size[best];
    }
  // boundary refinement sweeps
  const int64_t hi = target + target / 8 + 1;   // 12.5% imbalance tolerance
  const int64_t lo = target - target / 8 - 1;
  std::vector<int32_t> cnt(nparts);
  for (int32_t s = 0; s < sweeps; ++s) {
    int64_t moved = 0;
    for (int64_t e = 0; e < ne; ++e) {
      std::fill(cnt.begin(), cnt.end(), 0);
      bool boundary = false;
      for (int32_t f = 0; f < nf; ++f) {
        int32_t o = neigh[e * nf + f];
        if (o >= 0) {
          ++cnt[part[o]];
          if (part[o] != part[e]) boundary = true;
        }
      }
      if (!boundary) continue;
      int32_t cur = part[e];
      int32_t best = cur;
      int32_t bestGain = 0;
      for (int32_t p = 0; p < nparts; ++p) {
        if (p == cur || cnt[p] == 0) continue;
        int32_t gain = cnt[p] - cnt[cur];
        if (gain > bestGain && size[p] < hi && size[cur] > lo) {
          bestGain = gain;
          best = p;
        }
      }
      if (best != cur) {
        part[e] = best;
        --size[cur];
        ++size[best];
        ++moved;
      }
    }
    if (moved == 0) break;
  }
  std::memcpy(out, part.data(), ne * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// COO -> CSR with sort + dedupe.  Phase 1 (nnz_out==nullptr? no — single
// call): caller passes capacity >= n_pairs; returns actual nnz.  indptr must
// have n_rows+1 slots; indices capacity n_pairs.
// ---------------------------------------------------------------------------
int64_t csr_from_coo(int64_t n_pairs, const int64_t* rows, const int64_t* cols,
                     int64_t n_rows, int64_t* indptr, int64_t* indices) {
  std::vector<int64_t> order(n_pairs);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [rows, cols](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  int64_t nnz = 0;
  int64_t prev_r = -1, prev_c = -1;
  std::fill(indptr, indptr + n_rows + 1, 0);
  for (int64_t k = 0; k < n_pairs; ++k) {
    int64_t r = rows[order[k]], c = cols[order[k]];
    if (r == prev_r && c == prev_c) continue;
    indices[nnz++] = c;
    ++indptr[r + 1];
    prev_r = r;
    prev_c = c;
  }
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] += indptr[r];
  return nnz;
}

}  // extern "C"
