// The CSR row reduction that K1 (csr_spmm.cu) and K2 (segment_sum.cu) share:
//   out[r, :] = sum_{k in [row_ptr[r], row_ptr[r + 1])} w[k] * x[idx(k), :]
// with idx(k) = col[k] for K1 ("gather") and idx(k) = k for K2
// ("contiguous", w all ones). float32 sums, output in x's dtype, empty rows 0.
//
// Work is cut by edges, not by rows: merge-path tiles (Merrill & Garland,
// "Merge-based parallel sparse matrix-vector multiplication", SC'16). The
// n_rows row ends and the n_edges edges form one merge list of
// n_rows + n_edges items; a CTA takes kTileItems consecutive items and each of
// its warps kWarpItems of them, so no warp walks more than kWarpItems edges
// whatever the degree distribution (a 21,305-edge hub spans 84 warps, 11
// CTAs, where the kernel this replaces gave it one warp). A CTA
// finds its two merge coordinates with a 32-way warp search of row_ptr itself
// (about 4 rounds of loads at ogbn-arxiv scale): no host plan and no cache per
// adjacency, so any CSR (row_ptr, t_row_ptr, a blocked remainder) runs as is.
// It then stages its row_ptr slice and, for K1, its col and w slices into
// shared memory with cp.async (read once, coalesced, no register staging),
// and each warp finds its own coordinates in that slice.
//
// A warp walks the rows of its items in order. A row that lies wholly inside
// the warp's items is written to out once. A row cut by a warp boundary
// leaves a float32 partial in the scratch buffer `part`: the warp's first row
// when it began in an earlier warp ("head"), its last row when it goes on in
// a later warp ("tail"). A second launch (csr_reduce_fixup) gives each head
// row the sum, in warp order, of the tails of that row and the head, and
// writes it once. No atomics: the sums are bitwise the same on every call.
//
// Inside a row, a group of kG lanes takes one edge, so a warp takes 32 / kG
// edges at once: kG = min(32, next_pow2(ceil(F / 4))) on the vector path,
// min(32, next_pow2(F)) on the scalar one. At width 1 all 32 lanes run over
// edges, at width 8 (two lanes of float4) 16 edges; at F >= 128 one edge a
// warp step, 128 features a pass. kU steps are issued before the first add,
// unconditionally (slots past the row's end reread its last edge and are not
// added, as in gat_spmm.cu), and the groups' partials are combined with a
// __shfl_xor_sync butterfly in a fixed order.
//
// Feature rows are not staged through shared memory: each is read once by
// one lane group with 16-byte loads (coalesced along the row, and for K2
// along consecutive rows), and 8 warp steps of them in flight on each warp
// already keep more bytes in flight than HBM needs. Staging them would add a
// shared-memory round trip and move no byte less. Tensor cores do not apply:
// the reduction is 2 flops (K1) or 1 (K2) per 4-8 bytes moved, far under the
// H100's ~295 flops a byte where the tensor cores, not HBM, would bound it.

#pragma once

#include "common.cuh"

namespace gnn {

constexpr int kWarpItems = 256;  // merge items (row ends + edges) per warp
constexpr int kTileItems = kWarpItems * kWarpsPerBlock;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The row coordinate of merge diagonal d: the first p in [lo, hi) with
// row_ptr[p + 1] + p >= d, else hi. rp[p + 1 - base] is row_ptr[p + 1]. A
// 32-way search: each round the warp probes 32 evenly spaced rows and keeps
// the span between the last probe below d and the first at or above it. All
// lanes return the same value.
__device__ __forceinline__ int merge_path_row(const int32_t* rp, int base, int lo,
                                              int hi, int d, int lane) {
  while (hi - lo > kWarp) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;
    const bool ge = p >= hi || rp[p + 1 - base] + p >= d;
    const unsigned m = __ballot_sync(kFullMask, ge);
    if (m == 0) {
      lo += (kWarp - 1) * step + 1;
    } else {
      const int k = __ffs(m) - 1;
      if (k == 0) return lo;
      hi = min(hi, lo + k * step);
      lo += (k - 1) * step + 1;
    }
  }
  const int p = lo + lane;
  const unsigned m = __ballot_sync(kFullMask, p >= hi || rp[p + 1 - base] + p >= d);
  return m ? lo + __ffs(m) - 1 : hi;
}

template <bool kVec, typename T>
__device__ __forceinline__ float4 load_feat(const T* p) {
  return kVec ? load4(p) : make_float4(load1(p), 0.f, 0.f, 0.f);
}
template <bool kVec, typename T>
__device__ __forceinline__ void store_feat(T* p, float4 v) {
  if (kVec) {
    store4(p, v);
  } else {
    store1(p, v.x);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sum of edges [b, e) of one row into `dst` (out's dtype) or, for a cut row,
// `pdst` (float32 scratch). col_s / w_s hold the CTA's edges from jbase on.
template <typename T, bool kVec, int kG, bool kGather>
__device__ __forceinline__ void reduce_row(int b, int e, const int32_t* col_s,
                                           const float* w_s, int jbase, bool has_w,
                                           const T* __restrict__ x, int F, int lane,
                                           T* dst, float* pdst) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kGroups = kWarp / kG;
  // warp steps in flight: 8 edges a warp at kG = 32, at least two steps
  constexpr int kU = kGroups >= 4 ? 2 : 8 / kGroups;
  const int q = lane / kG;
  const int f_lane = (lane % kG) * kPer;
  for (int f0 = 0; f0 < F; f0 += kG * kPer) {
    const int f = f0 + f_lane;
    const bool active = f < F;
    const int fl = active ? f : 0;  // idle lanes read a valid address
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = b; base < e; base += kGroups * kU) {
      float4 v[kU];
      float wv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = min(base + u * kGroups + q, e - 1);
        const int row = kGather ? col_s[k - jbase] : k;
        wv[u] = has_w ? w_s[k - jbase] : 1.f;
        v[u] = load_feat<kVec>(x + static_cast<int64_t>(row) * F + fl);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (base + u * kGroups + q < e) fma4(acc, wv[u], v[u]);
      }
    }
#pragma unroll
    for (int off = kG; off < kWarp; off <<= 1) {
      acc.x += __shfl_xor_sync(kFullMask, acc.x, off);
      if (kVec) {
        acc.y += __shfl_xor_sync(kFullMask, acc.y, off);
        acc.z += __shfl_xor_sync(kFullMask, acc.z, off);
        acc.w += __shfl_xor_sync(kFullMask, acc.w, off);
      }
    }
    if (q == 0 && active) {
      if (pdst) {
        store_feat<kVec>(pdst + f, acc);
      } else {
        store_feat<kVec>(dst + f, acc);
      }
    }
  }
}

// One CTA per kTileItems merge items, one warp per kWarpItems of them.
// part holds two float32 [F] partials per warp (head, tail) and part_row
// their rows (-1: none).
template <typename T, bool kVec, int kG, bool kGather>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_reduce_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ col,
                  const float* __restrict__ w,  // may be null: all ones
                  const T* __restrict__ x, T* __restrict__ out,
                  float* __restrict__ part, int32_t* __restrict__ part_row,
                  int n_rows, int n_edges, int F) {
  extern __shared__ int32_t smem[];
  __shared__ int cta_row[2];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int total = n_rows + n_edges;
  const int d0 = blockIdx.x * kTileItems;
  const int d1 = min(d0 + kTileItems, total);
  if (warp < 2) {
    const int d = warp == 0 ? d0 : d1;
    const int i = merge_path_row(row_ptr, 0, max(0, d - n_edges), min(d, n_rows), d, lane);
    if (lane == 0) cta_row[warp] = i;
  }
  __syncthreads();
  const int i0c = cta_row[0], i1c = cta_row[1];
  const int j0c = d0 - i0c, j1c = d1 - i1c;
  int32_t* rp_s = smem;  // row_ptr[i0c .. i1c]
  int32_t* col_s = smem + kTileItems + 1;
  float* w_s = reinterpret_cast<float*>(col_s + kTileItems);
  for (int t = threadIdx.x; t <= i1c - i0c; t += blockDim.x) {
    cp_async4(rp_s + t, row_ptr + i0c + t);
  }
  if (kGather) {
    for (int t = threadIdx.x; t < j1c - j0c; t += blockDim.x) {
      cp_async4(col_s + t, col + j0c + t);
      if (w) cp_async4(w_s + t, w + j0c + t);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int dw0 = min(d0 + warp * kWarpItems, d1);
  const int dw1 = min(dw0 + kWarpItems, d1);
  const int i0 = merge_path_row(rp_s, i0c, max(i0c, dw0 - n_edges), min(i1c, dw0), dw0, lane);
  const int i1 = merge_path_row(rp_s, i0c, max(i0c, dw1 - n_edges), min(i1c, dw1), dw1, lane);
  const int j0 = dw0 - i0, j1 = dw1 - i1;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  int head = -1, tail = -1;
  if (dw0 < dw1) {
    for (int r = i0; r <= i1 && r < n_rows; ++r) {
      const int rb = rp_s[r - i0c];
      const int e = r < i1 ? rp_s[r + 1 - i0c] : j1;
      float* pdst = nullptr;
      if (r == i1) {
        tail = r;
        pdst = part + (2 * tile + 1) * F;
      } else if (r == i0 && rb < j0) {
        head = r;
        pdst = part + 2 * tile * F;
      }
      reduce_row<T, kVec, kG, kGather>(max(rb, j0), e, col_s, w_s, j0c, kGather && w,
                                       x, F, lane, out + static_cast<int64_t>(r) * F, pdst);
    }
  }
  if (lane == 0) {
    part_row[2 * tile] = head;
    part_row[2 * tile + 1] = tail;
  }
}

// One warp per warp tile of csr_reduce_kernel: a tile with a head row r sums
// the tails of r in the tiles just before it, in tile order, then its head,
// and writes out[r].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_reduce_fixup(const float* __restrict__ part, const int32_t* __restrict__ part_row,
                 T* __restrict__ out, int n_tiles, int F) {
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= n_tiles) return;
  const int r = part_row[2 * t];
  if (r < 0) return;
  int s = t;  // first tile of the run of tails of row r that ends at t - 1
  for (;;) {
    const int q = s - 1 - lane;
    const unsigned other = ~__ballot_sync(kFullMask, q >= 0 && part_row[2 * q + 1] == r);
    if (other) {
      s -= __ffs(other) - 1;
      break;
    }
    s -= kWarp;
  }
  constexpr int kPer = kVec ? 4 : 1;
  for (int f = lane * kPer; f < F; f += kWarp * kPer) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int u = s; u < t; ++u) {
      acc = add4(acc, load_feat<kVec>(part + (2 * static_cast<int64_t>(u) + 1) * F + f));
    }
    acc = add4(acc, load_feat<kVec>(part + 2 * static_cast<int64_t>(t) * F + f));
    store_feat<kVec>(out + static_cast<int64_t>(r) * F + f, acc);
  }
}

// Warp tiles (two partials each) of a CSR with n_rows rows and n_edges
// edges; -1 where the merge coordinates would not fit int32.
inline int csr_reduce_tiles(int n_rows, int n_edges) {
  const int64_t total = static_cast<int64_t>(n_rows) + n_edges;
  if (n_rows < 0 || n_edges < 0 || total + kTileItems > INT32_MAX) return -1;
  return static_cast<int>((total + kTileItems - 1) / kTileItems) * kWarpsPerBlock;
}

inline int lanes_per_edge(int F, bool vec) {
  const int need = vec ? (F + 3) / 4 : F;
  int g = 1;
  while (g < need && g < kWarp) g <<= 1;
  return g;
}

template <typename T, bool kVec, int kG, bool kGather>
int launch_csr_reduce_g(const int32_t* row_ptr, const int32_t* col, const float* w,
                        const T* x, T* out, float* part, int32_t* part_row,
                        int n_rows, int n_edges, int F, cudaStream_t s) {
  const int n_tiles = csr_reduce_tiles(n_rows, n_edges);
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  const size_t smem = sizeof(int32_t) * (kTileItems + 1 + (kGather ? 2 * kTileItems : 0));
  csr_reduce_kernel<T, kVec, kG, kGather><<<grid, block, smem, s>>>(
      row_ptr, col, w, x, out, part, part_row, n_rows, n_edges, F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_reduce_fixup<T, kVec><<<grid, block, 0, s>>>(part, part_row, out, n_tiles, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, bool kGather>
int launch_csr_reduce_v(const int32_t* row_ptr, const int32_t* col, const float* w,
                        const T* x, T* out, float* part, int32_t* part_row,
                        int n_rows, int n_edges, int F, cudaStream_t s) {
#define GNN_REDUCE_G(G)                                                         \
  case G:                                                                       \
    return launch_csr_reduce_g<T, kVec, G, kGather>(row_ptr, col, w, x, out,    \
                                                    part, part_row, n_rows,     \
                                                    n_edges, F, s);
  switch (lanes_per_edge(F, kVec)) {
    GNN_REDUCE_G(1)
    GNN_REDUCE_G(2)
    GNN_REDUCE_G(4)
    GNN_REDUCE_G(8)
    GNN_REDUCE_G(16)
    default:
      return launch_csr_reduce_g<T, kVec, 32, kGather>(row_ptr, col, w, x, out, part,
                                                       part_row, n_rows, n_edges, F, s);
  }
#undef GNN_REDUCE_G
}

// Enqueues the reduction and its fixup on `stream`; returns cudaGetLastError().
// part: float32 [2 * tiles * F], part_row: int32 [2 * tiles], with tiles =
// csr_reduce_tiles(n_rows, n_edges). row_ptr[n_rows] must equal n_edges.
template <typename T, bool kGather>
int launch_csr_reduce(const void* row_ptr, const void* col, const void* w, const void* x,
                      void* out, void* part, void* part_row, int n_rows, int n_edges,
                      int F, int vec, void* stream) {
  auto rp = static_cast<const int32_t*>(row_ptr);
  auto c = static_cast<const int32_t*>(col);
  auto wp = static_cast<const float*>(w);
  auto xp = static_cast<const T*>(x);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(part);
  auto pr = static_cast<int32_t*>(part_row);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch_csr_reduce_v<T, true, kGather>(rp, c, wp, xp, op, pp, pr, n_rows, n_edges, F, s);
  }
  return launch_csr_reduce_v<T, false, kGather>(rp, c, wp, xp, op, pp, pr, n_rows, n_edges, F, s);
}

}  // namespace gnn
