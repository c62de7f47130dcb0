// The CSR row reduction that K1 (csr_spmm.cu), K2 (segment_sum.cu) and K3
// (gat_spmm.cu) share:
//   out[r, f] = sum_{k in [row_ptr[r], row_ptr[r + 1])} wgt(k, f) * x[idx(k), f]
// over rows of F features. The Op parameter names the instance:
//   Gather      (K1): idx(k) = col[k], wgt(k, f) = w[k] (1 where w is null);
//   Contiguous  (K2): idx(k) = k,      wgt(k, f) = 1;
//   GatherHeads (K3): idx(k) = col[k], the row is H heads of F / H features and
//                     wgt(k, f) = w[widx(k) * H + f / (F / H)], with
//                     widx(k) = w_index[k], or k where w_index is null.
// float32 sums, output in x's dtype, empty rows 0.
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
// It then stages its row_ptr slice and, for K1, its col and w slices (for K3
// col and w_index) into shared memory with cp.async (read once, coalesced, no
// register staging), and each warp finds its own coordinates in that slice.
// K3's weights stay in global memory: a lane reads its own head's weight
// beside the feature load, the H weights of an edge are 4 H contiguous bytes
// (one 32-byte sector at H = 8) that the lanes of a warp share, and a CTA's
// 2,048 x H weights in shared memory (64 KB at H = 8) would leave an SM two
// CTAs where the index slices alone leave it eight.
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
// added), and the groups' partials are combined with a __shfl_xor_sync
// butterfly in a fixed order. On K3's vector path F / H is a multiple of 4,
// so a lane's four features lie in one head.
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

// The instances of the reduction; a profile shows them in the kernels' names.
struct Contiguous {
  static constexpr bool kGather = false;
  static constexpr bool kHeads = false;
};
struct Gather {
  static constexpr bool kGather = true;
  static constexpr bool kHeads = false;
};
struct GatherHeads {
  static constexpr bool kGather = true;
  static constexpr bool kHeads = true;
};

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

// The merge items [d0, d1) of this CTA and its first and last rows i0c and
// i1c, which warps 0 and 1 find in row_ptr (cta_row: two ints of shared
// memory). Every thread returns them, after a __syncthreads; the CTA's
// row_ptr[i0c .. i1c] is then being staged into rp_s with cp.async, which
// the caller waits for.
struct CtaItems {
  int d0, d1, i0c, i1c;
};

__device__ __forceinline__ CtaItems cta_items(const int32_t* __restrict__ row_ptr, int32_t* rp_s,
                                              int* cta_row, int n_rows, int n_edges, int warp,
                                              int lane) {
  const int d0 = blockIdx.x * kTileItems;
  const int d1 = min(d0 + kTileItems, n_rows + n_edges);
  if (warp < 2) {
    const int d = warp == 0 ? d0 : d1;
    const int i = merge_path_row(row_ptr, 0, max(0, d - n_edges), min(d, n_rows), d, lane);
    if (lane == 0) cta_row[warp] = i;
  }
  __syncthreads();
  const int i0c = cta_row[0], i1c = cta_row[1];
  for (int t = threadIdx.x; t <= i1c - i0c; t += blockDim.x) {
    cp_async4(rp_s + t, row_ptr + i0c + t);
  }
  return {d0, d1, i0c, i1c};
}

// A warp's kWarpItems merge items of its CTA's: rows i0 .. i1 and edges
// [j0, j1), found in the staged slice rp_s; none where the CTA ends first.
struct WarpItems {
  int i0, i1, j0, j1;
  bool none;
};

__device__ __forceinline__ WarpItems warp_items(const int32_t* rp_s, const CtaItems& c,
                                                int n_edges, int warp, int lane) {
  const int dw0 = min(c.d0 + warp * kWarpItems, c.d1);
  const int dw1 = min(dw0 + kWarpItems, c.d1);
  const int i0 = merge_path_row(rp_s, c.i0c, max(c.i0c, dw0 - n_edges), min(c.i1c, dw0), dw0, lane);
  const int i1 = merge_path_row(rp_s, c.i0c, max(c.i0c, dw1 - n_edges), min(c.i1c, dw1), dw1, lane);
  return {i0, i1, dw0 - i0, dw1 - i1, dw0 >= dw1};
}

// How a warp holds a row: wholly, or cut as its first row, begun in an
// earlier warp (the head), or as its last, perhaps going on in a later one
// (the tail).
constexpr int kWhole = -1, kHead = 0, kTail = 1;

// row(r, b, end, side) for each row r of the warp's items in order, with
// [b, end) the row's edges among them.
template <typename Row>
__device__ __forceinline__ void for_each_row(const int32_t* rp_s, int i0c, const WarpItems& w,
                                             int n_rows, Row&& row) {
  if (w.none) return;
  for (int r = w.i0; r <= w.i1 && r < n_rows; ++r) {
    const int rb = rp_s[r - i0c];
    const int end = r < w.i1 ? rp_s[r + 1 - i0c] : w.j1;
    const int side = r == w.i1 ? kTail : r == w.i0 && rb < w.j0 ? kHead : kWhole;
    row(r, max(rb, w.j0), end, side);
  }
}

// The first warp tile of the run of tails of row r that ends at tile t - 1
// (t where tile t - 1 holds no tail of r); part_row holds each tile's head
// and tail rows. All lanes return the same value.
__device__ __forceinline__ int run_start(const int32_t* __restrict__ part_row, int r, int t,
                                         int lane) {
  int s = t;
  for (;;) {
    const int q = s - 1 - lane;
    const unsigned other = ~__ballot_sync(kFullMask, q >= 0 && part_row[2 * q + 1] == r);
    if (other) return s - (__ffs(other) - 1);
    s -= kWarp;
  }
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
// `pdst` (float32 scratch). col_s / w_s / wi_s hold the CTA's edges from jbase
// on: w_s K1's weights (null: ones), wi_s K3's weight rows (null: the edge's
// own); K3 reads its weights from w [E, H] in global memory, head0 being the
// head of the lane's features in the first pass. A group narrower than a warp
// covers the row in one pass (lanes_per_edge), so only kG = 32 loops over f0.
template <typename T, bool kVec, int kG, typename Op>
__device__ __forceinline__ void reduce_row(int b, int e, const int32_t* col_s,
                                           const float* w_s, const int32_t* wi_s,
                                           int jbase, const float* __restrict__ w,
                                           const T* __restrict__ x, int F, int H,
                                           int head_width, int head0, int lane, T* dst,
                                           float* pdst) {
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
    const int head = !Op::kHeads ? 0 : f0 == 0 ? head0 : fl / head_width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = b; base < e; base += kGroups * kU) {
      float4 v[kU];
      float wv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = min(base + u * kGroups + q, e - 1);
        const int row = Op::kGather ? col_s[k - jbase] : k;
        if (Op::kHeads) {
          const int wk = wi_s ? wi_s[k - jbase] : k;
          wv[u] = __ldg(w + static_cast<int64_t>(wk) * H + head);
        } else {
          wv[u] = w_s ? w_s[k - jbase] : 1.f;
        }
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
    if (kG < kWarp) break;
  }
}

// One CTA per kTileItems merge items, one warp per kWarpItems of them.
// part holds two float32 [F] partials per warp (head, tail) and part_row
// their rows (-1: none). H and w_index serve GatherHeads only.
template <typename T, bool kVec, int kG, typename Op>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_reduce_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ col,
                  const float* __restrict__ w,  // Gather: [E] or null (all ones); GatherHeads: [E, H]
                  const int32_t* __restrict__ w_index,  // may be null: edge k has weight row k
                  const T* __restrict__ x, T* __restrict__ out,
                  float* __restrict__ part, int32_t* __restrict__ part_row,
                  int n_rows, int n_edges, int F, int H) {
  extern __shared__ int32_t smem[];
  __shared__ int cta_row[2];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int32_t* rp_s = smem;  // row_ptr[i0c .. i1c]
  const CtaItems c = cta_items(row_ptr, rp_s, cta_row, n_rows, n_edges, warp, lane);
  const int j0c = c.d0 - c.i0c, j1c = c.d1 - c.i1c;
  int32_t* col_s = smem + kTileItems + 1;
  // the third slice: K1's weights, or K3's weight rows
  int32_t* wi_s = col_s + kTileItems;
  float* w_s = reinterpret_cast<float*>(wi_s);
  const bool stage_w = Op::kGather && !Op::kHeads && w;
  const bool stage_wi = Op::kHeads && w_index;
  if (Op::kGather) {
    for (int t = threadIdx.x; t < j1c - j0c; t += blockDim.x) {
      cp_async4(col_s + t, col + j0c + t);
      if (stage_w) cp_async4(w_s + t, w + j0c + t);
      if (stage_wi) cp_async4(wi_s + t, w_index + j0c + t);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const WarpItems items = warp_items(rp_s, c, n_edges, warp, lane);
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int head_width = Op::kHeads ? F / H : F;
  const int f_lane = (lane % kG) * (kVec ? 4 : 1);
  const int head0 = Op::kHeads && f_lane < F ? f_lane / head_width : 0;
  int head = -1, tail = -1;
  for_each_row(rp_s, c.i0c, items, n_rows, [&](int r, int b, int e, int side) {
    float* pdst = nullptr;
    if (side == kTail) {
      tail = r;
      pdst = part + (2 * tile + 1) * F;
    } else if (side == kHead) {
      head = r;
      pdst = part + 2 * tile * F;
    }
    reduce_row<T, kVec, kG, Op>(b, e, col_s, stage_w ? w_s : nullptr, stage_wi ? wi_s : nullptr,
                                j0c, w, x, F, H, head_width, head0, lane,
                                out + static_cast<int64_t>(r) * F, pdst);
  });
  if (lane == 0) {
    part_row[2 * tile] = head;
    part_row[2 * tile + 1] = tail;
  }
}

// One warp per warp tile of csr_reduce_kernel: a tile with a head row r sums
// the tails of r in the tiles just before it, in tile order, then its head,
// and writes out[r]. Op only names the instance.
template <typename T, bool kVec, typename Op>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_reduce_fixup(const float* __restrict__ part, const int32_t* __restrict__ part_row,
                 T* __restrict__ out, int n_tiles, int F) {
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= n_tiles) return;
  const int r = part_row[2 * t];
  if (r < 0) return;
  const int s = run_start(part_row, r, t, lane);
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

// The arguments of one reduction, as the C entries receive them.
template <typename T>
struct ReduceArgs {
  const int32_t* row_ptr;
  const int32_t* col;
  const float* w;
  const int32_t* w_index;
  const T* x;
  T* out;
  float* part;
  int32_t* part_row;
  int n_rows, n_edges, F, H;
  cudaStream_t stream;
};

template <typename T, bool kVec, int kG, typename Op>
int launch_csr_reduce_g(const ReduceArgs<T>& a) {
  const int n_tiles = csr_reduce_tiles(a.n_rows, a.n_edges);
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  const size_t smem = sizeof(int32_t) * (kTileItems + 1 + (Op::kGather ? 2 * kTileItems : 0));
  csr_reduce_kernel<T, kVec, kG, Op><<<grid, block, smem, a.stream>>>(
      a.row_ptr, a.col, a.w, a.w_index, a.x, a.out, a.part, a.part_row, a.n_rows, a.n_edges,
      a.F, a.H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_reduce_fixup<T, kVec, Op><<<grid, block, 0, a.stream>>>(a.part, a.part_row, a.out,
                                                              n_tiles, a.F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, typename Op>
int launch_csr_reduce_v(const ReduceArgs<T>& a) {
  switch (lanes_per_edge(a.F, kVec)) {
    case 1:
      return launch_csr_reduce_g<T, kVec, 1, Op>(a);
    case 2:
      return launch_csr_reduce_g<T, kVec, 2, Op>(a);
    case 4:
      return launch_csr_reduce_g<T, kVec, 4, Op>(a);
    case 8:
      return launch_csr_reduce_g<T, kVec, 8, Op>(a);
    case 16:
      return launch_csr_reduce_g<T, kVec, 16, Op>(a);
    default:
      return launch_csr_reduce_g<T, kVec, 32, Op>(a);
  }
}

// Enqueues the reduction and its fixup on `stream`; returns cudaGetLastError().
// F is the width of a row of x and out (K3: all H heads, H dividing F; H = 1
// otherwise). part: float32 [2 * tiles * F], part_row: int32 [2 * tiles], with
// tiles = csr_reduce_tiles(n_rows, n_edges). row_ptr[n_rows] must equal n_edges.
template <typename T, typename Op>
int launch_csr_reduce(const void* row_ptr, const void* col, const void* w,
                      const void* w_index, const void* x, void* out, void* part,
                      void* part_row, int n_rows, int n_edges, int F, int H, int vec,
                      void* stream) {
  if (H < 1 || F % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ReduceArgs<T> a{static_cast<const int32_t*>(row_ptr),
                        static_cast<const int32_t*>(col),
                        static_cast<const float*>(w),
                        static_cast<const int32_t*>(w_index),
                        static_cast<const T*>(x),
                        static_cast<T*>(out),
                        static_cast<float*>(part),
                        static_cast<int32_t*>(part_row),
                        n_rows, n_edges, F, H,
                        static_cast<cudaStream_t>(stream)};
  return vec ? launch_csr_reduce_v<T, true, Op>(a) : launch_csr_reduce_v<T, false, Op>(a);
}

}  // namespace gnn
