// GATv2's attention score (Brody, Alon and Yahav, "How Attentive are Graph
// Attention Networks?", ICLR 2022), forward and backward, float32:
//   z[e, h, :] = h_dst[dst[e], h, :] + h_src[src[e], h, :]
//   s[e, h]    = sum_f att[h, f] * LeakyReLU(z[e, h, f])
// over the E edges of an adjacency in its dst-sorted order; h_src [N_src, H,
// F], h_dst [N_dst, H, F], att [H, F], s [E, H]. From the cotangent ds [E, H]
// the backward recomputes z edge by edge and gives
//   dh_dst[i] = sum over the in-edges e of i of dz[e]   (by destination)
//   dh_src[j] = sum over the out-edges e of j of dz[e]  (by source)
//   datt[h, f] = sum_e ds[e, h] * LeakyReLU(z[e, h, f])
// with dz[e, h, f] = ds[e, h] * att[h, f] * (z > 0 ? 1 : slope). No [E, H, F]
// array is written, forward or backward: only s, or dh_src, dh_dst, datt and
// their scratch.
//
// Replaces no Pallas kernel: the JAX package has no GATv2. Written plainly
// in torch the score materialises [E, H, F] float32 arrays for the two
// gathers, the sum and the LeakyReLU's mask, 634 MB each at ogbn-arxiv scale
// and (H, F) = (8, 8), the pattern of GAT's old SDDMM (8.6 ms a step).
//
// What bounds it on an H100: bytes. Forward, each input and output once
// (h_src, h_dst, att, src, dst, s) is 186 MB at ogbn-arxiv scale (169,343
// nodes, 2,478,219 edges with self loops) and (8, 8), 0.056 ms at 3.35 TB/s;
// 84 MB at (1, 40), 0.025 ms. With no reuse of a gathered h_src row (the
// h_dst row is the same for the consecutive edges of a destination) the
// E * H * F gathered values make it 777 MB, 0.232 ms, and 453 MB, 0.135 ms.
// Backward, each input and output once (ds, h_src, h_dst, att, row_ptr, src,
// t_row_ptr, t_perm, t_col; dh_src, dh_dst, datt) is 284 MB at (8, 8),
// 0.085 ms, and 149 MB at (1, 40), 0.045 ms; each pass gathers the other
// side's row per edge and the pass by source reads ds again, so with no
// reuse 1.55 GB, 0.461 ms, and 0.90 GB, 0.268 ms. Four to eight flops per
// 4 bytes gathered: no tensor cores.
//
// Design. The forward is the SDDMM's (gat_sddmm.cu): the E * H (edge, head)
// pairs in order, p = e * H + h, a group of min(32, next_pow2(ceil(F / 4)))
// lanes a pair on the vector path (F % 4 == 0, 16-byte loads), two pairs a
// thread with all their loads issued before the first add, and the group's
// partials summed by a __shfl_xor_sync butterfly in a fixed order. The walk
// is by edge in dst order, so consecutive edges read the same h_dst row, and
// the 21,305-edge hub needs no care.
//
// The backward is two passes of csr_reduce.cuh's merge-path tiles, over rows
// of W = H * F features (a lane's four features lie in one head on the vector
// path, F % 4 == 0): by destination over (row_ptr, src), where the edge's
// cotangent is ds[k], and by source over the transpose (t_row_ptr, t_col),
// where it is ds[t_perm[k]], the order K1's gather VJP walks. A warp keeps
// its row's own features (h_dst[i], or h_src[j]) in registers, gathers the
// other side's row per edge, recomputes z and sums dz; rows cut by a warp
// boundary leave partials that csr_reduce_fixup sums in warp order, as for
// K1-K3. The pass by destination also sums ds * LeakyReLU(z) per warp into a
// [tiles, W] scratch, which gatv2_score_datt_kernel reduces over the tiles in
// a fixed tree: two deterministic stages, no atomics, the same bits on every
// call. The hub spans 84 warps in either pass.

#include "csr_reduce.cuh"

namespace gnn {

constexpr int kScoreSteps = 2;  // block steps of pairs a thread takes in the forward
constexpr int kDattRows = 32;   // rows of threads of the datt reduction

// The two passes of the backward; a profile shows them in the kernels' names.
struct gatv2_score_by_dst {
  static constexpr bool kDst = true;
};
struct gatv2_score_by_src {
  static constexpr bool kDst = false;
};

__device__ __forceinline__ float leaky(float z, float slope) { return z > 0.f ? z : z * slope; }

// acc + sum over the lane's features of a * LeakyReLU(d + s)
template <bool kVec>
__device__ __forceinline__ float score_feat(float4 a, float4 d, float4 s, float slope, float acc) {
  acc = fmaf(a.x, leaky(d.x + s.x, slope), acc);
  if (kVec) {
    acc = fmaf(a.y, leaky(d.y + s.y, slope), acc);
    acc = fmaf(a.z, leaky(d.z + s.z, slope), acc);
    acc = fmaf(a.w, leaky(d.w + s.w, slope), acc);
  }
  return acc;
}

template <bool kVec, int kL>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gatv2_score_kernel(const int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                   const float* __restrict__ h_src, const float* __restrict__ h_dst,
                   const float* __restrict__ att, float* __restrict__ s, int n_pairs, int H,
                   int F, float slope) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kPairs = kWarp * kWarpsPerBlock / kL;  // pairs of one block step
  const int slot = threadIdx.x / kL;
  const int f_lane = (threadIdx.x % kL) * kPer;
  const int64_t row = static_cast<int64_t>(H) * F;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPairs * kScoreSteps + slot;
  const float* dp[kScoreSteps];
  const float* sp[kScoreSteps];
  const float* ap[kScoreSteps];
#pragma unroll
  for (int u = 0; u < kScoreSteps; ++u) {
    // a pair past the end rereads the last one and is not stored
    const int64_t pu = p0 + u * kPairs;
    const int p = pu < n_pairs ? static_cast<int>(pu) : n_pairs - 1;
    const int e = p / H;
    const int head = (p - e * H) * F;
    dp[u] = h_dst + __ldg(dst + e) * row + head;
    sp[u] = h_src + __ldg(src + e) * row + head;
    ap[u] = att + head;
  }
  float acc[kScoreSteps];
#pragma unroll
  for (int u = 0; u < kScoreSteps; ++u) acc[u] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kL * kPer) {
    const int f = f0 + f_lane;
    const bool active = f < F;
    const int fl = active ? f : 0;  // idle lanes read a valid address
    float4 a[kScoreSteps], d[kScoreSteps], v[kScoreSteps];
#pragma unroll
    for (int u = 0; u < kScoreSteps; ++u) {
      a[u] = load_feat<kVec>(ap[u] + fl);
      d[u] = load_feat<kVec>(dp[u] + fl);
      v[u] = load_feat<kVec>(sp[u] + fl);
    }
#pragma unroll
    for (int u = 0; u < kScoreSteps; ++u) {
      if (active) acc[u] = score_feat<kVec>(a[u], d[u], v[u], slope, acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kScoreSteps; ++u) {
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) acc[u] += __shfl_xor_sync(kFullMask, acc[u], off);
  }
  if (threadIdx.x % kL == 0) {
#pragma unroll
    for (int u = 0; u < kScoreSteps; ++u) {
      const int64_t p = p0 + u * kPairs;
      if (p < n_pairs) s[p] = acc[u];
    }
  }
}

// dz of one feature added to acc; by destination also ds * LeakyReLU(z) to
// datt. c = ds * att.
template <bool kDst>
__device__ __forceinline__ void dz_feat(float r, float v, float c, float g, float slope,
                                        float& acc, float& datt) {
  const float z = r + v;
  acc += z > 0.f ? c : c * slope;
  if (kDst) datt = fmaf(g, leaky(z, slope), datt);
}

// One CTA per kTileItems merge items of the pass's CSR, one warp per
// kWarpItems of them, as csr_reduce_kernel. By destination: rows row_ptr,
// col = src, the edge's cotangent row k; h_row = h_dst, h_col = h_src. By
// source: rows t_row_ptr, col = t_col, the cotangent row t_perm[k]; h_row =
// h_src, h_col = h_dst. part / part_row: the rows cut by a warp boundary;
// datt_part (by destination): float32 [tiles, W], each warp's sum.
template <bool kVec, int kG, typename Side>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gatv2_score_bwd_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                       const int32_t* __restrict__ eid, const float* __restrict__ ds,
                       const float* __restrict__ h_row, const float* __restrict__ h_col,
                       const float* __restrict__ att, float* __restrict__ out,
                       float* __restrict__ part, int32_t* __restrict__ part_row,
                       float* __restrict__ datt_part, int n_rows, int n_edges, int W, int H, int F,
                       float slope) {
  constexpr bool kDst = Side::kDst;
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kGroups = kWarp / kG;
  // warp steps in flight: 8 edges a warp at kG = 32, four steps for groups
  // of 8 lanes or fewer (with two, ptxas spilled the pass by source)
  constexpr int kU = kGroups >= 4 ? 4 : 8 / kGroups;
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
  int32_t* eid_s = col_s + kTileItems;  // by source: t_perm
  for (int t = threadIdx.x; t <= i1c - i0c; t += blockDim.x) {
    cp_async4(rp_s + t, row_ptr + i0c + t);
  }
  for (int t = threadIdx.x; t < j1c - j0c; t += blockDim.x) {
    cp_async4(col_s + t, col + j0c + t);
    if (!kDst) cp_async4(eid_s + t, eid + j0c + t);
  }
  cp_async_wait_all();
  __syncthreads();

  const int dw0 = min(d0 + warp * kWarpItems, d1);
  const int dw1 = min(dw0 + kWarpItems, d1);
  const int i0 = merge_path_row(rp_s, i0c, max(i0c, dw0 - n_edges), min(i1c, dw0), dw0, lane);
  const int i1 = merge_path_row(rp_s, i0c, max(i0c, dw1 - n_edges), min(i1c, dw1), dw1, lane);
  const int j0 = dw0 - i0, j1 = dw1 - i1;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int q = lane / kG;
  const int f_lane = (lane % kG) * kPer;
  int head_row = -1, tail_row = -1;
  for (int f0 = 0; f0 < W; f0 += kG * kPer) {
    const int f = f0 + f_lane;
    const bool active = f < W;
    const int fl = active ? f : 0;  // idle lanes read a valid address
    const int head = fl / F;
    const float4 a = load_feat<kVec>(att + fl);
    float4 datt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dw0 < dw1) {
      for (int r = i0; r <= i1 && r < n_rows; ++r) {
        const int rb = rp_s[r - i0c];
        const int e = r < i1 ? rp_s[r + 1 - i0c] : j1;
        float* pdst = nullptr;
        if (r == i1) {
          tail_row = r;
          pdst = part + (2 * tile + 1) * W;
        } else if (r == i0 && rb < j0) {
          head_row = r;
          pdst = part + 2 * tile * W;
        }
        const float4 hr = load_feat<kVec>(h_row + static_cast<int64_t>(r) * W + fl);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int base = max(rb, j0); base < e; base += kGroups * kU) {
          float4 v[kU];
          float g[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int k = min(base + u * kGroups + q, e - 1);
            const int ek = kDst ? k : eid_s[k - j0c];
            g[u] = __ldg(ds + static_cast<int64_t>(ek) * H + head);
            v[u] = load_feat<kVec>(h_col + static_cast<int64_t>(col_s[k - j0c]) * W + fl);
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (base + u * kGroups + q < e) {
              dz_feat<kDst>(hr.x, v[u].x, g[u] * a.x, g[u], slope, acc.x, datt.x);
              if (kVec) {
                dz_feat<kDst>(hr.y, v[u].y, g[u] * a.y, g[u], slope, acc.y, datt.y);
                dz_feat<kDst>(hr.z, v[u].z, g[u] * a.z, g[u], slope, acc.z, datt.z);
                dz_feat<kDst>(hr.w, v[u].w, g[u] * a.w, g[u], slope, acc.w, datt.w);
              }
            }
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
          store_feat<kVec>(pdst ? pdst + f : out + static_cast<int64_t>(r) * W + f, acc);
        }
      }
    }
    if (kDst) {
#pragma unroll
      for (int off = kG; off < kWarp; off <<= 1) {
        datt.x += __shfl_xor_sync(kFullMask, datt.x, off);
        if (kVec) {
          datt.y += __shfl_xor_sync(kFullMask, datt.y, off);
          datt.z += __shfl_xor_sync(kFullMask, datt.z, off);
          datt.w += __shfl_xor_sync(kFullMask, datt.w, off);
        }
      }
      if (q == 0 && active) store_feat<kVec>(datt_part + tile * W + f, datt);
    }
    if (kG < kWarp) break;
  }
  if (lane == 0) {
    part_row[2 * tile] = head_row;
    part_row[2 * tile + 1] = tail_row;
  }
}

// datt[c] = sum over the tiles of datt_part[t, c]: thread (y, x) of a block
// sums the tiles y, y + kDattRows, ... of column 32 * blockIdx.x + x in
// order, and row 0 adds the kDattRows sums in order.
__global__ void __launch_bounds__(kWarp * kDattRows)
gatv2_score_datt_kernel(const float* __restrict__ datt_part, float* __restrict__ datt,
                        int n_tiles, int W) {
  __shared__ float sums[kDattRows][kWarp + 1];
  const int x = threadIdx.x % kWarp, y = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarp + x;
  float acc = 0.f;
  if (c < W) {
    for (int t = y; t < n_tiles; t += kDattRows) acc += datt_part[static_cast<int64_t>(t) * W + c];
  }
  sums[y][x] = acc;
  __syncthreads();
  if (y == 0 && c < W) {
    float total = 0.f;
    for (int r = 0; r < kDattRows; ++r) total += sums[r][x];
    datt[c] = total;
  }
}

template <bool kVec, int kL>
int launch_gatv2_score_l(const int32_t* dst, const int32_t* src, const float* h_src,
                         const float* h_dst, const float* att, float* s, int n_pairs, int H,
                         int F, float slope, cudaStream_t stream) {
  constexpr int64_t kPerBlock = static_cast<int64_t>(kWarp * kWarpsPerBlock / kL) * kScoreSteps;
  const dim3 grid(static_cast<unsigned>((n_pairs + kPerBlock - 1) / kPerBlock));
  gatv2_score_kernel<kVec, kL><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
      dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_gatv2_score_v(const int32_t* dst, const int32_t* src, const float* h_src,
                         const float* h_dst, const float* att, float* s, int n_pairs, int H,
                         int F, float slope, cudaStream_t stream) {
  // one head's F features take the place of a row's: the same lane groups
  switch (lanes_per_edge(F, kVec)) {
    case 1:
      return launch_gatv2_score_l<kVec, 1>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
    case 2:
      return launch_gatv2_score_l<kVec, 2>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
    case 4:
      return launch_gatv2_score_l<kVec, 4>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
    case 8:
      return launch_gatv2_score_l<kVec, 8>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
    case 16:
      return launch_gatv2_score_l<kVec, 16>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
    default:
      return launch_gatv2_score_l<kVec, 32>(dst, src, h_src, h_dst, att, s, n_pairs, H, F, slope, stream);
  }
}

// The arguments of one pass of the backward.
struct BwdPass {
  const int32_t* row_ptr;
  const int32_t* col;
  const int32_t* eid;
  const float* h_row;
  const float* h_col;
  float* out;
  int n_rows;
};

template <bool kVec, int kG, typename Side>
int launch_gatv2_bwd_pass_g(const BwdPass& p, const float* ds, const float* att, float* part,
                            int32_t* part_row, float* datt_part, int n_edges, int H, int F,
                            float slope, cudaStream_t stream) {
  const int n_tiles = csr_reduce_tiles(p.n_rows, n_edges);
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int W = H * F;
  const dim3 grid(n_tiles / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  const size_t smem = sizeof(int32_t) * (kTileItems + 1 + (Side::kDst ? 1 : 2) * kTileItems);
  gatv2_score_bwd_kernel<kVec, kG, Side><<<grid, block, smem, stream>>>(
      p.row_ptr, p.col, p.eid, ds, p.h_row, p.h_col, att, p.out, part, part_row, datt_part,
      p.n_rows, n_edges, W, H, F, slope);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_reduce_fixup<float, kVec, Side><<<grid, block, 0, stream>>>(part, part_row, p.out, n_tiles, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, typename Side>
int launch_gatv2_bwd_pass(const BwdPass& p, const float* ds, const float* att, float* part,
                          int32_t* part_row, float* datt_part, int n_edges, int H, int F,
                          float slope, cudaStream_t stream) {
  switch (lanes_per_edge(H * F, kVec)) {
    case 1:
      return launch_gatv2_bwd_pass_g<kVec, 1, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
    case 2:
      return launch_gatv2_bwd_pass_g<kVec, 2, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
    case 4:
      return launch_gatv2_bwd_pass_g<kVec, 4, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
    case 8:
      return launch_gatv2_bwd_pass_g<kVec, 8, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
    case 16:
      return launch_gatv2_bwd_pass_g<kVec, 16, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
    default:
      return launch_gatv2_bwd_pass_g<kVec, 32, Side>(p, ds, att, part, part_row, datt_part, n_edges, H, F, slope, stream);
  }
}

template <bool kVec>
int launch_gatv2_score_bwd_v(const BwdPass& by_dst, const BwdPass& by_src, const float* ds,
                             const float* att, float* datt, float* part, int32_t* part_row,
                             float* datt_part, int n_edges, int H, int F, float slope,
                             cudaStream_t stream) {
  int rc = launch_gatv2_bwd_pass<kVec, gatv2_score_by_dst>(by_dst, ds, att, part, part_row,
                                                           datt_part, n_edges, H, F, slope, stream);
  if (rc != 0) return rc;
  // the second pass reuses the first's scratch after it on the stream
  rc = launch_gatv2_bwd_pass<kVec, gatv2_score_by_src>(by_src, ds, att, part, part_row, nullptr,
                                                       n_edges, H, F, slope, stream);
  if (rc != 0) return rc;
  const int W = H * F;
  gatv2_score_datt_kernel<<<(W + kWarp - 1) / kWarp, kWarp * kDattRows, 0, stream>>>(
      datt_part, datt, csr_reduce_tiles(by_dst.n_rows, n_edges), W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnn

extern "C" {

// Enqueues the forward on `stream`; returns cudaGetLastError(). dst, src:
// int32 [n_edges]; h_src [N_src, H, F], h_dst [N_dst, H, F], att [H, F]
// contiguous float32; s: float32 [n_edges, H]. vec needs F % 4 == 0 and
// h_src, h_dst, att on 16-byte boundaries. E * H must fit int32.
int gnn_gatv2_score_f32(const void* dst, const void* src, const void* h_src, const void* h_dst,
                        const void* att, void* s, int n_edges, int H, int F, float slope, int vec,
                        void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(n_edges) * H;
  if (n_edges < 0 || H < 1 || F < 1 || n_pairs > INT32_MAX || (vec && F % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs == 0) return static_cast<int>(cudaSuccess);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* hs = static_cast<const float*>(h_src);
  const auto* hd = static_cast<const float*>(h_dst);
  const auto* a = static_cast<const float*>(att);
  auto* out = static_cast<float*>(s);
  auto st = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(n_pairs);
  return vec ? gnn::launch_gatv2_score_v<true>(d, sr, hs, hd, a, out, p, H, F, slope, st)
             : gnn::launch_gatv2_score_v<false>(d, sr, hs, hd, a, out, p, H, F, slope, st);
}

// Enqueues the backward's five launches on `stream` (each pass and its
// fixup, then the datt reduction); returns cudaGetLastError(). row_ptr
// [n_dst + 1] and src [n_edges] are the dst-sorted CSR, t_row_ptr [n_src + 1],
// t_perm and t_col [n_edges] its transpose; ds [n_edges, H], h_src, h_dst,
// att as the forward's; dh_src, dh_dst, datt outputs of their shapes. part /
// part_row: scratch of max(gnn_csr_reduce_tiles(n_dst, n_edges),
// gnn_csr_reduce_tiles(n_src, n_edges)) tiles at width H * F; datt_part:
// float32 [gnn_csr_reduce_tiles(n_dst, n_edges), H * F]. vec needs F % 4 == 0
// and every feature array on 16-byte boundaries.
int gnn_gatv2_score_bwd_f32(const void* row_ptr, const void* src, const void* t_row_ptr,
                            const void* t_perm, const void* t_col, const void* ds,
                            const void* h_src, const void* h_dst, const void* att, void* dh_src,
                            void* dh_dst, void* datt, void* part, void* part_row, void* datt_part,
                            int n_dst, int n_src, int n_edges, int H, int F, float slope, int vec,
                            void* stream) {
  if (n_dst < 0 || n_src < 0 || n_edges < 0 || H < 1 || F < 1 ||
      static_cast<int64_t>(H) * F > INT32_MAX / 4 || (vec && F % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* hs = static_cast<const float*>(h_src);
  const auto* hd = static_cast<const float*>(h_dst);
  const gnn::BwdPass by_dst{static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(src),
                            nullptr, hd, hs, static_cast<float*>(dh_dst), n_dst};
  const gnn::BwdPass by_src{static_cast<const int32_t*>(t_row_ptr),
                            static_cast<const int32_t*>(t_col), static_cast<const int32_t*>(t_perm),
                            hs, hd, static_cast<float*>(dh_src), n_src};
  const auto* g = static_cast<const float*>(ds);
  const auto* a = static_cast<const float*>(att);
  auto* dt = static_cast<float*>(datt);
  auto* pt = static_cast<float*>(part);
  auto* pr = static_cast<int32_t*>(part_row);
  auto* dp = static_cast<float*>(datt_part);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? gnn::launch_gatv2_score_bwd_v<true>(by_dst, by_src, g, a, dt, pt, pr, dp, n_edges, H, F, slope, st)
             : gnn::launch_gatv2_score_bwd_v<false>(by_dst, by_src, g, a, dt, pt, pr, dp, n_edges, H, F, slope, st);
}

}  // extern "C"
