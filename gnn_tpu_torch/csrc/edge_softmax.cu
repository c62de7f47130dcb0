// The softmax of attention scores by destination, as GAT and GATv2 take it,
// forward and backward, float32. Over the E edges of an adjacency in its
// dst-sorted order, e [E, H] the scores and row(k) the destination of edge k:
//   m[n, h]   = max over the in-edges k of n of e[k, h]   (0 where n has none)
//   ex[k, h]  = exp(e[k, h] - m[row(k), h])
//   den[n, h] = max(sum over the in-edges k of n of ex[k, h], 1e-16)
// and, with m held constant, from the cotangents g_ex [E, H] and g_den [N, H]:
//   de[k, h]  = ex[k, h] * (g_ex[k, h] + g_den[row(k), h]).
// The rest of the attention (dropout of ex, the numerator on K3, num / den)
// stays with the caller.
//
// Replaces no Pallas kernel: the JAX package leaves the softmax to XLA
// (gnn_tpu/mp/gat.py: segment_max, the shift's gather, exp and the
// denominator's segment sum). The port ran those as a scatter-max, a
// [N, H] -> [E, H] index_select by an int64 index for the shift (1.50 ms a
// call at ogbn-arxiv scale and H = 8 on an H100), the subtract and exp, K2
// for the denominator and a clamp; backward a second such index_select for
// the denominator's VJP, an add and exp's VJP: about ten launches and two
// gathers where each destination's in-edges are one contiguous run of e.
//
// What bounds it on an H100: bytes. Forward e, ex, den and row_ptr, each
// once, are 165 MB at ogbn-arxiv scale (169,343 nodes, 2,478,219 edges with
// self loops) and H = 8, 0.049 ms at 3.35 TB/s; 21 MB at H = 1. Backward ex,
// g_ex, de, g_den and the rows of the edges are 249 MB and 0.074 ms at H = 8.
// A few flops a value (a max, a subtract, an exp, an add): no tensor cores.
//
// Design. The forward walks csr_reduce.cuh's merge-path tiles (256 row ends
// + edges a warp), so the 21,305-edge hub spans 84 warps and no warp follows
// it alone. Lane groups over the heads are sized as K2's over a row of H
// features: min(32, next_pow2(ceil(H / 4))) lanes an edge on the vector path
// (H % 4 == 0, 16-byte loads), so 16 edges a warp step at H = 8 and 32 at
// H = 1. A warp takes each of its rows twice, both times from the same
// bytes: the max (exact in any order), then exp(e - m) and its sum, summed
// in a fixed order and combined across the lane groups by a
// __shfl_xor_sync butterfly. A row that lies wholly in the warp writes ex
// and den at once, with its final m: the max is read once a row segment,
// never once an edge, and nothing is gathered. A row cut by a warp boundary
// leaves its segment's (max, sum of exp(e - max)) in a scratch slot of the
// warp's head or tail, and its segment's edge range; a second launch
// (edge_softmax_fixup) gives every warp with such a slot the row's run of
// slots in warp order, which it combines as (M = max m_i, S = sum s_i
// exp(m_i - M)) in that order: each warp of the run obtains the same M and
// S, writes ex over its own segment with M, and the warp that holds the
// row's end writes den. No atomics: the same bits on every call.
//
// The backward is elementwise over the E * H values, four heads a thread on
// the vector path; a value's g_den is read through the int32 row of its
// edge, and the [N, H] g_den (5.4 MB at H = 8) sits in L2. One launch.
//
// exp is expf: no __expf, no fast-math flags.

#include <math_constants.h>

#include "csr_reduce.cuh"

namespace gnn {

constexpr float kDenMin = 1e-16f;

// the shift of a row whose max is m: 0 where the row has no finite max
__device__ __forceinline__ float shift_of(float m) { return isfinite(m) ? m : 0.f; }

template <bool kVec>
__device__ __forceinline__ void max_into(float4& m, float4 v) {
  m.x = fmaxf(m.x, v.x);
  if (kVec) {
    m.y = fmaxf(m.y, v.y);
    m.z = fmaxf(m.z, v.z);
    m.w = fmaxf(m.w, v.w);
  }
}

template <bool kVec>
__device__ __forceinline__ float4 shift4(float4 m) {
  return make_float4(shift_of(m.x), kVec ? shift_of(m.y) : 0.f, kVec ? shift_of(m.z) : 0.f,
                     kVec ? shift_of(m.w) : 0.f);
}

template <bool kVec>
__device__ __forceinline__ float4 exp_shifted(float4 v, float4 s) {
  return make_float4(expf(v.x - s.x), kVec ? expf(v.y - s.y) : 0.f, kVec ? expf(v.z - s.z) : 0.f,
                     kVec ? expf(v.w - s.w) : 0.f);
}

template <bool kVec>
__device__ __forceinline__ void add_into(float4& a, float4 v) {
  a.x += v.x;
  if (kVec) {
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
}

template <bool kVec>
__device__ __forceinline__ float4 clamp_den(float4 s) {
  return make_float4(fmaxf(s.x, kDenMin), fmaxf(s.y, kDenMin), fmaxf(s.z, kDenMin),
                     fmaxf(s.w, kDenMin));
}

// One segment's sum s, taken with the shift of its own max m, moved to the
// row's shift; a segment with no edge adds nothing.
__device__ __forceinline__ float rescaled(float m, float s, float shift) {
  return s == 0.f ? 0.f : s * expf(shift_of(m) - shift);
}

template <bool kVec>
__device__ __forceinline__ void add_rescaled(float4& a, float4 m, float4 s, float4 shift) {
  a.x += rescaled(m.x, s.x, shift.x);
  if (kVec) {
    a.y += rescaled(m.y, s.y, shift.y);
    a.z += rescaled(m.z, s.z, shift.z);
    a.w += rescaled(m.w, s.w, shift.w);
  }
}

// Across the lane groups of a warp (lanes kG apart hold the same heads).
template <bool kVec, int kG>
__device__ __forceinline__ void warp_max(float4& m) {
#pragma unroll
  for (int off = kG; off < kWarp; off <<= 1) {
    m.x = fmaxf(m.x, __shfl_xor_sync(kFullMask, m.x, off));
    if (kVec) {
      m.y = fmaxf(m.y, __shfl_xor_sync(kFullMask, m.y, off));
      m.z = fmaxf(m.z, __shfl_xor_sync(kFullMask, m.z, off));
      m.w = fmaxf(m.w, __shfl_xor_sync(kFullMask, m.w, off));
    }
  }
}

template <bool kVec, int kG>
__device__ __forceinline__ void warp_sum(float4& a) {
#pragma unroll
  for (int off = kG; off < kWarp; off <<= 1) {
    a.x += __shfl_xor_sync(kFullMask, a.x, off);
    if (kVec) {
      a.y += __shfl_xor_sync(kFullMask, a.y, off);
      a.z += __shfl_xor_sync(kFullMask, a.z, off);
      a.w += __shfl_xor_sync(kFullMask, a.w, off);
    }
  }
}

// Warp steps in flight: two at 4 or more edges a warp step, as K2's.
template <int kG>
__host__ __device__ constexpr int steps_in_flight() {
  return kWarp / kG >= 4 ? 2 : 8 / (kWarp / kG);
}

// exp(e[k, f..] - shift) over the edges [b, end) of one row that lane group
// q takes, stored to ex[k, f..] where kStore; returns the group's sum of them.
template <bool kVec, int kG, bool kStore>
__device__ __forceinline__ float4 exp_row(const float* __restrict__ e, float* __restrict__ ex,
                                          int b, int end, int H, int f, bool active, int q,
                                          float4 shift) {
  constexpr int kGroups = kWarp / kG;
  constexpr int kU = steps_in_flight<kG>();
  const int fl = active ? f : 0;  // idle lanes read a valid address
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = b; base < end; base += kGroups * kU) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = min(base + u * kGroups + q, end - 1);
      v[u] = load_feat<kVec>(e + static_cast<int64_t>(k) * H + fl);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = base + u * kGroups + q;
      if (k < end) {
        const float4 x = exp_shifted<kVec>(v[u], shift);
        add_into<kVec>(acc, x);
        if (kStore && active) store_feat<kVec>(ex + static_cast<int64_t>(k) * H + f, x);
      }
    }
  }
  return acc;
}

// One CTA per kTileItems merge items of the by-destination CSR, one warp
// per kWarpItems of them, as csr_reduce_kernel. part: two slots a warp
// (head, tail) of 2 H floats, the segment's max then its sum; part_row their
// rows (-1: none); part_seg their edge ranges [begin, end).
template <bool kVec, int kG>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
edge_softmax_kernel(const int32_t* __restrict__ row_ptr, const float* __restrict__ e,
                    float* __restrict__ ex, float* __restrict__ den, float* __restrict__ part,
                    int32_t* __restrict__ part_row, int32_t* __restrict__ part_seg, int n_rows,
                    int n_edges, int H) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kGroups = kWarp / kG;
  constexpr int kU = steps_in_flight<kG>();
  __shared__ int32_t rp_s[kTileItems + 1];  // row_ptr[i0c .. i1c]
  __shared__ int cta_row[2];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const CtaItems c = cta_items(row_ptr, rp_s, cta_row, n_rows, n_edges, warp, lane);
  cp_async_wait_all();
  __syncthreads();

  const WarpItems items = warp_items(rp_s, c, n_edges, warp, lane);
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int q = lane / kG;
  const int f_lane = (lane % kG) * kPer;
  int head_row = -1, tail_row = -1;
  int head_b = 0, head_e = 0, tail_b = 0, tail_e = 0;
  for_each_row(rp_s, c.i0c, items, n_rows, [&](int r, int b, int end, int side) {
    if (side == kTail) {
      tail_row = r, tail_b = b, tail_e = end;
    } else if (side == kHead) {
      head_row = r, head_b = b, head_e = end;
    }
    for (int f0 = 0; f0 < H; f0 += kG * kPer) {
      const int f = f0 + f_lane;
      const bool active = f < H;
      const int fl = active ? f : 0;
      float4 m = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      for (int base = b; base < end; base += kGroups * kU) {
        float4 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          // a slot past the row's end rereads its last edge: no other max
          const int k = min(base + u * kGroups + q, end - 1);
          v[u] = load_feat<kVec>(e + static_cast<int64_t>(k) * H + fl);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) max_into<kVec>(m, v[u]);
      }
      warp_max<kVec, kG>(m);
      float4 s;
      if (side == kWhole) {
        s = exp_row<kVec, kG, true>(e, ex, b, end, H, f, active, q, shift4<kVec>(m));
      } else {
        s = exp_row<kVec, kG, false>(e, ex, b, end, H, f, active, q, shift4<kVec>(m));
      }
      warp_sum<kVec, kG>(s);
      if (q == 0 && active) {
        if (side == kWhole) {
          store_feat<kVec>(den + static_cast<int64_t>(r) * H + f, clamp_den<kVec>(s));
        } else {
          float* slot = part + (2 * tile + side) * 2 * H;
          store_feat<kVec>(slot + f, m);
          store_feat<kVec>(slot + H + f, s);
        }
      }
      if (kG < kWarp) break;
    }
  });
  if (lane == 0) {
    part_row[2 * tile] = head_row;
    part_row[2 * tile + 1] = tail_row;
    part_seg[4 * tile] = head_b;
    part_seg[4 * tile + 1] = head_e;
    part_seg[4 * tile + 2] = tail_b;
    part_seg[4 * tile + 3] = tail_e;
  }
}

// The warp tile at or after t + 1 that holds row r's end as its head; -1 if
// none does.
__device__ __forceinline__ int head_tile(const int32_t* __restrict__ part_row, int r, int t,
                                         int n_tiles, int lane) {
  for (int u0 = t + 1; u0 < n_tiles; u0 += kWarp) {
    const int u = u0 + lane;
    const unsigned hit = __ballot_sync(kFullMask, u < n_tiles && part_row[2 * u] == r);
    if (hit) return u0 + __ffs(hit) - 1;
  }
  return -1;
}

// One warp per warp tile of edge_softmax_kernel. For each of the tile's cut
// rows (head, then tail) with its run of slots s .. h (tails s .. h - 1, the
// head h): M and S in warp order, den[r] from the head tile, and ex over the
// tile's own segment of the row.
template <bool kVec, int kG>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
edge_softmax_fixup(const float* __restrict__ e, float* __restrict__ ex, float* __restrict__ den,
                   const float* __restrict__ part, const int32_t* __restrict__ part_row,
                   const int32_t* __restrict__ part_seg, int n_tiles, int H) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kGroups = kWarp / kG;
  const int t = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= n_tiles) return;
  const int q = lane / kG;
  const int f_lane = (lane % kG) * kPer;
  for (int side = kHead; side <= kTail; ++side) {
    const int r = part_row[2 * t + side];
    const int k0 = part_seg[4 * t + 2 * side], k1 = part_seg[4 * t + 2 * side + 1];
    // a tail that holds no edge of its row has nothing to write
    if (r < 0 || (side == kTail && k0 >= k1)) continue;
    const int h = side == kHead ? t : head_tile(part_row, r, t, n_tiles, lane);
    if (h < 0) continue;
    const int s = run_start(part_row, r, h, lane);
    for (int f0 = 0; f0 < H; f0 += kG * kPer) {
      const int f = f0 + f_lane;
      const bool active = f < H;
      const int fl = active ? f : 0;
      const auto slot = [&](int u, int which) {  // which 0: the segment's max, 1: its sum
        const int64_t at = (2 * static_cast<int64_t>(u) + (u == h ? 0 : 1)) * 2 * H;
        return load_feat<kVec>(part + at + which * H + fl);
      };
      // the lane groups take the run's slots in turns and meet in a butterfly:
      // every warp of the run takes them in the same order and gets the same bits
      float4 m = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      for (int u = s + q; u <= h; u += kGroups) max_into<kVec>(m, slot(u, 0));
      warp_max<kVec, kG>(m);
      const float4 shift = shift4<kVec>(m);
      if (side == kHead) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int u = s + q; u <= h; u += kGroups) add_rescaled<kVec>(sum, slot(u, 0), slot(u, 1), shift);
        warp_sum<kVec, kG>(sum);
        if (q == 0 && active) store_feat<kVec>(den + static_cast<int64_t>(r) * H + f, clamp_den<kVec>(sum));
      }
      exp_row<kVec, kG, true>(e, ex, k0, k1, H, f, active, q, shift);
      if (kG < kWarp) break;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
edge_softmax_bwd_kernel(const int32_t* __restrict__ dst, const float* __restrict__ ex,
                        const float* __restrict__ g_ex, const float* __restrict__ g_den,
                        float* __restrict__ de, int n_items, int H) {
  constexpr int kPer = kVec ? 4 : 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int at = i * kPer;
  const int k = at / H;
  const int h = at - k * H;
  float4 g = load_feat<kVec>(g_ex + at);
  add_into<kVec>(g, load_feat<kVec>(g_den + static_cast<int64_t>(__ldg(dst + k)) * H + h));
  const float4 x = load_feat<kVec>(ex + at);
  store_feat<kVec>(de + at, make_float4(g.x * x.x, g.y * x.y, g.z * x.z, g.w * x.w));
}

template <bool kVec, int kG>
int launch_edge_softmax_g(const int32_t* row_ptr, const float* e, float* ex, float* den,
                          float* part, int32_t* part_row, int32_t* part_seg, int n_rows,
                          int n_edges, int H, cudaStream_t stream) {
  const int n_tiles = csr_reduce_tiles(n_rows, n_edges);
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  edge_softmax_kernel<kVec, kG><<<grid, block, 0, stream>>>(row_ptr, e, ex, den, part, part_row,
                                                            part_seg, n_rows, n_edges, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_softmax_fixup<kVec, kG><<<grid, block, 0, stream>>>(e, ex, den, part, part_row, part_seg,
                                                           n_tiles, H);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_edge_softmax_v(const int32_t* row_ptr, const float* e, float* ex, float* den,
                          float* part, int32_t* part_row, int32_t* part_seg, int n_rows,
                          int n_edges, int H, cudaStream_t stream) {
  switch (lanes_per_edge(H, kVec)) {
    case 1:
      return launch_edge_softmax_g<kVec, 1>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
    case 2:
      return launch_edge_softmax_g<kVec, 2>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
    case 4:
      return launch_edge_softmax_g<kVec, 4>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
    case 8:
      return launch_edge_softmax_g<kVec, 8>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
    case 16:
      return launch_edge_softmax_g<kVec, 16>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
    default:
      return launch_edge_softmax_g<kVec, 32>(row_ptr, e, ex, den, part, part_row, part_seg, n_rows, n_edges, H, stream);
  }
}

}  // namespace gnn

extern "C" {

// Enqueues the forward's two launches (the tiles, then the cut rows) on
// `stream`; returns cudaGetLastError(). row_ptr: int32 [n_rows + 1] with
// row_ptr[n_rows] == n_edges; e, ex: float32 [n_edges, H]; den: float32
// [n_rows, H]; part: float32 [2 * tiles * 2 * H] and part_idx: int32
// [6 * tiles] scratch, tiles = gnn_csr_reduce_tiles(n_rows, n_edges). vec
// needs H % 4 == 0 and e, ex, den, part on 16-byte boundaries.
int gnn_edge_softmax_f32(const void* row_ptr, const void* e, void* ex, void* den, void* part,
                         void* part_idx, int n_rows, int n_edges, int H, int vec, void* stream) {
  if (n_rows < 0 || n_edges < 0 || H < 1 || (vec && H % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = gnn::csr_reduce_tiles(n_rows, n_edges);
  if (n_tiles < 0 || static_cast<int64_t>(n_edges) * H > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* x = static_cast<const float*>(e);
  auto* y = static_cast<float*>(ex);
  auto* d = static_cast<float*>(den);
  auto* pt = static_cast<float*>(part);
  auto* pr = static_cast<int32_t*>(part_idx);
  auto* ps = pr + 2 * static_cast<int64_t>(n_tiles);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? gnn::launch_edge_softmax_v<true>(rp, x, y, d, pt, pr, ps, n_rows, n_edges, H, st)
             : gnn::launch_edge_softmax_v<false>(rp, x, y, d, pt, pr, ps, n_rows, n_edges, H, st);
}

// Enqueues the backward's one launch on `stream`; returns cudaGetLastError().
// dst: int32 [n_edges], the row of each edge; ex, de: float32 [n_edges, H];
// g_ex [n_edges, H] and g_den [n_rows, H] float32.
// vec needs H % 4 == 0 and every float array on 16-byte boundaries.
int gnn_edge_softmax_bwd_f32(const void* dst, const void* ex, const void* g_ex, const void* g_den,
                             void* de, int n_edges, int H, int vec, void* stream) {
  const int64_t n_values = static_cast<int64_t>(n_edges) * H;
  if (n_edges < 0 || H < 1 || n_values > INT32_MAX || (vec && H % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_items = static_cast<int>(n_values / (vec ? 4 : 1));
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  const int per_block = gnn::kWarp * gnn::kWarpsPerBlock;
  const dim3 grid((n_items + per_block - 1) / per_block);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* x = static_cast<const float*>(ex);
  const auto* gx = static_cast<const float*>(g_ex);
  const auto* gd = static_cast<const float*>(g_den);
  auto* out = static_cast<float*>(de);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    gnn::edge_softmax_bwd_kernel<true><<<grid, per_block, 0, st>>>(d, x, gx, gd, out, n_items, H);
  } else {
    gnn::edge_softmax_bwd_kernel<false><<<grid, per_block, 0, st>>>(d, x, gx, gd, out, n_items, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
