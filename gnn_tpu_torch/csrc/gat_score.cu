// GAT's attention score, forward and backward, float32. Over the E edges of
// an adjacency in its dst-sorted order, with h [N, H, F] the messages,
// att_src and att_dst [H, F] the attention vectors and the destinations the
// first N_dst nodes:
//   a[n, h, 0] = sum_f att_src[h, f] h[n, h, f]   a[n, h, 1] = the same with att_dst
//   e[k, h]    = LeakyReLU(a[dst[k], h, 1] + a[src[k], h, 0])
// and from the cotangent de [E, H]:
//   ds[k, h]   = de[k, h] where that sum is > 0, else de[k, h] * slope
//   d_dst[n]   = sum of ds over the in-edges of n (K2 over row_ptr)
//   d_src[n]   = sum of ds over the out-edges of n (K1 over the transpose CSR, col = t_perm)
//   dh[n, h, f] = d_src[n, h] att_src[h, f] + d_dst[n, h] att_dst[h, f]
//   datt_src[h, f] = sum_n d_src[n, h] h[n, h, f]   datt_dst likewise with d_dst
// The backward recomputes a and the sum of the two node scores, so nothing
// of the score is kept from the forward but h. With round_src, a[src[k], h, 0] is
// rounded to bfloat16 before the add (the message dtype it rides the edges
// in).
//
// Replaces no Pallas kernel: the JAX package takes both node scores with
// einsums, gathers them to the edges with jnp.take, adds them and applies
// the LeakyReLU in XLA (gnn_tpu/mp/gat.py:160-170). The port ran those as a
// GEMM with a block-diagonal matrix built each step, two index_selects by
// int64 copies of the index arrays, an add and a LeakyReLU, about fifteen
// launches and autograd nodes a layer, whose host issue set the pace of a
// GAT step on an H100 (the device's share of a step is 4.6 ms).
//
// What bounds it on an H100: the host and the launches. Bytes: forward h
// once (43 MB at ogbn-arxiv scale, (H, F) = (8, 8)), src, dst and e once and
// a's two rows an edge from L2, about 0.07 ms at 3.35 TB/s; backward about
// twice that. A few flops a value. The forward is one C entry of two
// launches; the backward two, of five (the node scores again, the ds pass,
// K2 and K1 with their fixups) and three (dh, datt's partials and their
// sum), so that a and ds are freed before dh is allocated.
//
// Design. The node scores: a thread an (n, h), its F products summed in
// order. The edges: a thread an (edge, head) pair p = k * H + h, so a warp's
// reads of an edge's heads are one run of a's row and its stores one
// coalesced run; int32 indices read as they are. The by-node sums of ds
// take K2 and K1 (csr_reduce.cuh's merge-path tiles, so the 21,305-edge hub
// spans many warps). datt: a block a run of kDattNodes nodes, a thread a
// (c, h, f) summing its run in node order into a partial; then a block a
// (c, h, f) sums the partials in a fixed tree. No atomics: the same bits on
// every call.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" {
int gnn_segment_sum_f32(const void* row_ptr, const void* msg, void* out, void* part, void* part_row,
                        int n_rows, int n_edges, int F, int vec, void* stream);
int gnn_csr_spmm_f32(const void* row_ptr, const void* col, const void* w, const void* x, void* out,
                     void* part, void* part_row, int n_rows, int n_edges, int F, int vec, void* stream);
}

namespace gnn {

constexpr int kScoreBlock = 256;
constexpr int kDattNodes = 256;
constexpr int kDattSumThreads = 256;

__global__ void __launch_bounds__(kScoreBlock)
    gat_node_score_kernel(const float* __restrict__ h, const float* __restrict__ att_src,
                          const float* __restrict__ att_dst, float* __restrict__ a, int n_pairs,
                          int H, int F) {
  const int p = blockIdx.x * kScoreBlock + threadIdx.x;  // n * H + h
  if (p >= n_pairs) return;
  const int head = p % H;
  const float* row = h + static_cast<int64_t>(p) * F;
  const float* ws = att_src + head * F;
  const float* wd = att_dst + head * F;
  float s = 0.f, d = 0.f;
  for (int f = 0; f < F; ++f) {
    const float x = __ldg(row + f);
    s = fmaf(x, __ldg(ws + f), s);
    d = fmaf(x, __ldg(wd + f), d);
  }
  a[2 * static_cast<int64_t>(p)] = s;
  a[2 * static_cast<int64_t>(p) + 1] = d;
}

template <bool kRound>
__device__ __forceinline__ float gat_score_sum(const int32_t* __restrict__ dst,
                                               const int32_t* __restrict__ src,
                                               const float* __restrict__ a, int k, int h, int H) {
  const int64_t d = static_cast<int64_t>(__ldg(dst + k)) * H + h;
  const int64_t s = static_cast<int64_t>(__ldg(src + k)) * H + h;
  float from_src = __ldg(a + 2 * s);
  if (kRound) from_src = __bfloat162float(__float2bfloat16_rn(from_src));
  return __ldg(a + 2 * d + 1) + from_src;
}

template <bool kRound>
__global__ void __launch_bounds__(kScoreBlock)
    gat_edge_score_kernel(const int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                          const float* __restrict__ a, float* __restrict__ e, int n_values, int H,
                          float slope) {
  const int p = blockIdx.x * kScoreBlock + threadIdx.x;
  if (p >= n_values) return;
  const int k = p / H;
  const float x = gat_score_sum<kRound>(dst, src, a, k, p - k * H, H);
  e[p] = x > 0.f ? x : x * slope;
}

template <bool kRound>
__global__ void __launch_bounds__(kScoreBlock)
    gat_edge_score_bwd_kernel(const int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                              const float* __restrict__ a, const float* __restrict__ de,
                              float* __restrict__ ds, int n_values, int H, float slope) {
  const int p = blockIdx.x * kScoreBlock + threadIdx.x;
  if (p >= n_values) return;
  const int k = p / H;
  const float g = __ldg(de + p);
  ds[p] = gat_score_sum<kRound>(dst, src, a, k, p - k * H, H) > 0.f ? g : g * slope;
}

// dh[n, h, f] = d_src[n, h] att_src[h, f] + d_dst[n, h] att_dst[h, f] (d_dst 0 from n_dst on)
__global__ void __launch_bounds__(kScoreBlock)
    gat_node_score_bwd_kernel(const float* __restrict__ d_src, const float* __restrict__ d_dst,
                              const float* __restrict__ att_src, const float* __restrict__ att_dst,
                              float* __restrict__ dh, int64_t n_values, int n_dst_pairs, int H,
                              int F) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kScoreBlock + threadIdx.x;
  if (i >= n_values) return;
  const int pair = static_cast<int>(i / F);  // n * H + h
  const int hf = static_cast<int>(i % (static_cast<int64_t>(H) * F));
  float g = __ldg(d_src + pair) * __ldg(att_src + hf);
  if (pair < n_dst_pairs) g = fmaf(__ldg(d_dst + pair), __ldg(att_dst + hf), g);
  dh[i] = g;
}

// part[b, c, h, f] = sum over the nodes n of block b's run of d_c[n, h] h[n, h, f]
__global__ void gat_datt_part_kernel(const float* __restrict__ h, const float* __restrict__ d_src,
                                     const float* __restrict__ d_dst, float* __restrict__ part,
                                     int n_nodes, int n_dst, int H, int F) {
  const int HF = H * F;
  const int t = threadIdx.x;  // c * HF + h * F + f
  const int c = t / HF;
  const int hf = t - c * HF;
  const int head = hf / F;
  const float* d = c == 0 ? d_src : d_dst;
  const int first = blockIdx.x * kDattNodes;
  int last = first + kDattNodes;
  const int end = c == 0 ? n_nodes : n_dst;
  if (last > end) last = end;
  float acc = 0.f;
  for (int n = first; n < last; ++n) {
    acc = fmaf(__ldg(d + static_cast<int64_t>(n) * H + head), __ldg(h + static_cast<int64_t>(n) * HF + hf), acc);
  }
  part[static_cast<int64_t>(blockIdx.x) * 2 * HF + t] = acc;
}

// datt[c, h, f] = sum over the blocks of part[b, c, h, f], in a fixed tree
__global__ void __launch_bounds__(kDattSumThreads)
    gat_datt_sum_kernel(const float* __restrict__ part, float* __restrict__ datt, int n_parts,
                        int n_out) {
  __shared__ float sums[kDattSumThreads];
  const int o = blockIdx.x;
  float acc = 0.f;
  for (int b = threadIdx.x; b < n_parts; b += kDattSumThreads) {
    acc += __ldg(part + static_cast<int64_t>(b) * n_out + o);
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kDattSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sums[threadIdx.x] += sums[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) datt[o] = sums[0];
}

inline dim3 blocks_for(int64_t n) {
  return dim3(static_cast<unsigned>((n + kScoreBlock - 1) / kScoreBlock));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace gnn

extern "C" {

// Blocks of datt's partials for n_nodes nodes: the scratch `datt_part` of
// the backward holds gnn_gat_datt_parts(n_nodes) * 2 * H * F floats.
int gnn_gat_datt_parts(int n_nodes) {
  return n_nodes < 0 ? -1 : (n_nodes + gnn::kDattNodes - 1) / gnn::kDattNodes;
}

// Enqueues the forward's two launches on `stream`; returns
// cudaGetLastError(). h: float32 [n_nodes, H, F]; att_src, att_dst: float32
// [H, F]; dst, src: int32 [n_edges], each in [0, n_nodes); a: float32
// [n_nodes, H, 2] and e: float32 [n_edges, H], written.
int gnn_gat_score_f32(const void* h, const void* att_src, const void* att_dst, const void* dst,
                      const void* src, void* a, void* e, int n_nodes, int n_edges, int H, int F,
                      float slope, int round_src, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(n_nodes) * H;
  const int64_t n_values = static_cast<int64_t>(n_edges) * H;
  if (n_nodes < 0 || n_edges < 0 || H < 1 || F < 1 || n_pairs > INT32_MAX || n_values > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto* av = static_cast<float*>(a);
  if (n_pairs > 0) {
    gnn::gat_node_score_kernel<<<gnn::blocks_for(n_pairs), gnn::kScoreBlock, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(att_src),
        static_cast<const float*>(att_dst), av, static_cast<int>(n_pairs), H, F);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_values == 0) return static_cast<int>(cudaSuccess);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* s = static_cast<const int32_t*>(src);
  auto* ev = static_cast<float*>(e);
  if (round_src) {
    gnn::gat_edge_score_kernel<true><<<gnn::blocks_for(n_values), gnn::kScoreBlock, 0, st>>>(
        d, s, av, ev, static_cast<int>(n_values), H, slope);
  } else {
    gnn::gat_edge_score_kernel<false><<<gnn::blocks_for(n_values), gnn::kScoreBlock, 0, st>>>(
        d, s, av, ev, static_cast<int>(n_values), H, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// Enqueues the first half of the backward on `stream` (five launches: the
// node scores again, the ds pass, K2 and K1 with their fixups); returns
// cudaGetLastError(). h, att_src, att_dst, dst, src as for the forward; de:
// float32 [n_edges, H]; row_ptr: int32 [n_dst + 1], the destinations' CSR
// of the edges; t_row_ptr: int32 [n_nodes + 1] and t_perm: int32
// [n_edges], the sources' CSR of edge positions. Written: a [n_nodes, H, 2]
// (the forward's bits again), ds [n_edges, H], d_dst [n_dst, H] and d_src
// [n_nodes, H], all float32. Scratch: part (float32) and part_row (int32)
// of K1's and K2's tiles, gnn_csr_reduce_tiles of the larger CSR, H floats
// and one row a tile's end, twice.
int gnn_gat_score_bwd_f32(const void* h, const void* att_src, const void* att_dst,
                          const void* dst, const void* src, void* a, const void* de,
                          const void* row_ptr, const void* t_row_ptr, const void* t_perm,
                          void* ds, void* d_dst, void* d_src, void* part, void* part_row,
                          int n_nodes, int n_dst, int n_edges, int H, int F, float slope,
                          int round_src, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(n_nodes) * H;
  const int64_t n_values = static_cast<int64_t>(n_edges) * H;
  if (n_nodes < 0 || n_dst < 0 || n_dst > n_nodes || n_edges < 0 || H < 1 || F < 1 ||
      n_pairs > INT32_MAX || n_values > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto* av = static_cast<float*>(a);
  auto* dsv = static_cast<float*>(ds);
  cudaError_t err;
  if (n_pairs > 0) {
    gnn::gat_node_score_kernel<<<gnn::blocks_for(n_pairs), gnn::kScoreBlock, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(att_src),
        static_cast<const float*>(att_dst), av, static_cast<int>(n_pairs), H, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (n_values > 0) {
    const auto* d = static_cast<const int32_t*>(dst);
    const auto* s = static_cast<const int32_t*>(src);
    const auto* g = static_cast<const float*>(de);
    if (round_src) {
      gnn::gat_edge_score_bwd_kernel<true><<<gnn::blocks_for(n_values), gnn::kScoreBlock, 0, st>>>(
          d, s, av, g, dsv, static_cast<int>(n_values), H, slope);
    } else {
      gnn::gat_edge_score_bwd_kernel<false><<<gnn::blocks_for(n_values), gnn::kScoreBlock, 0, st>>>(
          d, s, av, g, dsv, static_cast<int>(n_values), H, slope);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // the node sums of ds on K2 (by destination) and K1 (by source, col = t_perm)
  const int vec = H % 4 == 0 && gnn::aligned16(ds) && gnn::aligned16(d_dst) && gnn::aligned16(d_src) &&
                  gnn::aligned16(part);
  if (n_dst > 0) {
    const int rc = gnn_segment_sum_f32(row_ptr, ds, d_dst, part, part_row, n_dst, n_edges, H, vec, stream);
    if (rc != 0) return rc;
  }
  if (n_nodes > 0) {
    const int rc = gnn_csr_spmm_f32(t_row_ptr, t_perm, nullptr, ds, d_src, part, part_row, n_nodes,
                                    n_edges, H, vec, stream);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaSuccess);
}

// Enqueues the second half of the backward on `stream` (three launches: dh,
// datt's partials and their sum); returns cudaGetLastError(). h, att_src,
// att_dst as for the forward; d_dst [n_dst, H] and d_src [n_nodes, H] as the
// first half wrote them. Written: dh [n_nodes, H, F] and datt [2, H, F]
// (source, then destination), float32. Scratch: datt_part, float32
// [gnn_gat_datt_parts(n_nodes), 2, H, F].
int gnn_gat_score_node_bwd_f32(const void* h, const void* att_src, const void* att_dst,
                               const void* d_dst, const void* d_src, void* dh, void* datt,
                               void* datt_part, int n_nodes, int n_dst, int H, int F, void* stream) {
  const int64_t n_dh = static_cast<int64_t>(n_nodes) * H * F;
  if (n_nodes < 0 || n_dst < 0 || n_dst > n_nodes || H < 1 || F < 1 || 2 * H * F > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ws = static_cast<const float*>(att_src);
  const auto* wd = static_cast<const float*>(att_dst);
  const auto* ddst = static_cast<const float*>(d_dst);
  const auto* dsrc = static_cast<const float*>(d_src);
  cudaError_t err;
  if (n_dh > 0) {
    gnn::gat_node_score_bwd_kernel<<<gnn::blocks_for(n_dh), gnn::kScoreBlock, 0, st>>>(
        dsrc, ddst, ws, wd, static_cast<float*>(dh), n_dh, n_dst * H, H, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int n_parts = gnn_gat_datt_parts(n_nodes);
  const int n_out = 2 * H * F;
  auto* pv = static_cast<float*>(datt_part);
  if (n_parts > 0) {
    gnn::gat_datt_part_kernel<<<n_parts, n_out, 0, st>>>(static_cast<const float*>(h), dsrc, ddst, pv,
                                                          n_nodes, n_dst, H, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gnn::gat_datt_sum_kernel<<<n_out, gnn::kDattSumThreads, 0, st>>>(pv, static_cast<float*>(datt),
                                                                    n_parts, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
