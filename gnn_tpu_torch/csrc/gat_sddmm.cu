// GAT's attention-weight gradient, the SDDMM of K3's backward:
//   dw[e, h] = sum_f g[dst[e], h, f] * x[src[e], h, f]
// over the E edges of an adjacency in its dst-sorted order; g [N_dst, H, F]
// is the cotangent of K3's output, x [N_src, H, F] K3's input, dw [E, H]
// float32. Products and sums in float32 whatever the dtype of g and x.
//
// Replaces no Pallas kernel. The JAX package gets this gradient from XLA's
// VJP of the jnp.take and the segment sum of GATConv's numerator
// (gnn_tpu/mp/gat.py:193-202). The port computed it in plain torch: two
// index_selects, a multiply and a sum, which wrote g[dst], x[src] and their
// product out as three [E, H, F] float32 arrays (3 x 634 MB at ogbn-arxiv
// scale and (H, F) = (8, 8)) and read them back. Here nothing but dw is
// written.
//
// What bounds it on an H100: bytes. x, g, src, dst and dw, each once, are
// 186 MB at ogbn-arxiv scale (169,343 nodes, 2,478,219 edges with self
// loops) and (H, F) = (8, 8) in float32, 0.056 ms at 3.35 TB/s; 84 MB at
// (1, 40), 0.025 ms. With no reuse of a gathered x row (x at (8, 8) is
// 43 MB, near the 50 MB L2) the E * H * F gathered values make it 777 MB,
// 0.232 ms, and 453 MB, 0.135 ms. 2 flops per 8 bytes read: no tensor cores.
//
// Design: the E * H (edge, head) pairs in order, p = e * H + h, so that
// consecutive pairs are consecutive entries of dw and the stores of a warp
// are one coalesced run. A group of kL = min(32, next_pow2(ceil(F / 4)))
// lanes takes one pair on the vector path (16-byte float32 or 8-byte
// bfloat16 loads, F % 4 == 0), kL = min(32, next_pow2(F)) on the scalar one:
// at (8, 8) two lanes a pair, so a warp step covers two edges and reads
// their g and x rows as 256-byte runs; at (1, 40) 16 lanes (10 active), two
// edges a warp step. Wider heads loop over F in steps of 4 kL features. Each
// thread takes kSddmmSteps = 2 pairs and starts all their loads before the
// first multiply: on an H100 (700 W), cold L2, float32, 0.201 ms at (8, 8)
// and 0.188 at (1, 40), against 0.220 and 0.204 with 4 pairs a thread (48
// registers against 32, so fewer threads in flight) and 0.300 and 0.277 with
// one. The gathered x rows set the time: at (1, 40) a 160-byte row costs
// about what a 256-byte one does at (8, 8), and streaming cache hints on g,
// the indices and dw (to keep x in L2) moved nothing. The walk is by edge in
// dst order, so the 21,305-edge hub needs no care and consecutive edges read
// the same g row, which L1 and L2 serve. A group's partials are summed by a
// __shfl_xor_sync butterfly in a fixed order: no atomics, the same bits on
// every call.

#include "csr_reduce.cuh"

namespace gnn {

constexpr int kSddmmSteps = 2;  // block steps of pairs a thread takes

template <bool kVec>
__device__ __forceinline__ float dot_feat(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  if (kVec) {
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

template <typename T, bool kVec, int kL>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_sddmm_kernel(const int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                 const T* __restrict__ g, const T* __restrict__ x, float* __restrict__ dw,
                 int n_pairs, int H, int F) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kPairs = kWarp * kWarpsPerBlock / kL;  // pairs of one block step
  const int slot = threadIdx.x / kL;
  const int f_lane = (threadIdx.x % kL) * kPer;
  const int64_t row = static_cast<int64_t>(H) * F;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPairs * kSddmmSteps + slot;
  const T* gp[kSddmmSteps];
  const T* xp[kSddmmSteps];
#pragma unroll
  for (int u = 0; u < kSddmmSteps; ++u) {
    // a pair past the end rereads the last one and is not stored
    const int64_t pu = p0 + u * kPairs;
    const int p = pu < n_pairs ? static_cast<int>(pu) : n_pairs - 1;
    const int e = p / H;
    const int64_t head = static_cast<int64_t>(p - e * H) * F;
    gp[u] = g + __ldg(dst + e) * row + head;
    xp[u] = x + __ldg(src + e) * row + head;
  }
  float acc[kSddmmSteps];
#pragma unroll
  for (int u = 0; u < kSddmmSteps; ++u) acc[u] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kL * kPer) {
    const int f = f0 + f_lane;
    const bool active = f < F;
    const int fl = active ? f : 0;  // idle lanes read a valid address
    float4 a[kSddmmSteps], b[kSddmmSteps];
#pragma unroll
    for (int u = 0; u < kSddmmSteps; ++u) {
      a[u] = load_feat<kVec>(gp[u] + fl);
      b[u] = load_feat<kVec>(xp[u] + fl);
    }
#pragma unroll
    for (int u = 0; u < kSddmmSteps; ++u) {
      if (active) acc[u] = dot_feat<kVec>(a[u], b[u], acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kSddmmSteps; ++u) {
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) acc[u] += __shfl_xor_sync(kFullMask, acc[u], off);
  }
  if (threadIdx.x % kL == 0) {
#pragma unroll
    for (int u = 0; u < kSddmmSteps; ++u) {
      const int64_t p = p0 + u * kPairs;
      if (p < n_pairs) dw[p] = acc[u];
    }
  }
}

template <typename T, bool kVec, int kL>
int launch_gat_sddmm_l(const int32_t* dst, const int32_t* src, const T* g, const T* x, float* dw,
                       int n_pairs, int H, int F, cudaStream_t stream) {
  constexpr int64_t kPerBlock = static_cast<int64_t>(kWarp * kWarpsPerBlock / kL) * kSddmmSteps;
  const dim3 grid(static_cast<unsigned>((n_pairs + kPerBlock - 1) / kPerBlock));
  gat_sddmm_kernel<T, kVec, kL><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(dst, src, g, x, dw,
                                                                            n_pairs, H, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_gat_sddmm_v(const int32_t* dst, const int32_t* src, const T* g, const T* x, float* dw,
                       int n_pairs, int H, int F, cudaStream_t stream) {
  // one head's F features take the place of a row's: the same lane groups
  switch (lanes_per_edge(F, kVec)) {
    case 1:
      return launch_gat_sddmm_l<T, kVec, 1>(dst, src, g, x, dw, n_pairs, H, F, stream);
    case 2:
      return launch_gat_sddmm_l<T, kVec, 2>(dst, src, g, x, dw, n_pairs, H, F, stream);
    case 4:
      return launch_gat_sddmm_l<T, kVec, 4>(dst, src, g, x, dw, n_pairs, H, F, stream);
    case 8:
      return launch_gat_sddmm_l<T, kVec, 8>(dst, src, g, x, dw, n_pairs, H, F, stream);
    case 16:
      return launch_gat_sddmm_l<T, kVec, 16>(dst, src, g, x, dw, n_pairs, H, F, stream);
    default:
      return launch_gat_sddmm_l<T, kVec, 32>(dst, src, g, x, dw, n_pairs, H, F, stream);
  }
}

// Enqueues the SDDMM on `stream`; returns cudaGetLastError(). vec needs
// F % 4 == 0 and g, x on vector-load boundaries. E * H must fit int32.
template <typename T>
int launch_gat_sddmm(const void* dst, const void* src, const void* g, const void* x, void* dw,
                     int n_edges, int H, int F, int vec, void* stream) {
  const int64_t n_pairs = static_cast<int64_t>(n_edges) * H;
  if (n_edges < 0 || H < 1 || F < 1 || n_pairs > INT32_MAX || (vec && F % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs == 0) return static_cast<int>(cudaSuccess);
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* gt = static_cast<const T*>(g);
  const auto* xt = static_cast<const T*>(x);
  auto* out = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(n_pairs);
  return vec ? launch_gat_sddmm_v<T, true>(d, s, gt, xt, out, p, H, F, st)
             : launch_gat_sddmm_v<T, false>(d, s, gt, xt, out, p, H, F, st);
}

}  // namespace gnn

extern "C" {

// dst, src: int32 [n_edges]; g [N_dst, H, F], x [N_src, H, F] contiguous, of
// one dtype; dw: float32 [n_edges, H].
int gnn_gat_sddmm_f32(const void* dst, const void* src, const void* g, const void* x, void* dw,
                      int n_edges, int H, int F, int vec, void* stream) {
  return gnn::launch_gat_sddmm<float>(dst, src, g, x, dw, n_edges, H, F, vec, stream);
}

int gnn_gat_sddmm_bf16(const void* dst, const void* src, const void* g, const void* x, void* dw,
                       int n_edges, int H, int F, int vec, void* stream) {
  return gnn::launch_gat_sddmm<__nv_bfloat16>(dst, src, g, x, dw, n_edges, H, F, vec, stream);
}

}  // extern "C"
