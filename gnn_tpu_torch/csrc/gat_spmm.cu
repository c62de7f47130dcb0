// K3: multi-head edge-weighted CSR SpMM,
//   out[r, h, :] = sum_k w[k, h] * x[col[k], h, :]
// over k in [row_ptr[r], row_ptr[r + 1]); x is [N, H, F], w is [E, H].
//
// Replaces GAT's numerator in gnn_tpu/mp/gat.py (GATConv.__call__ :193-202):
// there the per-edge messages ex_num[e, h] * h[src_e, h, :] are written out
// as an [E, H * F] array and reduced by the Pallas segment sum
// (gnn_tpu/ops/pallas/segment.py::segment_sum_sorted through
// ops/segment.py::segment_sum_edges). Here the gather, the per-head scale and
// the per-row reduction are one kernel, so that array never exists. The same
// kernel runs the backward dh = A_w^T g over the transpose CSR
// (t_row_ptr, dst[t_perm], w[t_perm]).
//
// Design: as csr_spmm.cu (K1), with a weight per edge and head. One warp per
// output row; lanes stride over the H * F features of the row, four a lane
// with one vector load where F % 4 == 0 and the rows are aligned (then a
// lane's four features share one head), else one a lane. Each lane reads its
// own head's weight once per edge, next to the feature load; lanes of one
// head read the same address, which the warp's load serves once. The warp
// reads 32 edge indices at once and broadcasts them with shuffles, keeps
// kUnroll gathered rows in flight, and adds them in edge order. Sums are
// float32 in registers, each output row is written once: no atomics, the
// result is deterministic. With H = 1 it computes what K1 does, in the same
// order.
//
// What bounds it on an H100: in principle the E * H * F gathered feature
// bytes (random rows, partly from the 50 MB L2) plus E * H weights. In
// practice, on a power-law graph, the largest row: one warp walks all of a
// hub's edges (21,305 at ogbn-arxiv scale) with kUnroll row loads in flight
// per 128-feature chunk, while the rest of the card idles -- the same floor
// as K1's. Splitting long rows across warps is the next step.

#include "common.cuh"

namespace gnn {

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_spmm_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ w,  // [E, H]
                const T* __restrict__ x,      // [N, H * F]
                T* __restrict__ out, int n_rows, int H, int F) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // whole warp leaves together
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  const int D = H * F;
  constexpr int kPerLane = kVec ? 4 : 1;
  constexpr int kStep = kWarp * kPerLane;
  for (int d0 = 0; d0 < D; d0 += kStep) {
    const int d = d0 + lane * kPerLane;
    const bool active = d < D;
    const int dl = active ? d : 0;  // idle lanes read a valid address
    const int head = dl / F;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = begin; base < end; base += kWarp) {
      const int k = base + lane;
      const int c = k < end ? __ldg(col + k) : 0;
      const int n = min(kWarp, end - base);
      for (int j = 0; j < n; j += kUnroll) {
        // kUnroll independent row and weight loads before the first add.
        // They are unconditional (slots past the row's end reread its last
        // edge and are not added), so no branch stands between them and
        // all are in flight at once, in bfloat16 too.
        float4 v[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int uj = min(j + u, n - 1);
          const int cj = __shfl_sync(kFullMask, c, uj);
          wv[u] = __ldg(w + static_cast<int64_t>(base + uj) * H + head);
          const T* src = x + static_cast<int64_t>(cj) * D + dl;
          if (kVec) {
            v[u] = load4(src);
          } else {
            v[u] = make_float4(load1(src), 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < n) {  // edge order
            if (kVec) {
              fma4(acc, wv[u], v[u]);
            } else {
              acc.x = fmaf(wv[u], v[u].x, acc.x);
            }
          }
        }
      }
    }
    if (active) {
      T* dst = out + static_cast<int64_t>(row) * D + d;
      if (kVec) {
        store4(dst, acc);
      } else {
        store1(dst, acc.x);
      }
    }
  }
}

template <typename T>
int launch_gat_spmm(const void* row_ptr, const void* col, const void* w,
                    const void* x, void* out, int n_rows, int H, int F,
                    int vec, void* stream) {
  const dim3 grid(blocks_for_rows(n_rows));
  const dim3 block(kWarp * kWarpsPerBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int32_t*>(row_ptr);
  auto c = static_cast<const int32_t*>(col);
  auto wp = static_cast<const float*>(w);
  auto xp = static_cast<const T*>(x);
  auto op = static_cast<T*>(out);
  if (vec) {
    gat_spmm_kernel<T, true><<<grid, block, 0, s>>>(rp, c, wp, xp, op, n_rows,
                                                    H, F);
  } else {
    gat_spmm_kernel<T, false><<<grid, block, 0, s>>>(rp, c, wp, xp, op, n_rows,
                                                     H, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnn

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError().
int gnn_gat_spmm_f32(const void* row_ptr, const void* col, const void* w,
                     const void* x, void* out, int n_rows, int H, int F,
                     int vec, void* stream) {
  return gnn::launch_gat_spmm<float>(row_ptr, col, w, x, out, n_rows, H, F,
                                     vec, stream);
}

int gnn_gat_spmm_bf16(const void* row_ptr, const void* col, const void* w,
                      const void* x, void* out, int n_rows, int H, int F,
                      int vec, void* stream) {
  return gnn::launch_gat_spmm<__nv_bfloat16>(row_ptr, col, w, x, out, n_rows,
                                             H, F, vec, stream);
}

}  // extern "C"
