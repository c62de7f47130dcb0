// K1: CSR sparse x dense product, out[r, :] = sum_k w[k] * x[col[k], :]
// over k in [row_ptr[r], row_ptr[r + 1]).
//
// Replaces gnn_tpu/ops/pallas/spmm.py::spmm_pallas (its gather x[src] * w
// followed by the Pallas segment sum of gnn_tpu/ops/pallas/segment.py). Here
// the gather, the scale and the per-row reduction are one kernel, so the
// [E, F] message array is never written to device memory. The same kernel
// runs the backward dx = A^T g over the transpose CSR (t_row_ptr, dst[t_perm],
// weight[t_perm]).
//
// Design: one warp per output row; lanes stride over the feature axis, four
// features a lane with one vector load where F % 4 == 0 and the rows are
// aligned, else one feature a lane. The warp reads 32 edge indices and
// weights at once and broadcasts them with shuffles, then keeps kUnroll
// gathered rows in flight before adding them in edge order. Sums are
// float32 in registers and each output row is written once: no atomics, so
// the result is deterministic. bfloat16 inputs are widened with the
// intrinsics.
//
// What bounds it on an H100: in principle the E * F gathered feature bytes
// of x (random rows, served partly from the 50 MB L2), not arithmetic (2
// flops a gathered element). In practice, on a power-law graph, the largest
// row: one warp walks all of a hub's edges (21,305 at ogbn-arxiv scale) with
// only kUnroll row loads in flight, so the kernel's time is about
// max_degree / kUnroll load latencies per 128-feature chunk while the rest
// of the card idles. Splitting long rows across warps (or merge-path) is
// the next step.

#include "common.cuh"

namespace gnn {

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_spmm_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ w,  // may be null: all ones
                const T* __restrict__ x, T* __restrict__ out, int n_rows,
                int F) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // whole warp leaves together
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  constexpr int kPerLane = kVec ? 4 : 1;
  constexpr int kStep = kWarp * kPerLane;
  for (int f0 = 0; f0 < F; f0 += kStep) {
    const int f = f0 + lane * kPerLane;
    const bool active = f < F;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = begin; base < end; base += kWarp) {
      const int k = base + lane;
      int c = 0;
      float wk = 0.f;
      if (k < end) {
        c = __ldg(col + k);
        wk = w ? __ldg(w + k) : 1.f;
      }
      const int n = min(kWarp, end - base);
      for (int j = 0; j < n; j += kUnroll) {
        // Issue kUnroll independent row loads before the first add, so a
        // long row waits on one load latency per kUnroll edges, not per edge.
        float4 v[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int cj = __shfl_sync(kFullMask, c, j + u);
          wv[u] = __shfl_sync(kFullMask, wk, j + u);
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active && j + u < n) {
            const T* src = x + static_cast<int64_t>(cj) * F + f;
            if (kVec) {
              v[u] = load4(src);
            } else {
              v[u].x = load1(src);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < n) {  // edge order, as before: same sums bit for bit
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
      T* dst = out + static_cast<int64_t>(row) * F + f;
      if (kVec) {
        store4(dst, acc);
      } else {
        store1(dst, acc.x);
      }
    }
  }
}

template <typename T>
int launch_csr_spmm(const void* row_ptr, const void* col, const void* w,
                    const void* x, void* out, int n_rows, int F, int vec,
                    void* stream) {
  const dim3 grid(blocks_for_rows(n_rows));
  const dim3 block(kWarp * kWarpsPerBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int32_t*>(row_ptr);
  auto c = static_cast<const int32_t*>(col);
  auto wp = static_cast<const float*>(w);
  auto xp = static_cast<const T*>(x);
  auto op = static_cast<T*>(out);
  if (vec) {
    csr_spmm_kernel<T, true><<<grid, block, 0, s>>>(rp, c, wp, xp, op, n_rows, F);
  } else {
    csr_spmm_kernel<T, false><<<grid, block, 0, s>>>(rp, c, wp, xp, op, n_rows, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnn

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError().
int gnn_csr_spmm_f32(const void* row_ptr, const void* col, const void* w,
                     const void* x, void* out, int n_rows, int F, int vec,
                     void* stream) {
  return gnn::launch_csr_spmm<float>(row_ptr, col, w, x, out, n_rows, F, vec,
                                     stream);
}

int gnn_csr_spmm_bf16(const void* row_ptr, const void* col, const void* w,
                      const void* x, void* out, int n_rows, int F, int vec,
                      void* stream) {
  return gnn::launch_csr_spmm<__nv_bfloat16>(row_ptr, col, w, x, out, n_rows,
                                             F, vec, stream);
}

}  // extern "C"
