// K2: sorted segment sum over CSR offsets, out[r, :] = sum_k msg[k, :] over
// k in [row_ptr[r], row_ptr[r + 1]); empty rows come out 0.
//
// Replaces gnn_tpu/ops/pallas/segment.py::segment_sum_sorted. The TPU kernel
// reduces chunks of dst-sorted edges with one-hot matmuls along a host-built
// chunk plan; on this card a warp per output row walks its contiguous edge
// range directly, so no plan, padding or one-hot arithmetic is needed: the
// contract is kept (float32 accumulation, output in msg's dtype), the plan is
// not.
//
// Design: as csr_spmm.cu without the gather and the weight. One warp per
// row, lanes over the feature axis (four features a lane with one vector
// load where F % 4 == 0 and rows are aligned), kUnroll message rows in
// flight, float32 sums in registers added in edge order, one write per row,
// no atomics.
//
// What bounds it on an H100: in principle streaming the E * F message bytes
// once (contiguous within a row); on a power-law graph, the largest row,
// which one warp walks with kUnroll loads in flight while the card idles.
// Splitting long rows across warps is the next step.

#include "common.cuh"

namespace gnn {

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_sum_kernel(const int32_t* __restrict__ row_ptr,
                   const T* __restrict__ msg, T* __restrict__ out, int n_rows,
                   int F) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  constexpr int kPerLane = kVec ? 4 : 1;
  constexpr int kStep = kWarp * kPerLane;
  for (int f = lane * kPerLane; f < F; f += kStep) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = begin; k0 < end; k0 += kUnroll) {
      // kUnroll independent loads in flight before the first add.
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + u < end) {
          const T* src = msg + static_cast<int64_t>(k0 + u) * F + f;
          if (kVec) {
            v[u] = load4(src);
          } else {
            v[u].x = load1(src);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < end) {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
      }
    }
    T* dst = out + static_cast<int64_t>(row) * F + f;
    if (kVec) {
      store4(dst, acc);
    } else {
      store1(dst, acc.x);
    }
  }
}

template <typename T>
int launch_segment_sum(const void* row_ptr, const void* msg, void* out,
                       int n_rows, int F, int vec, void* stream) {
  const dim3 grid(blocks_for_rows(n_rows));
  const dim3 block(kWarp * kWarpsPerBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int32_t*>(row_ptr);
  auto mp = static_cast<const T*>(msg);
  auto op = static_cast<T*>(out);
  if (vec) {
    segment_sum_kernel<T, true><<<grid, block, 0, s>>>(rp, mp, op, n_rows, F);
  } else {
    segment_sum_kernel<T, false><<<grid, block, 0, s>>>(rp, mp, op, n_rows, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnn

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError().
int gnn_segment_sum_f32(const void* row_ptr, const void* msg, void* out,
                        int n_rows, int F, int vec, void* stream) {
  return gnn::launch_segment_sum<float>(row_ptr, msg, out, n_rows, F, vec,
                                        stream);
}

int gnn_segment_sum_bf16(const void* row_ptr, const void* msg, void* out,
                         int n_rows, int F, int vec, void* stream) {
  return gnn::launch_segment_sum<__nv_bfloat16>(row_ptr, msg, out, n_rows, F,
                                                vec, stream);
}

}  // extern "C"
