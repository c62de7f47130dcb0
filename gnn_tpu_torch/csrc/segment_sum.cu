// K2: sorted segment sum over CSR offsets, out[r, :] = sum_k msg[k, :] over
// k in [row_ptr[r], row_ptr[r + 1]); empty rows come out 0.
//
// Replaces gnn_tpu/ops/pallas/segment.py::segment_sum_sorted. The TPU kernel
// reduces chunks of dst-sorted edges with one-hot matmuls along a host-built
// chunk plan; on this card the merge-path tiles of csr_reduce.cuh cut the
// same dst-sorted rows into equal shares of row ends and edges, searched in
// row_ptr itself, so no plan, padding or one-hot arithmetic is needed: the
// contract is kept (float32 accumulation, output in msg's dtype), the plan is
// not.
//
// Design: csr_reduce.cuh's Contiguous instance -- K1 without the
// gather. A warp's edges are consecutive message rows, so a lane group's
// 16-byte loads run along one contiguous span; only row_ptr is staged
// through shared memory (cp.async). Lane groups sized to F put all 32 lanes
// on edges at width 1 and 16 edges a warp step at width 8 (GAT's
// denominator and destination-gather VJP); a fixup launch sums the rows cut
// by a tile boundary in tile order: no atomics, deterministic.
//
// What bounds it on an H100: bytes, streaming the E * F messages once: with
// out and row_ptr 2.71 GB at F=256 and ogbn-arxiv scale in float32 (0.810 ms
// at 3.35 TB/s), 85 MB at width 8 (0.026 ms), 11 MB at width 1. The
// warp-per-row kernel this
// replaces followed the largest row instead (the 21,305-edge hub: 8 ms at
// F=256, 2.7 ms at width 8 with 2 of 32 lanes busy).

#include "csr_reduce.cuh"

extern "C" {

// Each entry enqueues the reduction and its fixup on `stream` and returns
// cudaGetLastError(). part / part_row: scratch of gnn_csr_reduce_tiles tiles.
int gnn_segment_sum_f32(const void* row_ptr, const void* msg, void* out, void* part,
                        void* part_row, int n_rows, int n_edges, int F, int vec,
                        void* stream) {
  return gnn::launch_csr_reduce<float, gnn::Contiguous>(row_ptr, nullptr, nullptr, nullptr, msg,
                                                        out, part, part_row, n_rows, n_edges,
                                                        F, 1, vec, stream);
}

int gnn_segment_sum_bf16(const void* row_ptr, const void* msg, void* out, void* part,
                         void* part_row, int n_rows, int n_edges, int F, int vec,
                         void* stream) {
  return gnn::launch_csr_reduce<__nv_bfloat16, gnn::Contiguous>(
      row_ptr, nullptr, nullptr, nullptr, msg, out, part, part_row, n_rows, n_edges, F, 1, vec,
      stream);
}

}  // extern "C"
