// K1: CSR sparse x dense product, out[r, :] = sum_k w[k] * x[col[k], :]
// over k in [row_ptr[r], row_ptr[r + 1]).
//
// Replaces gnn_tpu/ops/pallas/spmm.py::spmm_pallas (its gather x[src] * w
// followed by the Pallas segment sum of gnn_tpu/ops/pallas/segment.py). Here
// the gather, the scale and the per-row reduction are one kernel, so the
// [E, F] message array is never written to device memory. The same kernel
// runs the backward dx = A^T g over the transpose CSR (t_row_ptr, dst[t_perm],
// weight[t_perm]), the source-gather VJP (col = t_perm, w = null) and the
// blocked layout's remainder CSR.
//
// Design: csr_reduce.cuh's Gather instance -- merge-path tiles of a fixed
// number of row ends and edges per warp, col and w staged through shared
// memory with cp.async, lane groups sized to F, a fixup launch for rows cut
// by a tile boundary; float32 sums, no atomics, deterministic.
//
// What bounds it on an H100: bytes. Each input and output once (x, out, col,
// w, row_ptr) is 367 MB at ogbn-arxiv scale and F=256 in float32, 0.110 ms at
// 3.35 TB/s; with no reuse of a gathered row (x is 173 MB, over the 50 MB L2)
// the E * F gathered bytes make it 2.73 GB, 0.815 ms. At widths 8 and 1 the
// 10-20 MB of indices and an L2-resident x, ~0.01 ms.
// The warp-per-row kernel this replaces followed the largest row instead (a
// 21,305-edge hub walked by one warp: 7.9 ms at F=256, 1.8 ms at width 1);
// with merge-path tiles no warp walks more than kWarpItems items, so the time
// follows the edge count.

#include "csr_reduce.cuh"

extern "C" {

// Each entry enqueues the reduction and its fixup on `stream` and returns
// cudaGetLastError(). part / part_row: scratch of gnn_csr_reduce_tiles tiles.
int gnn_csr_spmm_f32(const void* row_ptr, const void* col, const void* w,
                     const void* x, void* out, void* part, void* part_row,
                     int n_rows, int n_edges, int F, int vec, void* stream) {
  return gnn::launch_csr_reduce<float, gnn::Gather>(row_ptr, col, w, nullptr, x, out, part,
                                                    part_row, n_rows, n_edges, F, 1, vec,
                                                    stream);
}

int gnn_csr_spmm_bf16(const void* row_ptr, const void* col, const void* w,
                      const void* x, void* out, void* part, void* part_row,
                      int n_rows, int n_edges, int F, int vec, void* stream) {
  return gnn::launch_csr_reduce<__nv_bfloat16, gnn::Gather>(row_ptr, col, w, nullptr, x, out,
                                                            part, part_row, n_rows, n_edges,
                                                            F, 1, vec, stream);
}

// Warp tiles of K1, K2 and K3 over a CSR of n_rows rows and n_edges edges (the
// scratch holds 2 * tiles partials of F float32 and 2 * tiles rows); -1 where
// n_rows + n_edges does not fit the kernels' int32 merge coordinates.
int gnn_csr_reduce_tiles(int n_rows, int n_edges) {
  return gnn::csr_reduce_tiles(n_rows, n_edges);
}

}  // extern "C"
