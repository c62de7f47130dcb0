// Native graph-core: host-side hot paths for graph preprocessing.
//
// TPU-native equivalent of the reference's C++ graph layer
// (reference: src/graph.cpp:10-75 converters, src/utils.cpp:96 index
// machinery) — but built for scale: the reference densifies O(N^2); these
// routines are O(E + N) counting sorts and samplers intended for
// 100M+-edge graphs where numpy's lexsort (O(E log E), multi-pass) becomes
// the preprocessing bottleneck.
//
// Pure C ABI (ctypes-friendly): no exceptions across the boundary, caller
// allocates all buffers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// Stable counting sort of edges by (dst major, src minor).
// Outputs: perm [E] (position in sorted order -> original edge id),
//          row_ptr [n_nodes + 1] CSR offsets over dst.
// Returns 0 on success, nonzero on invalid ids.
int64_t sort_edges_csr(int64_t n_nodes, int64_t n_edges,
                       const int64_t* src, const int64_t* dst,
                       int64_t* perm, int64_t* row_ptr) {
  for (int64_t e = 0; e < n_edges; ++e) {
    if (src[e] < 0 || src[e] >= n_nodes || dst[e] < 0 || dst[e] >= n_nodes)
      return 1;
  }
  std::vector<int64_t> count(n_nodes + 1, 0);
  std::vector<int64_t> tmp(n_edges);
  // Pass 1: stable counting sort by src (minor key).
  for (int64_t e = 0; e < n_edges; ++e) count[src[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; ++i) count[i + 1] += count[i];
  for (int64_t e = 0; e < n_edges; ++e) tmp[count[src[e]]++] = e;
  // Pass 2: stable counting sort by dst (major key).
  std::memset(count.data(), 0, sizeof(int64_t) * (n_nodes + 1));
  for (int64_t e = 0; e < n_edges; ++e) count[dst[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; ++i) count[i + 1] += count[i];
  std::memcpy(row_ptr, count.data(), sizeof(int64_t) * (n_nodes + 1));
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t e = tmp[i];
    perm[count[dst[e]]++] = e;
  }
  return 0;
}

// Weighted or unweighted in/out degrees.
void degrees(int64_t n_nodes, int64_t n_edges, const int64_t* nodes,
             const float* weight, double* out) {
  std::memset(out, 0, sizeof(double) * n_nodes);
  if (weight) {
    for (int64_t e = 0; e < n_edges; ++e) out[nodes[e]] += weight[e];
  } else {
    for (int64_t e = 0; e < n_edges; ++e) out[nodes[e]] += 1.0;
  }
}

// Uniform neighbor sampling over a CSR graph.
// replace != 0: with replacement (always exactly `fanout` draws).
// replace == 0: without replacement; rows with degree < fanout are padded
//               with -1. Uses partial Fisher-Yates on an index scratch.
// Zero-degree seeds emit the seed itself in slot 0, -1 elsewhere.
void sample_neighbors(const int64_t* row_ptr, const int64_t* col,
                      int64_t n_seeds, const int64_t* seeds, int64_t fanout,
                      uint64_t rng_seed, int64_t replace, int64_t* out) {
  std::mt19937_64 rng(rng_seed);
  std::vector<int64_t> scratch;
  for (int64_t s = 0; s < n_seeds; ++s) {
    int64_t v = seeds[s];
    int64_t lo = row_ptr[v], hi = row_ptr[v + 1];
    int64_t deg = hi - lo;
    int64_t* row = out + s * fanout;
    if (deg == 0) {
      row[0] = v;
      for (int64_t j = 1; j < fanout; ++j) row[j] = -1;
      continue;
    }
    if (replace) {
      for (int64_t j = 0; j < fanout; ++j)
        row[j] = col[lo + static_cast<int64_t>(rng() % deg)];
    } else if (deg <= fanout) {
      for (int64_t j = 0; j < deg; ++j) row[j] = col[lo + j];
      for (int64_t j = deg; j < fanout; ++j) row[j] = -1;
    } else {
      scratch.resize(deg);
      for (int64_t j = 0; j < deg; ++j) scratch[j] = lo + j;
      for (int64_t j = 0; j < fanout; ++j) {
        int64_t r = j + static_cast<int64_t>(rng() % (deg - j));
        std::swap(scratch[j], scratch[r]);
        row[j] = col[scratch[j]];
      }
    }
  }
}

// Merge duplicate edges of a dst-sorted edge list (weights summed).
// In: sorted src/dst [E] (by dst major, src minor) + optional weight.
// Out: compacted arrays; returns the number of unique edges.
int64_t coalesce_sorted(int64_t n_edges, const int64_t* src,
                        const int64_t* dst, const float* weight,
                        int64_t* out_src, int64_t* out_dst,
                        float* out_weight) {
  int64_t m = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    if (m > 0 && out_src[m - 1] == src[e] && out_dst[m - 1] == dst[e]) {
      if (weight) out_weight[m - 1] += weight[e];
      continue;
    }
    out_src[m] = src[e];
    out_dst[m] = dst[e];
    if (weight) out_weight[m] = weight[e];
    ++m;
  }
  return m;
}

// Greedy balanced 1-D partition of nodes by edge count: contiguous node
// ranges such that each part holds ~E/P in-edges. Outputs part boundaries
// [P + 1] over node ids.
void partition_by_edges(int64_t n_nodes, int64_t n_parts,
                        const int64_t* row_ptr, int64_t* boundaries) {
  int64_t total = row_ptr[n_nodes];
  boundaries[0] = 0;
  int64_t node = 0;
  for (int64_t p = 1; p < n_parts; ++p) {
    int64_t target = total * p / n_parts;
    while (node < n_nodes && row_ptr[node] < target) ++node;
    boundaries[p] = node;
  }
  boundaries[n_parts] = n_nodes;
}

// Community detection by (size-capped) synchronous-ish label propagation
// over a CSR graph. Labels start as node ids; each sweep visits nodes in a
// seeded random order and adopts the most frequent label among neighbors
// (ties -> smallest label; weights supported). A community stops absorbing
// nodes once it reaches `max_size` (cap <= 0 disables), which keeps the
// discovered communities packable into fixed device windows.
//
// Scalability (the blocked layout's prep cost at papers100M scale): after
// the first full sweep, only ACTIVE nodes are revisited — a node re-votes
// only if one of its in-neighbors changed label in the previous sweep
// (tracked through a reverse adjacency built once, O(E + N)). LP converges
// geometrically, so later sweeps touch a small, shrinking frontier instead
// of re-sweeping all E edges; measured end-to-end prep numbers per scale
// are in docs/PERF.md ("Cluster prep cost").
//
// Approximation note: the active set tracks LABEL changes only. A node's
// best vote also depends on community SIZES vs max_size, and a community
// filling to (or dropping back below) the cap via distant nodes does not
// reactivate the nodes voting over it — so convergence can differ from a
// full re-sweep (and from the pre-active-set output for the same seed).
// This is a deliberate heuristic trade: reactivating every voter adjacent
// to a cap-crossing community would re-grow the frontier toward O(N) per
// sweep, and the downstream consumer (window packing + the refine_windows
// swap pass below) is itself a capture heuristic whose measured quality is
// what matters (docs/PERF.md "Cluster prep cost": capture holds across
// scales; refine_windows recovers boundary losses either way).
// out_label [n_nodes]; returns the number of distinct labels.
int64_t label_propagation(int64_t n_nodes, const int64_t* row_ptr,
                          const int64_t* col, const float* weight,
                          int64_t n_iters, int64_t max_size,
                          uint64_t rng_seed, int64_t* out_label) {
  std::vector<int64_t> label(n_nodes);
  std::vector<int64_t> size(n_nodes, 1);
  for (int64_t v = 0; v < n_nodes; ++v) label[v] = v;
  std::vector<int64_t> order(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v) order[v] = v;
  // Sparse per-node vote table: touched labels tracked for O(deg) reset.
  std::vector<double> votes(n_nodes, 0.0);
  std::vector<int64_t> touched;
  std::mt19937_64 rng(rng_seed);
  // Reverse adjacency (u -> list of v with an in-edge u->v): when u
  // changes label, exactly those v see a changed vote set. int32 ids are
  // safe (node ids < 2^31 by the int-width audit) and halve the footprint.
  int64_t n_edges_tot = row_ptr[n_nodes];
  std::vector<int32_t> rcol(n_edges_tot);
  std::vector<int64_t> rptr(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_edges_tot; ++e) rptr[col[e] + 1]++;
  for (int64_t u = 0; u < n_nodes; ++u) rptr[u + 1] += rptr[u];
  {
    std::vector<int64_t> cursor(rptr.begin(), rptr.end() - 1);
    for (int64_t v = 0; v < n_nodes; ++v)
      for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e)
        rcol[cursor[col[e]]++] = static_cast<int32_t>(v);
  }
  std::vector<uint8_t> in_next(n_nodes, 0);
  std::vector<int64_t> next;
  int64_t n_active = n_nodes;  // sweep 0 visits everyone
  for (int64_t it = 0; it < n_iters; ++it) {
    // Fisher-Yates shuffle of the active visit order per sweep.
    for (int64_t i = n_active - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(rng() % (i + 1));
      std::swap(order[i], order[j]);
    }
    int64_t moves = 0;
    next.clear();
    for (int64_t oi = 0; oi < n_active; ++oi) {
      int64_t v = order[oi];
      int64_t lo = row_ptr[v], hi = row_ptr[v + 1];
      if (lo == hi) continue;
      touched.clear();
      for (int64_t e = lo; e < hi; ++e) {
        int64_t u = col[e];
        if (u == v) continue;
        int64_t lu = label[u];
        if (votes[lu] == 0.0) touched.push_back(lu);
        votes[lu] += weight ? static_cast<double>(weight[e]) : 1.0;
      }
      int64_t best = label[v];
      double best_votes = votes[best];  // 0 if no neighbor shares it
      for (int64_t lu : touched) {
        if (lu == label[v]) continue;
        bool full = max_size > 0 && size[lu] >= max_size;
        if (!full &&
            (votes[lu] > best_votes ||
             (votes[lu] == best_votes && lu < best))) {
          best = lu;
          best_votes = votes[lu];
        }
      }
      for (int64_t lu : touched) votes[lu] = 0.0;
      if (best != label[v]) {
        size[label[v]]--;
        size[best]++;
        label[v] = best;
        ++moves;
        // v's label changed: every node voting over v, and v itself,
        // must re-vote next sweep.
        if (!in_next[v]) { in_next[v] = 1; next.push_back(v); }
        for (int64_t e = rptr[v]; e < rptr[v + 1]; ++e) {
          int64_t w = rcol[e];
          if (!in_next[w]) { in_next[w] = 1; next.push_back(w); }
        }
      }
    }
    if (moves == 0) break;
    n_active = static_cast<int64_t>(next.size());
    for (int64_t i = 0; i < n_active; ++i) {
      order[i] = next[i];
      in_next[next[i]] = 0;
    }
  }
  // Compact labels to 0..k-1 (order of first appearance by node id).
  std::vector<int64_t> remap(n_nodes, -1);
  int64_t k = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    int64_t l = label[v];
    if (remap[l] < 0) remap[l] = k++;
    out_label[v] = remap[l];
  }
  return k;
}

// First-fit-decreasing packing of community label groups into fixed
// `rows`-node windows — the host-side prep of the cluster-packed blocked
// layouts (graphs/blocked.py cluster_pack_order; this is its exact
// semantics, >10x faster: the Python first-fit scan is O(chunks x bins),
// here a segment tree gives first-fit in O(log bins) per chunk).
// labels [n] in 0..n_labels-1; out_perm [n] receives new -> old node ids.
void cluster_pack(int64_t n, int64_t n_labels, const int64_t* labels,
                  int64_t rows, int64_t* out_perm) {
  // Stable counting sort of nodes by label (== np.argsort(labels, stable)).
  std::vector<int64_t> count(n_labels + 1, 0);
  for (int64_t v = 0; v < n; ++v) count[labels[v] + 1]++;
  for (int64_t l = 0; l < n_labels; ++l) count[l + 1] += count[l];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t v = 0; v < n; ++v) order[cursor[labels[v]]++] = v;
  }
  // Chunks: (start offset into `order`, size), oversized groups chopped.
  struct Chunk { int64_t start, size; };
  std::vector<Chunk> chunks;
  chunks.reserve(n_labels + n / std::max<int64_t>(rows, 1) + 1);
  for (int64_t l = 0; l < n_labels; ++l) {
    int64_t s = count[l], size = count[l + 1] - count[l];
    while (size > rows) {
      chunks.push_back({s, rows});
      s += rows;
      size -= rows;
    }
    if (size) chunks.push_back({s, size});
  }
  // FFD order: descending size, stable (ties keep label order).
  std::stable_sort(chunks.begin(), chunks.end(),
                   [](const Chunk& a, const Chunk& b) { return a.size > b.size; });
  // First-fit via a segment tree of max remaining space over bin index.
  int64_t max_bins = static_cast<int64_t>(chunks.size());
  int64_t tree_n = 1;
  while (tree_n < max_bins) tree_n <<= 1;
  std::vector<int64_t> tree(2 * tree_n, -1);  // -1 = bin not created
  auto update = [&](int64_t i, int64_t val) {
    i += tree_n;
    tree[i] = val;
    for (i >>= 1; i >= 1; i >>= 1)
      tree[i] = std::max(tree[2 * i], tree[2 * i + 1]);
  };
  std::vector<std::vector<int64_t>> bins;  // chunk indices per bin
  std::vector<int64_t> space;
  std::vector<int64_t> chunk_order(chunks.size());
  for (size_t c = 0; c < chunks.size(); ++c) {
    int64_t need = chunks[c].size;
    int64_t bin = -1;
    if (tree[1] >= need) {  // leftmost bin with space >= need
      int64_t i = 1;
      while (i < tree_n) {
        i = (tree[2 * i] >= need) ? 2 * i : 2 * i + 1;
      }
      bin = i - tree_n;
    }
    if (bin < 0) {
      bin = static_cast<int64_t>(bins.size());
      bins.emplace_back();
      space.push_back(rows);
      update(bin, rows);
    }
    bins[bin].push_back(static_cast<int64_t>(c));
    space[bin] -= need;
    update(bin, space[bin]);
  }
  // Emit: full bins first (creation order), then underfull (creation
  // order) concatenated — identical to the Python reference.
  int64_t off = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (size_t b = 0; b < bins.size(); ++b) {
      bool full = space[b] == 0;
      if ((pass == 0) != full) continue;
      for (int64_t ci : bins[b]) {
        const Chunk& ch = chunks[ci];
        std::memcpy(out_perm + off, order.data() + ch.start,
                    sizeof(int64_t) * ch.size);
        off += ch.size;
      }
    }
  }
}

// Size-capped Louvain community detection: modularity local moves + graph
// aggregation. Plurality-vote label propagation (above) stalls at a local
// optimum well below planted-partition truth (measured: 0.80 edge capture
// vs ~0.86 ground truth on the arxiv-scale clustered benchmark) because a
// plurality tie between the home label and a denser true community is a
// no-move; modularity's null-model term (k_v * tot_C / 2m) breaks exactly
// those ties toward the denser community, and aggregation then escapes
// single-node local optima entirely. Standard Louvain (Blondel et al.),
// with one addition: a community's NODE count (summed through super-nodes)
// may not exceed `max_size`, keeping every community packable into an
// R-row device window (graphs/blocked.py).
//
// CSR over the symmetrized graph (in-edges; degree-symmetric input makes
// in == out). weight optional. out_label [n]; returns #labels (compacted
// in first-appearance-by-node-id order, same convention as LP above).
int64_t louvain_cluster(int64_t n_nodes, const int64_t* row_ptr,
                        const int64_t* col, const float* weight,
                        int64_t max_levels, int64_t max_sweeps,
                        int64_t max_size, double resolution,
                        uint64_t rng_seed, int64_t* out_label) {
  // Current aggregation level's graph (CSR, double weights).
  std::vector<int64_t> rp(row_ptr, row_ptr + n_nodes + 1);
  std::vector<int64_t> cl(col, col + row_ptr[n_nodes]);
  std::vector<double> wt(row_ptr[n_nodes]);
  for (int64_t e = 0; e < row_ptr[n_nodes]; ++e)
    wt[e] = weight ? static_cast<double>(weight[e]) : 1.0;
  // node_label[v]: original node -> current top-level community.
  std::vector<int64_t> node_label(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v) node_label[v] = v;
  // nsize[super-node]: original node count it represents.
  std::vector<int64_t> nsize(n_nodes, 1);
  std::mt19937_64 rng(rng_seed);

  double two_m = 0.0;
  for (double w : wt) two_m += w;  // symmetric: sum over directed = 2m
  if (two_m <= 0.0) {
    for (int64_t v = 0; v < n_nodes; ++v) out_label[v] = v;
    return n_nodes;
  }

  int64_t n = n_nodes;
  for (int64_t level = 0; level < max_levels; ++level) {
    // --- local-move phase on the current super-graph -----------------
    std::vector<int64_t> comm(n);
    std::vector<double> deg(n, 0.0), tot(n, 0.0);
    std::vector<double> selfw(n, 0.0);
    std::vector<int64_t> csize(n);
    for (int64_t v = 0; v < n; ++v) {
      comm[v] = v;
      csize[v] = nsize[v];
      for (int64_t e = rp[v]; e < rp[v + 1]; ++e) {
        deg[v] += wt[e];
        if (cl[e] == v) selfw[v] += wt[e];
      }
      tot[v] = deg[v];
    }
    std::vector<int64_t> order(n);
    for (int64_t v = 0; v < n; ++v) order[v] = v;
    std::vector<double> kin(n, 0.0);
    std::vector<int64_t> touched;
    int64_t total_moves = 0;
    for (int64_t sweep = 0; sweep < max_sweeps; ++sweep) {
      for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng() % (i + 1));
        std::swap(order[i], order[j]);
      }
      int64_t moves = 0;
      for (int64_t oi = 0; oi < n; ++oi) {
        int64_t v = order[oi];
        int64_t cv = comm[v];
        touched.clear();
        for (int64_t e = rp[v]; e < rp[v + 1]; ++e) {
          int64_t u = cl[e];
          if (u == v) continue;
          int64_t cu = comm[u];
          if (kin[cu] == 0.0) touched.push_back(cu);
          kin[cu] += wt[e];
        }
        // remove v from its community for the comparison
        tot[cv] -= deg[v];
        csize[cv] -= nsize[v];
        double base = kin[cv] - resolution * deg[v] * tot[cv] / two_m;
        int64_t best = cv;
        double best_gain = base;
        for (int64_t c : touched) {
          if (c == cv) continue;
          if (max_size > 0 && csize[c] + nsize[v] > max_size) continue;
          double g = kin[c] - resolution * deg[v] * tot[c] / two_m;
          if (g > best_gain || (g == best_gain && c < best)) {
            best = c;
            best_gain = g;
          }
        }
        for (int64_t c : touched) kin[c] = 0.0;
        tot[best] += deg[v];
        csize[best] += nsize[v];
        if (best != cv) {
          comm[v] = best;
          ++moves;
        }
      }
      total_moves += moves;
      if (moves == 0) break;
    }
    // compact community ids
    std::vector<int64_t> remap(n, -1);
    int64_t k = 0;
    for (int64_t v = 0; v < n; ++v)
      if (remap[comm[v]] < 0) remap[comm[v]] = k++;
    for (int64_t v = 0; v < n; ++v) comm[v] = remap[comm[v]];
    for (int64_t v = 0; v < n_nodes; ++v)
      node_label[v] = comm[node_label[v]];
    if (total_moves == 0 || k == n) break;  // converged at this level
    // --- aggregation phase: communities become super-nodes -----------
    std::vector<int64_t> new_nsize(k, 0);
    for (int64_t v = 0; v < n; ++v) new_nsize[comm[v]] += nsize[v];
    // bucket edges by (comm[v], comm[u]), merging duplicates per row
    std::vector<int64_t> new_rp(k + 1, 0);
    std::vector<int64_t> new_cl;
    std::vector<double> new_wt;
    new_cl.reserve(cl.size());
    new_wt.reserve(cl.size());
    {
      // rows of the aggregate graph, built row-by-row with a scratch map
      std::vector<int64_t> nodes_of;  // original super-nodes sorted by comm
      std::vector<int64_t> cnt(k + 1, 0);
      for (int64_t v = 0; v < n; ++v) cnt[comm[v] + 1]++;
      for (int64_t c = 0; c < k; ++c) cnt[c + 1] += cnt[c];
      nodes_of.resize(n);
      {
        std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
        for (int64_t v = 0; v < n; ++v) nodes_of[cur[comm[v]]++] = v;
      }
      std::vector<double> acc(k, 0.0);
      std::vector<int64_t> hit;
      for (int64_t c = 0; c < k; ++c) {
        hit.clear();
        for (int64_t i = cnt[c]; i < cnt[c + 1]; ++i) {
          int64_t v = nodes_of[i];
          for (int64_t e = rp[v]; e < rp[v + 1]; ++e) {
            int64_t cu = comm[cl[e]];
            if (acc[cu] == 0.0) hit.push_back(cu);
            acc[cu] += wt[e];
          }
        }
        std::sort(hit.begin(), hit.end());
        for (int64_t cu : hit) {
          new_cl.push_back(cu);
          new_wt.push_back(acc[cu]);
          acc[cu] = 0.0;
        }
        new_rp[c + 1] = static_cast<int64_t>(new_cl.size());
      }
    }
    rp.swap(new_rp);
    cl.swap(new_cl);
    wt.swap(new_wt);
    nsize.swap(new_nsize);
    n = k;
  }
  // compact final labels in first-appearance order (LP convention)
  std::vector<int64_t> remap(n_nodes, -1);
  int64_t k = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    int64_t l = node_label[v];
    if (remap[l] < 0) remap[l] = k++;
    out_label[v] = remap[l];
  }
  return k;
}

// Boundary refinement of a window packing: Kernighan–Lin-style greedy swap
// sweeps over the window assignment produced by label_propagation +
// cluster_pack. Windows are the consecutive `rows`-slices of the packed
// permutation, so every window's size is fixed — improvement happens by
// swapping node PAIRS between windows, raising the intra-window edge
// fraction ("capture", the dense-diagonal share of graphs/blocked.py).
//
// Deterministic (no RNG): nodes are visited in ascending id order; a node
// whose in-neighbors plurality-vote for another window B queues under the
// ordered pair (A -> B) and is matched FIFO against nodes of B queued for
// A; a matched pair swaps iff the exact pair delta (gain_v + gain_u -
// 2 * edges(u, v)) is positive. Failed or stale candidates are discarded
// for the sweep (re-queuing them can cycle). Votes use IN-edges only: on
// the degree-symmetric graphs the blocked layout is built from
// (to_undirected + self loops) the in-edge gain is exactly half the true
// objective delta, so every accepted swap strictly raises capture.
// win [n] (inout): window id per node. Returns the number of swaps.
int64_t refine_windows(int64_t n, const int64_t* row_ptr, const int64_t* col,
                       int64_t n_windows, int64_t n_sweeps, int64_t* win) {
  std::vector<int64_t> votes(n_windows, 0);
  std::vector<int64_t> touched;
  struct Queue { std::vector<int64_t> q; size_t head = 0; };
  std::unordered_map<uint64_t, Queue> pending;
  auto key = [n_windows](int64_t from, int64_t to) {
    return static_cast<uint64_t>(from) * static_cast<uint64_t>(n_windows) +
           static_cast<uint64_t>(to);
  };
  // Gain of moving v to `to`, and v's in-edge count to a third window
  // `other` (pass -1 to skip): one O(deg) scan serves the pair check.
  auto gain2 = [&](int64_t v, int64_t to, int64_t partner) {
    int64_t w_cur = 0, w_to = 0, w_pair = 0;
    int64_t home = win[v];
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      int64_t u = col[e];
      if (u == v) continue;  // self loops are intra in every assignment
      if (u == partner) ++w_pair;
      if (win[u] == home) ++w_cur;
      else if (win[u] == to) ++w_to;
    }
    return std::pair<int64_t, int64_t>(w_to - w_cur, w_pair);
  };
  int64_t total_swaps = 0;
  for (int64_t sweep = 0; sweep < n_sweeps; ++sweep) {
    pending.clear();
    int64_t swaps = 0;
    for (int64_t v = 0; v < n; ++v) {
      int64_t lo = row_ptr[v], hi = row_ptr[v + 1];
      if (lo == hi) continue;
      touched.clear();
      for (int64_t e = lo; e < hi; ++e) {
        int64_t u = col[e];
        if (u == v) continue;
        int64_t wu = win[u];
        if (votes[wu] == 0) touched.push_back(wu);
        votes[wu]++;
      }
      int64_t A = win[v], best = A;
      int64_t best_votes = votes[A];  // 0 if no neighbor shares A
      for (int64_t wu : touched) {
        if (votes[wu] > best_votes ||
            (votes[wu] == best_votes && wu < best)) {
          best = wu;
          best_votes = votes[wu];
        }
      }
      int64_t g_v = votes[best] - votes[A];
      for (int64_t wu : touched) votes[wu] = 0;
      if (best == A || g_v <= 0) continue;
      int64_t B = best;
      auto it = pending.find(key(B, A));
      bool swapped = false;
      if (it != pending.end()) {
        Queue& q = it->second;
        while (q.head < q.q.size()) {
          int64_t u = q.q[q.head++];
          if (win[u] != B) continue;  // stale: u already swapped away
          auto [g_u, m_uv] = gain2(u, A, v);
          if (g_v + g_u - 2 * m_uv > 0) {
            win[v] = B;
            win[u] = A;
            ++swaps;
            swapped = true;
            break;
          }
          // failed candidate: discarded for this sweep (see header)
        }
      }
      if (!swapped) {
        Queue& q = pending[key(A, B)];
        q.q.push_back(v);
      }
    }
    total_swaps += swaps;
    if (swaps == 0) break;
  }
  return total_swaps;
}

}  // extern "C"
