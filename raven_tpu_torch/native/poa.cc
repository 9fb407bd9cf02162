// Partial-order-alignment window consensus (spoa-equivalent, from scratch).
//
// Host-side consensus engine for the polisher: the reference delegates this
// to the racon/spoa dependencies (use site RavenLib/src/polish.cc:43-51);
// the TPU path is the batched JAX kernel in raven_tpu/ops/poa.py, and this
// C++ implementation is the exact host oracle + CPU fallback.
//
// Semantics: global (NW) alignment of each fragment to the growing DAG with
// linear gap scores; mismatches reuse "aligned" sibling nodes; consensus is
// the heaviest bundle (max in-edge weight, tie-broken by predecessor score),
// optionally trimmed where node support < half the fragment count.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PoaEdge {
  std::int32_t tail;
  std::int32_t head;
  std::int64_t weight;
};

struct PoaNode {
  std::uint8_t ch;
  std::int32_t aligned_ring;  // next node in the aligned ring (-1 none)
  std::int64_t support;       // sequences traversing this node
  std::vector<std::int32_t> in_edges;   // edge ids
  std::vector<std::int32_t> out_edges;  // edge ids
};

struct PoaGraph {
  std::vector<PoaNode> nodes;
  std::vector<PoaEdge> edges;
  std::vector<std::int32_t> topo;  // topological order (aligned groups adjacent)

  std::int32_t AddNode(std::uint8_t ch) {
    nodes.push_back(PoaNode{ch, -1, 0, {}, {}});
    return static_cast<std::int32_t>(nodes.size()) - 1;
  }

  void AddOrBumpEdge(std::int32_t tail, std::int32_t head, std::int64_t w) {
    for (auto eid : nodes[tail].out_edges) {
      if (edges[eid].head == head) {
        edges[eid].weight += w;
        return;
      }
    }
    edges.push_back(PoaEdge{tail, head, w});
    std::int32_t eid = static_cast<std::int32_t>(edges.size()) - 1;
    nodes[tail].out_edges.push_back(eid);
    nodes[head].in_edges.push_back(eid);
  }

  // Kahn topological sort keeping aligned rings adjacent (like spoa, so the
  // DP can treat aligned groups as one column).
  void TopoSort() {
    const std::int32_t n = static_cast<std::int32_t>(nodes.size());
    std::vector<std::int32_t> indeg(n, 0);
    for (const auto& e : edges) indeg[e.head]++;
    std::vector<char> placed(n, 0);
    std::vector<std::int32_t> stack;
    topo.clear();
    topo.reserve(n);
    for (std::int32_t i = 0; i < n; ++i) {
      if (indeg[i] == 0 && !placed[i]) {
        // place the whole aligned ring together if all are ready
        stack.push_back(i);
      }
    }
    // simple Kahn; ring adjacency is handled by processing ring members when
    // each becomes ready (alignment rings have no internal edges)
    std::vector<std::int32_t> queue = stack;
    std::size_t qh = 0;
    while (qh < queue.size()) {
      std::int32_t v = queue[qh++];
      if (placed[v]) continue;
      placed[v] = 1;
      topo.push_back(v);
      for (auto eid : nodes[v].out_edges) {
        std::int32_t h = edges[eid].head;
        if (--indeg[h] == 0) queue.push_back(h);
      }
    }
  }
};

constexpr std::int32_t NEG = -0x3f3f3f3f;

}  // namespace

extern "C" {

// Build consensus of one window.
//   backbone / blen: window backbone codes
//   frags / offs / flens: nfrags fragments (concatenated)
//   weights: per-base weights parallel to frags (nullptr -> 1)
//   match/mismatch/gap: alignment scores (gap is linear, negative)
//   trim: racon-style trimming where support < half of fragments
//   out / out_cap: consensus buffer; returns consensus length (or -1).
long long raven_poa_consensus(const std::uint8_t* backbone, long long blen,
                              const std::uint8_t* frags, const long long* offs,
                              const long long* flens,
                              const std::uint8_t* weights, long long nfrags,
                              int match, int mismatch, int gap, int trim,
                              std::uint8_t* out, long long out_cap) {
  if (blen <= 0) return 0;
  PoaGraph g;
  g.nodes.reserve(blen * 2);

  // backbone chain (support counts like any sequence)
  std::int32_t prev = g.AddNode(backbone[0]);
  g.nodes[prev].support = 1;
  std::vector<std::int32_t> backbone_ids(blen);
  backbone_ids[0] = prev;
  for (long long i = 1; i < blen; ++i) {
    std::int32_t cur = g.AddNode(backbone[i]);
    g.nodes[cur].support = 1;
    g.AddOrBumpEdge(prev, cur, 2);  // uniform backbone weight (w[i-1]+w[i])
    prev = cur;
    backbone_ids[i] = cur;
  }

  std::vector<std::int32_t> rank;       // node -> topo rank
  std::vector<std::int32_t> H, Hdiag;   // DP score, traceback
  std::vector<std::int8_t> move;        // 0 diag, 1 up(graph gap), 2 left(frag gap)
  std::vector<std::int32_t> from;       // predecessor topo rank for diag/up

  for (long long f = 0; f < nfrags; ++f) {
    const std::uint8_t* s = frags + offs[f];
    const long long m = flens[f];
    if (m <= 0) continue;
    const std::uint8_t* w = weights ? weights + offs[f] : nullptr;

    g.TopoSort();
    const std::int32_t V = static_cast<std::int32_t>(g.topo.size());
    rank.assign(g.nodes.size(), -1);
    for (std::int32_t r = 0; r < V; ++r) rank[g.topo[r]] = r;

    const long long stride = m + 1;
    H.assign(static_cast<std::size_t>(V + 1) * stride, NEG);
    move.assign(static_cast<std::size_t>(V + 1) * stride, 0);
    from.assign(static_cast<std::size_t>(V + 1) * stride, 0);

    // row 0 = virtual start (before any graph node)
    for (long long j = 0; j <= m; ++j) {
      H[j] = static_cast<std::int32_t>(j) * gap;
      move[j] = 2;
    }

    for (std::int32_t r = 0; r < V; ++r) {
      const PoaNode& node = g.nodes[g.topo[r]];
      std::int32_t* row = &H[static_cast<std::size_t>(r + 1) * stride];
      std::int8_t* mrow = &move[static_cast<std::size_t>(r + 1) * stride];
      std::int32_t* frow = &from[static_cast<std::size_t>(r + 1) * stride];

      // predecessor rows: virtual start if no in-edges
      for (long long j = 0; j <= m; ++j) row[j] = NEG;
      auto consider_pred = [&](std::int32_t pr) {
        const std::int32_t* prow = &H[static_cast<std::size_t>(pr + 1) * stride];
        // up (graph advance, fragment gap)
        for (long long j = 0; j <= m; ++j) {
          std::int32_t v = prow[j] + gap;
          if (v > row[j]) {
            row[j] = v;
            mrow[j] = 1;
            frow[j] = pr;
          }
        }
        // diagonal
        for (long long j = 1; j <= m; ++j) {
          std::int32_t sc = (node.ch == s[j - 1]) ? match : mismatch;
          std::int32_t v = prow[j - 1] + sc;
          if (v > row[j]) {
            row[j] = v;
            mrow[j] = 0;
            frow[j] = pr;
          }
        }
      };
      if (node.in_edges.empty()) {
        consider_pred(-1);
      } else {
        for (auto eid : node.in_edges) consider_pred(rank[g.edges[eid].tail]);
      }
      // free start at any node (graph-local alignment, like the window
      // fragments racon feeds spoa: a fragment covering only part of the
      // window must not pay for the uncovered graph prefix)
      if (row[0] < 0) {
        row[0] = 0;
        mrow[0] = 3;  // traceback stop marker
      }
      // left (fragment consumes, graph stays)
      for (long long j = 1; j <= m; ++j) {
        std::int32_t v = row[j - 1] + gap;
        if (v > row[j]) {
          row[j] = v;
          mrow[j] = 2;
        }
      }
    }

    // global: best end = max over nodes with no out-edges at j=m; if the
    // fragment ends mid-graph (terminal graph gap is free in spoa's NW via
    // trailing deletions), walking up rows costs gap — emulate spoa kNW by
    // allowing free end at any node, taking the max scoring cell at j=m.
    std::int32_t best_r = -1;
    std::int32_t best_score = NEG;
    for (std::int32_t r = 0; r < V; ++r) {
      std::int32_t v = H[static_cast<std::size_t>(r + 1) * stride + m];
      if (v > best_score) {
        best_score = v;
        best_r = r;
      }
    }
    if (best_r < 0) continue;

    // traceback -> (node_id or -1 for insertion, frag_pos) pairs
    std::vector<std::pair<std::int32_t, long long>> path;  // (graph node, j)
    std::int32_t r = best_r;
    long long j = m;
    while (r != -1 || j != 0) {
      if (r == -1) {  // virtual start row: remaining prefix is insertions
        path.emplace_back(-1, j - 1);
        --j;
        continue;
      }
      const std::size_t idx = static_cast<std::size_t>(r + 1) * stride + j;
      const std::int8_t mv = move[idx];
      if (mv == 3) {
        break;  // free-start marker: the alignment begins at this node
      }
      if (mv == 0) {
        path.emplace_back(g.topo[r], j - 1);
        r = from[idx];
        --j;
      } else if (mv == 1) {
        r = from[idx];
      } else {
        path.emplace_back(-1, j - 1);
        --j;
      }
    }
    std::reverse(path.begin(), path.end());

    // thread the fragment through the graph
    std::int32_t prev_node = -1;
    long long prev_j = -1;
    for (const auto& step : path) {
      std::int32_t node_id = step.first;
      const long long jj = step.second;
      const std::uint8_t ch = s[jj];
      if (node_id != -1 && g.nodes[node_id].ch != ch) {
        // mismatch: reuse an aligned sibling with this char or grow the ring
        std::int32_t ring = g.nodes[node_id].aligned_ring;
        std::int32_t found = -1;
        std::int32_t cur = ring;
        while (cur != -1 && cur != node_id) {
          if (g.nodes[cur].ch == ch) {
            found = cur;
            break;
          }
          cur = g.nodes[cur].aligned_ring;
        }
        if (found == -1) {
          std::int32_t fresh = g.AddNode(ch);
          // insert into ring after node_id
          std::int32_t nxt = g.nodes[node_id].aligned_ring;
          g.nodes[node_id].aligned_ring = fresh;
          g.nodes[fresh].aligned_ring = (nxt == -1) ? node_id : nxt;
          node_id = fresh;
        } else {
          node_id = found;
        }
      } else if (node_id == -1) {
        node_id = g.AddNode(ch);
      }
      g.nodes[node_id].support += 1;
      if (prev_node != -1) {
        const std::int64_t wsum =
            (w ? (std::int64_t)w[prev_j] + (std::int64_t)w[jj] : 2);
        g.AddOrBumpEdge(prev_node, node_id, wsum);
      }
      prev_node = node_id;
      prev_j = jj;
    }
  }

  // ---- heaviest-bundle consensus (spoa TraverseHeaviestBundle style) ----
  g.TopoSort();
  const std::int32_t V = static_cast<std::int32_t>(g.topo.size());
  std::vector<std::int64_t> score(g.nodes.size(), 0);
  std::vector<std::int64_t> best_w(g.nodes.size(), -1);
  std::vector<std::int32_t> pred(g.nodes.size(), -1);
  for (std::int32_t r = 0; r < V; ++r) {
    std::int32_t v = g.topo[r];
    for (auto eid : g.nodes[v].in_edges) {
      const auto& e = g.edges[eid];
      if (e.weight > best_w[v] ||
          (e.weight == best_w[v] && pred[v] != -1 &&
           score[e.tail] > score[pred[v]])) {
        best_w[v] = e.weight;
        pred[v] = e.tail;
      }
    }
    score[v] = (pred[v] == -1 ? 0 : score[pred[v]]) + std::max<std::int64_t>(best_w[v], 0);
  }
  std::int32_t best_node = -1;
  std::int64_t best_score = -1;
  for (std::int32_t r = 0; r < V; ++r) {
    std::int32_t v = g.topo[r];
    if (score[v] > best_score) {
      best_score = score[v];
      best_node = v;
    }
  }
  if (best_node == -1) return 0;

  std::vector<std::int32_t> consensus;
  for (std::int32_t v = best_node; v != -1; v = pred[v]) consensus.push_back(v);
  std::reverse(consensus.begin(), consensus.end());

  long long begin = 0;
  long long end = static_cast<long long>(consensus.size());
  if (trim && nfrags >= 2) {
    // racon: average_coverage = (num_sequences - 1) / 2, backbone included
    const std::int64_t min_support = nfrags / 2;
    while (begin < end && g.nodes[consensus[begin]].support < min_support)
      ++begin;
    while (end > begin && g.nodes[consensus[end - 1]].support < min_support)
      --end;
    if (begin >= end) {
      begin = 0;
      end = static_cast<long long>(consensus.size());
    }
  }

  const long long n_out = end - begin;
  if (n_out > out_cap) return -1;
  for (long long i = 0; i < n_out; ++i)
    out[i] = g.nodes[consensus[begin + i]].ch;
  return n_out;
}

}  // extern "C"
