# Copy of src/repro/core/ordering.py (numpy only), kept so that repro_torch never
# imports the JAX package.  Keep the two in step.
"""Fill-reducing orderings (HYLU preprocessing step 2).

HYLU adopts AMD, a modified AMD, and a modified METIS-based nested dissection,
selected adaptively.  We implement the same *selection* structure with:

  - ``min_degree``   — quotient-graph minimum-degree with element absorption
                       (the AMD family; we use exact external degrees instead of
                       AMD's degree upper bound — the approximation exists to
                       save CPU time, not to improve quality, and numpy set ops
                       make exact degrees affordable at our scales)
  - ``rcm``          — reverse Cuthill–McKee (cheap bandwidth ordering)
  - ``nested_dissection`` — level-set (George) recursive bisection with
                       min-degree leaves: the METIS substitute
  - ``natural``      — identity

``select_ordering`` runs the candidates, computes the symbolic factorization
cost of each (via the elimination tree; see symbolic.py) and returns the
cheapest — this mirrors HYLU's "select based on symbolic statistics".
"""
from __future__ import annotations

import heapq
import numpy as np

from .matrix import CSR


# --------------------------------------------------------------------------
# adjacency helpers (pattern CSR assumed symmetric with diagonal)
# --------------------------------------------------------------------------
def _adj_lists(pat: CSR):
    """Adjacency (excluding diagonal) as list of np arrays."""
    adj = []
    for i in range(pat.n):
        idx, _ = pat.row(i)
        adj.append(idx[idx != i].astype(np.int64))
    return adj


# --------------------------------------------------------------------------
# minimum degree (quotient graph, element absorption)
# --------------------------------------------------------------------------
def min_degree(pat: CSR) -> np.ndarray:
    """Return permutation ``order`` (order[k] = k-th pivot).

    Quotient-graph minimum degree with element absorption and the genuine
    AMD approximate external degree (Amestoy-Davis-Duff):

        d̂_i = |A_i'| + |L_p \\ i| + Σ_{e∋i, e≠p} |L_e \\ L_p|

    where every |L_e \\ L_p| (the w(e) counters) is computed for all touched
    elements in one decrementing pass over L_p — the trick that makes AMD
    fast. Elements with w(e)==0 are absorbed into the new element."""
    n = pat.n
    adj = _adj_lists(pat)
    elems_of: list[list[int]] = [[] for _ in range(n)]
    L: dict[int, np.ndarray] = {}
    alive = np.ones(n, dtype=bool)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    heap = [(int(deg[i]), i) for i in range(n)]
    heapq.heapify(heap)
    order = np.empty(n, dtype=np.int64)
    lp_mask = np.zeros(n, dtype=bool)

    for k in range(n):
        while True:
            d, p = heapq.heappop(heap)
            if alive[p] and d <= deg[p]:
                break
        # L_p = (A_p ∪ ⋃_{e∋p} L_e) \ {p}, alive vars only
        elems_of[p] = [e for e in elems_of[p] if e in L]
        parts = [adj[p][alive[adj[p]]]] + [L[e] for e in elems_of[p]]
        lp = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)
        lp = lp[(lp != p) & alive[lp]]
        order[k] = p
        alive[p] = False
        for e in elems_of[p]:
            del L[e]                       # absorbed into element p
        L[p] = lp
        lsize = len(lp)
        lp_mask[lp] = True
        # --- w(e) = |L_e \ L_p| in one decrementing pass ------------------
        w: dict[int, int] = {}
        for i in lp:
            lst = elems_of[int(i)]
            for e in lst:
                if e in L:
                    if e not in w:
                        w[e] = len(L[e])
                    w[e] -= 1
        # absorb elements fully covered by the new one
        for e, we in w.items():
            if we <= 0 and e in L:
                del L[e]
        # --- degree updates ----------------------------------------------
        for i in lp:
            i = int(i)
            ai = adj[i]
            ai = ai[alive[ai]]
            ai = ai[~lp_mask[ai]]          # covered by element p now
            adj[i] = ai
            elems = [e for e in elems_of[i] if e in L]
            d_hat = len(ai) + (lsize - 1) + sum(w.get(e, 0) for e in elems)
            elems.append(p)
            elems_of[i] = elems
            deg[i] = max(int(d_hat), 0)
            heapq.heappush(heap, (deg[i], i))
        lp_mask[lp] = False
    return order


# --------------------------------------------------------------------------
# reverse Cuthill–McKee
# --------------------------------------------------------------------------
def _bfs_levels(adj, start, alive_mask=None):
    """Vectorized BFS over list-of-arrays adjacency."""
    n = len(adj)
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    order = [frontier]
    lvl = 0
    while len(frontier):
        nbr = (np.concatenate([adj[int(u)] for u in frontier])
               if len(frontier) else np.empty(0, np.int64))
        nbr = np.unique(nbr)
        nbr = nbr[level[nbr] < 0]
        if alive_mask is not None:
            nbr = nbr[alive_mask[nbr]]
        if not len(nbr):
            break
        lvl += 1
        level[nbr] = lvl
        order.append(nbr)
        frontier = nbr
    return level, np.concatenate(order).tolist()


def _pseudo_peripheral(adj, nodes):
    start = int(nodes[0])
    mask = np.zeros(len(adj), dtype=bool)
    mask[nodes] = True
    for _ in range(4):
        level, order = _bfs_levels(adj, start, mask)
        far = order[-1]
        if level[far] <= level[order[-1]] and far == start:
            break
        if far == start:
            break
        start = far
    return start


def rcm(pat: CSR) -> np.ndarray:
    n = pat.n
    adj = _adj_lists(pat)
    degs = np.array([len(a) for a in adj])
    visited = np.zeros(n, dtype=bool)
    out = []
    for comp_start in range(n):
        if visited[comp_start]:
            continue
        comp_nodes = np.where(~visited)[0]
        start = _pseudo_peripheral(adj, [comp_start])
        # BFS ordering neighbors by degree
        queue = [start]
        visited[start] = True
        while queue:
            u = queue.pop(0)
            out.append(u)
            nbrs = [int(v) for v in adj[u] if not visited[v]]
            nbrs.sort(key=lambda v: degs[v])
            for v in nbrs:
                visited[v] = True
                queue.append(v)
    return np.array(out[::-1], dtype=np.int64)


# --------------------------------------------------------------------------
# nested dissection (level-set bisection, min-degree leaves)
# --------------------------------------------------------------------------
def nested_dissection(pat: CSR, leaf: int = 128) -> np.ndarray:
    n = pat.n
    adj = _adj_lists(pat)
    out: list[int] = []

    def order_sub(nodes: np.ndarray):
        if len(nodes) <= leaf:
            out.extend(_md_sub(adj, nodes))
            return
        mask = np.zeros(n, dtype=bool)
        mask[nodes] = True
        start = _pseudo_peripheral(adj, nodes)
        level, bfs_order = _bfs_levels(adj, start, mask)
        reached = np.array(bfs_order, dtype=np.int64)
        unreached = nodes[level[nodes] < 0]
        if len(reached) <= leaf or level[reached].max() < 2:
            out.extend(_md_sub(adj, nodes))
            return
        mid = int(np.median(level[reached]))
        sep = reached[level[reached] == mid]
        left = reached[level[reached] < mid]
        right = reached[level[reached] > mid]
        if len(left) == 0 or len(right) == 0:
            out.extend(_md_sub(adj, nodes))
            return
        order_sub(np.concatenate([left, unreached]) if len(unreached) else left)
        order_sub(right)
        out.extend(_md_sub(adj, sep))

    order_sub(np.arange(n, dtype=np.int64))
    return np.array(out, dtype=np.int64)


def _md_sub(adj, nodes: np.ndarray):
    """Minimum-degree ordering restricted to ``nodes`` (simple version:
    degrees within the subgraph, no quotient graph — leaves are small)."""
    nodes = np.asarray(nodes, dtype=np.int64)
    if len(nodes) <= 2:
        return nodes.tolist()
    in_sub = {int(v): k for k, v in enumerate(nodes)}
    m = len(nodes)
    nbrs = [set(in_sub[int(v)] for v in adj[int(u)] if int(v) in in_sub)
            for u in nodes]
    alive = [True] * m
    heap = [(len(nbrs[k]), k) for k in range(m)]
    heapq.heapify(heap)
    result = []
    for _ in range(m):
        while True:
            d, k = heapq.heappop(heap)
            if alive[k] and d == len(nbrs[k]):
                break
        alive[k] = False
        result.append(int(nodes[k]))
        clique = [v for v in nbrs[k] if alive[v]]
        for v in clique:
            nbrs[v].discard(k)
            for w in clique:
                if w != v:
                    nbrs[v].add(w)
            heapq.heappush(heap, (len(nbrs[v]), v))
    return result


# --------------------------------------------------------------------------
# adaptive selection
# --------------------------------------------------------------------------
ORDERINGS = {
    "natural": lambda pat: np.arange(pat.n, dtype=np.int64),
    "min_degree": min_degree,
    "rcm": rcm,
    "nested_dissection": nested_dissection,
}


def select_ordering(pat: CSR, candidates=("min_degree", "nested_dissection",
                                          "natural"), return_all=False):
    """Run candidate orderings, score each by predicted factorization FLOPs
    (from elimination-tree column counts) and return the winner.

    Mirrors HYLU's preprocessing: "AMD ... and a modified nested dissection
    ... are adopted for reordering" + selection by symbolic statistics.
    Fill counting aborts early once a candidate exceeds the best fill so
    far (a hopeless 'natural' ordering never pays its full O(fill) walk).
    """
    from .symbolic import etree_col_counts
    best = None
    best_fill = None
    scores = {}
    for name in candidates:
        perm = ORDERINGS[name](pat)
        ppat = pat.permute(perm, perm)
        cc = etree_col_counts(ppat, abort_nnz=(4 * best_fill + 16)
                              if best_fill is not None else None)
        flops = float(np.sum(2.0 * cc.astype(np.float64) ** 2))
        fill = float(cc.sum())
        scores[name] = (flops, fill)
        if best is None or flops < best[1]:
            best = (name, flops, perm)
            best_fill = fill
    if return_all:
        return best[2], best[0], scores
    return best[2], best[0]
