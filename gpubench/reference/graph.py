"""The plain reference: the benchmark's own adjacency and searches, worked
out again from the edge list and weights the benchmark generated.

Plain torch on whatever device the edges live on; no kernel, cache or
code of the program.  Every pass over the 2^31 directed edges of a
SCALE 26 graph runs in pieces of `PIECE` edges, and every frontier
expansion in chunks of about `PIECE` adjacency entries, so the
temporaries stay a few GiB.

- `RefGraph`: CSR by source (a counting sort in pieces), with the weights
  in the same order.
- `bfs_levels`: the hop count from a root, level by level.
- `sssp_dist`: shortest distances over positive integer weights, Dial's
  buckets: each step settles every vertex at the smallest tentative
  distance and relaxes its edges.
- `component_labels`: every vertex's component as its minimum id (min-label
  propagation with pointer jumping), and `component_edges`, the input edges
  of each component: the Graph500 TEPS numerator.
- The controls (`bfs_levels_in_place`, `sssp_dist` with `weight_bits=4`)
  break one guarantee each and must fail the comparison.
"""
from __future__ import annotations

import torch

PIECE = 1 << 27
I32_MAX = 2**31 - 1


def edge_pieces(edges):
    """(start, src, dst) pieces of a (2, E) edge list, as int64."""
    for a in range(0, edges.shape[1], PIECE):
        yield (a, edges[0, a:a + PIECE].long(), edges[1, a:a + PIECE].long())


def out_degrees(edges, n: int):
    """(n,) int64: each vertex's directed edges out."""
    deg = torch.zeros(n, dtype=torch.int64, device=edges.device)
    for _, u, _ in edge_pieces(edges):
        deg += torch.bincount(u, minlength=n)
    return deg


class RefGraph:
    """CSR by source of a directed edge list, weights (if any) beside."""

    def __init__(self, edges, weights, n: int):
        dev = edges.device
        self.n = n
        self.device = dev
        self.deg = out_degrees(edges, n)
        self.row_off = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(self.deg, 0, out=self.row_off[1:])
        E = edges.shape[1]
        self.col = torch.empty(E, dtype=torch.int32, device=dev)
        self.w = None if weights is None else \
            torch.empty(E, dtype=torch.uint8, device=dev)
        fill = self.row_off[:-1].clone()
        for a, u, v in edge_pieces(edges):
            order = torch.argsort(u)
            us = u[order]
            keys, counts = torch.unique_consecutive(us, return_counts=True)
            first = torch.cumsum(counts, 0) - counts
            rank = torch.arange(us.numel(), device=dev) - \
                torch.repeat_interleave(first, counts)
            pos = fill[us] + rank
            self.col[pos] = v[order].to(torch.int32)
            if weights is not None:
                self.w[pos] = weights[a:a + PIECE][order]
            fill[keys] += counts
            del order, us, keys, counts, first, rank, pos

    def chunks(self, front):
        """Split a vertex list into runs of about PIECE adjacency entries."""
        deg = self.deg[front]
        cum = torch.cumsum(deg, 0)
        total = int(cum[-1]) if cum.numel() else 0
        if total <= PIECE:
            yield front
            return
        cuts = torch.searchsorted(
            cum, torch.arange(PIECE, total, PIECE, device=cum.device))
        bounds = [0] + sorted(set(int(c) + 1 for c in cuts.tolist())) + \
            [front.numel()]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi > lo:
                yield front[lo:hi]

    def expand(self, front):
        """(neighbour, source, adjacency position) of every entry of the
        rows of `front` (int64)."""
        deg = self.deg[front]
        total = int(deg.sum())
        seg = torch.repeat_interleave(
            torch.arange(front.numel(), device=front.device), deg,
            output_size=total)
        first = torch.cumsum(deg, 0) - deg
        pos = self.row_off[front][seg] + \
            (torch.arange(total, device=front.device) - first[seg])
        return self.col[pos].long(), front[seg], pos


def bfs_levels(g: RefGraph, root: int):
    """(n,) int32 hop counts from root, -1 unreached; and the deepest
    level."""
    level = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    level[root] = 0
    front = torch.tensor([root], dtype=torch.int64, device=g.device)
    depth = 0
    while True:
        for chunk in g.chunks(front):
            nb, _, _ = g.expand(chunk)
            level[nb[level[nb] < 0]] = depth + 1
        front = torch.nonzero(level == depth + 1).flatten()
        if front.numel() == 0:
            return level, depth
        depth += 1


def bfs_levels_in_place(g: RefGraph, root: int):
    """The BFS control: a level's claims are written into the frontier the
    level is still reading (no second buffer), so a vertex found in a
    level expands within it, at that level's number.  Returns (level, pred,
    deepest level) as a program would; its levels are not hop counts."""
    level = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    pred = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    level[root] = 0
    pred[root] = root
    front = torch.tensor([root], dtype=torch.int64, device=g.device)
    depth = 0
    while front.numel():
        queue = list(g.chunks(front))
        while queue:
            nb, src, _ = g.expand(queue.pop())
            new = level[nb] < 0
            nb, src = nb[new], src[new]
            level[nb] = depth + 1
            pred[nb] = src.to(torch.int32)
            found = torch.unique(nb)
            if found.numel():
                queue.extend(g.chunks(found))
        front = torch.nonzero(level == depth + 1).flatten()
        if front.numel() == 0:
            break
        depth += 1
    return level, pred, int(level.max())


def quantise_weights(w, bits: int):
    """Weights rounded to `bits` bits (a scale of 2^(8 - bits)), never 0."""
    step = 1 << (8 - bits)
    q = torch.clamp(torch.round(w.float() / step), 1, (1 << bits) - 1)
    return (q * step).to(torch.int32)


def sssp_dist(g: RefGraph, root: int, weight_bits: int = 8):
    """(n,) int32 shortest distances from root over the weights, -1
    unreached.  weight_bits < 8 is the SSSP control: the same search over
    weights rounded to that many bits."""
    tent = torch.full((g.n,), I32_MAX, dtype=torch.int32, device=g.device)
    dist = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    done = torch.zeros(g.n, dtype=torch.bool, device=g.device)
    tent[root] = 0
    while True:
        m = int(tent.min())
        if m == I32_MAX:
            return dist
        bucket = torch.nonzero(tent == m).flatten()
        tent[bucket] = I32_MAX
        dist[bucket] = m
        done[bucket] = True
        for chunk in g.chunks(bucket):
            nb, _, pos = g.expand(chunk)
            w = g.w[pos]
            w = w.to(torch.int32) if weight_bits == 8 else \
                quantise_weights(w, weight_bits)
            cand = m + w
            keep = ~done[nb]
            tent.scatter_reduce_(0, nb[keep], cand[keep], "amin")


def component_labels(edges, n: int):
    """(n,) int64: each vertex's component as its minimum vertex id, on a
    symmetrised edge list."""
    lab = torch.arange(n, dtype=torch.int64, device=edges.device)
    while True:
        before = lab.clone()
        for _, u, v in edge_pieces(edges):
            lab.scatter_reduce_(0, v, lab[u], "amin")
        while True:                          # pointer jumping
            nxt = lab[lab]
            if torch.equal(nxt, lab):
                break
            lab = nxt
        if torch.equal(before, lab):
            return lab


def component_edges(edges, lab):
    """(n,) int64: per component label, its undirected input edges (the
    directed entries whose source it holds, halved: the list is
    symmetrised, so both ends of every edge lie in one component)."""
    count = torch.zeros(lab.numel(), dtype=torch.int64, device=lab.device)
    for _, u, _ in edge_pieces(edges):
        count += torch.bincount(lab[u], minlength=lab.numel())
    return count // 2
