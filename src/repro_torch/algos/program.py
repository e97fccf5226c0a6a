"""The `FrontierProgram` contract (DESIGN.md sec. 8), the port of
`repro/algos/program.py`.

A frontier program is a distributed graph algorithm expressed against the
2D-partitioned engine: per-vertex state, a per-level step that expands the
frontier and folds to the owners, and a convergence predicate.  The engine
(`repro_torch.algos.engine.FrontierEngine`) supplies the eager level loop.

The blocks below make the "value propagation" level shared by connected
components, SSSP and multi-source BFS (`cc.py`, `sssp.py`, `multi_bfs.py`):

  expand exchange of frontier + payload (`plan_values`)  ->  chunked CSC
  scan min-combining relaxed payloads into a dense per-local-row candidate
  array (`scan_relax`)  ->  canonical per-owner buckets of the improved rows
  (`pack_blocks`)  ->  value-carrying fold (`FoldCodec.fold_values`)  ->
  scatter-min merge into the owned block (`scatter_min_received`)  ->  the
  next frontier from the changed owned rows (`owned_to_front`).

Everything is min-combined, so results do not depend on delivery order and
every fold codec gives the same outputs.  State is stacked over the
topology's block of the grid (`dist.topology.LocalBlock`): (Rl, Cl, ...)
arrays, processor (i, j) at `local.loc(i, j)`, the loops over the block's
processors explicit.  On the stacked grid the block is the whole grid;
across a process group every read of another processor's data goes through
the topology's collectives, and grid-wide outputs through `topo.fetch`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import frontier as F
from repro_torch.core.types import Grid2D

I32_MAX = 2**31 - 1


class FrontierProgram:
    """What a distributed frontier algorithm implements.

    The engine calls, per search: `init`, `make_step` and `plan`, then the
    loop -- one host read of the plan's counts, `keep_going`, the step,
    `plan` again -- and finally `finalize`; `assemble` turns the per-search
    outputs into the program's output object.  `extra` is the program's
    per-processor graph arrays beyond the CSC (the CSR twin for direction
    optimisation), stacked (R, C, ...).
    """
    name = "?"
    codec_hint = "list"
    n_extra = 0          # per-processor graph arrays beyond the CSC
    n_csr_extra = 2      # what the bottom-up twin appends: the CSR twin's
                         #   row_off, col_idx (+ CSR-ordered weights, SSSP)
    uses_bottomup = False

    @property
    def key(self) -> tuple:
        """Programs with equal keys may share an engine (with the config's
        knobs, `BFSConfig.algo_engine_key`)."""
        return (self.name,)

    def init(self, engine, graph, arg):
        """Stacked initial state for one search argument."""
        raise NotImplementedError

    def plan(self, engine, graph, st):
        """The level's device-side preparation.  Its `counts` attribute is
        a (1 + P,) int64 tensor: the global frontier size, then every
        processor's edges to scan -- the loop's ONE host read per level."""
        raise NotImplementedError

    def make_step(self, engine, graph, extra=()):
        """Return step(state, plan, counts) -> (state', edges scanned this
        level, aux), counts being the plan's counts as read (ints).  extra:
        the program's first `n_extra` arrays.

        aux is the per-level telemetry channel (`obs.trace`): None when
        `engine.telemetry` is off (no step computes it then), else a dict
        with `scanned` (the plan's per-processor edge counts, a device
        tensor) and any of `folded`, `wire`, `msgs`, `dir` (ints or (R, C)
        tensors; a missing key records 0)."""
        raise NotImplementedError

    def make_bottomup_step(self, engine, graph, extra):
        """Bottom-up twin of `plan` + `make_step`, consuming the CSR arrays
        at the END of `extra`: returns (plan_fn, step_fn), plan_fn(state)
        -> a plan whose counts are the global frontier size then every
        processor's bottom-up edges to scan, and step_fn like `make_step`'s
        step.  Its state trajectory must equal the top-down step's, so the
        direction driver may mix directions level by level."""
        raise NotImplementedError(
            f"{self.name} has no bottom-up step; it cannot run under "
            f"direction optimisation")

    def front_count(self, st):
        """Every processor's own frontier size, (R, C) int32 (the trace's
        `front_dev` channel).  Every state in the port carries
        `front_cnt`; wrappers delegate to their inner program."""
        return st.front_cnt

    def keep_going(self, engine, st, total: int) -> bool:
        """Convergence predicate (True = run another level)."""
        raise NotImplementedError

    def finalize(self, engine, st) -> tuple:
        """Per-search output tensors."""
        raise NotImplementedError

    def assemble(self, engine, outs, B):
        """Per-search outputs -> output object (B=None for a scalar
        search, else the batch size)."""
        raise NotImplementedError

    # -- mid-traversal checkpointing (DESIGN.md sec. 15) ---------------------

    def level_count(self, st) -> int:
        """The state's 1-based level / iteration counter (a host int: the
        segmented driver's progress readout, no device read)."""
        raise NotImplementedError

    def export_state(self, engine, st, n: int) -> dict:
        """One search's stacked state -> flat dict of numpy arrays in
        GLOBAL vertex-id order, sliced to the raw `n` -- the
        grid-independent half of the checkpoint schema, the JAX package's
        array for array.  Must include a 0-d `levels_done` entry."""
        raise NotImplementedError(
            f"{self.name} does not support mid-traversal checkpointing")

    def import_state(self, engine, snap: dict):
        """Inverse of `export_state` onto ENGINE's grid (which need not be
        the grid that exported `snap`): a stacked state on the engine's
        device, re-padded to the new grid and with per-processor caches
        rebuilt from the authoritative global state."""
        raise NotImplementedError(
            f"{self.name} does not support mid-traversal checkpointing")


def pack_blocks(improved, vals, grid: Grid2D, fill_val=I32_MAX, ops=None):
    """Dense (..., n_rows_local) improvements -> canonical fold buckets.

    Local row m*S + t of block m maps to bucket row m, so the dense array IS
    the bucket structure after a reshape; per bucket, improved entries are
    front-packed ascending (the canonical form `FoldCodec.fold_values`
    requires).  Returns (ids (..., C, S) local-row ids pad -1, cnt
    (..., C), vals (..., C, S) aligned, pad `fill_val`).

    ops: the fold-kernel bundle for `core.frontier.compact_offsets`, which
    front-packs the offsets; bit-identical either way."""
    C, S = grid.C, grid.S
    lead = improved.shape[:-1]
    imp = improved.reshape(-1, S)
    ts, cnt = F.compact_offsets(imp, ops)
    m = torch.arange(C, dtype=torch.int32,
                     device=imp.device).repeat(imp.shape[0] // C)[:, None]
    ok = ts >= 0
    # pads are -1, so m*S + ts cannot overflow and one mask suffices
    ids = torch.where(ok, m * S + ts, -1)
    vs = torch.where(ok, torch.gather(vals.reshape(-1, S), 1,
                                      ts.clamp(min=0).long()), fill_val)
    return (ids.reshape(lead + (C, S)), cnt.reshape(lead + (C,)),
            vs.reshape(lead + (C, S)))


def identity_relax(p, w):
    """The relax of label propagation and multi-source BFS: the payload
    travels unchanged."""
    return p


def global_order(owned, topo=None):
    """(R, C, S) owned blocks -> (n,) in global vertex order (processor
    (i, j) owns block b = j*R + i).  topo: the blocks are that topology's
    (Rl, Cl, S), fetched whole to every rank first."""
    if topo is not None:
        owned = topo.fetch(owned)
    return owned.transpose(0, 1).reshape(-1)


def owned_rows(x, grid: Grid2D, j0: int = 0):
    """(Rl, Cl, n_rows_local [+ 1], ...) -> every processor's owned block
    (Rl, Cl, S, ...), a copy: processor (i, j) owns local rows j*S ..
    j*S + S - 1.  j0: the grid column of the block's first column."""
    C, S = grid.C, grid.S
    Rl, Cl = x.shape[:2]
    blocks = x[:, :, :grid.n_rows_local].reshape((Rl, Cl, C, S)
                                                 + x.shape[3:])
    lj = torch.arange(Cl, device=x.device)
    return blocks[:, lj, j0 + lj]


def set_owned_rows(x, owned, grid: Grid2D, j0: int = 0) -> None:
    """Write (Rl, Cl, S) `owned` into every processor's owned block of the
    contiguous (Rl, Cl, n_rows_local) `x`, in place."""
    Rl, Cl = x.shape[:2]
    lj = torch.arange(Cl, device=x.device)
    x.view(Rl, Cl, grid.C, grid.S)[:, lj, j0 + lj] = owned


# ----------------------------------------------------------------------------
# Shared state of the min-monoid value programs (CC, SSSP)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class ValueState:
    """Stacked state of a min-monoid value-propagation program.

    `val` spans ALL local rows (n/R), generalising the BFS visited bitmap:
    the owned block is the authoritative value, remote rows are this
    processor's send-suppression cache (the smallest value it has proposed
    or seen for that vertex)."""
    val: torch.Tensor        # (R, C, n_rows_local) int32, I32_MAX = top
    front: torch.Tensor      # (R, C, S) local col ids, ascending, pad -1
    payload: torch.Tensor    # (R, C, S) int32 values aligned with front
    front_cnt: torch.Tensor  # (R, C) int32
    it: int                  # 1-based iteration counter


# ----------------------------------------------------------------------------
# Level building blocks
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class ValuePlan:
    """A top-down value level's expand exchange and scan workload, before
    the host read."""
    all_front: torch.Tensor    # (R, C, n_cols_local) int32
    all_payload: torch.Tensor  # (R, C, n_cols_local) int32
    front_total: torch.Tensor  # (R, C) int32
    cumul: list                # per processor: (ncl + 1,) int32
    counts: torch.Tensor       # (1 + P,) int64: global frontier, then every
                               #   processor's edges to scan


def scan_workload(engine, graph, all_front, front_total, front_cnt):
    """Every processor's CSC scan workload over its gathered frontier:
    (per processor (ncl + 1,) int32 cumul, and the (1 + P,) int64 counts --
    the global frontier size, then every processor's edges to scan -- that
    the engine reads once per level)."""
    topo = engine.topo
    loc = topo.local.loc
    cumul, totals = [], []
    for i, j in topo.coords():
        li, lj = loc(i, j)
        c, t = F.scan_plan(graph.col_off[li, lj], all_front[li, lj],
                           front_total[li, lj])
        cumul.append(c)
        totals.append(t)
    counts = torch.stack([topo.psum_all(front_cnt)] + totals)
    return cumul, counts.to(torch.int64)


def plan_values(engine, graph, st, fill: int) -> ValuePlan:
    """Expand exchange of frontier + payload (`fill` pads the payload
    channel) and every processor's scan workload."""
    from repro_torch.dist import exchange as X

    all_front, all_pay, ftot = X.expand_exchange_values(
        st.front, st.front_cnt, st.payload, topo=engine.topo, fill=fill,
        ops=engine.fold_ops)
    cumul, counts = scan_workload(engine, graph, all_front, ftot,
                                  st.front_cnt)
    return ValuePlan(all_front, all_pay, ftot, cumul, counts)


def own_slots(n: int, n_rows: int, device):
    """Lane t's own index t mod n_rows: where a masked lane adds min's
    identity, instead of every masked lane meeting on one sink slot."""
    return torch.arange(n, dtype=torch.int64, device=device) % n_rows


def scan_relax(col_off, row_idx, edge_vals, all_front, all_payload,
               front_total, relax, *, n_rows: int, edge_chunk: int = 8192,
               expand_fn=None, plan=None, cand=None):
    """Chunked CSC scan of the gathered frontier, min-combining relaxed
    payloads into a dense per-local-row candidate array.

    For each edge u -> v of a frontier column u it proposes
    `relax(payload[u], edge_vals[edge])` for v; proposals for one v combine
    by MIN, so the result does not depend on scan order.  expand_fn: the
    value-carrying chunk kernel (`repro_torch.kernels.expand.
    expand_chunk_values`); None = the plain reference scan.  plan:
    `(cumul, total)` with total an int, when the caller already ran
    `scan_plan`; cand: the (n_rows,) int32 array to combine into, in place
    (None = a fresh one).  Returns (cand, edges scanned)."""
    if plan is None:
        cumul, total = F.scan_plan(col_off, all_front, front_total)
        total = int(total)
    else:
        cumul, total = plan
    dev = col_off.device
    if cand is None:
        cand = torch.full((n_rows,), I32_MAX, dtype=torch.int32, device=dev)
    lanes = torch.arange(edge_chunk, dtype=torch.int32, device=dev)
    slots = own_slots(edge_chunk, n_rows, dev)
    for start in range(0, total, edge_chunk):
        if expand_fn is None:
            v, _, k, addr, valid = F.reference_expand_chunk(
                start + lanes, cumul, all_front, front_total, col_off,
                row_idx)
            pay = all_payload[k]
        else:
            v, pay, addr, valid = expand_fn(start, edge_chunk, cumul,
                                            all_front, all_payload,
                                            front_total, col_off, row_idx)
        w = None if edge_vals is None else edge_vals[addr]
        val = torch.where(valid, relax(pay, w), I32_MAX)
        cand.scatter_reduce_(0, torch.where(valid, v.long(), slots), val,
                             "amin")
    return cand, total


def scatter_min_received(recv_ids, recv_vals, j, S: int):
    """Fold-received (..., C, S) owned rows j*S + t and aligned values ->
    (..., S) per-owned-row MIN over all senders (I32_MAX where nothing
    arrived).  j: the receiver's grid column, broadcastable against
    recv_ids.  A pad adds I32_MAX at its own slot."""
    lead = recv_ids.shape[:-2]
    got = recv_ids >= 0
    slot = torch.arange(S, dtype=torch.int64, device=recv_ids.device)
    t = torch.where(got, (recv_ids - j * S).long(), slot)
    inc = torch.full(lead + (S,), I32_MAX, dtype=torch.int32,
                     device=recv_ids.device)
    inc.scatter_reduce_(-1, t.reshape(lead + (-1,)),
                        torch.where(got, recv_vals, I32_MAX)
                        .reshape(lead + (-1,)), "amin")
    return inc


def owned_to_front(changed, vals, grid: Grid2D, fill_val=I32_MAX, ops=None,
                   i0: int = 0):
    """Changed owned rows -> next frontier, canonical ascending.

    changed / vals: (Rl, Cl, S).  Owned local row j*S + t of processor
    (i, j) becomes local col i*S + t (paper ROW2COL).  Returns (front
    (Rl, Cl, S) col ids pad -1, payload aligned pad `fill_val`, cnt
    (Rl, Cl)).  i0: the grid row of the block's first row.  ops: the
    fold-kernel bundle for the compaction (bit-identical either way)."""
    S = grid.S
    Rl, Cl = changed.shape[:2]
    ts, cnt = F.compact_offsets(changed.reshape(Rl * Cl, S), ops)
    ok = ts >= 0
    payload = torch.where(ok, torch.gather(vals.reshape(Rl * Cl, S), 1,
                                           ts.clamp(min=0).long()), fill_val)
    i_s = torch.arange(i0, i0 + Rl, dtype=torch.int32,
                       device=changed.device).view(Rl, 1, 1) * S
    front = torch.where(ok.view(Rl, Cl, S), i_s + ts.view(Rl, Cl, S), -1)
    return front, payload.view(Rl, Cl, S), cnt.view(Rl, Cl)


def value_fold_aux(engine, plan, cnt, direction: int) -> dict:
    """The telemetry aux of a level whose fold is a value fold (the value
    programs' step, the BFS bottom-up step): cnt (R, C, C) entries per
    destination bucket.  Its wire bytes are the strategy-scaled static
    frame plus the count-proportional value channel (on the flat route,
    the codec's `wire_bytes_values_sent`)."""
    grid, strat = engine.grid, engine.exchange
    cols = engine.topo.local.cols(cnt.device).to(torch.int64).view(1, -1)
    return {"scanned": plan.counts[1:],
            "folded": cnt.sum(dim=-1, dtype=torch.int32),
            "wire": strat.wire_bytes(engine.codec.wire_bytes(grid), grid.C)
            + strat.value_extra_bytes(cnt, cols, grid.C),
            "msgs": strat.msgs_per_exchange(grid.C), "dir": direction}


def make_value_step(engine, graph, *, relax, edge_vals=None, scan=None):
    """The min-monoid level step shared by CC and SSSP, the port of JAX's
    `make_value_step`.

    scan -> suppress (strict improvements over the local cache only) ->
    pack_blocks -> codec fold_values -> scatter-min merge into the owned
    block -> the next frontier from the changed owned rows.  `relax(p, w)`
    is the per-edge proposal; edge_vals the (R, C, e_max) per-edge values
    it reads (or None).  scan: `(state, plan, block_edges) -> cand
    (R, C, n_rows_local)`, the bottom-up pull scan
    (`algos.direction.make_pull_scan`); None = the top-down `scan_relax`
    over a `plan_values` plan.  Returns step(state, plan, counts) ->
    (state', edges scanned, aux); aux records direction 1 under the pull
    scan."""
    from repro_torch.dist.exchange import receiver_cols

    grid, topo = engine.grid, engine.topo
    i0, j0 = topo.local.i0, topo.local.j0
    step_dir = 0 if scan is None else 1
    if scan is None:
        scan = push_scan(engine, graph, relax=relax, edge_vals=edge_vals)

    def step(st: ValueState, plan, counts):
        cand = scan(st, plan, counts[1:])
        owned_prev = owned_rows(st.val, grid, j0)
        improved = cand < st.val          # strict improvements only
        torch.minimum(st.val, cand, out=st.val)
        ids, cnt, vals = pack_blocks(improved, cand, grid,
                                     ops=engine.fold_ops)
        del cand, improved
        ri, _, rv = engine.codec.fold_values(ids, cnt, vals, topo=topo)
        aux = value_fold_aux(engine, plan, cnt, step_dir) \
            if engine.telemetry else None
        inc = scatter_min_received(ri, rv, receiver_cols(topo), grid.S)
        # merge against the PRE-scan owned block: this processor's own
        # proposals travel through the self bucket of the exchange
        new_owned = torch.minimum(owned_prev, inc)
        changed = new_owned < owned_prev
        set_owned_rows(st.val, new_owned, grid, j0)
        front, payload, nc = owned_to_front(changed, new_owned, grid,
                                            ops=engine.fold_ops, i0=i0)
        return (ValueState(val=st.val, front=front, payload=payload,
                           front_cnt=nc, it=st.it + 1), sum(counts[1:]), aux)

    return step


def push_scan(engine, graph, *, relax, edge_vals=None):
    """The top-down scan of a value level: `scan_relax` on every processor
    over a `plan_values` plan.  Returns scan(state, plan, block_edges) ->
    cand (Rl, Cl, n_rows_local)."""
    grid, topo = engine.grid, engine.topo
    nrl = grid.n_rows_local
    blk = topo.local

    def scan(st, plan, block_edges):
        cand = torch.full((blk.Rl, blk.Cl, nrl), I32_MAX, dtype=torch.int32,
                          device=engine.device)
        for p, (i, j) in enumerate(topo.coords()):
            li, lj = blk.loc(i, j)
            scan_relax(graph.col_off[li, lj], graph.row_idx[li, lj],
                       None if edge_vals is None else edge_vals[li, lj],
                       plan.all_front[li, lj], plan.all_payload[li, lj],
                       plan.front_total[li, lj], relax, n_rows=nrl,
                       edge_chunk=engine.edge_chunk,
                       expand_fn=engine.value_expand_fn,
                       plan=(plan.cumul[p], block_edges[p]),
                       cand=cand[li, lj])
        return cand

    return scan


# ----------------------------------------------------------------------------
# Checkpoint-schema helpers (DESIGN.md sec. 15)
#
# Export reads the stacked (R, C, ...) state into GLOBAL vertex-id order;
# import rebuilds a grid's stacked layout from the global arrays.  Both
# live on the partition identities of DESIGN.md sec. 2: processor (i, j)'s
# owned block b = j*R + i covers global ids [(j*R + i)*S, (j*R + i + 1)*S),
# its local rows run over blocks m*R + i for m in 0..C-1, and owned local
# row j*S + t converts to local col i*S + t (ROW2COL).
# ----------------------------------------------------------------------------

def rows_to_global(grid: Grid2D, i: int) -> np.ndarray:
    """Global vertex ids of grid row i's local rows, in local-row order
    (identical for every processor in grid row i -- the j-independence
    that lets import fill ALL local rows from one gather)."""
    R, C, S = grid.R, grid.C, grid.S
    return ((np.arange(C)[:, None] * R + i) * S
            + np.arange(S)[None, :]).reshape(-1)


def owned_from_global(g, grid: Grid2D, local=None):
    """(n,) global-order tensor -> its (R, C, S) owned blocks, a view (the
    inverse of `global_order`).  local: a `topology.LocalBlock`, whose
    (Rl, Cl, S) blocks are sliced out."""
    owned = g.view(grid.C, grid.R, grid.S).transpose(0, 1)
    if local is not None:
        owned = owned[local.i0:local.i0 + local.Rl,
                      local.j0:local.j0 + local.Cl]
    return owned


def rows_from_global(g, grid: Grid2D, local=None):
    """(n,) global-order tensor -> (R, C, n_rows_local): every local row of
    processor (i, j) holds the value of its vertex, `rows_to_global(grid,
    i)` as one view (block m of grid row i is global block m*R + i).
    local: a `topology.LocalBlock`, whose (Rl, Cl, ...) rows only are
    built."""
    R, C, S = grid.R, grid.C, grid.S
    rows = g.view(C, R, S).transpose(0, 1).reshape(R, C * S)
    i0, Rl, Cl = (0, R, C) if local is None \
        else (local.i0, local.Rl, local.Cl)
    return rows[i0:i0 + Rl].unsqueeze(1).expand(Rl, Cl, C * S).contiguous()


def front_mask(front, front_cnt, grid: Grid2D, i0: int = 0):
    """(Rl, Cl, S) frontier col ids (valid first `front_cnt`) -> (Rl, Cl,
    S) bool over the owned block's rows (col i*S + t is owned row t).
    i0: the grid row of the block's first row."""
    S = grid.S
    Rl, Cl = front.shape[:2]
    dev = front.device
    valid = torch.arange(S, device=dev) < front_cnt[..., None]
    i_s = torch.arange(i0, i0 + Rl, dtype=torch.int32,
                       device=dev).view(Rl, 1, 1) * S
    # pads mark the spare slot S, dropped below
    t = torch.where(valid, front - i_s, S).long()
    m = torch.zeros((Rl, Cl, S + 1), dtype=torch.bool, device=dev)
    m.scatter_(2, t, True)
    return m[:, :, :S]


def host(x, n: int) -> np.ndarray:
    """A global-order tensor's first n entries as a host numpy array."""
    return x[:n].cpu().numpy()


def padded_global(a, grid: Grid2D, fill, device, dtype=torch.int32):
    """A raw (n_raw,) snapshot array -> (grid.n,) tensor on device, the new
    grid's padding vertices set to `fill` (a scalar, or "gid": their own
    global ids)."""
    a = torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                     dtype=dtype)
    n_raw = a.shape[0]
    if fill == "gid":
        tail = torch.arange(n_raw, grid.n, dtype=dtype, device=device)
    else:
        tail = torch.full((grid.n - n_raw,), fill, dtype=dtype,
                          device=device)
    return torch.cat([a, tail])


def export_value_state(grid: Grid2D, st: ValueState, n: int,
                       topo=None) -> dict:
    """ValueState -> global snapshot (JAX's `export_value_state`).

    `val` exports the RAW owned blocks (I32_MAX = top; programs whose
    finalize remaps sentinels do so only at output time), `in_front` is the
    explicit frontier mask (value frontiers are not derivable from `val`
    alone), and the frontier payloads are NOT stored -- they equal the owned
    value at the frontier rows, which import re-reads.  topo: the state's
    topology; across a process group both are fetched whole to every
    rank.
    """
    blk = None if topo is None else topo.local
    i0, j0 = (0, 0) if blk is None else (blk.i0, blk.j0)
    val = global_order(owned_rows(st.val, grid, j0), topo)
    in_front = global_order(front_mask(st.front, st.front_cnt, grid, i0),
                            topo)
    return {"val": host(val, n), "in_front": host(in_front, n),
            "it": np.asarray(st.it, np.int64),
            "levels_done": np.asarray(st.it - 1, np.int64)}


def import_value_state(grid: Grid2D, snap: dict, device, pad: str = "max",
                       ops=None, local=None) -> ValueState:
    """Global snapshot -> ValueState on `grid` (JAX's
    `import_value_state`), of the block `local` (a `topology.LocalBlock`;
    None = the whole grid).

    Every local row takes the authoritative global value: the owned block
    exactly, and remote rows get a send-suppression cache that is a SUPERSET
    of any organically-grown one -- suppressed proposals would have carried
    cand >= the owner's current value, invisible to the min-merge and the
    strict `changed` mask, so resumed trajectories stay bit-identical.

    pad: value for the new grid's padding vertices (>= the raw n): "max"
    (I32_MAX -- never-visited sentinel, SSSP) or "gid" (own global id --
    CC's converged self-label, what an uninterrupted run holds there after
    level 1).  ops: the fold-kernel bundle for the frontier's compaction.
    """
    gv = padded_global(snap["val"], grid, I32_MAX if pad == "max" else pad,
                       device)
    inf = padded_global(snap["in_front"], grid, False, device,
                        dtype=torch.bool)
    front, payload, cnt = owned_to_front(
        owned_from_global(inf, grid, local),
        owned_from_global(gv, grid, local), grid, ops=ops,
        i0=0 if local is None else local.i0)
    return ValueState(val=rows_from_global(gv, grid, local), front=front,
                      payload=payload, front_cnt=cnt, it=int(snap["it"]))
