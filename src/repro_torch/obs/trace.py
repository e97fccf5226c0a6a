"""In-program per-level traces (DESIGN.md sec. 13), the port of
`repro/obs/trace.py`.

When a session's `BFSConfig(telemetry=True)`, the `FrontierEngine` keeps
the per-level record built here beside each search and `assemble_traces`
turns it into one host `LevelTrace` per search.  Per level, per processor:

  frontier    global frontier count ENTERING the level (the total the
              level loop read, the same the direction heuristic consumes)
  front_dev   this processor's own frontier count entering the level
  scanned     edges scanned this level on this processor (the expand stamp)
  folded      entries this processor folded to owners (the fold stamp)
  wire        fold wire bytes this processor sent (the exchange stamp): the
              exchange strategy's scaling of the codec's static
              `wire_bytes(grid)` for set folds, plus the count-proportional
              value-channel bytes for value folds
  msgs        point-to-point fold messages this processor sent (the
              strategy's `msgs_per_exchange`: C-1 flat, log2(C) butterfly)
  dir         direction the level ran (0 top-down / 1 bottom-up)

The device side is one (R, C, levels) tensor per channel on the search's
device -- (Rl, Cl, levels) across a process group, the rank's block.
After every step the level loop writes slot min(k, L-1) of each
(L = max_levels): copies from the step's device tensors, fills from the
values the host already holds (the frontier total it read, the static wire
and message counts, the direction), so telemetry adds no host read per
level.  The tensors hold min(L, 64) levels at first and double, up to L,
when a search runs past them: the value programs bound their loops by
L = n + 1, and P * (n + 1) slots a channel would not fit beside a SCALE 26
graph.  `assemble_traces` reads each search's levels once, at the end, and
builds the `LevelTrace` with numpy as the JAX package does; across a
process group it fetches every rank's channels in that one read (the JAX
engine's `fetch_all`), so every rank builds the same trace.  JAX's
uint32 channels (`scanned`, `wire`) are int64 tensors here, wrapped modulo
2^32 where JAX wraps.  Telemetry is off by default, keyed into every engine
cache, and outputs are identical either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Channel order of the per-search trace outputs the engine appends after
# `edges_scanned`, plus one trailing level counter `k`.
TRACE_CHANNELS = ("frontier", "front_dev", "scanned", "folded", "wire",
                  "msgs", "dir")
N_TRACE_OUTS = len(TRACE_CHANNELS) + 1
U32_MASK = 0xFFFFFFFF
FIRST_LEVELS = 64               # levels the record holds before it grows
_DTYPES = {"frontier": torch.int32, "front_dev": torch.int32,
           "scanned": torch.int64, "folded": torch.int32,
           "wire": torch.int64, "msgs": torch.int32, "dir": torch.int32}


# ----------------------------------------------------------------------------
# Device side: the per-search record
# ----------------------------------------------------------------------------

def init_trace(max_levels: int, block, device) -> dict:
    """Fresh per-search trace: every channel (Rl, Cl, min(max_levels, 64))
    on `device` (block: the (Rl, Cl) processors recorded, a grid's whole
    (R, C) on the stacked grid), `dir` at -1 (unused level); the host
    level counter k and the bound L = max_levels."""
    L = int(max_levels)
    shape = (int(block[0]), int(block[1]), min(L, FIRST_LEVELS))
    tr = {c: torch.full(shape, -1 if c == "dir" else 0, dtype=dt,
                        device=device) for c, dt in _DTYPES.items()}
    tr["k"] = 0
    tr["L"] = L
    return tr


def _grow(tr: dict) -> None:
    """Double every channel's levels (up to L), padding as `init_trace`."""
    cap = tr["dir"].shape[-1]
    new = min(tr["L"], 2 * cap)
    for c in TRACE_CHANNELS:
        t = tr[c]
        pad = torch.full(t.shape[:-1] + (new - cap,), -1 if c == "dir" else 0,
                         dtype=t.dtype, device=t.device)
        tr[c] = torch.cat([t, pad], dim=-1)


def normalize_aux(aux: "dict | None") -> dict:
    """Fill the optional step-aux channel (a missing key records 0)."""
    aux = aux or {}
    return {c: aux.get(c, 0) for c in ("folded", "wire", "msgs", "dir")}


def record_level(tr: dict, *, frontier, front_dev, scanned, aux) -> dict:
    """Record one level at slot min(k, L-1), in place; returns the carry.

    frontier: the global count (int); front_dev: (Rl, Cl) tensor; scanned:
    (Rl * Cl,) or (Rl, Cl) tensor of per-processor edges; aux:
    `normalize_aux`'s dict, each entry an int (the same on every
    processor) or an (Rl, Cl) tensor."""
    k = min(tr["k"], tr["L"] - 1)
    if k >= tr["dir"].shape[-1]:
        _grow(tr)
    vals = dict(aux, frontier=frontier, front_dev=front_dev,
                scanned=scanned & U32_MASK, wire=aux["wire"] & U32_MASK)
    for c in TRACE_CHANNELS:
        slot = tr[c][:, :, k]
        v = vals[c]
        if isinstance(v, torch.Tensor):
            slot.copy_(v.reshape(slot.shape))
        else:
            slot.fill_(v)
    tr["k"] += 1
    return tr


def trace_outputs(tr: dict) -> tuple:
    """The record as the engine's extra per-search outputs (fixed order)."""
    return tuple(tr[c] for c in TRACE_CHANNELS) + (tr["k"],)


# ----------------------------------------------------------------------------
# Host side
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class LevelTrace:
    """One search's per-level telemetry, global + per-processor.

    Arrays are truncated to the levels actually run; `*_dev` arrays carry a
    leading P = R*C processor axis in row-major grid order (p = i*C + j),
    the order of the JAX package's gathered (R, C, L) outputs."""
    program: str
    codec: str
    grid: tuple                 # (R, C)
    n_levels: int
    frontier: np.ndarray        # (n_levels,) int64 global frontier entering
    frontier_dev: np.ndarray    # (P, n_levels) int64 per-processor frontier
    scanned: np.ndarray         # (n_levels,) int64 global edges scanned
    scanned_dev: np.ndarray
    folded: np.ndarray          # (n_levels,) int64 global folded entries
    folded_dev: np.ndarray
    wire_bytes: np.ndarray      # (n_levels,) int64 global fold wire bytes
    wire_dev: np.ndarray
    msgs: np.ndarray            # (n_levels,) int64 global fold messages sent
    msgs_dev: np.ndarray
    direction: np.ndarray       # (n_levels,) int32: 0 top-down / 1 bottom-up

    @property
    def total_wire_bytes(self) -> int:
        return int(self.wire_bytes.sum())

    @property
    def total_msgs(self) -> int:
        return int(self.msgs.sum())

    @property
    def total_scanned(self) -> int:
        return int(self.scanned.sum())

    def levels(self) -> list:
        """Per-level dict rows (what benches serialize)."""
        return [
            {"level": k, "frontier": int(self.frontier[k]),
             "scanned": int(self.scanned[k]),
             "folded": int(self.folded[k]),
             "wire_bytes": int(self.wire_bytes[k]),
             "msgs": int(self.msgs[k]),
             "dir": int(self.direction[k])}
            for k in range(self.n_levels)]

    def to_dict(self) -> dict:
        return {"program": self.program, "codec": self.codec,
                "grid": list(self.grid), "n_levels": self.n_levels,
                "levels": self.levels()}


def _one_trace(chans, k, *, grid, program, codec) -> LevelTrace:
    n = min(int(k), chans["dir"].shape[-1])
    i64 = np.int64
    f_dev = chans["front_dev"][:, :n].astype(i64)
    s_dev = chans["scanned"][:, :n].astype(i64)
    c_dev = chans["folded"][:, :n].astype(i64)
    w_dev = chans["wire"][:, :n].astype(i64)
    m_dev = chans["msgs"][:, :n].astype(i64)
    return LevelTrace(
        program=program, codec=codec, grid=(grid.R, grid.C), n_levels=n,
        frontier=chans["frontier"][0, :n].astype(i64), frontier_dev=f_dev,
        scanned=s_dev.sum(axis=0), scanned_dev=s_dev,
        folded=c_dev.sum(axis=0), folded_dev=c_dev,
        wire_bytes=w_dev.sum(axis=0), wire_dev=w_dev,
        msgs=m_dev.sum(axis=0), msgs_dev=m_dev,
        direction=np.asarray(chans["dir"][0, :n], np.int32))


def assemble_traces(traw, B, *, grid, program: str, codec: str,
                    fetch=None):
    """Per-search trace outputs -> LevelTrace (B=None) or a tuple of B.

    `traw` holds one `trace_outputs` tuple per search (one for a scalar
    search): every channel (Rl, Cl, levels) on the device, then k.  The
    levels a search recorded (min(k, levels); a clamped search filled all
    L) are read to the host in one copy a search, after `fetch` (the
    topology's: a rank's blocks -> the whole grid's, on every rank; None
    = the record is the whole grid's).  `frontier` / `dir` are the same
    on every processor, so processor 0's row is the global figure; the
    work channels are per processor and sum to the global figures."""
    traces = []
    for t in traw:
        n = min(int(t[-1]), t[0].shape[-1])
        chans = torch.stack([a[:, :, :n].to(torch.int64) for a in t[:-1]],
                            dim=2)                  # (Rl, Cl, 7, n)
        if fetch is not None:
            chans = fetch(chans)                    # (R, C, 7, n)
        host = chans.movedim(2, 0).cpu().numpy()
        traces.append(_one_trace(
            {c: host[ci].reshape(-1, n) for ci, c in
             enumerate(TRACE_CHANNELS)}, t[-1], grid=grid, program=program,
            codec=codec))
    return traces[0] if B is None else tuple(traces)
