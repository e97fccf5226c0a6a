"""Process-group bootstrap, placement and the wire (DESIGN.md sec. 14), the
port of `repro/dist/multihost.py` over `torch.distributed`.

The stacked grid (`dist.topology.StackedTopology`) holds every processor of
the R x C grid on one device.  Across a process group each rank holds a
rectangular block of it instead, and the exchanges become collectives
(`dist.topology.GroupTopology`).  This module is the whole process-group
surface:

  initialize()      `torch.distributed.init_process_group`: NCCL on a CUDA
                    device, gloo on the CPU or when asked for.
  is_multiprocess() more than one rank in the group.
  global_mesh()     the grid's `ProcessMesh`: rank p holds the row-major run
                    of processors [p*L, (p+1)*L), L = R*C / world -- the
                    devices process p owns in the JAX package's
                    `global_mesh` (all devices in process order, reshaped
                    row-major).  With `processes=k` the mesh spans the
                    first k ranks only, over a sub-group (the survivor
                    grid of an elastic shrink, JAX's `jax.devices()[:R*C]`);
                    every rank of the world calls it, the others get None.
  put_dev()         a host (R, C, ...) array -> this rank's (Rl, Cl, ...)
                    blocks on its device (every rank holds the same host
                    copy).
  put_replicated()  a host array whole on this rank's device.
  fetch()           this rank's (Rl, Cl, ...) blocks -> the whole
                    (R, C, ...) array on every rank (`process_allgather`).
  raise_together()  one member's failure raised on every member, so no
                    rank waits in a collective its peers never reach.
  broadcast_tree()  a rank's output (dataclasses, tuples, tensors) to every
                    rank of a group.
  axis_all_to_all() / axis_all_gather()
                    JAX's all_to_all / all_gather over one named mesh axis
                    for every processor of the rank's block (the
                    expert-parallel MoE's dispatch and FSDP gather).

The wire: every tensor crosses the group as a uint8 view of its contiguous
bytes and is viewed back to its dtype on arrival -- bit-exact for every
dtype, and gloo refuses uint16, uint32 and int16 tensors but takes uint8.
Under gloo a CUDA tensor is staged through a host copy explicitly (nothing
relies on gloo's CUDA support); under NCCL device tensors go to the
collective as they are.  The reductions (`all_reduce_i64`) travel as int64,
which both backends take; `all_reduce_max_u8` merges uint8 marks and
`all_reduce_sum` sums floats in float32.

A mesh's collectives run in its own process group (`ProcessMesh.group`,
the world for `global_mesh()` without `processes=`), and its row and column
groups are built with it, on every rank of the world in the same order
(`new_group` is collective over the world).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import resolve_device

# the device and backend `initialize` bound this process to
_STATE = {"device": None, "backend": None}


def initialize(init_method: str, num_processes: int, process_id: int, *,
               device=None, backend: str | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the process group (once, before any graph is planned).

    init_method: the rendezvous, e.g. "file:///tmp/x/store" or
    "tcp://localhost:PORT" (no port is hard-wired here).  device: the
    rank's device (None = CUDA, raising without a card; "cpu" for the CPU
    tests).  backend: None = "nccl" on CUDA, "gloo" on the CPU; "gloo" may
    be asked for on CUDA too (its messages are then staged through the
    host).  timeout_s bounds every collective, so a rank whose peers have
    diverged or died fails instead of waiting for ever.  Returns the
    rank's device."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    _STATE.update(device=dev, backend=backend)
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None)


def is_initialized() -> bool:
    """Has this process joined a process group (`initialize`)?"""
    return dist.is_initialized()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def current_device() -> torch.device:
    """The device `initialize` bound this process to."""
    return _STATE["device"]


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The grid over the process group, and this rank's block of it.

    shape (R, C); the rank holds processors (i, j) with i0 <= i < i0 + Rl
    and j0 <= j < j0 + Cl -- the row-major run [rank*L, (rank+1)*L).
    `rank` and `world` count the mesh's members; `ranks` holds their
    global ranks in mesh order, `group` their process group (None = the
    world) and `groups` the row and column groups the topology
    exchanges in."""
    shape: tuple
    axis_names: tuple
    rank: int
    world: int
    i0: int
    j0: int
    Rl: int
    Cl: int
    device: torch.device
    backend: str
    ranks: tuple = ()
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    groups: Any = dataclasses.field(default=None, compare=False,
                                    repr=False)

    @property
    def block_grid(self) -> tuple:
        """(block rows, block columns) of the ranks' blocks."""
        return self.shape[0] // self.Rl, self.shape[1] // self.Cl

    def block_of(self, rank: int) -> tuple:
        """Rank `rank`'s (block row, block column)."""
        nbc = self.block_grid[1]
        return rank // nbc, rank % nbc

    def rank_of(self, bi: int, bj: int) -> int:
        """The mesh rank holding block (bi, bj)."""
        return bi * self.block_grid[1] + bj

    def global_rank(self, rank: int) -> int:
        """Mesh rank -> its rank in the world."""
        return self.ranks[rank] if self.ranks else rank


@dataclasses.dataclass(frozen=True)
class Groups:
    """A mesh's process groups: one per block row (the ranks of a
    processor-row) and one per block column."""
    rows: list
    cols: list


def _new_group(ranks):
    return dist.new_group(list(ranks))


def _build_groups(shape, Rl, Cl, ranks) -> Groups:
    """Every row group, then every column group, in the same order on every
    rank of the world (`new_group` is collective over it)."""
    nbr, nbc = shape[0] // Rl, shape[1] // Cl
    rows = [_new_group(ranks[bi * nbc + bj] for bj in range(nbc))
            for bi in range(nbr)]
    cols = [_new_group(ranks[bi * nbc + bj] for bi in range(nbr))
            for bj in range(nbc)]
    return Groups(rows, cols)


def block_shape(R: int, C: int, world: int) -> tuple:
    """(Rl, Cl) of every rank's block: L = R*C / world processors, a run
    within one grid row (L divides C) or whole grid rows (C divides L).
    Any other world raises a ValueError."""
    P = R * C
    if world < 1 or P % world:
        raise ValueError(f"a {R}x{C} grid cannot be split over {world} "
                         f"ranks: R*C = {P} is not a multiple of the world")
    L = P // world
    if C % L == 0:
        return 1, L
    if L % C == 0:
        return L // C, C
    raise ValueError(
        f"a {R}x{C} grid over {world} ranks gives each rank a run of "
        f"{L} processors, which is not a rectangle: the run length must "
        f"divide C = {C} or be a multiple of it")


def global_mesh(axis_shapes, axis_names=("r", "c"), *,
                processes: int | None = None) -> ProcessMesh | None:
    """The grid's mesh over the joined process group (every rank builds
    the same one).

    processes: the mesh spans the first `processes` ranks only (None =
    every rank), over a group of their own -- the counterpart of a JAX
    mesh over `jax.devices()[:R*C]`.  Every rank of the world must call
    this (the groups are created collectively); a rank outside the mesh
    gets None."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group: call "
                           "multihost.initialize(...) first")
    R, C = (int(x) for x in axis_shapes)
    full = dist.get_world_size()
    world = full if processes is None else int(processes)
    if not 1 <= world <= full:
        raise ValueError(f"a mesh over {world} processes in a world of "
                         f"{full}")
    Rl, Cl = block_shape(R, C, world)
    ranks = tuple(range(world))
    group = None if world == full else _new_group(ranks)
    groups = _build_groups((R, C), Rl, Cl, ranks)
    rank = dist.get_rank()
    if rank >= world:
        return None
    p0 = rank * Rl * Cl
    return ProcessMesh(shape=(R, C), axis_names=tuple(axis_names),
                       rank=rank, world=world, i0=p0 // C, j0=p0 % C,
                       Rl=Rl, Cl=Cl, device=_STATE["device"],
                       backend=_STATE["backend"], ranks=ranks, group=group,
                       groups=groups)


def put_dev(x, mesh: ProcessMesh):
    """Host (R, C, ...) array (numpy or tensor) -> this rank's
    (Rl, Cl, ...) blocks on its device.  No data moves between ranks."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    blk = x[mesh.i0:mesh.i0 + mesh.Rl, mesh.j0:mesh.j0 + mesh.Cl]
    return blk.to(mesh.device).contiguous()


def put_replicated(x, mesh: ProcessMesh):
    """Host array (search roots, source sets) whole on this rank's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh.device)


# ----------------------------------------------------------------------------
# The wire
# ----------------------------------------------------------------------------

def _staged(t: torch.Tensor) -> bool:
    return _STATE["backend"] == "gloo" and t.device.type != "cpu"


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """x's contiguous bytes as a flat uint8 tensor where the collective
    reads it: the host under gloo, x's device under NCCL."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    return b.cpu() if _staged(b) else b


def wire_buffer(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised uint8 receive buffer of `nbytes` where the
    collective writes it."""
    dev = torch.device("cpu") if _staged(like) else like.device
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def from_wire(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Received bytes -> a tensor of `like`'s dtype and device."""
    return buf.view(like.dtype).reshape(shape).to(like.device)


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every member's x stacked in group-rank order: (size, *x.shape)."""
    src = to_wire(x)
    buf = wire_buffer(size * src.numel(), x)
    dist.all_gather_into_tensor(buf, src, group=group)
    return from_wire(buf, x, (size,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """x (size, ...): x[k] goes to member k; returns recv (size, ...) with
    recv[k] what member k sent here."""
    src = to_wire(x)
    buf = wire_buffer(src.numel(), x)
    dist.all_to_all_single(buf, src, group=group)
    return from_wire(buf, x, x.shape)


def exchange_pair(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to global rank `peer` and receive its tensor of the same
    shape and dtype (one pairwise exchange)."""
    src = to_wire(x)
    buf = wire_buffer(src.numel(), x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, peer, group),
        dist.P2POp(dist.irecv, buf, peer, group)])
    for r in reqs:
        r.wait()
    return from_wire(buf, x, x.shape)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """All-reduce `t` where the backend reads it (the card under NCCL, the
    host under gloo); returns the result there."""
    t = t.to(_STATE["device"]) if _STATE["backend"] == "nccl" else t.cpu()
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_reduce_i64(values, group=None, op: str = "sum") -> torch.Tensor:
    """The elementwise int64 reduction ("sum", "min" or "max") of `values`
    (a tensor or ints) over the group, as a host int64 tensor."""
    t = torch.as_tensor(values).to(torch.int64).reshape(-1)
    return _reduce(t, op, group).cpu()


def all_reduce_max_u8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of a uint8 (or bool, as uint8) tensor over
    the group, on x's device."""
    return _reduce(x.to(torch.uint8), "max", group).to(x.device)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of a float tensor over the group, accumulated in
    float32 and returned in x's dtype on x's device (every member gets the
    same bits)."""
    return _reduce(x.to(torch.float32), "sum", group).to(x.device, x.dtype)


def _line(mesh: ProcessMesh, axis: int) -> tuple:
    """The group of the ranks on this rank's line along mesh dim `axis`
    (the other dim fixed) and its member count."""
    bi, bj = mesh.block_of(mesh.rank)
    if axis == 1:
        return mesh.groups.rows[bi], mesh.block_grid[1]
    return mesh.groups.cols[bj], mesh.block_grid[0]


def axis_all_to_all(x: torch.Tensor, mesh: ProcessMesh,
                    axis: int) -> torch.Tensor:
    """JAX's `all_to_all(x, axis_name, 0, 0)` over mesh dim `axis` for
    every processor of this rank's block: x (Rl, Cl, P, ...), x[li, lj, p]
    processor (i, j)'s payload for the processor at coordinate p along
    `axis` (P its size) -> recv (Rl, Cl, P, ...), recv[li, lj, p] what
    that processor sent to (i, j).  One all_to_all in the line's group."""
    Rl, Cl = x.shape[:2]
    tail = tuple(x.shape[3:])
    rest = tuple(range(4, 4 + len(tail)))
    group, k = _line(mesh, axis)
    if axis == 1:
        send = x.reshape((Rl, Cl, k, Cl) + tail).movedim(2, 0)
        recv = all_to_all(send, group, k)
        # recv[m, li, ls, lj]: member m's x[li, ls, my column lj]
        out = recv.permute((1, 3, 0, 2) + rest)
    else:
        send = x.reshape((Rl, Cl, k, Rl) + tail).movedim(2, 0)
        recv = all_to_all(send, group, k)
        # recv[m, ls, lj, li]: member m's x[ls, lj, my row li]
        out = recv.permute((3, 2, 0, 1) + rest)
    return out.reshape((Rl, Cl, mesh.shape[axis]) + tail)


def axis_all_gather(x: torch.Tensor, mesh: ProcessMesh,
                    axis: int) -> torch.Tensor:
    """JAX's `all_gather(x, axis_name)` over mesh dim `axis` for every
    processor of this rank's block: x (Rl, Cl, ...) -> (Rl, Cl, P, ...),
    out[li, lj, p] the x of the processor at coordinate p along `axis` on
    (i, j)'s line.  One all_gather in the line's group."""
    Rl, Cl = x.shape[:2]
    tail = tuple(x.shape[2:])
    group, k = _line(mesh, axis)
    g = all_gather(x, group, k)                       # (k, Rl, Cl, ...)
    if axis == 1:
        line = g.transpose(0, 1).reshape((Rl, k * Cl) + tail)
        return line.unsqueeze(1).expand((Rl, Cl, k * Cl) + tail)
    line = g.reshape((k * Rl, Cl) + tail).transpose(0, 1)
    return line.unsqueeze(0).expand((Rl, Cl, k * Rl) + tail)


def fetch(x, mesh: ProcessMesh | None = None):
    """This rank's (Rl, Cl, ...) blocks -> the whole (R, C, ...) array on
    every rank, an all-gather over the world (identity without a mesh)."""
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    nbr, nbc = mesh.block_grid
    g = all_gather(x, mesh.group, mesh.world)     # (world, Rl, Cl, ...)
    g = g.reshape((nbr, nbc, mesh.Rl, mesh.Cl) + tuple(x.shape[2:]))
    return g.transpose(1, 2).reshape(mesh.shape + tuple(x.shape[2:]))


def fetch_all(xs, mesh: ProcessMesh | None = None) -> tuple:
    """`fetch` over a tuple of outputs."""
    return tuple(fetch(x, mesh) for x in xs)


# ----------------------------------------------------------------------------
# Agreement: decisions every rank takes together
# ----------------------------------------------------------------------------

def _src(group, rank: int) -> int:
    """A group rank -> its rank in the world (broadcasts name the world's)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def broadcast_object(obj, group=None, src: int = 0):
    """Group rank `src`'s picklable `obj` on every member (the others pass
    anything)."""
    box = [obj]
    dist.broadcast_object_list(box, src=_src(group, src), group=group)
    return box[0]


def gather_objects(obj, group=None) -> list:
    """Every member's picklable `obj`, in group-rank order, on every
    member."""
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, obj, group=group)
    return every


def raise_together(err: BaseException | None, group=None) -> None:
    """Every member of `group` passes its own outcome (None = no failure);
    when any member failed, every member raises the same RuntimeError,
    naming the lowest failing rank and its error (that rank's chained to
    it).  So a failure on one rank stops its peers too, instead of leaving
    them in a collective it never reaches."""
    mine = None if err is None else f"{type(err).__name__}: {err}"
    for r, msg in enumerate(gather_objects(mine, group)):
        if msg is not None:
            raise RuntimeError(f"rank {r} of the process group failed: "
                               f"{msg}") from err
    return None


class _Tensor:
    """A tensor's place in a broadcast tree: its shape and dtype."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _map_leaves(x, fn, kind):
    """x with every leaf of type `kind` replaced by fn(leaf), through
    dataclasses, dicts, lists and tuples, in one fixed order."""
    if isinstance(x, kind):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_leaves(getattr(x, f.name), fn, kind)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _map_leaves(v, fn, kind) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(v, fn, kind) for v in x)
    return x


def broadcast_tree(tree, device, group=None, src: int = 0):
    """Group rank `src`'s `tree` (an output dataclass, tuples, dicts, lists
    of tensors and picklable values) on every member of `group`, its
    tensors on `device`.  The structure travels pickled, every tensor as
    its bytes on the uint8 wire, in the structure's order."""
    mine = dist.get_rank(group) == src
    tensors = []
    if mine:
        tree = _map_leaves(tree, lambda t: tensors.append(t) or _Tensor(t),
                           torch.Tensor)
    skel = broadcast_object(tree if mine else None, group, src)
    sent = iter(tensors)

    def receive(spec):
        like = torch.empty(0, dtype=spec.dtype, device=device)
        if mine:
            buf = to_wire(next(sent).to(device))
        else:
            buf = wire_buffer(int(np.prod(spec.shape, dtype=np.int64))
                              * like.element_size(), like)
        dist.broadcast(buf, src=_src(group, src), group=group)
        return from_wire(buf, like, spec.shape)
    return _map_leaves(skel, receive, _Tensor)
