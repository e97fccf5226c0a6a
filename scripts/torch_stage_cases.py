"""Inputs that stress the stages of the fused expand kernels (B1
`expand_chunk`, B8 `expand_chunk_values`), of the fused bottom-up kernels
(B7 `bottomup_chunk`, B9 `bottomup_chunk_values`), of B11
`visited_filter`, the two forms of B3 `pack_bits` / B4 `unpack_bits`, B2
`compact_rows` and B10 `binsearch_map`, made with numpy from one seed.

Stage 1 maps a block of consecutive edge ids to frontier slots, or to row
slots over the value-capped masked-degree cumsum in the bottom-up kernels
(`stage::workload_map_block` in `src/repro_torch/csrc/stages.cuh`); stage
3 dedups a tile through a hash table in shared memory (`stage::
filter_tile`).  The cases aim at what each could get wrong:

  EXPAND_CASES (B1 and B8; start, chunk length E)
    one_vertex     every live lane carries the same vertex
    congruent      vertices congruent modulo the 1024-slot table of tile 512
    all_visited    every visited bit set
    all_clear      no visited bit set, 50 rows: many duplicates a tile
    tile_1/3/384   chunk lengths 521, 1563 and 1152, which `pick_tile`
                   maps to tiles 1, 3 and 384
    zero_run       700 zero-degree frontier slots in a row, longer than a
                   block
    wide_slot      one frontier slot of degree 3000, spanning many blocks
    straddle       a chunk straddling the live total
    past_total     a chunk wholly past it
    front_total_0  an empty frontier
    ragged         E = 1000 from start 37: n_lanes % 256 != 0 for B8

  BOTTOMUP_CASES (B7 and B9; start, chunk length E, frontier block size;
  a kernel block maps 1024 lanes)
    zero_run       a visited (zero-width) run of 1500 rows, longer than a
                   block's lanes
    tail_run       the flat tail at and past the live total meeting a
                   zero-width run, in a chunk straddling the total
    wide_row       one row of degree 5000, spanning many blocks
    mostly_visited 99 % of 120000 rows visited: a block walks ~26000
                   slots, far more than its lanes, the chunk straddling
                   the live total
    sparse_live    99.8 % of 400000 rows visited: a block spans ~130000
                   slots, past the walk limit (the lane searches), the
                   chunk straddling the live total
    straddle       a chunk straddling the live total
    past_total     a chunk wholly past it
    total_0        every row visited: total = 0, every lane masked
    ragged         E = 1000 from start 37 (E % 1024 and E % 256 != 0)
    block_37       frontier blocks of 37 columns (block % 32 != 0)
    empty_frontier no frontier bit set
    full_frontier  every frontier bit set

  FILTER_CASES (B11, at each tile of FILTER_TILES, 4 tiles of lanes)
    one_vertex     every valid lane carries the same unvisited vertex
    congruent      vertices congruent modulo the tile's table size
    extremes       valid lanes with v = -1, INT32_MIN, INT32_MAX, 0, 31, 32
    all_visited    every visited bit set
    all_clear      no visited bit set, 40 distinct vertices a tile

  BITS_CASES (B3 and B4; an (N, S) mask and the (N, ceil(S/32)) words of
  it, their pad bits past S random; `csrc/bits.cu` takes its vector form
  when S % 16 == 0 and a row of bytes starts 16-byte aligned)
    aligned        N = 8, S = 4096
    half_word_tail S = 4112: the last word holds 16 bits, one 16-byte half
    odd_s          S = 4099, S % 16 != 0: the general form
    one_word_1/31/32  S = 1, 31 (general) and 32 (vector): one word a row
    all_false      no bit set
    all_true       every bit set, S = 4112: the pad bits stay 0
    fold_density   N = 8, S = 8192 at p = 0.1725, the bitmap fold's density
                   on the SCALE 26 direction-optimised search
    offset_view    the mask a contiguous view 8 bytes into its buffer (pack
                   takes the general form) and the words a view one word in

  COMPACT_CASES (B2 `compact_rows`; an (N, S) mask, its channels and
  fills; `csrc/compact.cu` cuts rows into tiles of COMPACT_TILE slots and
  takes its vector form where S % 16 == 0)
    exchange_row   one row of 4 prefix-masked blocks with counts 0, S_b,
                   1234 and 4097, as `compact_blocks` builds it
    all_false      no slot kept
    all_true       every slot kept
    edge_4095/4096/4097  N = 2, S = 3 tiles: counts ending one before,
                   at and one after a tile boundary (row 0 a prefix, row 1
                   spread over the row)
    unaligned      S = 10007, S % 16 != 0 with N = 5: the general form
    s_1            S = 1
    short_rows     N = 600 rows of S = 37, shorter than a tile
    sparse         density 0.001: long runs of empty tiles
    dense          density 0.999
    extremes       two channels of any int32, fills INT32_MIN and
                   INT32_MAX
    offsets_8      the slot-offset channel (`SLOT_OFFSETS`) at N = 8, the
                   bitmap decode's rows, at the fold's density

  BINSEARCH_CASES (B10 `binsearch_map`; a cumul, its front_total, gids and
  the Pallas tile; `csrc/stages.cu` maps blocks of 2048 lanes and
  searches a span of up to 512 slots in shared memory)
    consecutive    consecutive gids, as a search's chunk
    gaps           sorted gids with random gaps: a block spans ~7600
                   slots, past the shared-memory budget (lanes search in
                   global memory)
    gaps_narrow    sorted gids with small gaps: a block spans a few
                   hundred slots (lanes search in shared memory)
    repeats        runs of repeated gids
    descending_tiles  each tile sorted, the tiles in descending order
    whole_cumul    one tile spanning the whole cumul
    below_first    cumul[0] > 0: lanes below it (0 here, -1 in the oracle)
    past_total     lanes at and past the live total (front_total < n)
    zero_runs      runs of 3000 zero-degree slots

The tests hold the port's plain versions to the JAX package's Pallas
kernels on these inputs (CPU: B1, B7, B2, B3 and B4 in
tests/test_torch_kernels.py, B8 and B9 in tests/test_torch_values.py, B10
and B11 in tests/test_torch_stages.py) and the kernels to the plain
versions (on the card, tests/test_torch_gpu.py and chip_smoke.py phases 3
and 12).
"""
from __future__ import annotations

import numpy as np

I32_MIN, I32_MAX = -2**31, 2**31 - 1
EXPAND_CASES = ("one_vertex", "congruent", "all_visited", "all_clear",
                "tile_1", "tile_3", "tile_384", "zero_run", "wide_slot",
                "straddle", "past_total", "front_total_0", "ragged")
EXPAND_TILES = {"tile_1": 1, "tile_3": 3, "tile_384": 384}
BOTTOMUP_CASES = ("zero_run", "tail_run", "wide_row", "mostly_visited",
                  "sparse_live", "straddle", "past_total", "total_0", "ragged", "block_37",
                  "empty_frontier", "full_frontier")
FILTER_CASES = ("one_vertex", "congruent", "extremes", "all_visited",
                "all_clear")
FILTER_TILES = (64, 128, 256, 512, 1024)
BITS_CASES = ("aligned", "half_word_tail", "odd_s", "one_word_1",
              "one_word_31", "one_word_32", "all_false", "all_true",
              "fold_density", "offset_view")
MASK_OFFSET = 8                   # bytes: offset_view's mask is not aligned
COMPACT_CASES = ("exchange_row", "all_false", "all_true", "edge_4095",
                 "edge_4096", "edge_4097", "unaligned", "s_1", "short_rows",
                 "sparse", "dense", "extremes", "offsets_8")
COMPACT_TILE = 4096               # kTile of csrc/compact.cu
BINSEARCH_CASES = ("consecutive", "gaps", "gaps_narrow", "repeats",
                   "descending_tiles", "whole_cumul", "below_first",
                   "past_total", "zero_runs")


def table_slots(tile: int) -> int:
    """Slots of stage 3's hash table at `tile` lanes: the next power of
    two >= 2 * tile (`stage::filter_table_slots`)."""
    slots = 2
    while slots < 2 * tile:
        slots <<= 1
    return slots


def pack_words(visited) -> np.ndarray:
    """The packed visited bitmap as int32 bit patterns, bit i of word w
    for row 32 w + i (`core.frontier.pack_bitmap`)."""
    n = visited.shape[0]
    padded = np.zeros(32 * ((n + 31) // 32), bool)
    padded[:n] = visited
    return np.packbits(padded, bitorder="little").view("<u4") \
        .astype(np.uint32).view(np.int32)


def _block(rng, deg, n_rows, front_total, rows=None):
    """A CSC block with the given column degrees; the frontier is columns
    0 .. front_total - 1 in order, so cumul follows `deg`."""
    ncl = deg.shape[0]
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = max(int(col_off[-1]), 1)
    row_idx = rng.integers(0, n_rows, size=nnz + 5).astype(np.int32)
    if rows is not None:
        row_idx[:nnz] = rows(nnz)
    row_idx[nnz:] = -1                                   # padding
    front = np.full(ncl, -1, np.int32)
    front[:front_total] = np.arange(front_total, dtype=np.int32)
    live_deg = np.where(np.arange(ncl) < front_total, deg, 0)
    cumul = np.concatenate([[0], np.cumsum(live_deg)]).astype(np.int32)
    payload = rng.integers(-5, I32_MAX, size=ncl).astype(np.int32)
    return dict(cumul=cumul, front=front, payload=payload,
                front_total=front_total, col_off=col_off, row_idx=row_idx)


def expand_case(name: str, seed: int = 0) -> dict:
    """One EXPAND_CASES input: numpy arrays cumul, front, payload,
    col_off, row_idx, visited (bool), words (int32); ints front_total,
    start, E."""
    assert name in EXPAND_CASES, name
    rng = np.random.default_rng([seed, EXPAND_CASES.index(name)])
    n_rows, ncl, max_deg, ft, rows = 300, 100, 9, 100, None
    start, E = 0, 1024
    if name in ("one_vertex", "congruent", "all_visited", "all_clear"):
        ncl, max_deg, ft = 64, 40, 64
    if name == "one_vertex":
        rows = lambda nnz: np.full(nnz, 7, np.int32)    # noqa: E731
    elif name == "congruent":
        n_rows = 64 * 1024
        rows = lambda nnz: (5 + 1024 * rng.integers(0, 64, size=nnz)) \
            .astype(np.int32)                           # noqa: E731
    elif name == "all_clear":
        n_rows = 50
    elif name in EXPAND_TILES:
        E = {"tile_1": 521, "tile_3": 1563, "tile_384": 1152}[name]
    elif name == "zero_run":
        ncl, ft, E = 1000, 1000, 2048
    elif name == "wide_slot":
        ncl, ft, E = 50, 50, 4096
    elif name == "ragged":
        start, E = 37, 1000
    deg = rng.integers(0, max_deg, size=ncl).astype(np.int32)
    if name == "zero_run":
        deg[200:900] = 0
    elif name == "wide_slot":
        deg[10] = 3000
    elif name == "front_total_0":
        ft = 0
    case = _block(rng, deg, n_rows, ft, rows)
    total = int(case["cumul"][ft])
    if name == "straddle":
        start = max(total - 300, 0)
    elif name == "past_total":
        start = total + 100
    visited = rng.random(n_rows) < 0.3
    if name == "one_vertex":
        visited[7] = False
    elif name == "all_visited":
        visited[:] = True
    elif name == "all_clear":
        visited[:] = False
    case.update(name=name, start=start, E=E, visited=visited,
                words=pack_words(visited))
    return case


def bottomup_case(name: str, seed: int = 0) -> dict:
    """One BOTTOMUP_CASES input: numpy arrays row_off, col_idx, cumul (the
    exclusive cumsum of the row degrees with visited rows zeroed), words
    (the frontier bitmap of R = 3 blocks, int32 bit patterns), dense_pay;
    ints total (= cumul[-1]), block, start, E."""
    assert name in BOTTOMUP_CASES, name
    rng = np.random.default_rng([seed, BOTTOMUP_CASES.index(name)])
    nrl, block, p_visited, p_front, start, E = 4000, 1000, 0.3, 0.4, 0, 4096
    if name == "mostly_visited":
        nrl, p_visited, E = 120_000, 0.99, 6144
    elif name == "sparse_live":
        nrl, p_visited = 400_000, 0.998
    elif name == "block_37":
        block = 37
    elif name == "empty_frontier":
        p_front = 0.0
    elif name == "full_frontier":
        p_front = 1.0
    elif name == "ragged":
        start, E = 37, 1000
    elif name == "wide_row":
        E = 8192
    deg = rng.integers(0, 9, size=nrl)
    visited = rng.random(nrl) < p_visited
    if name == "zero_run":
        visited[1000:2500] = True
    elif name == "tail_run":
        visited[nrl - 1500:] = True       # the live total ends before them
        deg[nrl - 1501] = 0               # and one unvisited zero-degree row
    elif name == "wide_row":
        deg[10], visited[10] = 5000, False
    elif name == "total_0":
        visited[:] = True
    ncl = 3 * block
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, ncl, size=int(row_off[-1]) + 7) \
        .astype(np.int32)
    cumul = np.concatenate([[0], np.cumsum(np.where(visited, 0, deg))]) \
        .astype(np.int32)
    total = int(cumul[-1])
    if name in ("tail_run", "straddle"):
        start = max(total - 1500, 0)
    elif name == "past_total":
        start = total + 100
    front = (rng.random((3, block)) < p_front).reshape(-1)
    W = (block + 31) // 32
    words = np.zeros(3 * W, np.uint32)
    for c in np.flatnonzero(front):
        blk, off = c // block, c % block
        words[blk * W + (off >> 5)] |= np.uint32(1) << np.uint32(off & 31)
    dense_pay = rng.integers(-5, I32_MAX, size=ncl).astype(np.int32)
    return dict(name=name, row_off=row_off, col_idx=col_idx, cumul=cumul,
                total=total, words=words.view(np.int32),
                dense_pay=dense_pay, block=block, start=start, E=E)


def bottomup_args(case: dict, device, values: bool = False):
    """B7's tensor arguments after (start, E): (cumul, total, row_off,
    col_idx, words), and dense_pay after them for B9 (`values`), on
    `device`."""
    import torch
    t = {k: torch.from_numpy(case[k]).to(device)
         for k in ("cumul", "row_off", "col_idx", "words", "dense_pay")}
    total = torch.tensor(case["total"], dtype=torch.int32, device=device)
    args = (t["cumul"], total, t["row_off"], t["col_idx"], t["words"])
    return args + (t["dense_pay"],) if values else args


def filter_case(name: str, tile: int, seed: int = 0) -> dict:
    """One FILTER_CASES input at `tile`: numpy v (int32), valid (bool),
    words (int32) over 4 tiles of lanes."""
    assert name in FILTER_CASES, name
    rng = np.random.default_rng([seed, FILTER_CASES.index(name), tile])
    e = 4 * tile
    slots = table_slots(tile)
    n_rows = 2048
    valid = rng.random(e) < 0.7
    if name == "one_vertex":
        v = np.full(e, 9, np.int32)
    elif name == "congruent":
        n_rows = 64 * slots + 32
        v = (3 + slots * rng.integers(0, 64, size=e)).astype(np.int32)
    elif name == "extremes":
        v = rng.choice(np.array([-1, I32_MIN, I32_MAX, 0, 31, 32],
                                np.int32), size=e)
        valid = rng.random(e) < 0.8
    elif name == "all_clear":
        v = rng.integers(0, 40, size=e).astype(np.int32)
    else:
        v = rng.integers(0, n_rows, size=e).astype(np.int32)
    nw = (n_rows + 31) // 32
    words = rng.integers(0, 2**32, size=nw, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    if name in ("one_vertex", "extremes"):
        # unvisited: 9, -1, INT32_MIN, 0, 31 (word 0), 32 (word 1) and
        # INT32_MAX (the last word, where the clamp puts it)
        words[:2] = 0
        words[-1] = 0
    elif name == "all_visited":
        words[:] = -1
    elif name == "all_clear":
        words[:] = 0
    return dict(name=name, tile=tile, v=v, valid=valid, words=words)


def expand_args(case: dict, device):
    """B1's tensor arguments after (start, E): (cumul, front, front_total,
    col_off, row_idx, words) on `device`."""
    import torch
    t = {k: torch.from_numpy(case[k]).to(device)
         for k in ("cumul", "front", "col_off", "row_idx", "words")}
    ft = torch.tensor(case["front_total"], dtype=torch.int32, device=device)
    return (t["cumul"], t["front"], ft, t["col_off"], t["row_idx"],
            t["words"])


def value_args(case: dict, device):
    """B8's tensor arguments after (start, E): (cumul, front, payload,
    front_total, col_off, row_idx) on `device`."""
    import torch
    cumul, front, ft, col_off, row_idx, _ = expand_args(case, device)
    payload = torch.from_numpy(case["payload"]).to(device)
    return cumul, front, payload, ft, col_off, row_idx


def filter_args(case: dict, device):
    """B11's tensor arguments (v, valid, words) on `device`."""
    import torch
    return tuple(torch.from_numpy(case[k]).to(device)
                 for k in ("v", "valid", "words"))


def bits_case(name: str, seed: int = 0) -> dict:
    """One BITS_CASES input: numpy mask ((N, S) bool) and words ((N, W)
    int32, the packed mask with random pad bits past S); bool `view` for
    offset_view."""
    assert name in BITS_CASES, name
    rng = np.random.default_rng([seed, BITS_CASES.index(name)])
    N, S, p = 3, 4096, 0.3
    if name in ("aligned", "fold_density"):
        N = 8
    if name in ("half_word_tail", "all_true"):
        S = 4112
    elif name == "odd_s":
        S = 4099
    elif name.startswith("one_word_"):
        S, p = int(name.rsplit("_", 1)[1]), 0.5
    elif name == "fold_density":
        S, p = 8192, 0.1725
    if name == "all_false":
        p = 0.0
    elif name == "all_true":
        p = 1.0
    mask = rng.random((N, S)) < p
    W = (S + 31) // 32
    padded = np.zeros((N, 32 * W), bool)
    padded[:, :S] = mask
    padded[:, S:] = rng.random((N, 32 * W - S)) < 0.5
    words = np.packbits(padded, axis=1, bitorder="little").view("<u4") \
        .astype(np.uint32).view(np.int32)
    return dict(name=name, mask=mask, words=words,
                view=name == "offset_view")


def bits_args(case: dict, device):
    """(mask, words) as tensors on `device`; for offset_view, contiguous
    views MASK_OFFSET bytes and one word into buffers of their own."""
    import torch
    mask = torch.from_numpy(case["mask"])
    words = torch.from_numpy(case["words"])
    if not case["view"]:
        return mask.to(device), words.to(device)
    buf = torch.zeros(mask.numel() + 2 * MASK_OFFSET, dtype=torch.bool,
                      device=device)
    vmask = buf[MASK_OFFSET:MASK_OFFSET + mask.numel()].view(mask.shape)
    vmask.copy_(mask)
    wbuf = torch.zeros(words.numel() + 1, dtype=torch.int32, device=device)
    vwords = wbuf[1:].view(words.shape)
    vwords.copy_(words)
    return vmask, vwords


def compact_case(name: str, seed: int = 0) -> dict:
    """One COMPACT_CASES input: numpy mask ((N, S) bool), arrays (a list of
    (N, S) int32 channels, None for the slot-offset channel) and fills."""
    assert name in COMPACT_CASES, name
    rng = np.random.default_rng([seed, COMPACT_CASES.index(name)])
    N, S, p = 3, 10000, 0.5
    fills = [-1]
    if name == "exchange_row":
        S_b = 5000
        cnts = np.array([0, S_b, 1234, 4097])
        mask = (np.arange(S_b)[None, :] < cnts[:, None]).reshape(1, -1)
        N, S = mask.shape
    elif name.startswith("edge_"):
        N, S = 2, 3 * COMPACT_TILE
        count = int(name.split("_")[1])
        mask = np.zeros((N, S), bool)
        mask[0, :count] = True
        mask[1, np.sort(rng.choice(S, count, replace=False))] = True
    else:
        if name == "unaligned":
            N, S = 5, 10007
        elif name == "s_1":
            N, S = 7, 1
        elif name == "short_rows":
            N, S, p = 600, 37, 0.4
        elif name in ("sparse", "dense"):
            N, S, p = 2, 32 * COMPACT_TILE, 0.001 if name == "sparse" \
                else 0.999
        elif name == "offsets_8":
            N, S, p = 8, 2 * COMPACT_TILE + 48, 0.1725
        p = {"all_false": 0.0, "all_true": 1.0}.get(name, p)
        mask = rng.random((N, S)) < p
    arrays = [rng.integers(-5, I32_MAX, size=(N, S)).astype(np.int32)]
    if name == "extremes":
        arrays = [rng.integers(I32_MIN, I32_MAX, size=(N, S),
                               endpoint=True).astype(np.int32)
                  for _ in range(2)]
        fills = [I32_MIN, I32_MAX]
    elif name == "offsets_8":
        arrays = [None]
    return dict(name=name, mask=mask, arrays=arrays, fills=fills)


def compact_args(case: dict, device):
    """(mask, arrays, fills) for `compact_rows` on `device`, the
    slot-offset channel as `SLOT_OFFSETS`."""
    import torch
    from repro_torch.core.frontier import SLOT_OFFSETS
    arrays = tuple(SLOT_OFFSETS if a is None
                   else torch.from_numpy(a).to(device)
                   for a in case["arrays"])
    return (torch.from_numpy(case["mask"]).to(device), arrays,
            tuple(case["fills"]))


def compact_arrays_np(case: dict) -> list:
    """The case's channels as numpy arrays, the slot-offset channel as
    each slot's offset (what the JAX kernel is given)."""
    N, S = case["mask"].shape
    t = np.broadcast_to(np.arange(S, dtype=np.int32), (N, S))
    return [t if a is None else a for a in case["arrays"]]


def binsearch_case(name: str, seed: int = 0) -> dict:
    """One BINSEARCH_CASES input: numpy cumul (non-decreasing int32, not
    yet clipped), gids (int32); ints front_total and tile."""
    assert name in BINSEARCH_CASES, name
    rng = np.random.default_rng([seed, BINSEARCH_CASES.index(name)])
    n_seg, E, tile, shift = 1000, 4096, 512, 0
    if name == "gaps":
        n_seg = 30000
    elif name == "whole_cumul":
        n_seg, E, tile = 5000, 2048, 2048
    elif name == "zero_runs":
        n_seg = 8000
    deg = rng.integers(0, 9, size=n_seg)
    if name == "zero_runs":
        deg[1000:4000] = 0
        deg[5000:8000] = 0
    if name == "below_first":
        shift = 500
    cumul = (np.concatenate([[0], np.cumsum(deg)]) + shift).astype(np.int32)
    ft = n_seg // 2 if name == "past_total" else n_seg
    total = int(cumul[ft])
    if name == "consecutive":
        gids = 1000 + np.arange(E)
    elif name in ("gaps", "gaps_narrow", "whole_cumul"):
        step = {"gaps": 30, "gaps_narrow": 1}.get(name, 2 * total // E + 1)
        gids = np.cumsum(rng.integers(0, step + 1, size=E))
    elif name == "repeats":
        gids = np.repeat(np.sort(rng.integers(0, total, size=E // 16)), 16)
    elif name == "descending_tiles":
        gids = np.sort(rng.integers(0, total, size=E))
        gids = gids.reshape(-1, tile)[::-1].reshape(-1)
    elif name == "below_first":
        gids = np.arange(E) * 2
    elif name == "past_total":
        gids = total - E // 2 + np.arange(E)
    else:
        gids = np.sort(rng.integers(0, total + 50, size=E))
    return dict(name=name, cumul=cumul, front_total=ft,
                gids=gids.astype(np.int32), tile=tile)
