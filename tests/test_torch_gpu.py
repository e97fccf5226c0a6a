"""The port's CUDA kernels against their plain torch versions, on the card,
and the card's whole path against the CPU's, which the CPU tests hold to
the JAX package (`test_card_equals_cpu_path`).

Marked `gpu`: without a CUDA device they skip (decided in a fixture).  This
file imports no jax, so it runs where only torch is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Integer outputs: exact equality.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as K
from repro_torch.kernels import fold as KF
from repro_torch.kernels import stages as S

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SC = _load_script("torch_stage_cases")
CARD_VS_CPU = _load_script("torch_card_vs_cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _random_block(rng, ncl, n_rows, front_total, max_deg=9):
    deg = rng.integers(0, max_deg, size=ncl).astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = max(int(col_off[-1]), 1)
    row_idx = rng.integers(0, n_rows, size=nnz + 5).astype(np.int32)
    row_idx[nnz:] = -1
    front = np.full(ncl, -1, np.int32)
    front[:front_total] = rng.permutation(ncl)[:front_total]
    visited = rng.random(n_rows) < 0.3
    return col_off, row_idx, front, visited


def _random_rows(rng, N, S, p):
    mask = rng.random((N, S)) < p
    a = rng.integers(-5, 1000, size=(N, S)).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, size=(N, S)).astype(np.int32)
    return mask, a, b


@pytest.mark.gpu
def test_kernels_equal_plain_on_card(cuda_device, rng):
    """Both kernels equal their plain versions, and each launch counts."""
    col_off, row_idx, front, visited = _random_block(rng, 3000, 5000, 2000)
    fr = np.clip(front, 0, 2999)
    deg = np.where(np.arange(3000) < 2000, col_off[fr + 1] - col_off[fr], 0)
    cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    words = F.pack_bitmap(torch.from_numpy(visited))
    args = [torch.from_numpy(x) for x in (cumul, front)] + [
        torch.tensor(2000, dtype=torch.int32)] + [
        torch.from_numpy(x) for x in (col_off, row_idx)] + [words]
    for start, E in ((0, 4096), (1000, 3000), (int(cumul[-1]) - 5, 512)):
        plain = K.plain_expand_chunk(start, E, *args)
        n0 = K.expand_chunk.launches
        kern = K.expand_chunk(start, E, *[a.to(cuda_device) for a in args])
        torch.cuda.synchronize()
        assert K.expand_chunk.launches == n0 + 1
        for p, k in zip(plain, kern):
            assert torch.equal(p, k.cpu())
    mask, a, b = _random_rows(rng, 3, 100_003, 0.4)
    tm, ta, tb = (torch.from_numpy(x) for x in (mask, a, b))
    plain = KF.plain_compact_rows(tm, (ta, tb), (-1, 5))
    kern = KF.compact_rows(tm.to(cuda_device),
                           (ta.to(cuda_device), tb.to(cuda_device)), (-1, 5))
    torch.cuda.synchronize()
    for p, k in zip(plain[0] + (plain[1],), kern[0] + (kern[1],)):
        assert torch.equal(p, k.cpu())


@pytest.mark.gpu
def test_bits_and_bottomup_equal_plain_on_card(cuda_device, rng):
    """pack_bits, unpack_bits and bottomup_chunk equal their plain
    versions, and each launch counts: S % 32 != 0, all-false / all-true
    masks, block % 32 != 0, empty / full frontier, total = 0, a chunk
    straddling the live total."""
    for N, S, p in ((3, 100_003, 0.4), (2, 64, 0.0), (4, 33, 1.0)):
        mask = torch.from_numpy(rng.random((N, S)) < p)
        n0 = (KF.pack_bits.launches, KF.unpack_bits.launches)
        words = KF.pack_bits(mask.to(cuda_device))
        bits = KF.unpack_bits(words, S)
        torch.cuda.synchronize()
        assert (KF.pack_bits.launches, KF.unpack_bits.launches) == \
            (n0[0] + 1, n0[1] + 1)
        assert torch.equal(words.cpu(), KF.plain_pack_bits(mask))
        assert torch.equal(bits.cpu(), mask)
    block, nrl = 1000, 3000
    deg = rng.integers(0, 9, size=nrl)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, nrl, size=int(row_off[-1]) + 7) \
        .astype(np.int32)
    visited = rng.random(nrl) < 0.3
    for frac in (0.0, 0.5, 1.0):
        front = torch.from_numpy(rng.random((3, block)) < frac)
        words = KF.plain_pack_bits(front).reshape(-1)
        for zero in (False, True):
            cumul = np.concatenate([[0], np.cumsum(
                np.where(visited | zero, 0, deg))]).astype(np.int32)
            total = int(cumul[-1])
            args = [torch.from_numpy(cumul),
                    torch.tensor(total, dtype=torch.int32),
                    torch.from_numpy(row_off), torch.from_numpy(col_idx),
                    words]
            for start, E in ((0, 4096), (max(total - 100, 0), 512)):
                plain = KB.plain_bottomup_chunk(start, E, *args, block=block)
                n0 = KB.bottomup_chunk.launches
                kern = KB.bottomup_chunk(
                    start, E, *[a.to(cuda_device) for a in args],
                    block=block)
                torch.cuda.synchronize()
                assert KB.bottomup_chunk.launches == n0 + 1
                for a, b in zip(plain, kern):
                    assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("name", SC.BITS_CASES)
def test_bits_cases_equal_plain_on_card(cuda_device, name):
    """pack_bits and unpack_bits equal their plain versions bit for bit on
    the BITS_CASES of `scripts/torch_stage_cases.py` (S % 32 == 16, S % 16
    != 0, one-word rows, all-false / all-true, the fold's density, views
    offset into their buffers), each launch counted, each in the form its
    rows pick: vector where S % 16 == 0 and a row of bytes starts 16-byte
    aligned, else general."""
    c = SC.bits_case(name)
    mask, words = SC.bits_args(c, cuda_device)
    S = mask.shape[1]
    n0 = (KF.pack_bits.launches, KF.unpack_bits.launches)
    kw = KF.pack_bits(mask)
    kb = KF.unpack_bits(words, S)
    torch.cuda.synchronize()
    assert (KF.pack_bits.launches, KF.unpack_bits.launches) == \
        (n0[0] + 1, n0[1] + 1)
    want = torch.from_numpy(c["mask"])
    assert torch.equal(kw.cpu(), KF.plain_pack_bits(want))
    assert torch.equal(kb.cpu(), KF.plain_unpack_bits(words.cpu(), S))
    assert torch.equal(kb.cpu(), want)
    aligned = S % 16 == 0
    assert KF.pack_bits.last_form == \
        ("vector" if aligned and not c["view"] else "general")
    assert KF.unpack_bits.last_form == ("vector" if aligned else "general")


@pytest.mark.gpu
def test_bits_cases_launch_both_forms(cuda_device):
    """Over BITS_CASES each of pack_bits and unpack_bits launches both its
    vector and its general form."""
    forms = {"pack_bits": set(), "unpack_bits": set()}
    for name in SC.BITS_CASES:
        mask, words = SC.bits_args(SC.bits_case(name), cuda_device)
        KF.pack_bits(mask)
        forms["pack_bits"].add(KF.pack_bits.last_form)
        KF.unpack_bits(words, mask.shape[1])
        forms["unpack_bits"].add(KF.unpack_bits.last_form)
    torch.cuda.synchronize()
    assert forms == {"pack_bits": {"vector", "general"},
                     "unpack_bits": {"vector", "general"}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", SC.COMPACT_CASES)
def test_compact_cases_equal_plain_on_card(cuda_device, name):
    """compact_rows equals its plain version on every slot and count of the
    COMPACT_CASES of `scripts/torch_stage_cases.py` (the exchange row,
    all-false / all-true, counts at a tile's edge, S % 16 != 0, S = 1,
    many short rows, densities 0.001 / 0.999, extreme fills, the
    slot-offset channel), one launch counted, in the form its rows pick:
    vector where S % 16 == 0 (fresh tensors are aligned), else general."""
    c = SC.compact_case(name)
    mask, arrays, fills = SC.compact_args(c, cuda_device)
    n0 = KF.compact_rows.launches
    kout, kcnt = KF.compact_rows(mask, arrays, fills)
    torch.cuda.synchronize()
    assert KF.compact_rows.launches == n0 + 1
    pout, pcnt = KF.plain_compact_rows(*SC.compact_args(c, "cpu"))
    for k, p_ in zip(kout + (kcnt,), pout + (pcnt,)):
        assert torch.equal(k.cpu(), p_)
    assert KF.compact_rows.last_form == \
        ("vector" if mask.shape[1] % 16 == 0 else "general")


@pytest.mark.gpu
def test_compact_rows_forms_and_many_rows(cuda_device, rng):
    """Both forms run over COMPACT_CASES; more than 65535 rows (the old
    grid's limit) and more channels than one launch takes (two launches)
    equal the plain version."""
    forms = set()
    for name in SC.COMPACT_CASES:
        KF.compact_rows(*SC.compact_args(SC.compact_case(name), cuda_device))
        forms.add(KF.compact_rows.last_form)
    assert forms == {"vector", "general"}
    mask = torch.from_numpy(rng.random((70_000, 3)) < 0.5)
    chans = tuple(torch.from_numpy(rng.integers(0, 99, size=(70_000, 3))
                                   .astype(np.int32)) for _ in range(5))
    fills = (-1, 2, 3, 4, 5)
    plain = KF.plain_compact_rows(mask, chans, fills)
    n0 = KF.compact_rows.launches
    kern = KF.compact_rows(mask.to(cuda_device),
                           tuple(c.to(cuda_device) for c in chans), fills)
    torch.cuda.synchronize()
    assert KF.compact_rows.launches == n0 + 2
    for k, p_ in zip(kern[0] + (kern[1],), plain[0] + (plain[1],)):
        assert torch.equal(k.cpu(), p_)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SC.BINSEARCH_CASES)
def test_binsearch_cases_equal_plain_on_card(cuda_device, name):
    """binsearch_map equals its plain version on every lane of the
    BINSEARCH_CASES of `scripts/torch_stage_cases.py` (consecutive gids,
    wide and narrow gaps, repeats, tiles descending across tiles, one tile
    spanning the whole cumul, lanes below cumul[0] and past the live total,
    zero-degree runs), one launch counted."""
    c = SC.binsearch_case(name)
    cc = S.clip_cumul(torch.from_numpy(c["cumul"]), c["front_total"])
    gids = torch.from_numpy(c["gids"])
    n0 = S.binsearch_map.launches
    kern = S.binsearch_map(cc.to(cuda_device), gids.to(cuda_device),
                           tile=c["tile"])
    torch.cuda.synchronize()
    assert S.binsearch_map.launches == n0 + 1
    assert torch.equal(kern.cpu(), S.map_workload(gids, cc))


@pytest.mark.gpu
def test_value_kernels_equal_plain_on_card(cuda_device, rng):
    """expand_chunk_values and bottomup_chunk_values equal their plain
    versions, and each launch counts: an empty frontier, total = 0, a chunk
    straddling the live total."""
    ncl = 3000
    for ft in (0, 2000):
        col_off, row_idx, front, _ = _random_block(rng, ncl, 5000, ft)
        fr = np.clip(front, 0, ncl - 1)
        deg = np.where(np.arange(ncl) < ft, col_off[fr + 1] - col_off[fr], 0)
        cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        pay = rng.integers(0, 2**31 - 1, size=ncl).astype(np.int32)
        args = [torch.from_numpy(x) for x in (cumul, front, pay)] + [
            torch.tensor(ft, dtype=torch.int32)] + [
            torch.from_numpy(x) for x in (col_off, row_idx)]
        for start, E in ((0, 4096), (max(int(cumul[-1]) - 5, 0), 512)):
            plain = K.plain_expand_chunk_values(start, E, *args)
            n0 = K.expand_chunk_values.launches
            kern = K.expand_chunk_values(start, E,
                                         *[a.to(cuda_device) for a in args])
            torch.cuda.synchronize()
            assert K.expand_chunk_values.launches == n0 + 1
            for p, k in zip(plain, kern):
                assert torch.equal(p, k.cpu())
    block, nrl = 1000, 3000
    deg = rng.integers(0, 9, size=nrl)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, nrl, size=int(row_off[-1]) + 7) \
        .astype(np.int32)
    visited = rng.random(nrl) < 0.3
    dense_pay = torch.from_numpy(
        rng.integers(0, 2**31 - 1, size=3 * block).astype(np.int32))
    for frac in (0.0, 0.5, 1.0):
        words = KF.plain_pack_bits(
            torch.from_numpy(rng.random((3, block)) < frac)).reshape(-1)
        for zero in (False, True):
            cumul = np.concatenate([[0], np.cumsum(
                np.where(visited | zero, 0, deg))]).astype(np.int32)
            total = int(cumul[-1])
            args = [torch.from_numpy(cumul),
                    torch.tensor(total, dtype=torch.int32),
                    torch.from_numpy(row_off), torch.from_numpy(col_idx),
                    words, dense_pay]
            for start, E in ((0, 4096), (max(total - 100, 0), 512)):
                plain = KB.plain_bottomup_chunk_values(start, E, *args,
                                                       block=block)
                n0 = KB.bottomup_chunk_values.launches
                kern = KB.bottomup_chunk_values(
                    start, E, *[a.to(cuda_device) for a in args],
                    block=block)
                torch.cuda.synchronize()
                assert KB.bottomup_chunk_values.launches == n0 + 1
                for a, b in zip(plain, kern):
                    assert torch.equal(a, b.cpu())


@pytest.mark.gpu
def test_delta_kernels_equal_plain_on_card(cuda_device, rng):
    """delta_gaps and delta_positions equal their plain versions, and each
    launch counts: all-invalid rows, full rows of S = 65536, S % 32 != 0,
    a sum that wraps int32."""
    for N, S, p in ((4, 1 << 16, 1.0), (3, 1 << 16, 0.3), (2, 33, 0.5),
                    (3, 100, 0.0)):
        mask = rng.random((N, S)) < p
        ts = np.where(mask, np.arange(S, dtype=np.int32), 2**31 - 1)
        ts = np.sort(ts, axis=1).astype(np.int32)
        valid = np.arange(S)[None, :] < mask.sum(axis=1)[:, None]
        tt, tv = torch.from_numpy(ts), torch.from_numpy(valid)
        n0 = (KF.delta_gaps.launches, KF.delta_positions.launches)
        gaps = KF.delta_gaps(tt.to(cuda_device), tv.to(cuda_device))
        pos = KF.delta_positions(gaps)
        torch.cuda.synchronize()
        assert (KF.delta_gaps.launches, KF.delta_positions.launches) == \
            (n0[0] + 1, n0[1] + 1)
        assert torch.equal(gaps.cpu(), KF.plain_delta_gaps(tt, tv))
        assert torch.equal(pos.cpu(), KF.plain_delta_positions(gaps.cpu()))
    big = torch.full((2, 40000), -1, dtype=torch.int16)    # gaps of 65535
    assert torch.equal(KF.delta_positions(big.to(cuda_device)).cpu(),
                       KF.plain_delta_positions(big))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 256, 512, 1024])
def test_binsearch_map_equals_plain_on_card(cuda_device, rng, tile):
    """binsearch_map equals its plain version on every lane, and each
    launch counts: runs of zero-degree frontier vertices, n_cumul < 256,
    front_total = 0, a chunk straddling the live total, lanes below
    cumul[0]."""
    for n_seg, ft, shift in ((100, 100, 0), (3000, 2000, 0), (3000, 0, 0),
                             (200, 150, 17)):
        deg = rng.integers(0, 9, size=n_seg).astype(np.int32)
        deg[n_seg // 4:n_seg // 2] = 0
        cumul = torch.from_numpy(
            np.concatenate([[0], np.cumsum(deg)]).astype(np.int32) + shift)
        cc = S.clip_cumul(cumul, ft)
        total = int(cumul[ft])
        for start in (0, max(total - 2 * tile, 0)):
            gids = start + torch.arange(4 * tile, dtype=torch.int32)
            plain = S.map_workload(gids, cc)
            n0 = S.binsearch_map.launches
            kern = S.binsearch_map(cc.to(cuda_device), gids.to(cuda_device),
                                   tile=tile)
            torch.cuda.synchronize()
            assert S.binsearch_map.launches == n0 + 1
            assert torch.equal(kern.cpu(), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 256, 512, 1024])
def test_visited_filter_equals_plain_on_card(cuda_device, rng, tile):
    """visited_filter equals its plain version on every lane, and each
    launch counts: n_rows % 32 != 0, all-visited and all-clear words,
    all-invalid lanes, many duplicates within a tile."""
    n_rows = 10_007
    for words_kind, p_valid, span in (("random", 0.7, n_rows),
                                      ("random", 0.7, 2 * tile // 3),
                                      ("all_visited", 0.7, n_rows),
                                      ("all_clear", 0.9, 50),
                                      ("random", 0.0, n_rows)):
        v = torch.from_numpy(rng.integers(0, span, size=8 * tile)
                             .astype(np.int32))
        valid = torch.from_numpy(rng.random(8 * tile) < p_valid)
        nw = (n_rows + 31) // 32
        if words_kind == "random":
            words = torch.from_numpy(rng.integers(0, 2**32, size=nw,
                                                  dtype=np.uint64)
                                     .astype(np.uint32).view(np.int32))
        else:
            words = torch.full((nw,), -1 if words_kind == "all_visited"
                               else 0, dtype=torch.int32)
        plain = S.filter_tile(v, valid, words, tile)
        n0 = S.visited_filter.launches
        kern = S.visited_filter(v.to(cuda_device), valid.to(cuda_device),
                                words.to(cuda_device), tile=tile)
        torch.cuda.synchronize()
        assert S.visited_filter.launches == n0 + 1
        assert torch.equal(kern.cpu(), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SC.EXPAND_CASES)
def test_expand_stage_cases_equal_plain_on_card(cuda_device, name):
    """B1 and B8 equal their plain versions bit for bit on the stage
    stress cases (`scripts/torch_stage_cases.py`: one vertex on every lane,
    vertices congruent modulo the hash table, all-visited / all-clear
    words, tiles 1, 3 and 384, a zero-degree run longer than a block, one
    slot spanning many blocks, chunks straddling and wholly past the live
    total, front_total = 0, n_lanes % 256 != 0), each launch counted."""
    c = SC.expand_case(name)
    start, E = c["start"], c["E"]
    plain = K.plain_expand_chunk(start, E, *SC.expand_args(c, "cpu"))
    n0 = K.expand_chunk.launches
    kern = K.expand_chunk(start, E, *SC.expand_args(c, cuda_device))
    torch.cuda.synchronize()
    assert K.expand_chunk.launches == n0 + 1
    for p, k in zip(plain, kern):
        assert torch.equal(p, k.cpu())
    plain = K.plain_expand_chunk_values(start, E,
                                        *SC.value_args(c, "cpu"))
    n0 = K.expand_chunk_values.launches
    kern = K.expand_chunk_values(start, E, *SC.value_args(c, cuda_device))
    torch.cuda.synchronize()
    assert K.expand_chunk_values.launches == n0 + 1
    for p, k in zip(plain, kern):
        assert torch.equal(p, k.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("name", SC.BOTTOMUP_CASES)
def test_bottomup_stage_cases_equal_plain_on_card(cuda_device, name):
    """B7 and B9 equal their plain versions bit for bit on the bottom-up
    stage-1 stress cases (`scripts/torch_stage_cases.py`: zero-width runs
    longer than a block, the flat tail past the live total, a row spanning
    many blocks, 99 % and 99.8 % of rows visited (a long walk, the lane
    searches), chunks straddling and wholly past the
    live total, total = 0, n_lanes % 256 != 0, block % 32 != 0, empty and
    full frontiers), masked lanes included, each launch counted."""
    c = SC.bottomup_case(name)
    start, E, block = c["start"], c["E"], c["block"]
    for kern_fn, plain_fn, values in (
            (KB.bottomup_chunk, KB.plain_bottomup_chunk, False),
            (KB.bottomup_chunk_values, KB.plain_bottomup_chunk_values,
             True)):
        plain = plain_fn(start, E, *SC.bottomup_args(c, "cpu", values),
                         block=block)
        n0 = kern_fn.launches
        kern = kern_fn(start, E, *SC.bottomup_args(c, cuda_device, values),
                       block=block)
        torch.cuda.synchronize()
        assert kern_fn.launches == n0 + 1
        for p, k in zip(plain, kern):
            assert torch.equal(p, k.cpu())


@pytest.mark.gpu
def test_card_equals_cpu_path(cuda_device):
    """The card against the CPU path, which the CPU tests hold to the JAX
    package: one R-MAT SCALE 12 graph made with numpy, on a 2x2 grid; BFS
    (scalar and batched) under every direction mode x codec x dedup, CC,
    SSSP and multi-BFS top-down and direction-optimised, every output field
    exact (`scripts/torch_card_vs_cpu.py`)."""
    rows = CARD_VS_CPU.run(cuda_device, scale=12, log=lambda s: None)
    assert len(rows) == 2 * 3 * 3 * 2 + 2 * 4


@pytest.mark.gpu
@pytest.mark.parametrize("tile", SC.FILTER_TILES)
@pytest.mark.parametrize("name", SC.FILTER_CASES)
def test_visited_filter_hash_cases_on_card(cuda_device, name, tile):
    """B11 equals its plain version bit for bit on the hash-claim stress
    cases: one vertex on every valid lane, vertices congruent modulo the
    tile's table size, v = -1 / INT32_MIN / INT32_MAX, all-visited and
    all-clear words."""
    c = SC.filter_case(name, tile)
    plain = S.filter_tile(*SC.filter_args(c, "cpu"), tile)
    n0 = S.visited_filter.launches
    kern = S.visited_filter(*SC.filter_args(c, cuda_device), tile=tile)
    torch.cuda.synchronize()
    assert S.visited_filter.launches == n0 + 1
    assert torch.equal(kern.cpu(), plain)


@pytest.mark.gpu
def test_local_expand_and_hook_on_card(cuda_device, rng):
    """local_expand's kernel path equals its reference path on the card,
    through B1; a BFS with BFSConfig(expand_fn=make_expand_fn(
    path="kernel")) equals the default one and launches B1."""
    from repro_torch.api import BFSConfig, DistGraph
    n = 3000
    deg = rng.integers(0, 9, size=n)
    col_off = torch.from_numpy(
        np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    row_idx = torch.from_numpy(rng.integers(0, n, size=int(deg.sum()))
                               .astype(np.int32))
    front = torch.from_numpy(rng.permutation(n)[:1200].astype(np.int32))
    visited = torch.from_numpy(rng.random(n) < 0.2)
    args = [(front.to(cuda_device), 1200),
            (col_off.to(cuda_device), row_idx.to(cuda_device)),
            visited.to(cuda_device)]
    n0 = K.expand_chunk.launches
    a = K.local_expand(*args, path="kernel", edge_chunk=1024)
    b = K.local_expand(*args, path="reference", edge_chunk=1024)
    torch.cuda.synchronize()
    assert K.expand_chunk.launches > n0
    for f in ("verts", "parents", "count", "visited", "edges_scanned"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    edges = torch.stack([torch.from_numpy(rng.integers(0, 512, size=4000)),
                         torch.from_numpy(rng.integers(0, 512, size=4000))])
    edges = torch.cat([edges, edges.flip(0)], dim=1).to(torch.int32)
    graph = DistGraph.from_edges(edges.to(cuda_device),
                                 BFSConfig(grid=(2, 2)), n=512)
    want = graph.session().bfs(int(edges[0, 0]))
    n0 = K.expand_chunk.launches
    sess = graph.session(BFSConfig(grid=(2, 2),
                                   expand_fn=K.make_expand_fn(path="kernel")))
    got = sess.bfs(int(edges[0, 0]))
    torch.cuda.synchronize()
    assert sess.engine.expand_path == "custom"
    assert K.expand_chunk.launches > n0
    assert torch.equal(got.level, want.level)
    assert torch.equal(got.pred, want.pred)
    assert got.edges_scanned == want.edges_scanned


def _block_bytes(tensors) -> int:
    """Bytes the caching allocator holds for these tensors' storages: the
    sizes of their active blocks in `torch.cuda.memory_snapshot()`."""
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    total = 0
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            addr = blk.get("address", addr)
            if blk["state"] == "active_allocated" and addr in ptrs:
                total += blk["size"]
            addr += blk["size"]
    return total


def _edge_tensors(graph) -> list:
    return [graph.edges, graph.edge_weights] + list(graph._edge_index.keys)


@pytest.mark.gpu
def test_dropping_the_edges_frees_their_memory(cuda_device):
    """`ensure_csr` and `release_edges` drop the edge list, its weights and
    the EdgeIndex: `memory_allocated` falls by exactly their blocks (and
    ensure_csr adds exactly the CSR twin and its weights)."""
    from repro_torch.api import BFSConfig, DistGraph

    edges, w = CARD_VS_CPU.rmat_numpy(10, 16, 0)
    for drop in ("ensure_csr", "release_edges"):
        graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)),
                                     weights=w, device=cuda_device)
        graph.edge_index()
        torch.cuda.synchronize()
        freed = _block_bytes(_edge_tensors(graph))
        assert freed >= edges.nbytes + w.nbytes
        before = torch.cuda.memory_allocated()
        getattr(graph, drop)()
        torch.cuda.synchronize()
        added = 0 if drop == "release_edges" else _block_bytes(
            list(graph.csr.values()) + [graph.csr_weights])
        assert graph.edges is None and graph._edge_index is None
        assert torch.cuda.memory_allocated() - before == added - freed
        del graph


@pytest.mark.gpu
def test_server_equals_direct_calls_on_card(cuda_device):
    """The port's GraphServer on the card (SCALE 10, 2x2): top-down and
    direction-optimised BFS batches with a pad slot, SSSP, two CC callers
    and a multi-BFS, every value field equal to the direct session call,
    through the kernels."""
    import dataclasses

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.serve import GraphServer, ServeConfig

    edges, w = CARD_VS_CPU.rmat_numpy(10, 16, 0)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)), weights=w,
                                 device=cuda_device)
    deg = np.bincount(edges[0], minlength=1 << 10)
    roots = [int(r) for r in np.flatnonzero(deg > 0)[:6]]
    dcfg = BFSConfig(grid=(2, 2), direction=True, fold_codec="bitmap")
    srv = GraphServer({"g": graph}, ServeConfig(max_batch=4))
    srv.warm(("bfs", "sssp", "cc"))
    K.expand_chunk.launches = 0
    calls = ([("bfs", r, srv.bfs("g", r)) for r in roots[:5]]
             + [("dir", r, srv.bfs("g", r, config=dcfg)) for r in roots[:2]]
             + [("sssp", r, srv.sssp("g", r)) for r in roots[:2]]
             + [("cc", None, srv.connected_components("g", tenant=t))
                for t in ("a", "b")]
             + [("mb", None, srv.multi_bfs("g", roots[:4], k=2))])
    srv.start()
    srv.drain()
    srv.stop()
    assert K.expand_chunk.launches > 0
    sess, dsess = graph.session(), graph.session(dcfg)
    direct = {"bfs": sess.bfs, "dir": dsess.bfs, "sssp": sess.sssp,
              "cc": lambda _: sess.connected_components(),
              "mb": lambda _: sess.multi_bfs(roots[:4], k=2)}
    for kind, r, t in calls:
        res = t.result(60)
        assert res.ok, res.error
        want = direct[kind](r)
        for f in dataclasses.fields(want):
            a, b = getattr(res.value, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), (kind, f.name)
            else:
                assert a == b, (kind, f.name)
    padded = sorted((b.live, b.padded_to) for b in srv.accounting.batches
                    if b.program == "bfs")
    assert padded == [(1, 1), (2, 2), (4, 4)]


@pytest.mark.gpu
def test_library_builds_and_loads_once_under_two_threads(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    """Two threads whose first launch loads one library into an empty
    `_libs`, with nothing built yet: one builds, both get the same
    handle."""
    import threading

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    barrier = threading.Barrier(2)
    got, errors = [], []

    def first():
        barrier.wait()
        try:
            got.append(build.library("bits"))
        except Exception as exc:           # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=first) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and len(got) == 2
    assert got[0] is got[1] is build._libs["bits"]
    assert not list((tmp_path / "kernels").glob("*.tmp*"))


@pytest.mark.gpu
@pytest.mark.parametrize("ft", [False, True], ids=["traced", "traced-ft"])
def test_group_traced_and_fault_tolerant_on_card(cuda_device, ft):
    """2 gloo ranks on cuda:0 at SCALE 12 (2x2, two processors a rank):
    every query top-down under list and adaptive under bitmap with
    telemetry=True -- and, fault-tolerant (ckpt_every=2), under a
    transient loss crossing level 3, retried once -- equals the stacked
    session on the card, every field and every trace channel on every
    rank (`tests/dist/torch_run_multihost.py`)."""
    import subprocess
    import sys
    script = ROOT / "tests" / "dist" / "torch_run_multihost.py"
    r = subprocess.run(
        [sys.executable, str(script), "2", "2", "flat", "--grid", "2x2",
         "--device", "cuda", "--scale", "12", "--configs", "traced",
         "--telemetry", "--timeout", "600"] + (["--ft"] if ft else []),
        capture_output=True, text=True, timeout=660)
    assert r.returncode == 0 and r.stdout.rstrip().endswith("OK"), \
        f"exit {r.returncode}\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}"


@pytest.mark.gpu
def test_graph_build_and_bfs_single_card_equal_cpu(cuda_device, monkeypatch):
    """`graphgen.build_csc` / `build_csr` and `core.bfs_single` on the card
    equal the CPU's (which the CPU tests hold to the JAX package) at SCALE
    12, with edge passes that split columns; the launcher runs on the card
    by default and prints two validated roots."""
    import os
    import subprocess
    import sys

    from repro_torch.core import bfs_single
    BS = importlib.import_module("repro_torch.core.bfs_single")
    from repro_torch.graphgen import build_csc, build_csr, rmat_edges

    n = 1 << 12
    edges = rmat_edges(12, 16, torch.Generator().manual_seed(3), "cpu")
    for build in (build_csc, build_csr):
        cpu = build(edges, n)
        card = build(edges.to(cuda_device), n)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
    co, ri = build_csc(edges, n)
    cco, cri = co.to(cuda_device), ri.to(cuda_device)
    for root in (0, 17, 4000):
        wl, wp = bfs_single(co, ri, root)
        for chunk in (1000, 1 << 26):
            monkeypatch.setattr(BS, "CHUNK", chunk)
            lv, pr = bfs_single(cco, cri, root)
            assert torch.equal(lv.cpu(), wl) and torch.equal(pr.cpu(), wp)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bfs_run", "--grid", "2x2",
         "--scale", "12", "--roots", "4", "--validate", "2"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "(2 validated)" in r.stdout, \
        f"exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"


# ---------------------------------------------------------------------------
# The graph-learning and recsys models: the card equals the CPU path, which
# the CPU tests hold to the JAX package (rtol 1e-4, atol 1e-5; a gradient
# whose largest entry passes 1 in units of it; fp32 matmuls, no TF32)
# ---------------------------------------------------------------------------

def _card_vs_cpu(cuda_device, model, run):
    """run(model, device) -> list of tensors, on a CPU model and on its copy
    on the card; each pair equal within the models' tolerance."""
    import copy

    assert not torch.backends.cuda.matmul.allow_tf32
    card = copy.deepcopy(model).to(cuda_device)
    for got, want in zip(run(card, cuda_device), run(model, "cpu")):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-5 * scale, equal_nan=True)


def _grads(model):
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach()
            for p in model.parameters()]


@pytest.mark.gpu
def test_graphsage_card_equals_cpu(cuda_device):
    """Full graph on the 2D SpMM (2x2 stacked) and a sampled block."""
    from repro_torch.core import Grid2D, partition_2d
    from repro_torch.core.spmm2d import make_spmm2d
    from repro_torch.dist import make_mesh
    from repro_torch.graphgen import build_csr, rmat_edges
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.gnn import graphsage as GS
    from repro_torch.sparse import NeighborSampler

    n = 1 << 10
    edges = rmat_edges(10, 8, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.randn((n, 16), generator=g)
    labels = torch.randint(0, 5, (n,), generator=g)
    ro, ci = build_csr(edges, n)
    block = NeighborSampler(ro.numpy(), ci.numpy(), seed=3).sample_block(
        torch.arange(64).numpy(), [15, 10])
    model = GS.init_params(GS.SAGEConfig("s", 2, 32, 16, 5),
                           torch.Generator().manual_seed(0), "cpu")

    def run(m, dev):
        grid = Grid2D.for_vertices(n, 2, 2)
        pg = partition_2d(edges.to(dev), grid)
        spmm = make_spmm2d(grid, make_mesh((2, 2), ("r", "c"), device=dev))
        m.zero_grad(set_to_none=True)
        loss = m.loss(x.to(dev), None, None, labels.to(dev),
                      spmm=lambda h: spmm(pg.col_off, pg.row_idx, pg.nnz, h))
        loss.backward()
        out = [loss.detach()] + _grads(m)
        m.zero_grad(set_to_none=True)
        feats = [x[torch.from_numpy(v)].to(dev) for v in block["nodes"]]
        bl = cross_entropy(m.apply_block(feats, [15, 10]),
                           labels[:64].to(dev))
        bl.backward()
        return out + [bl.detach()] + _grads(m)

    _card_vs_cpu(cuda_device, model, run)


@pytest.mark.gpu
@pytest.mark.parametrize("corr", [1, 3])
def test_equivariant_card_equals_cpu(cuda_device, corr):
    from repro_torch.models.gnn import equivariant as EQ
    g = torch.Generator().manual_seed(4)
    n, e = 30, 64
    pos = torch.randn((n, 3), generator=g)
    spec = torch.randint(0, 8, (n,), generator=g)
    src = torch.randint(0, n, (e,), generator=g)
    dst = (src + torch.randint(1, n, (e,), generator=g)) % n
    model = EQ.init_params(EQ.EquivConfig("e", 2, 16, 8, 5.0,
                                          correlation_order=corr),
                           torch.Generator().manual_seed(0), "cpu")

    def run(m, dev):
        args = [t.to(dev) for t in (spec, pos, src, dst)]
        en, forces = m.energy_and_forces(*args)
        m.zero_grad(set_to_none=True)
        e2, node = m(*args)
        e2.backward()
        return [en.detach(), forces, node.detach()] + _grads(m)

    _card_vs_cpu(cuda_device, model, run)


@pytest.mark.gpu
def test_egnn_card_equals_cpu(cuda_device):
    from repro_torch.models.gnn import egnn as EG
    g = torch.Generator().manual_seed(5)
    n, e = 30, 64
    feats = torch.randn((n, 8), generator=g)
    pos = torch.randn((n, 3), generator=g)
    src = torch.randint(0, n, (e,), generator=g)
    dst = (src + torch.randint(1, n, (e,), generator=g)) % n
    model = EG.init_params(EG.EGNNConfig("g", 4, 64, 8),
                           torch.Generator().manual_seed(0), "cpu")

    def run(m, dev):
        m.zero_grad(set_to_none=True)
        en, h, x = m(*(t.to(dev) for t in (feats, pos, src, dst)))
        en.backward()
        return [en.detach(), h.detach(), x.detach()] + _grads(m)

    _card_vs_cpu(cuda_device, model, run)


@pytest.mark.gpu
def test_deepfm_and_adamw_card_equal_cpu(cuda_device):
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    cfg = D.DeepFMConfig("d", embed_dim=10, mlp=(64, 64),
                         vocabs=(64, 1000, 5000, 37, 12000, 8))
    g = torch.Generator().manual_seed(6)
    idx = torch.stack([torch.randint(0, v, (512,), generator=g)
                       for v in cfg.vocabs], 1)
    y = (torch.rand(512, generator=g) > 0.5).float()
    user = idx[0, :4]
    items = idx[:, 4:]
    model = D.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def run(m, dev):
        params = dict(m.named_parameters())
        state = adamw_init(params)
        outs = []
        for _ in range(2):
            m.zero_grad(set_to_none=True)
            loss = m.loss(idx.to(dev), y.to(dev))
            loss.backward()
            outs += [loss.detach()] + _grads(m)
            adamw_update(AdamWConfig(lr=1e-2), params,
                         {k: p.grad for k, p in params.items()}, state)
        with torch.no_grad():
            outs.append(m.score_candidates(user.to(dev), items.to(dev)))
        return outs + [p.detach() for p in m.parameters()]

    _card_vs_cpu(cuda_device, model, run)


@pytest.mark.gpu
def test_sparse_ops_card_equal_cpu(cuda_device):
    from repro_torch import sparse as SP
    g = torch.Generator().manual_seed(7)
    n, e = 300, 4000
    h = torch.randint(-8, 9, (n, 6), generator=g).float()
    src = torch.randint(-2, n + 2, (e,), generator=g)
    dst = torch.randint(-n, n + 3, (e,), generator=g)
    valid = torch.rand(e, generator=g) < 0.7
    off = torch.cumsum(torch.randint(0, 5, (41,), generator=g), 0)
    off = torch.cat([torch.zeros(1, dtype=off.dtype), off])
    flat = torch.randint(-1, n + 1, (int(off[-1]),), generator=g)
    bags = torch.randint(-1, n, (40, 7), generator=g)
    for dev in (cuda_device,):
        for reduce in ("sum", "mean", "max"):
            for v in (None, valid):
                got = SP.gather_scatter(h.to(dev), src.to(dev), dst.to(dev),
                                        n, reduce=reduce, valid=None if v
                                        is None else v.to(dev))
                want = SP.gather_scatter(h, src, dst, n, reduce=reduce,
                                         valid=v)
                torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0
                                           if reduce != "mean" else 1e-6)
        msg = h[src.clamp(0, n - 1)]
        for op in (SP.segment_sum, SP.segment_max):
            torch.testing.assert_close(op(msg.to(dev), dst.to(dev), n).cpu(),
                                       op(msg, dst, n), rtol=0, atol=0)
        for args in ((bags,), (flat, off)):
            got = SP.embedding_bag(h.to(dev), *(a.to(dev) for a in args))
            torch.testing.assert_close(got.cpu(), SP.embedding_bag(h, *args),
                                       rtol=0, atol=0)


ARCH_IDS = ["bfs-rmat", "deepfm", "egnn", "gemma2-2b", "glm4-9b",
            "graphsage-reddit", "h2o-danube-1.8b", "kimi-k2-1t-a32b", "mace",
            "nequip", "qwen2-moe-a2.7b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_registry_smoke_on_the_card(cuda_device, arch_id):
    from repro_torch.configs import ARCHS, get_arch
    assert sorted(ARCHS) == ARCH_IDS
    get_arch(arch_id).smoke()


@pytest.mark.gpu
def test_moe_over_a_group_on_the_card_equals_stacked(cuda_device, tmp_path):
    """A 1-rank gloo group on the card holding a 2x2 ("data", "model")
    `ProcessMesh` (every collective through its one-member groups, staged
    through the host), fp32, with fsdp_axis and int8 dispatch: output,
    aux and gradients equal the stacked mesh's on the card within rtol
    1e-5 / atol 1e-6 of each tensor's largest entry (`index_add_` on the
    card adds in no fixed order)."""
    from repro_torch.dist import make_mesh, multihost
    from repro_torch.models import moe as M

    class Cfg:
        n_experts, top_k, capacity_factor, cap_e_mult = 6, 2, 1.25, 4
    g = torch.Generator(device=cuda_device).manual_seed(3)
    names = ("x", "router", "w1", "w3", "w2")
    shapes = ((64, 32), (32, 8), (8, 32, 48), (8, 32, 48), (8, 48, 32))
    p = {k: torch.randn(s, generator=g, device=cuda_device) * 0.3
         for k, s in zip(names, shapes)}
    gy = torch.randn((64, 32), generator=g, device=cuda_device)

    def run(mesh, **kw):
        args = {k: v.clone().requires_grad_() for k, v in p.items()}
        y, aux = M.moe_apply(args["x"], {k: args[k] for k in names[1:]},
                             Cfg, mesh=M.MoEShard(
                                 mesh=mesh, token_axes=("data", "model"),
                                 expert_axis="model", **kw))
        return [y, aux] + list(torch.autograd.grad(
            torch.sum(y * gy) + aux, list(args.values())))

    multihost.initialize(f"file://{tmp_path}/store", 1, 0,
                         device=cuda_device, backend="gloo")
    try:
        pm = multihost.global_mesh((2, 2), ("data", "model"))
        stacked = make_mesh((2, 2), ("data", "model"), device=cuda_device)
        for kw in ({}, {"fsdp_axis": "data", "quant_dispatch": True}):
            for got, want in zip(run(pm, **kw), run(stacked, **kw)):
                scale = float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=1e-5,
                                           atol=1e-6 * max(scale, 1.0))
    finally:
        multihost.shutdown()
