"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `gpu`: without a CUDA device they skip (decided in a fixture).  This
file imports no jax, so it runs where only torch is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Integer outputs: exact equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as K
from repro_torch.kernels import fold as KF


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
