"""The port's session surface: entry points refuse to run without a card
unless told device="cpu"; every knob the port does not support yet raises,
naming its ROADMAP item; the direction knobs are accepted and key the
engine cache; `check_vertex_ids` speaks as the JAX one does; the
torch R-MAT generator is deterministic per seed, in range and symmetric."""
import numpy as np
import pytest
import torch

from repro.api.session import check_vertex_ids as jax_check_vertex_ids
from repro_torch.api import BFSConfig, DistGraph, check_vertex_ids
from repro_torch.graphgen import rmat_edges

EDGES = np.array([[0, 1, 1, 2], [1, 0, 2, 1]], np.int32)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistGraph.from_edges(EDGES, BFSConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rmat_edges(4, 2)
    sess = DistGraph.from_edges(EDGES, BFSConfig(), device="cpu").session()
    out = sess.bfs(0)
    assert out.level.device.type == "cpu"
    assert out.level.tolist() == [0, 1, 2] and out.pred.tolist() == [0, 0, 1]
    assert out.edges_scanned == 4 and int(out.n_levels) == 4


@pytest.mark.parametrize("knob,value,item", [
    ("telemetry", True, "A10"), ("fault_tolerance", True, "A11"),
    ("exchange", "butterfly", "A9"), ("exchange", "auto", "A9"),
    ("expand_fn", lambda *a: a, "A17"),
])
def test_unsupported_knobs_name_their_roadmap_item(knob, value, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        BFSConfig(**{knob: value})


@pytest.mark.parametrize("knobs", [
    {"direction": True}, {"direction": "bottomup"},
    {"direction": "adaptive"}, {"direction": False}, {"direction": None},
    {"fold_codec": "bitmap"}, {"direction": True, "fold_codec": "bitmap"},
    {"direction": True, "alpha": 12, "beta": 96, "bottomup": "reference"},
])
def test_direction_knobs_are_accepted(knobs):
    from repro.api import BFSConfig as JaxBFSConfig
    ours, theirs = BFSConfig(**knobs), JaxBFSConfig(**knobs)
    assert ours.direction_mode == theirs.direction_mode
    for k, v in knobs.items():
        assert getattr(ours, k) == v


def test_bad_direction_spelling_raises():
    with pytest.raises(ValueError, match="direction='sideways'"):
        BFSConfig(direction="sideways")


def test_engine_key_covers_direction_knobs():
    """Sessions that differ only in a direction knob get their own engine
    (a direction-enabled session on a graph that already served top-down
    must not reuse the top-down engine)."""
    graph = DistGraph.from_edges(EDGES, BFSConfig(), device="cpu")
    base = graph.session().engine
    variants = [BFSConfig(direction=True), BFSConfig(direction="bottomup"),
                BFSConfig(direction=True, alpha=12),
                BFSConfig(direction=True, beta=32),
                BFSConfig(direction=True, bottomup="reference"),
                BFSConfig(fold_codec="bitmap")]
    engines = [graph.session(c).engine for c in variants]
    assert len({id(e) for e in [base] + engines}) == len(variants) + 1
    assert graph.session(BFSConfig(direction=True)).engine is engines[0]
    assert engines[0].program.mode == "adaptive"
    assert engines[1].program.mode == "bottomup"
    assert (engines[2].program.alpha, engines[3].program.beta) == (12, 32)
    assert base.program.name == "bfs" and base.bottomup_fn is None


@pytest.mark.parametrize("knob,value", [
    ("expand", "pallas"), ("fold", "pallas-interpret"), ("dedup", "atomic"),
    ("edge_chunk", 0)])
def test_bad_spellings_raise(knob, value):
    with pytest.raises(ValueError):
        BFSConfig(**{knob: value})


def test_defaults_match_the_jax_config():
    from repro.api import BFSConfig as JaxBFSConfig
    ours, theirs = BFSConfig(), JaxBFSConfig()
    for f in ("grid", "fold_codec", "edge_chunk", "dedup", "max_levels",
              "direction", "alpha", "beta", "row_axes", "col_axes",
              "expand_fn", "expand", "fold", "bottomup", "exchange",
              "telemetry", "fault_tolerance", "ckpt_every"):
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("ids", [5, -1, [0, 7], np.array([1.5]),
                                 np.array([2, 3], np.int64), []])
def test_check_vertex_ids_matches_jax(ids):
    def message(fn):
        try:
            fn(ids, 6, "roots")
        except ValueError as e:
            return str(e)
        return None
    assert message(check_vertex_ids) == message(jax_check_vertex_ids)
    if isinstance(ids, np.ndarray):
        assert message(lambda *a: check_vertex_ids(torch.as_tensor(ids),
                                                   *a[1:])) \
            == message(jax_check_vertex_ids)


def test_session_rejects_bad_roots():
    sess = DistGraph.from_edges(EDGES, BFSConfig(), device="cpu").session()
    with pytest.raises(ValueError, match="out-of-range vertex id 3"):
        sess.bfs(3)
    with pytest.raises(ValueError, match="scalar or 1D"):
        sess.bfs(np.zeros((2, 2), np.int32))


def test_rmat_edges_deterministic_symmetric():
    def gen(seed):
        return rmat_edges(8, 4, torch.Generator().manual_seed(seed), "cpu")
    a, b, c = gen(1), gen(1), gen(2)
    assert a.shape == (2, 2 * 4 * 256) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 256
    E = 4 * 256
    assert torch.equal(a[:, E:], a[:, :E].flip(0))
    # the R-MAT skew: the largest degree far above the mean of 8
    assert int(torch.bincount(a[0].long(), minlength=256).max()) > 40
