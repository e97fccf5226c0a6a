"""The port's LM (`repro_torch.models.lm`) against the JAX package's
(`repro.models.lm`), on the CPU, with JAX's parameters carried across
(`convert.load_jax_params`, bf16 leaves bit for bit) and tokens from a
numpy seed; the JAX side runs under `jax.jit`:

  * `forward` (logits and aux) on three dense configs -- gemma2's features
    (softcaps, `query_scale`, sandwich norms, tied embeddings, windows
    (8, 0)), glm4's `rope_fraction=0.5`, danube's all-SWA window -- and
    one MoE config with phantom experts and a shared expert; gemma2's
    again in bf16;
  * `decode_step`: JAX's tokens and caches step by step, and the port's
    own `forward` argmax at every position, the ring buffer included
    (window 4, cache 4, 12 steps);
  * `loss_fn` and its gradients with labels -1 and below -V masked:
    equal to JAX's and free of NaN; `remat=True` equal to `remat=False`;
  * `init_params`: JAX's tree names, shapes and dtypes, the draw scales,
    `sw1 == sw3` at init; `param_count`, `active_param_count` and every
    field of the five full configs equal to JAX's (arithmetic only).

Tolerances: fp32 logits and caches within 1e-5 of their largest
magnitude; losses rtol 1e-5; gradients rtol 1e-4 with atol 1e-5 of each
tensor's largest entry; tokens, positions and config fields exactly.  bf16
logits within 3e-2 of their largest magnitude (JAX's CPU backend keeps
fp32 between fused bf16 ops where the port rounds each op; both lie that
far from the fp32 logits of the same weights).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro_torch.convert import load_jax_params
from repro_torch.models import lm as L

BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=97)
DENSE = {
    "gemma2": dict(window_pattern=(8, 0), attn_softcap=50.0,
                   logit_softcap=30.0, query_scale=256 ** -0.5,
                   post_norms=True, tie_embeddings=True),
    "glm4": dict(rope_fraction=0.5),
    "danube": dict(window_pattern=(4,)),
}
MOE = dict(n_experts=6, top_k=2, d_ff_expert=32, n_shared=1,
           n_experts_padded=8)
CONFIGS = {**DENSE, "moe": dict(moe=MOE)}
FULL = ("gemma2_2b", "glm4_9b", "h2o_danube_1_8b", "kimi_k2_1t_a32b",
        "qwen2_moe_a2_7b")
LOGIT_TOL, BF16_TOL = 1e-5, 3e-2
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", remat=False, **kw):
    kw = {**BASE, **kw}
    moe = kw.pop("moe", None)
    jcfg = JL.LMConfig(**kw, moe=moe and JL.MoESettings(**moe),
                       dtype=getattr(jnp, dtype), remat=remat)
    cfg = L.LMConfig(**kw, moe=moe and L.MoESettings(**moe),
                     dtype=getattr(torch, dtype), remat=remat)
    return jcfg, cfg


def _pair(key=0, **kw):
    """(JAX config, JAX params, port model with JAX's params)."""
    jcfg, cfg = _cfgs(**kw)
    jp = JL.init_params(jcfg, jax.random.key(key))
    model = L.init_params(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp))
    return jcfg, jp, model


def _flat(tree) -> dict:
    def name(path):
        return ".".join(str(k.key) for k in path)
    return {name(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(seed, shape, vocab=BASE["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= tol * np.abs(want).max(), err


def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_equals_jax(name):
    jcfg, jp, model = _pair(**CONFIGS[name])
    toks = _tokens(1, (2, 16))
    jl, ja = jax.jit(lambda p, t: JL.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    logits, aux = model(torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    _close_scaled(_np(logits), jl, LOGIT_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ja), rtol=1e-5)
    if name != "moe":
        assert float(aux.detach()) == 0.0


def test_forward_bf16_equals_jax():
    """gemma2's features in bf16: JAX's bf16 tree loaded bit for bit; the
    port's logits within BF16_TOL of JAX's, and no farther from the fp32
    logits of the same weights than twice JAX's own distance."""
    jcfg, jp, model = _pair(dtype="bfloat16", **DENSE["gemma2"])
    assert model.attn["wq"].dtype == torch.bfloat16
    assert torch.equal(model.attn["wq"].view(torch.int16), torch.from_numpy(
        np.array(jp["attn"]["wq"]).view(np.int16)))
    toks = _tokens(2, (2, 16))
    jl, _ = jax.jit(lambda p, t: JL.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    got = _np(model(torch.from_numpy(toks))[0])
    _close_scaled(got, jl, BF16_TOL)
    jcfg32, _ = _cfgs(**DENSE["gemma2"])
    j32, _ = jax.jit(lambda p, t: JL.forward(jcfg32, p, t))(jax.tree.map(
        lambda a: a.astype(jnp.float32), jp), jnp.asarray(toks))
    j32 = np.asarray(j32)
    assert np.abs(got - j32).max() <= 2 * np.abs(np.asarray(jl) - j32).max()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,steps,max_seq", [
    ("gemma2", 16, 32), ("glm4", 16, 32), ("danube", 12, 64),
    ("moe", 16, 32)])
def test_decode_equals_jax_and_forward(name, steps, max_seq):
    """Each step's greedy token equals JAX's and the port's own forward
    argmax at that position (teacher-forced); the caches equal JAX's after
    the last step.  danube: window 4 -> a 4-slot ring buffer over 12
    steps."""
    jcfg, jp, model = _pair(**CONFIGS[name])
    toks = _tokens(3, (2, steps))
    cache = L.init_cache(model.cfg, 2, max_seq, device="cpu")
    jcache = JL.init_cache(jcfg, 2, max_seq)
    assert cache["k"].shape == tuple(jcache["k"].shape)
    if name == "danube":
        assert cache["k"].shape[2] == 4
    jstep = jax.jit(lambda c, t, i: JL.decode_step(jcfg, jp, c, t, i))
    logits, _ = model(torch.from_numpy(toks))
    want_fwd = torch.argmax(logits, dim=-1).to(torch.int32)
    for t in range(steps):
        nxt, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]),
                                       t)
        jnxt, jcache = jstep(jcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        assert torch.equal(nxt, want_fwd[:, t]), t
    for k in ("k", "v"):
        _close_scaled(_np(cache[k]), jcache[k], LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_decode_argmax_ties_take_the_lowest_index():
    """Zeroed unembedding: every logit ties, and the greedy token is 0, as
    `jnp.argmax` gives."""
    jcfg, jp, model = _pair(**DENSE["glm4"])
    with torch.no_grad():
        model.unembed.zero_()
    jp = {**jp, "unembed": jnp.zeros_like(jp["unembed"])}
    cache = L.init_cache(model.cfg, 2, 8, device="cpu")
    nxt, _ = model.decode_step(cache, torch.tensor([5, 7]), 0)
    jnxt, _ = jax.jit(lambda p, c, t: JL.decode_step(jcfg, p, c, t, 0))(
        jp, JL.init_cache(jcfg, 2, 8), jnp.asarray([5, 7]))
    assert nxt.tolist() == np.asarray(jnxt).tolist() == [0, 0]


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _labels(seed, vocab=BASE["vocab"]):
    labels = _tokens(seed, (2, 16))
    labels[0, :3] = -1
    labels[1, 5] = -vocab - 3          # below -V: JAX's take gives NaN
    labels[1, 9] = -7                  # wraps to V - 7, masked
    return labels


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_equal_jax(name):
    jcfg, jp, model = _pair(**CONFIGS[name])
    toks, labels = _tokens(4, (2, 16)), _labels(5)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: JL.loss_fn(
        jcfg, p, jnp.asarray(toks), jnp.asarray(labels))))(jp)
    loss = model.loss(torch.from_numpy(toks), torch.from_numpy(labels))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert np.isfinite(float(loss.detach())) and np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _flat(jg)
    assert sorted(names) == sorted(want)
    for k, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), k
        _grad_close(_np(g), want[k])


@pytest.mark.parametrize("name", ["gemma2", "moe"])
def test_remat_equals_no_remat(name):
    """torch.utils.checkpoint recomputes each layer: the loss and every
    gradient are the same bits as without it."""
    _, jp, model = _pair(**CONFIGS[name])
    _, cfg = _cfgs(remat=True, **CONFIGS[name])
    remat = load_jax_params(L.init_params(cfg, device="cpu"),
                            jax.tree.map(np.asarray, jp))
    toks, labels = torch.from_numpy(_tokens(6, (2, 16))), \
        torch.from_numpy(_labels(7))
    out = []
    for m in (model, remat):
        loss = m.loss(toks, labels)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# parameters and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2", "glm4", "moe"])
def test_init_params_matches_jax_tree(name):
    """Names, shapes and dtypes of JAX's tree (bf16, the router fp32), the
    draw scales 1/sqrt(shape[-2]), and sw1 == sw3 (one JAX key)."""
    jcfg, cfg = _cfgs(dtype="bfloat16", **CONFIGS[name])
    want = _flat(jax.eval_shape(lambda k: JL.init_params(jcfg, k),
                                jax.random.key(0)))
    model = L.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        assert tuple(p.shape) == tuple(want[k].shape), k
        assert str(p.dtype).split(".")[1] == str(want[k].dtype), k
    for k, p in got.items():
        std = float(p.float().std())
        if k.endswith("ln") or k.endswith("ln_post") or k == "ln_f":
            assert bool((p == 1).all()), k
        else:
            assert abs(std * np.sqrt(p.shape[-2]) - 1) < 0.1, (k, std)
    if name == "moe":
        assert torch.equal(got["mlp.sw1"], got["mlp.sw3"])
        assert got["mlp.router"].dtype == torch.float32
    # param_count counts the routed experts, the tree allocates phantoms
    phantom = cfg.moe.e_alloc - cfg.moe.n_experts if cfg.moe else 0
    n = sum(p.numel() for k, p in got.items() if "ln" not in k)
    assert n == cfg.param_count() + BASE["n_layers"] * BASE["d_model"] * \
        phantom * (1 + 3 * MOE["d_ff_expert"])


@pytest.mark.parametrize("mod", FULL)
def test_full_configs_and_counts_equal_jax(mod):
    """Arithmetic only: no parameter of the full configs is allocated."""
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    ref = importlib.import_module(f"repro.configs.{mod}")
    cfg, jcfg = port.CONFIG, ref.CONFIG
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert a.pop("dtype") == torch.bfloat16 and b.pop("dtype") == jnp.bfloat16
    assert a == b
    assert cfg.windows == jcfg.windows
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert port.SKIP_SHAPES == ref.SKIP_SHAPES
    assert port.__doc__.split("\n")[0] == ref.__doc__.split("\n")[0]
    if cfg.moe:
        assert cfg.moe.e_alloc == jcfg.moe.e_alloc


def test_building_blocks_equal_jax():
    """rmsnorm (fp32 normalise, cast back, then scale), rope at fraction
    0.5 with odd rotary widths rounded down, attention with a window,
    a softcap and invalid keys, swiglu."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 3, 14)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    jrope = jax.jit(JL.rope, static_argnums=(2, 3))
    for frac in (1.0, 0.5, 0.3, 0.0):
        _close_scaled(_np(L.rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1e4, frac)),
                      jrope(jnp.asarray(x), jnp.asarray(pos), 1e4, frac),
                      1e-6)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    _close_scaled(_np(L.rmsnorm(torch.from_numpy(h), torch.from_numpy(s))),
                  jax.jit(JL.rmsnorm)(jnp.asarray(h), jnp.asarray(s)), 1e-6)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    qp = np.broadcast_to(np.arange(2, 7, dtype=np.int32), (2, 5))
    kp = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    valid = rng.random((2, 7)) < 0.8
    for window in (0, 3):
        got = L.attention(*(torch.from_numpy(np.array(a)) for a in
                            (q, k, v, qp, kp)), window=window, softcap=5.0,
                          scale=0.3, k_valid=torch.from_numpy(valid))
        want = jax.jit(lambda q, k, v, qp, kp, kv, w=window: JL.attention(
            q, k, v, qp, kp, window=w, softcap=5.0, scale=0.3,
            k_valid=kv))(*(jnp.asarray(a) for a in (q, k, v, qp, kp,
                                                     valid)))
        _close_scaled(_np(got), want, 1e-6)
    w1, w3 = (rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(2))
    w2 = rng.standard_normal((24, 16)).astype(np.float32)
    _close_scaled(_np(L.swiglu(*(torch.from_numpy(a) for a in
                                 (h, w1, w3, w2)))),
                  jax.jit(JL.swiglu)(*(jnp.asarray(a) for a in
                                       (h, w1, w3, w2))), 1e-6)
