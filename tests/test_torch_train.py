"""The port's train and serve steps (`repro_torch.train`) against the JAX
package's (`repro.train`), on the CPU:

  * `make_train_step` over the LM's `loss_fn` for two steps (the moments
    carry): the loss, grad norm, lr, every parameter, both moments and
    the step equal JAX's, with `microbatches` 1 and 2 (fp32 sums divided
    by the count) and with `compress_frac` (top-k with error feedback,
    the residual tree equal too);
  * the compressed step converging on a quadratic (tests/
    test_integration_extra.py's `test_train_step_with_gradient_
    compression`), the microbatched one too (tests/test_substrate.py's
    `test_train_step_microbatching`), and `TrainState.tree()` holding the
    step's tensors, not copies;
  * `make_serve_step` over `decode_step`: the tokens of JAX's serve step.

Tolerances: losses, grad norms and lr rtol 1e-5; parameters, moments and
residuals rtol 1e-4 with atol 1e-5 of each tensor's largest entry (a
parameter that AdamW moves by lr keeps its operands' absolute error);
tokens and steps exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_serve_step as jax_make_serve_step
from repro.train import make_train_step as jax_make_train_step
from repro.train.train_step import init_state as jax_init_state
from repro_torch.convert import load_jax_params, params_to_numpy
from repro_torch.models import lm as L
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, TrainState, make_serve_step, \
    make_train_step
from repro_torch.train.train_step import init_state

KW = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
          d_head=8, d_ff=64, vocab=61, window_pattern=(8, 0),
          attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
          tie_embeddings=True, remat=False)
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, weight_decay=0.1)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
    return {name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


def _batches(micro):
    rng = np.random.default_rng(3)
    shape = (2, 2, 12) if micro > 1 else (2, 12)
    out = []
    for _ in range(2):
        toks = rng.integers(0, KW["vocab"], shape).astype(np.int32)
        labels = np.roll(toks, -1, axis=-1)
        labels[..., -1] = -1
        out.append((toks, labels))
    return out


@pytest.mark.parametrize("micro,frac", [(1, None), (2, None), (1, 0.05)],
                         ids=["plain", "microbatches", "compressed"])
def test_train_step_equals_jax(micro, frac):
    jcfg = JL.LMConfig(**KW, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.key(0))
    jtc = JTrainConfig(optimizer=JAdamWConfig(**OPT), microbatches=micro,
                       compress_frac=frac)
    jstep = jax.jit(jax_make_train_step(
        lambda p, b: JL.loss_fn(jcfg, p, b[0], b[1]), jtc))
    jstate = jax_init_state(jtc, jp).tree()

    model = L.init_params(L.LMConfig(**KW, dtype=torch.float32),
                          device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp))
    tc = TrainConfig(optimizer=AdamWConfig(**OPT), microbatches=micro,
                     compress_frac=frac)
    step = make_train_step(lambda p, b: model.loss(b[0], b[1]), tc)
    state = init_state(tc, dict(model.named_parameters())).tree()
    assert (state["err"] is None) == (frac is None)

    for toks, labels in _batches(micro):
        jstate, jinfo = jstep(jstate, (jnp.asarray(toks),
                                       jnp.asarray(labels)))
        state, info = step(state, (torch.from_numpy(toks),
                                   torch.from_numpy(labels)))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(info[k]), float(jinfo[k]),
                                       rtol=1e-5)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])
        back = _flat(params_to_numpy(model))
        want = _flat(jstate["params"])
        assert sorted(back) == sorted(want)
        for k in want:
            _close(back[k], want[k])
            assert state["params"][k] is dict(model.named_parameters())[k]
        for m in ("mu", "nu") + (("err",) if frac else ()):
            tree = state["err"] if m == "err" else state["opt"][m]
            want = _flat(jstate["err"] if m == "err" else jstate["opt"][m])
            for k, v in tree.items():
                _close(v, want[k])


def test_compressed_step_converges_on_a_quadratic():
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    tc = TrainConfig(optimizer=AdamWConfig(lr=0.1, weight_decay=0.0,
                                           warmup_steps=0),
                     compress_frac=0.5)
    step = make_train_step(lambda p, b: torch.sum((p["w"] - target) ** 2),
                           tc)
    st = init_state(tc, {"w": torch.zeros(4)}).tree()
    assert st["err"] is not None
    for _ in range(300):
        st, info = step(st, None)
    np.testing.assert_allclose(st["params"]["w"].detach().numpy(),
                               target.numpy(), atol=0.1)


def test_train_step_microbatching_converges():
    """tests/test_substrate.py's quadratic over 4 microbatches (a leading
    microbatch axis): the parameters reach the target."""
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    tc = TrainConfig(optimizer=AdamWConfig(lr=0.05, weight_decay=0.0,
                                           warmup_steps=0), microbatches=4)
    step = make_train_step(
        lambda p, b: torch.sum((p["w"] - target) ** 2) + 0.0 * b.sum(), tc)
    st = init_state(tc, {"w": torch.zeros(4)}).tree()
    for _ in range(200):
        st, info = step(st, torch.zeros((4, 1)))
    np.testing.assert_allclose(st["params"]["w"].detach().numpy(),
                               target.numpy(), atol=5e-2)


def test_train_state_tree_holds_the_tensors():
    w = torch.zeros(3)
    st = TrainState(params={"w": w}, opt={"step": torch.zeros(())})
    assert st.tree()["params"]["w"] is w and st.tree()["err"] is None


def test_serve_step_equals_jax():
    jcfg = JL.LMConfig(**KW, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.key(1))
    model = load_jax_params(L.init_params(L.LMConfig(**KW,
                                                     dtype=torch.float32),
                                          device="cpu"),
                            jax.tree.map(np.asarray, jp))
    serve = make_serve_step(lambda p, c, t, i: model.decode_step(c, t, i))
    jserve = jax.jit(jax_make_serve_step(
        lambda p, c, t, i: JL.decode_step(jcfg, p, c, t, i)))
    cache = L.init_cache(model.cfg, 3, 16, device="cpu")
    jcache = JL.init_cache(jcfg, 3, 16)
    tok = np.array([1, 5, 9], np.int32)
    jtok = jnp.asarray(tok)
    got = torch.from_numpy(tok)
    for t in range(10):
        got, cache = serve(None, cache, got, t)
        jtok, jcache = jserve(jp, jcache, jtok, jnp.int32(t))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtok))
