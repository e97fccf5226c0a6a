"""The port's DeepFM (`repro_torch.models.recsys.deepfm`) against the JAX
package's, on the CPU, with JAX's parameters carried across
(`convert.load_jax_params`):

  * `forward`, `loss` and every gradient against `jax.value_and_grad`, and
    `score_candidates`, on `smoke_deepfm`'s config;
  * ids past a field's vocabulary and negative ids take JAX's `jnp.take`
    rule (wrap, NaN past either end of the table);
  * the FM term equals the pairwise sum (tests/test_models_lm_recsys.py);
  * `CRITEO_VOCABS`, `n_fields`, `total_rows` and `field_offsets` of the
    Criteo config equal JAX's, without allocating its 33.8M-row table.

Tolerance: rtol 1e-4, atol 1e-5; integers and config fields exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import deepfm as JD
from repro_torch.convert import load_jax_params
from repro_torch.models.recsys import deepfm as D

RTOL, ATOL = 1e-4, 1e-5
SMOKE = dict(name="deepfm-smoke", embed_dim=4, mlp=(16, 16),
             vocabs=(8, 16, 32, 8))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _pair(key=0, **cfg):
    jcfg = JD.DeepFMConfig(**cfg)
    jp = JD.init_params(jcfg, jax.random.key(key))
    model = D.init_params(D.DeepFMConfig(**cfg), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp))
    return jp, model, jcfg


def _ids(rng, vocabs, batch):
    return np.stack([rng.integers(0, v, batch) for v in vocabs],
                    1).astype(np.int32)


def test_forward_loss_grads_equal_jax():
    jp, model, jcfg = _pair(**SMOKE)
    rng = np.random.default_rng(1)
    idx = _ids(rng, SMOKE["vocabs"], 8)
    y = (rng.random(8) > 0.5).astype(np.float32)
    jfwd, (want, jg) = jax.jit(lambda p: (
        JD.forward(jcfg, p, jnp.asarray(idx)),
        jax.value_and_grad(lambda q: JD.loss_fn(
            jcfg, q, jnp.asarray(idx), jnp.asarray(y)))(p)))(jp)
    _close(model(_t(idx)), jfwd)
    loss = model.loss(_t(idx), _t(y))
    _close(loss, want)
    loss.backward()
    _close(model.table.grad, jg["table"])
    _close(model.linear.grad, jg["linear"])
    _close(model.bias.grad, jg["bias"])
    for got, w in zip(model.mlp, jg["mlp"]):
        _close(got.grad, w)


def test_score_candidates_equals_jax():
    jp, model, jcfg = _pair(key=2, **SMOKE)
    user = np.array([1, 2], np.int32)
    cands = np.random.default_rng(3).integers(0, 8, (50, 2)).astype(np.int32)
    _close(model.score_candidates(_t(user), _t(cands)),
           JD.score_candidates(jcfg, jp, jnp.asarray(user),
                               jnp.asarray(cands)))


def test_out_of_range_ids_follow_jnp_take():
    jp, model, jcfg = _pair(**SMOKE)
    total = jcfg.total_rows
    idx = np.array([[0, 1, 2, 3], [-1, 0, 0, 0], [total, 0, 0, 0],
                    [-total - 1, 0, 0, 0], [9, 17, 33, 9]], np.int32)
    got = model(_t(idx)).detach().numpy()
    want = np.asarray(JD.forward(jcfg, jp, jnp.asarray(idx)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fm_matches_pairwise():
    """FM identity: 0.5((sum v)^2 - sum v^2) == sum_{i<j} <v_i, v_j>."""
    cfg = D.DeepFMConfig(name="t", embed_dim=3, mlp=(4,), vocabs=(5, 5, 5))
    model = D.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with torch.no_grad():
        for w in model.mlp:
            w.zero_()
        model.linear.zero_()
    idx = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    got = float(model(idx)[0].detach())
    rows = idx[0] + model.field_offsets()
    v = model.table.detach()[rows.long()].double()
    want = sum(float(v[i] @ v[j]) for i in range(3)
               for j in range(i + 1, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_criteo_config_equals_jax():
    """The Criteo config's vocabularies and derived sizes, without the
    33.8M x 10 table."""
    assert D.CRITEO_VOCABS == JD.CRITEO_VOCABS
    cfg, jcfg = D.DeepFMConfig("deepfm"), JD.DeepFMConfig("deepfm")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_fields, cfg.total_rows) == (jcfg.n_fields, jcfg.total_rows)
    assert cfg.total_rows % 512 == 0
    got = D.field_offsets(cfg, device="cpu")
    want = np.asarray(JD.field_offsets(jcfg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_module_field_offsets_and_devices():
    model = D.init_params(D.DeepFMConfig(**SMOKE), device="cpu")
    np.testing.assert_array_equal(
        model.field_offsets().numpy(),
        D.field_offsets(D.DeepFMConfig(**SMOKE), device="cpu").numpy())
    assert {n for n, _ in model.named_parameters()} == {
        "table", "linear", "bias", "mlp.0", "mlp.1", "mlp.2"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, {"table": np.zeros((512, 4), np.float32)})
