"""Keras-semantics dropout in the LSTM layer."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import init_lstm_layer, lstm_layer_apply


@pytest.fixture(scope="module")
def layer():
    return init_lstm_layer(jax.random.PRNGKey(0), 6, 10)


@pytest.fixture(scope="module")
def x(rng_mod=np.random.default_rng(5)):
    return jnp.asarray(rng_mod.normal(size=(4, 20, 6)), jnp.float32)


def test_zero_rate_is_identity(layer, x):
    a = lstm_layer_apply(layer, x)
    b = lstm_layer_apply(layer, x, dropout=0.0, recurrent_dropout=0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_requires_rng(layer, x):
    with pytest.raises(ValueError):
        lstm_layer_apply(layer, x, dropout=0.3)


def test_dropout_changes_output_deterministically(layer, x):
    k = jax.random.PRNGKey(42)
    a = lstm_layer_apply(layer, x, dropout=0.4, rng=k)
    b = lstm_layer_apply(layer, x, dropout=0.4, rng=k)
    c = lstm_layer_apply(layer, x, dropout=0.4, rng=jax.random.PRNGKey(43))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # same key
    assert not np.allclose(np.asarray(a), np.asarray(c))         # different key
    assert not np.allclose(np.asarray(a), np.asarray(lstm_layer_apply(layer, x)))


def test_recurrent_dropout(layer, x):
    k = jax.random.PRNGKey(1)
    a = lstm_layer_apply(layer, x, recurrent_dropout=0.4, rng=k)
    assert np.isfinite(np.asarray(a)).all()
    assert not np.allclose(np.asarray(a), np.asarray(lstm_layer_apply(layer, x)))


def test_inverted_scaling_keeps_expectation(layer):
    """With a mask of rate p, E[masked x] = x — check the empirical mean of
    the gate pre-activations stays close to the undropped one."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 5, 6)), jnp.float32)
    outs = []
    for i in range(16):
        outs.append(
            np.asarray(
                lstm_layer_apply(layer, x, dropout=0.3, rng=jax.random.PRNGKey(i))
            )
        )
    mean_drop = np.mean(outs, axis=0)
    ref = np.asarray(lstm_layer_apply(layer, x))
    # nonlinearity biases the mean slightly; loose tolerance
    assert np.abs(mean_drop - ref).mean() < 0.05


# ---------------------------------------------------------------------------
# Dropout in the factorized (singular) forward — reference
# code/svd_classes_v3.py:121-137 (merged: one mask) and :154-205 (split:
# per-gate masks).
# ---------------------------------------------------------------------------

from svd_lstm_tpu.factor.svd import make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.models.singular import (
    dropout_masks,
    singular_layer_apply,
    singular_lstm_apply,
)
from svd_lstm_tpu.models.lstm import gate_update


@pytest.fixture(scope="module", params=[False, True], ids=["split", "merged"])
def smodel(request):
    dense = init_stacked_lstm(jax.random.PRNGKey(2), input_dim=6, units=(10, 10))
    return make_singular_model(dense, merged_kernel=request.param)


@pytest.fixture(scope="module")
def xs():
    return jnp.asarray(np.random.default_rng(9).normal(size=(4, 12, 6)), jnp.float32)


def test_singular_zero_rate_is_identity(smodel, xs):
    a = singular_lstm_apply(smodel, xs)
    b = singular_lstm_apply(smodel, xs, dropout=0.0, recurrent_dropout=0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_singular_dropout_requires_rng(smodel, xs):
    with pytest.raises(ValueError):
        singular_lstm_apply(smodel, xs, dropout=0.3)
    with pytest.raises(ValueError):
        singular_layer_apply(smodel.layers[0], xs, recurrent_dropout=0.3)


def test_singular_input_masks_constant_across_time(smodel, xs):
    """A time-constant input must produce a time-constant masked gate
    projection — i.e. ONE mask drawn per call and reused at every timestep
    (Keras get_dropout_mask_for_cell semantics, reference :121-124)."""
    from svd_lstm_tpu.models.singular import _masked_input_projection

    layer = smodel.layers[0]
    B, T, d = xs.shape
    count = 4 if layer.split else 1
    dp = dropout_masks(jax.random.PRNGKey(3), 0.5, (B, d), count, jnp.float32)
    x_const = jnp.broadcast_to(xs[:, :1], xs.shape)
    xp = np.asarray(_masked_input_projection(layer, x_const, dp))
    np.testing.assert_allclose(xp, np.broadcast_to(xp[:, :1], xp.shape), atol=1e-6)


def test_singular_dropout_matches_manual_reference(smodel, xs):
    """Replicate the reference cell math step-by-step with explicitly drawn
    masks (merged: dp_mask[0] on inputs, rec_dp_mask[0] on h, reference
    :125-137; split: per-gate masks through per-gate factor chains,
    reference :154-205) and compare against the scan implementation."""
    p = smodel.layers[0]
    B, T, d = xs.shape
    n = p.units
    rate, rrate = 0.4, 0.3
    rng = jax.random.PRNGKey(11)
    k_dp, k_rdp = jax.random.split(rng)
    count = 4 if p.split else 1
    dp = np.asarray(dropout_masks(k_dp, rate, (B, d), count, jnp.float32))
    rdp = np.asarray(dropout_masks(k_rdp, rrate, (B, n), count, jnp.float32))

    wl, ws, wr = np.asarray(p.wl), np.asarray(p.ws), np.asarray(p.wr)
    ul, us, ur = np.asarray(p.ul), np.asarray(p.us), np.asarray(p.ur)
    b = np.asarray(p.b)
    x = np.asarray(xs)

    def three(v, left, sig, right, masks):
        if p.split:  # per-gate chains
            return np.concatenate(
                [((v * masks[g]) @ left[g] * sig[g]) @ right[g] for g in range(4)],
                axis=-1,
            )
        return ((v * masks[0]) @ left * sig) @ right

    h = np.zeros((B, n), np.float32)
    c = np.zeros((B, n), np.float32)
    outs = []
    for t in range(T):
        z = three(x[:, t], wl, ws, wr, dp) + b + three(h, ul, us, ur, rdp)
        h_j, c_j = gate_update(jnp.asarray(z), jnp.asarray(c))
        h, c = np.asarray(h_j), np.asarray(c_j)
        outs.append(h)
    expected = np.stack(outs, axis=1)

    got = np.asarray(
        singular_layer_apply(p, xs, dropout=rate, recurrent_dropout=rrate, rng=rng)
    )
    np.testing.assert_allclose(got, expected, atol=2e-5)


def test_finetune_runs_with_dropout():
    """Fine-tune with dropout enabled trains and validates finitely
    (validation runs deterministic — no rng — like Keras training=False)."""
    from svd_lstm_tpu.config import FactorConfig, TrainConfig
    from svd_lstm_tpu.train.finetune import finetune

    rng = np.random.default_rng(4)
    T = 300
    X = rng.normal(size=(1, T, 6)).astype(np.float32)
    y = np.convolve(X[0, :, 0], np.ones(5) / 5, mode="same").astype(np.float32)

    dense = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=6, units=(8,))
    sm = make_singular_model(dense, merged_kernel=False)
    fcfg = FactorConfig(dropout=0.25, recurrent_dropout=0.25, hoyer=0.01)
    tcfg = TrainConfig(num_windows=64, window_len=16, batch_size=16, epochs=2)
    res = finetune(sm, X, y, factor_cfg=fcfg, train_cfg=tcfg)
    assert len(res.history) == 2
    assert np.isfinite(res.history).all()
