"""Dense LSTM numerics: verified against torch.nn.LSTM as an independent
oracle (same cell equations as Keras: gate order i,f,g,o; sigmoid/tanh)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from svd_lstm_tpu.models.lstm import (
    LSTMLayerParams,
    init_stacked_lstm,
    lstm_cell_step,
    lstm_layer_apply,
    stacked_lstm_apply,
)


def _random_layer(rng, d, n):
    return LSTMLayerParams(
        W=jnp.asarray(rng.normal(scale=0.3, size=(d, 4 * n)), jnp.float32),
        U=jnp.asarray(rng.normal(scale=0.3, size=(n, 4 * n)), jnp.float32),
        b=jnp.asarray(rng.normal(scale=0.1, size=(4 * n,)), jnp.float32),
    )


class TestVsTorch:
    @pytest.mark.parametrize("d,n,T,B", [(16, 40, 37, 2), (1, 30, 25, 3), (8, 8, 10, 1)])
    def test_layer_matches_torch(self, rng, d, n, T, B):
        torch = pytest.importorskip("torch")
        p = _random_layer(rng, d, n)
        x = rng.normal(size=(B, T, d)).astype(np.float32)

        ours = np.asarray(lstm_layer_apply(p, jnp.asarray(x)))

        m = torch.nn.LSTM(d, n, batch_first=True)
        with torch.no_grad():
            m.weight_ih_l0.copy_(torch.tensor(np.asarray(p.W).T))
            m.weight_hh_l0.copy_(torch.tensor(np.asarray(p.U).T))
            m.bias_ih_l0.copy_(torch.tensor(np.asarray(p.b)))
            m.bias_hh_l0.zero_()
            theirs, _ = m(torch.tensor(x))
        np.testing.assert_allclose(ours, theirs.numpy(), atol=1e-4)

    def test_stacked_matches_torch(self, rng):
        torch = pytest.importorskip("torch")
        key = jax.random.PRNGKey(0)
        params = init_stacked_lstm(key, input_dim=16, units=(20, 12))
        x = rng.normal(size=(2, 30, 16)).astype(np.float32)

        ours = np.asarray(stacked_lstm_apply(params, jnp.asarray(x)))

        h = torch.tensor(x)
        for layer in params.layers:
            d, n = layer.W.shape[0], layer.units
            m = torch.nn.LSTM(d, n, batch_first=True)
            with torch.no_grad():
                m.weight_ih_l0.copy_(torch.tensor(np.asarray(layer.W).T))
                m.weight_hh_l0.copy_(torch.tensor(np.asarray(layer.U).T))
                m.bias_ih_l0.copy_(torch.tensor(np.asarray(layer.b)))
                m.bias_hh_l0.zero_()
                h, _ = m(h)
        with torch.no_grad():
            out = h @ torch.tensor(np.asarray(params.head.w)) + torch.tensor(
                np.asarray(params.head.b)
            )
        np.testing.assert_allclose(ours, out.numpy(), atol=5e-5)


class TestCellStep:
    def test_step_equals_scan(self, rng):
        """The batch-1 real-time step (deployment semantics) must agree with
        the scan path exactly."""
        p = _random_layer(rng, 16, 24)
        x = jnp.asarray(rng.normal(size=(1, 10, 16)), jnp.float32)
        seq = lstm_layer_apply(p, x)

        h = jnp.zeros((1, 24))
        c = jnp.zeros((1, 24))
        outs = []
        for t in range(10):
            h, c = lstm_cell_step(p, x[:, t], h, c)
            outs.append(h)
        manual = jnp.stack(outs, axis=1)
        np.testing.assert_allclose(np.asarray(seq), np.asarray(manual), atol=1e-6)

    def test_return_sequences_false(self, rng):
        key = jax.random.PRNGKey(1)
        params = init_stacked_lstm(key, input_dim=4, units=(8,))
        x = jnp.asarray(rng.normal(size=(3, 12, 4)), jnp.float32)
        full = stacked_lstm_apply(params, x, return_sequences=True)
        last = stacked_lstm_apply(params, x, return_sequences=False)
        np.testing.assert_allclose(np.asarray(full[:, -1]), np.asarray(last), atol=1e-6)


class TestInit:
    def test_forget_bias_and_shapes(self):
        params = init_stacked_lstm(jax.random.PRNGKey(0), 16, (40, 40), head_dim=1)
        l0 = params.layers[0]
        assert l0.W.shape == (16, 160) and l0.U.shape == (40, 160)
        b = np.asarray(l0.b)
        assert (b[40:80] == 1.0).all()  # unit forget bias
        assert (b[:40] == 0.0).all() and (b[80:] == 0.0).all()
        # recurrent init orthogonal per gate block
        U = np.asarray(l0.U)
        blk = U[:, :40]
        np.testing.assert_allclose(blk.T @ blk, np.eye(40), atol=1e-5)

    def test_jit_forward(self, rng):
        params = init_stacked_lstm(jax.random.PRNGKey(0), 16, (40, 40, 40, 40))
        f = jax.jit(lambda p, x: stacked_lstm_apply(p, x, return_sequences=False))
        x = jnp.asarray(rng.normal(size=(4, 50, 16)), jnp.float32)
        out = f(params, x)
        assert out.shape == (4, 1)
        assert np.isfinite(np.asarray(out)).all()


def test_gate_update_bwd_matches_autodiff(rng):
    """cell_update_bwd is THE cell-gradient formula the backward kernel
    calls; pin it directly against jax's VJP of gate_update (the kernel's
    own parity tests validate it only end-to-end)."""
    from svd_lstm_tpu.models.lstm import cell_update_bwd, gate_update, split_gates

    B, n = 3, 7
    z = jnp.asarray(rng.normal(size=(B, 4 * n)), jnp.float32)
    c_prev = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    dh = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    dc = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)

    (h, c_t), vjp = jax.vjp(gate_update, z, c_prev)
    dz_ref, dcp_ref = vjp((dh, dc))
    dz, dcp = cell_update_bwd(*split_gates(z), c_prev, c_t, dh, dc)
    dz = jnp.concatenate(dz, axis=-1)
    np.testing.assert_allclose(np.asarray(dz), np.asarray(dz_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(dcp), np.asarray(dcp_ref), atol=1e-6)
