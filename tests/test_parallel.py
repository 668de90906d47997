"""Sharded training/inference on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax

from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.parallel.mesh import make_mesh
from svd_lstm_tpu.parallel.train import (
    make_batched_inference,
    make_sharded_train_step,
    shard_layer_tp,
    shard_params_for_mesh,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(16, 30, 8)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    return x, y


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestTpSlicing:
    def test_slices_partition_columns(self):
        params = init_stacked_lstm(jax.random.PRNGKey(0), 8, (8,))
        layer = params.layers[0]
        s0 = shard_layer_tp(layer, 2, 0)
        s1 = shard_layer_tp(layer, 2, 1)
        # gate i of the full layer = [s0 gate i | s1 gate i]
        W = np.asarray(layer.W)
        np.testing.assert_array_equal(np.asarray(s0.W)[:, :4], W[:, 0:4])
        np.testing.assert_array_equal(np.asarray(s1.W)[:, :4], W[:, 4:8])
        np.testing.assert_array_equal(np.asarray(s0.W)[:, 4:8], W[:, 8:12])


class TestShardedTrainStep:
    @pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
    def test_sgd_step_matches_true_gradient(self, data, dp, tp):
        """One sharded SGD step moves every parameter by exactly lr times
        the single-device gradient: no reduction is applied twice (adam's
        first step, ~ lr * sign(g), cannot see a gradient scaled by the
        device count)."""
        from svd_lstm_tpu.parallel.train import unshard_params_from_mesh

        x, y = data
        mesh = make_mesh(dp=dp, tp=tp)
        params = init_stacked_lstm(jax.random.PRNGKey(1), 8, (8, 8))
        opt = optax.sgd(1.0)
        sharded = shard_params_for_mesh(params, mesh)
        new, _, _ = make_sharded_train_step(mesh, opt)(sharded, opt.init(sharded), x, y)
        new = unshard_params_from_mesh(jax.device_get(new), tp)

        def loss(p):
            pred = stacked_lstm_apply(p, x, return_sequences=False)[..., 0]
            return jnp.mean(jnp.square(pred - y))

        g = jax.grad(loss)(params)
        for a, p0, gi in zip(jax.tree.leaves(new), jax.tree.leaves(params), jax.tree.leaves(g)):
            np.testing.assert_allclose(np.asarray(p0) - np.asarray(a), np.asarray(gi), atol=1e-6)

    @pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
    def test_loss_matches_unsharded(self, data, dp, tp):
        """One sharded train step must produce the same loss as the
        single-device reference step (same params, same batch)."""
        x, y = data
        mesh = make_mesh(dp=dp, tp=tp)
        params = init_stacked_lstm(jax.random.PRNGKey(1), 8, (8, 8))
        opt = optax.adam(1e-3)

        sharded = shard_params_for_mesh(params, mesh)
        opt_state = opt.init(sharded)
        step = make_sharded_train_step(mesh, opt)
        _, _, loss = step(sharded, opt_state, x, y)

        pred = stacked_lstm_apply(params, x, return_sequences=False)[..., 0]
        ref_loss = float(jnp.mean(jnp.square(pred - y)))
        assert float(loss) == pytest.approx(ref_loss, rel=1e-4)

    def test_loss_decreases_over_steps(self, data):
        x, y = data
        mesh = make_mesh(dp=4, tp=2)
        params = init_stacked_lstm(jax.random.PRNGKey(2), 8, (8, 8))
        opt = optax.adam(1e-2)
        sharded = shard_params_for_mesh(params, mesh)
        opt_state = opt.init(sharded)
        step = make_sharded_train_step(mesh, opt)
        losses = []
        p, s = sharded, opt_state
        for _ in range(5):
            p, s, l = step(p, s, x, y)
            losses.append(float(l))
        assert losses[-1] < losses[0]

    def test_tp_forward_matches_dense(self, data):
        """tp=2 sharded forward == unsharded forward (same math, different
        layout): verified through the loss at identical params."""
        x, y = data
        mesh = make_mesh(dp=1, tp=2)
        params = init_stacked_lstm(jax.random.PRNGKey(3), 8, (8,))
        opt = optax.sgd(0.0)  # zero LR: params unchanged, loss = forward loss
        sharded = shard_params_for_mesh(params, mesh)
        step = make_sharded_train_step(mesh, opt)
        _, _, loss = step(sharded, opt.init(sharded), x, y)
        pred = stacked_lstm_apply(params, x, return_sequences=False)[..., 0]
        assert float(loss) == pytest.approx(float(jnp.mean((pred - y) ** 2)), rel=1e-4)


class TestBatchedInference:
    def test_multi_sequence_sharded(self, data):
        x, _ = data
        mesh = make_mesh(dp=8, tp=1)
        params = init_stacked_lstm(jax.random.PRNGKey(4), 8, (8,))
        run = make_batched_inference(mesh, stacked_lstm_apply)
        out = run(params, x)
        ref = stacked_lstm_apply(params, x, return_sequences=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)

    def test_fast_mode_sharded_matches_unsharded(self, data):
        """dp batched inference over predict(precision="fast") (the bf16
        scan, partitioned by GSPMD): sharded fast inference must equal the
        single-device fast forward — sequences are independent, so the
        shard boundary cannot change any row's arithmetic."""
        from svd_lstm_tpu.api import predict

        def fast(p, xx, return_sequences=True):
            return predict(p, xx, precision="fast", consult_cache=False)

        x, _ = data
        mesh = make_mesh(dp=8, tp=1)
        params = init_stacked_lstm(jax.random.PRNGKey(5), 8, (128, 8))
        out = make_batched_inference(mesh, fast)(params, x)
        assert len(out.sharding.device_set) == 8
        out = np.asarray(out)
        ref = np.asarray(fast(params, x))
        np.testing.assert_allclose(out, ref, atol=1e-6)
        # and it stays bf16-close to the exact forward
        exact = np.asarray(stacked_lstm_apply(params, x, return_sequences=True))
        rel = np.linalg.norm(out - exact) / np.linalg.norm(exact)
        assert rel < 3e-2


class TestDpCompressedModels:
    """dp-sharding of the COMPRESSED model families."""

    @pytest.fixture(scope="class")
    def smodel(self):
        from svd_lstm_tpu.factor.svd import make_singular_model

        dense = init_stacked_lstm(jax.random.PRNGKey(2), 8, (8, 8))
        return make_singular_model(dense, merged_kernel=False)

    def test_dp_singular_finetune_matches_unsharded(self, data, smodel):
        """Sharded singular fine-tune step ≡ unsharded step: identical loss
        and identical updated σ, over 3 consecutive steps."""
        from svd_lstm_tpu.config import FactorConfig
        from svd_lstm_tpu.models.singular import singular_lstm_apply
        from svd_lstm_tpu.parallel.train import make_dp_finetune_step
        from svd_lstm_tpu.train.finetune import (
            make_finetune_optimizer,
            regularization_loss,
        )

        x, y = data
        fcfg = FactorConfig(hoyer=0.01)
        mesh = make_mesh(dp=8, tp=1)
        step, opt_state = make_dp_finetune_step(mesh, smodel, fcfg, 1e-3)

        # unsharded reference: same optimizer, same loss
        opt = make_finetune_optimizer(smodel, fcfg, 1e-3)
        ref_state = opt.init(smodel)

        def ref_step(p, s, x, y):
            def loss_fn(p):
                pred = singular_lstm_apply(p, x, return_sequences=False)[..., 0]
                return jnp.mean(jnp.square(pred - y)) + regularization_loss(p, fcfg)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s, loss

        ps, pr = smodel, smodel
        ss, sr = opt_state, ref_state
        for i in range(3):
            ps, ss, loss_s = step(ps, ss, x, y)
            pr, sr, loss_r = ref_step(pr, sr, x, y)
            assert np.isclose(float(loss_s), float(loss_r), rtol=1e-5), f"step {i}"
        for a, b in zip(jax.tree.leaves(ps), jax.tree.leaves(pr)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
        # σ actually moved (the fine-tune trains) while factors stayed frozen
        assert not np.allclose(
            np.asarray(ps.layers[0].ws), np.asarray(smodel.layers[0].ws)
        )
        np.testing.assert_array_equal(
            np.asarray(ps.layers[0].wl), np.asarray(smodel.layers[0].wl)
        )

    def test_dp_train_step_dense_parity(self, data):
        """The generic dp step on the DENSE model matches the dedicated
        dp×tp step at tp=1 (same math, two code paths)."""
        from svd_lstm_tpu.parallel.train import make_dp_train_step

        x, y = data
        params = init_stacked_lstm(jax.random.PRNGKey(3), 8, (8,))
        opt = optax.adam(1e-3)
        mesh = make_mesh(dp=8, tp=1)

        step_g = make_dp_train_step(mesh, opt, stacked_lstm_apply)
        p1, _, loss_g = step_g(params, opt.init(params), x, y)

        sharded = shard_params_for_mesh(params, mesh)
        step_d = make_sharded_train_step(mesh, opt)
        p2, _, loss_d = step_d(sharded, opt.init(sharded), x, y)
        assert np.isclose(float(loss_g), float(loss_d), rtol=1e-5)

    def test_dp_batched_inference_reduced(self, data):
        """Reduced (two-step) batched inference sharded over the mesh equals
        the local reduced forward AND the dense forward (exactness)."""
        from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
        from svd_lstm_tpu.models.reduced import reduced_lstm_apply

        x, _ = data
        dense = init_stacked_lstm(jax.random.PRNGKey(4), 8, (8, 8))
        rmodel = make_reduced_model(make_singular_model(dense), rank=8)

        mesh = make_mesh(dp=8, tp=1)
        run = make_batched_inference(mesh, reduced_lstm_apply)
        out = np.asarray(run(rmodel, x))
        local = np.asarray(reduced_lstm_apply(rmodel, x, return_sequences=True))
        np.testing.assert_allclose(out, local, atol=1e-6)
        full = np.asarray(stacked_lstm_apply(dense, x, return_sequences=True))
        np.testing.assert_allclose(out, full, atol=1e-4)
