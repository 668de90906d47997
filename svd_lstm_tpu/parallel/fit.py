"""Multi-device training LOOP: the sharded counterpart of train.loop.fit.

parallel/train.py provides sharded *steps* (dense dp×tp, generic dp for
the compressed families); this module provides the epoch loop around
them, so a user of the single-device trainer
(reference code/train_full_model_v4.py:98-126 workflow) can scale the
same run across a Mesh without rewriting anything:

* the window set is built once (same sampler, same seed ⇒ the same
  windows as the single-device fit) and device_put dp-sharded along the
  batch axis — each device holds 1/dp of the 256 MB window set;
* each epoch is ONE jitted ``lax.scan`` over the shuffled minibatches
  whose body is the per-device train step with a ``psum`` gradient
  reduction (shard_map around the scan, so the collective compiles into
  the epoch program — no per-step dispatch);
* NaN rollback / history / checkpoint semantics match ``fit`` exactly
  (the reference's only fault tolerance,
  old_versions/train_full_model.py:125-136).

Gradient math is identical to the single-device trainer: per-shard mean
losses/grads pmean'd over equal shard sizes == the full-batch mean, so
``fit_dp`` reproduces ``fit``'s loss history to f32 reduction-order
noise (asserted in tests/test_parallel_fit.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svd_lstm_tpu.config import TrainConfig
from svd_lstm_tpu.data.batcher import split_train_random
from svd_lstm_tpu.models.lstm import stacked_lstm_apply
from svd_lstm_tpu.parallel.train import _local_value_and_grad
from svd_lstm_tpu.train.loop import (
    TrainResult,
    drive_epochs,
    make_val_fn,
    mse_last_step,
    resolve_train_apply_fn,
    shuffled_epoch_batches,
)


def fit_dp(
    params: Any,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    cfg: TrainConfig = TrainConfig(),
    apply_fn: Callable = stacked_lstm_apply,
    optimizer: optax.GradientTransformation | None = None,
    loss_extra: Callable | None = None,
    verbose: bool = False,
    windows: tuple | None = None,
    init_opt_state: Any = None,
    dropout_rng: jax.Array | None = None,
    validation: tuple | None = None,
    checkpoint_path: str | None = None,
) -> TrainResult:
    """Data-parallel ``fit`` over every device of ``mesh``: params and
    optimizer state replicated, each minibatch sharded along its batch
    axis, grads ``pmean``-reduced inside an epoch-level scan.

    Works for any model family whose ``apply_fn`` is pure XLA (dense,
    singular, reduced — the same contract as
    ``parallel.train.make_dp_train_step``). ``cfg.batch_size`` must be
    divisible by the device count.

    ``cfg.recurrence_kernel`` is honored exactly like ``fit``: the dense
    scan and the singular fine-tune swap to the recurrence kernel pair
    (check_vma then comes off — the check cannot see through a
    ``pallas_call``).

    ``dropout_rng`` enables per-batch dropout keys (same schedule as
    ``fit``); each device folds in its ``dp`` index so mask draws are
    independent across shards — statistically equivalent to, but not
    bitwise-identical with, the single-device mask draw.
    """
    n_dev = int(mesh.devices.size)
    if cfg.batch_size % n_dev != 0:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by {n_dev} devices"
        )
    flat_mesh = Mesh(mesh.devices.reshape(-1), ("dp",))
    if optimizer is None:
        optimizer = optax.adam(cfg.learning_rate)

    # validation always runs the EXACT pre-swap forward (config.py
    # invariant, same as train.loop.fit); kernel/remat swaps are the ONE
    # shared resolve_train_apply_fn — fit and fit_dp cannot drift
    exact_apply_fn = apply_fn
    apply_fn, using_kernel = resolve_train_apply_fn(cfg, apply_fn)

    params = jax.device_put(
        jax.tree.map(lambda a: jnp.array(a, copy=True), params),
        NamedSharding(flat_mesh, P()),
    )
    # multi-phase callers carry adam moments across phases (same contract
    # as train.loop.fit); copied because the jitted epoch donates its inputs
    opt_state = (
        jax.device_put(
            jax.tree.map(lambda a: jnp.array(a, copy=True), init_opt_state),
            NamedSharding(flat_mesh, P()),
        )
        if init_opt_state is not None
        else optimizer.init(params)
    )

    def base_loss(p, x, y, rng=None):
        loss = mse_last_step(p, x, y, apply_fn, rng)
        if loss_extra is not None:
            loss = loss + loss_extra(p)
        return loss

    def local_epoch(p, s, xs, ys, keys=None):
        # xs: (steps, B/dp, T, d) local shard; the scan IS the epoch
        def body(carry, xy):
            p, s = carry
            x, y = xy[0], xy[1]
            rng = None
            if len(xy) == 3:
                # independent masks per shard: fold in the dp index
                rng = jax.random.fold_in(xy[2], jax.lax.axis_index("dp"))
            with jax.default_matmul_precision(cfg.matmul_precision):
                loss, grads = _local_value_and_grad(
                    lambda q: base_loss(q, x, y, rng), p, "dp"
                )
            loss = jax.lax.pmean(loss, "dp")
            grads = jax.lax.pmean(grads, "dp")
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), loss

        scan_xs = (xs, ys) if keys is None else (xs, ys, keys)
        (p, s), losses = jax.lax.scan(body, (p, s), scan_xs)
        return p, s, jnp.mean(losses)

    @partial(jax.jit, donate_argnums=(0, 1))
    def epoch_fn(p, s, xs, ys, keys=None):
        pspec = jax.tree.map(lambda _: P(), p)
        ospec = jax.tree.map(lambda _: P(), s)
        in_specs = [pspec, ospec, P(None, "dp"), P(None, "dp")]
        args = [p, s, xs, ys]
        if keys is not None:
            in_specs.append(P())  # keys replicated; devices fold in dp index
            args.append(keys)
        return shard_map(
            local_epoch,
            mesh=flat_mesh,
            in_specs=tuple(in_specs),
            out_specs=(pspec, ospec, P()),
            # pure-XLA epoch bodies (incl. dropout — axis_index/fold_in
            # type correctly) keep the static mis-sharding guard on; only
            # the kernel engine turns it off, where the check cannot see
            # through a pallas_call
            check_vma=not using_kernel,
        )(*args)

    if windows is not None:
        X_mini, y_mini = windows
    else:
        X_mini, y_mini = split_train_random(
            X_train, y_train, cfg.num_windows, cfg.window_len, seed=cfg.seed
        )
    # the whole window set lives on device, dp-sharded along the batch axis
    X_dev = jax.device_put(
        jnp.asarray(X_mini), NamedSharding(flat_mesh, P("dp", None, None))
    )
    y_dev = jax.device_put(jnp.asarray(y_mini), NamedSharding(flat_mesh, P("dp")))

    # whole-run validation MSE each epoch on the exact pre-swap forward
    # (reference passes validation_data to Keras fit,
    # code/svd_acceleration_v3.py:126)
    val_fn = make_val_fn(exact_apply_fn, validation)

    def epoch_step(params, opt_state, epoch):
        # same (seed + epoch) shuffle and dropout-key schedule as fit —
        # the gather preserves X_dev's dp sharding
        xs, ys, keys = shuffled_epoch_batches(
            X_dev, y_dev, X_mini.shape[0], cfg, epoch, dropout_rng
        )
        params, opt_state, mean_loss = epoch_fn(params, opt_state, xs, ys, keys)
        return params, opt_state, float(mean_loss)

    def restore(host_tree):
        # rollback snapshots are host copies; re-shard replicated
        return jax.device_put(
            jax.tree.map(jnp.asarray, host_tree), NamedSharding(flat_mesh, P())
        )

    return drive_epochs(
        cfg, params, opt_state, epoch_step,
        val_fn=val_fn, checkpoint_path=checkpoint_path, verbose=verbose,
        restore=restore,
    )


def finetune_dp(
    sparams,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    factor_cfg=None,
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state: Any = None,
) -> TrainResult:
    """dp-sharded singular fine-tune LOOP (σ-only masked adam +
    Hoyer/orthogonality, Keras-semantics dropout when configured) — the
    multi-device form of ``train.finetune.finetune``, matching the
    reference fine-tune stage (code/svd_acceleration_v3.py:119-128)
    scaled over the mesh."""
    from svd_lstm_tpu.config import FactorConfig
    from svd_lstm_tpu.train.finetune import (
        dropout_apply_fn,
        make_finetune_optimizer,
        regularization_loss,
    )

    if factor_cfg is None:
        factor_cfg = FactorConfig()
    if train_cfg is None:
        train_cfg = TrainConfig(
            epochs=factor_cfg.finetune_epochs,
            batch_size=factor_cfg.finetune_batch_size,
        )

    # same wrapper + key derivation + family dispatch as the single-device
    # finetune (one shared definition — they cannot drift)
    base_apply = None
    if hasattr(sparams, "inner"):  # ConvSingularParams
        from svd_lstm_tpu.models.conv import conv_singular_apply

        base_apply = conv_singular_apply
    apply_fn, dropout_rng = dropout_apply_fn(
        factor_cfg, train_cfg.seed, remat_chunk=train_cfg.remat_chunk,
        base_apply=base_apply,
    )
    optimizer = make_finetune_optimizer(
        sparams, factor_cfg, train_cfg.learning_rate
    )
    return fit_dp(
        sparams,
        X_train,
        y_train,
        mesh,
        cfg=train_cfg,
        apply_fn=apply_fn,
        optimizer=optimizer,
        loss_extra=lambda p: regularization_loss(p, factor_cfg),
        verbose=verbose,
        init_opt_state=init_opt_state,
        dropout_rng=dropout_rng,
    )


def finetune_reduced_dp(
    rparams,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state: Any = None,
    windows: tuple | None = None,
    validation: tuple | None = None,
) -> TrainResult:
    """dp-sharded post-truncation recovery fine-tune LOOP — the
    multi-device form of ``train.finetune.finetune_reduced`` (the
    beyond-reference stage: the reference's reduced cell is frozen,
    code/svd_classes_v3.py:249-315). Family dispatch
    (``ReducedModelParams`` / conv hybrid ``ConvReducedParams``) shares
    ``train.finetune.reduced_apply_fn``, and the kernel routing shares
    ``resolve_train_apply_fn``: ``train_cfg.recurrence_kernel`` swaps the
    pure-LSTM family onto ops/reduced_train's fused engine."""
    from svd_lstm_tpu.train.finetune import reduced_apply_fn

    if train_cfg is None:
        train_cfg = TrainConfig()
    return fit_dp(
        rparams,
        X_train,
        y_train,
        mesh,
        cfg=train_cfg,
        apply_fn=reduced_apply_fn(rparams),
        verbose=verbose,
        init_opt_state=init_opt_state,
        windows=windows,
        validation=validation,
    )
