"""Full-model windowed-BPTT trainer.

Reproduces the reference training scheme (code/train_full_model_v4.py:98-126):
sample ``num_windows`` random windows of ``window_len`` steps, adam + MSE on
the window-end target, ``epochs`` passes — plus the v1 trainer's only fault
tolerance, NaN-loss detection with rollback to the last good parameters
(reference old_versions/train_full_model.py:125-136).

One jitted ``train_step`` (value_and_grad over the scan-based
forward), static batch shapes, donated params/opt-state to keep everything
on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from svd_lstm_tpu.config import TrainConfig
from svd_lstm_tpu.data.batcher import split_train_random, window_epoch_iterator
from svd_lstm_tpu.models.lstm import stacked_lstm_apply


@dataclasses.dataclass
class TrainResult:
    params: Any
    history: list                      # per-epoch mean loss
    rollbacks: int = 0                 # NaN-rollback count
    val_history: list = dataclasses.field(default_factory=list)
    opt_state: Any = None              # final optimizer state (resume/inspection)


def mse_last_step(params, x, y, apply_fn, rng=None) -> jax.Array:
    if rng is None:
        pred = apply_fn(params, x, return_sequences=False)[..., 0]
    else:
        pred = apply_fn(params, x, return_sequences=False, rng=rng)[..., 0]
    return jnp.mean(jnp.square(pred - y))


def make_val_fn(exact_apply_fn: Callable, validation: tuple | None):
    """Jitted whole-run validation MSE on the EXACT forward (config.py
    invariant: validation metrics never run at relaxed precision), or None.
    Accepts Xv (B, T, d) with yv shaped (T,), (B, T) or (B*T,) — both sides
    are flattened (reshape(1, -1) on yv alone would break B > 1)."""
    if validation is None:
        return None
    Xv = jnp.asarray(validation[0])
    yv = jnp.asarray(np.asarray(validation[1]).reshape(-1))
    return jax.jit(
        lambda p: jnp.mean(
            jnp.square(
                exact_apply_fn(p, Xv, return_sequences=True)[..., 0].reshape(-1)
                - yv
            )
        )
    )


def shuffled_epoch_batches(
    X_dev, y_dev, n_windows: int, cfg: TrainConfig, epoch: int, dropout_rng=None
):
    """One epoch's shuffled minibatch stack: (xs, ys, keys) with xs
    (steps, batch, T, d). The shuffle is a device-side gather driven by a
    host permutation (no per-epoch re-shipping of the 256 MB window set).
    The (seed + epoch) permutation and
    the per-batch dropout-key schedule are the contract ``fit`` and
    ``fit_dp`` both follow — their loss-history parity is tested at dp=8
    (tests/test_parallel_fit.py)."""
    rng_e = np.random.default_rng(cfg.seed + epoch)
    n_full = (n_windows // cfg.batch_size) * cfg.batch_size
    if n_full == 0:
        # a zero-step epoch would scan nothing, mean([]) = NaN, and the
        # NaN rollback would silently turn the whole run into a no-op
        raise ValueError(
            f"num_windows ({n_windows}) < batch_size ({cfg.batch_size}): "
            "every epoch would run zero steps"
        )
    perm = jnp.asarray(rng_e.permutation(n_windows)[:n_full])
    xs = X_dev[perm].reshape(-1, cfg.batch_size, *X_dev.shape[1:])
    ys = y_dev[perm].reshape(-1, cfg.batch_size)
    keys = None
    if dropout_rng is not None:
        # fresh per-batch masks, Keras-style (a new mask set each cell
        # build/call), deterministic given (dropout_rng, epoch)
        keys = jax.random.split(jax.random.fold_in(dropout_rng, epoch), xs.shape[0])
    return xs, ys, keys


def drive_epochs(
    cfg: TrainConfig,
    params: Any,
    opt_state: Any,
    epoch_step: Callable,
    *,
    val_fn: Callable | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    restore: Callable | None = None,
) -> TrainResult:
    """The epoch driver shared by ``fit`` and ``parallel.fit_dp``: NaN
    rollback, loss/validation history, save-best checkpointing.

    ``epoch_step(params, opt_state, epoch) -> (params, opt_state, float)``
    runs one epoch. ``restore(host_tree)`` re-materializes a host snapshot
    on device for rollback (dp callers re-shard; default is a plain
    device transfer).

    NaN rollback restores BOTH params and optimizer state: the reference's
    checkpoint reload keeps Keras' in-process optimizer moments intact
    (old_versions/train_full_model.py:133-136), so resetting adam's mu/nu
    to zero here would diverge from that semantics. Save-best-by-loss is
    the reference's ModelCheckpoint (old_versions/train_full_model.py:
    108-116)."""
    if restore is None:
        restore = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    last_good = jax.device_get(params)
    last_good_opt = jax.device_get(opt_state)
    history: list = []
    val_history: list = []
    rollbacks = 0
    best_loss = float("inf")
    for epoch in range(cfg.epochs):
        params, opt_state, epoch_loss = epoch_step(params, opt_state, epoch)
        if cfg.nan_rollback and not np.isfinite(epoch_loss):
            # reference old_versions/train_full_model.py:133-136: reload
            # the last checkpoint and keep going.
            params = restore(last_good)
            opt_state = restore(last_good_opt)
            rollbacks += 1
            if verbose:
                print(f"epoch {epoch}: NaN loss — rolled back")
            continue
        last_good = jax.device_get(params)
        last_good_opt = jax.device_get(opt_state)
        history.append(epoch_loss)
        msg = f"epoch {epoch}: loss {epoch_loss:.6f}"
        if val_fn is not None:
            val_loss = float(val_fn(params))
            val_history.append(val_loss)
            msg += f"  val {val_loss:.6f}"
        if checkpoint_path is not None and epoch_loss < best_loss:
            best_loss = epoch_loss
            from svd_lstm_tpu.io.checkpoint import save_params

            save_params(checkpoint_path, params)
        if verbose:
            print(msg)
    return TrainResult(
        params=params, history=history, rollbacks=rollbacks,
        val_history=val_history, opt_state=opt_state,
    )


def resolve_train_apply_fn(cfg: TrainConfig, apply_fn: Callable):
    """The kernel/remat apply-fn swaps shared by ``fit`` and
    ``parallel.fit_dp`` (ONE definition — the two loops cannot drift).
    Returns ``(apply_fn, using_kernel)``.

    * ``cfg.recurrence_kernel``: the dense scan, the σ fine-tune, the
      post-truncation recovery fine-tune AND the conv hybrids swap to the
      custom-VJP recurrence kernel pair (ops/gpu_recurrence.py, through
      ops/singular_train.py / ops/reduced_train.py / ops/conv_train.py;
      in-kernel dots are TF32). Stacks with a layer wider than the kernel
      takes keep the scan, with one line of log. Dropout wrappers and
      custom applies keep their scan — the kernels have no mask support —
      and remat below may still apply to them.
    * ``cfg.remat_chunk``: chunked-time ``jax.checkpoint`` BPTT
      (models/lstm.py, models/singular.py) for the XLA-scan paths —
      O(T/K + K) live activation memory, identical values. A wrapper
      that already baked the knob in advertises it via
      ``remat_chunk_applied`` (train/finetune.dropout_apply_fn); any
      other apply_fn cannot carry it, which warns instead of silently
      training without remat (and then OOMing exactly as if the knob
      were ignored).
    """
    from svd_lstm_tpu.models.conv import (
        conv_lstm_apply,
        conv_reduced_apply,
        conv_singular_apply,
    )
    from svd_lstm_tpu.models.reduced import reduced_lstm_apply
    from svd_lstm_tpu.models.singular import singular_lstm_apply

    if cfg.recurrence_kernel:
        from svd_lstm_tpu.ops import conv_train, gpu_recurrence, reduced_train, singular_train

        swaps = (
            (stacked_lstm_apply, gpu_recurrence.stacked_lstm_apply_fast_train),
            (singular_lstm_apply, singular_train.singular_lstm_apply_fast_train),
            (reduced_lstm_apply, reduced_train.reduced_lstm_apply_fast_train),
            # conv hybrids: hoisted conv front end (standard XLA VJP)
            # feeding the same kernels through the family's dense view
            # (the reference trains the hybrid end-to-end,
            # code/old_versions/toy-convolution.py:70-76)
            (conv_lstm_apply, conv_train.conv_lstm_apply_fast_train),
            (conv_singular_apply, conv_train.conv_singular_apply_fast_train),
            (conv_reduced_apply, conv_train.conv_reduced_apply_fast_train),
        )
        kernel_apply = next((k for f, k in swaps if apply_fn is f), None)
        if kernel_apply is not None:
            return kernel_apply, True
    if cfg.remat_chunk:
        if apply_fn is stacked_lstm_apply:
            return partial(stacked_lstm_apply, remat_chunk=cfg.remat_chunk), False
        if apply_fn is singular_lstm_apply:
            return partial(singular_lstm_apply, remat_chunk=cfg.remat_chunk), False
        # conv hybrids carry the knob too (taken when recurrence_kernel is
        # off — with it on, the kernel branch above catches them first)
        if apply_fn is conv_lstm_apply:
            return partial(conv_lstm_apply, remat_chunk=cfg.remat_chunk), False
        if apply_fn is conv_singular_apply:
            return partial(conv_singular_apply, remat_chunk=cfg.remat_chunk), False
        if getattr(apply_fn, "remat_chunk_applied", None) != cfg.remat_chunk:
            import warnings

            warnings.warn(
                f"TrainConfig.remat_chunk={cfg.remat_chunk} cannot be "
                f"applied to apply_fn {apply_fn!r}: only the stock "
                "stacked/singular scans (or a dropout_apply_fn wrapper "
                "built with the same remat_chunk) carry the knob — "
                "training will run WITHOUT activation rematerialization",
                stacklevel=3,
            )
    return apply_fn, False


def apply_cached_train_flags(
    cfg: TrainConfig, params, X_train, windows, verbose: bool = False
) -> TrainConfig:
    """``TrainConfig.auto_flags``: read-only consult of the autotune cache
    (bench/autotune.py ``tune --train`` writes it) for the measured-best
    ``(matmul_precision, recurrence_kernel)`` pair at this
    (model, window-batch shape, device). Hit -> those flags replace the
    config's; miss -> the config is returned unchanged (never measures —
    the training analog of ``api.predict(impl="auto")``'s cache consult)."""
    from svd_lstm_tpu.bench.autotune import cached_train_flags

    # shape reads only — np.asarray on a device-resident window set would
    # copy it to the host just to read .shape
    if windows is not None:
        w0 = windows[0]
        wshape = w0.shape if hasattr(w0, "shape") else np.asarray(w0).shape
        shape = (cfg.batch_size,) + tuple(wshape[1:])
    else:
        xs = (
            X_train.shape
            if hasattr(X_train, "shape")
            else np.asarray(X_train).shape
        )
        shape = (cfg.batch_size, cfg.window_len, int(xs[-1]))
    probe = np.empty(shape, dtype=np.float32)
    hit = cached_train_flags(params, probe)
    if hit is None:
        return cfg
    prec, kernel = hit
    if verbose:
        print(
            f"auto_flags: tuned regime hit — matmul_precision={prec} "
            f"recurrence_kernel={kernel}"
        )
    return dataclasses.replace(cfg, matmul_precision=prec, recurrence_kernel=kernel)


def fit(
    params: Any,
    X_train: np.ndarray,
    y_train: np.ndarray,
    cfg: TrainConfig = TrainConfig(),
    apply_fn: Callable = stacked_lstm_apply,
    optimizer: optax.GradientTransformation | None = None,
    loss_extra: Callable | None = None,
    validation: tuple | None = None,
    checkpoint_path: str | None = None,
    jit_epoch: bool = True,
    verbose: bool = False,
    windows: tuple | None = None,
    dropout_rng: jax.Array | None = None,
    init_opt_state: Any = None,
    loss_fn: Callable | None = None,
) -> TrainResult:
    """Train ``params`` on random windows of the (1, T, d) training run.

    ``loss_extra(params) -> scalar`` lets callers add regularization terms
    (used by the singular fine-tune).

    ``loss_fn(params, x, y, apply_fn, rng) -> scalar`` overrides the
    window-end MSE data term (default :func:`mse_last_step`). Used by the
    v1-protocol reproduction: Keras broadcast the scalar window-end label
    across the TimeDistributed sequence output, training EVERY timestep
    toward the end label (reference old_versions/train_full_model.py:
    130-131 — model outputs (B, T, 1), y_mini is (B,)).

    ``validation=(X, y)`` evaluates whole-run MSE each epoch (reference
    passes validation_data to Keras fit, code/svd_acceleration_v3.py:126).

    ``checkpoint_path`` enables save-best-by-loss checkpointing (reference
    ModelCheckpoint(save_best_only), old_versions/train_full_model.py:108-116).

    ``jit_epoch`` (default True) runs each epoch as ONE device program
    (lax.scan over the shuffled minibatches) instead of one dispatch per
    step, so no per-step host dispatch sits between steps. The whole
    window set lives on device (~1 GB at the reference scale). Set False
    for per-step host-side control.
    """
    # Fresh buffers: the jitted step donates its inputs, and donating the
    # caller's arrays would invalidate them outside this function.
    params = jax.tree.map(lambda a: jnp.array(a, copy=True), params)
    if cfg.auto_flags:
        cfg = apply_cached_train_flags(cfg, params, X_train, windows, verbose)
    # Validation metrics always run exact (config.py invariant): keep the
    # pre-swap apply_fn for val_fn — recurrence_kernel relaxes only the
    # training step's dots, like matmul_precision does. The kernel/remat
    # swaps themselves live in resolve_train_apply_fn (the reference's
    # fine-tune stage, code/svd_acceleration_v3.py:119-128, runs through
    # the same kernels via the differentiable dense reconstruction in
    # ops/singular_train.py).
    exact_apply_fn = apply_fn
    apply_fn, _ = resolve_train_apply_fn(cfg, apply_fn)
    if optimizer is None:
        optimizer = optax.adam(cfg.learning_rate)
    # init_opt_state lets multi-phase callers (e.g. pruning fine-tune)
    # carry adam moments across phases instead of resetting them. Copied
    # for the same reason params are: the jitted step donates its inputs,
    # and donating the caller's buffers would invalidate them outside here.
    opt_state = (
        jax.tree.map(lambda a: jnp.array(a, copy=True), init_opt_state)
        if init_opt_state is not None
        else optimizer.init(params)
    )

    data_loss = mse_last_step if loss_fn is None else loss_fn
    if loss_extra is None:
        def base_loss(p, x, y, f, rng=None):
            return data_loss(p, x, y, f, rng)
    else:
        def base_loss(p, x, y, f, rng=None):
            return data_loss(p, x, y, f, rng) + loss_extra(p)

    def loss_fn(p, x, y, f, rng=None):
        # cfg.matmul_precision relaxes the train step's matmul passes
        # (forward AND backward — the context is active while both trace);
        # the default "float32" keeps exact-reconstruction parity.
        with jax.default_matmul_precision(cfg.matmul_precision):
            return base_loss(p, x, y, f, rng)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(p, s, x, y, rng=None):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y, apply_fn, rng)
        updates, s = optimizer.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        return p, s, loss

    @partial(jax.jit, donate_argnums=(0, 1))
    def epoch_scan(p, s, xs, ys, keys=None):
        """xs: (steps, batch, T, d); ys: (steps, batch); keys: per-step
        dropout keys (steps, 2) or None."""

        def body(carry, xy):
            p, s = carry
            x, y = xy[0], xy[1]
            rng = xy[2] if len(xy) == 3 else None
            loss, grads = jax.value_and_grad(loss_fn)(p, x, y, apply_fn, rng)
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), loss

        scan_xs = (xs, ys) if keys is None else (xs, ys, keys)
        (p, s), losses = jax.lax.scan(body, (p, s), scan_xs)
        return p, s, jnp.mean(losses)

    if windows is not None:
        # Pre-built (X_mini, y_mini) window set — bypasses the random
        # sampler (used for custom curricula and fault-injection tests).
        X_mini, y_mini = windows
    else:
        X_mini, y_mini = split_train_random(
            X_train, y_train, cfg.num_windows, cfg.window_len, seed=cfg.seed
        )
    if jit_epoch:
        # The whole window set moves to device ONCE; each epoch's shuffle is
        # a device-side gather driven by a host permutation (20k int32s)
        # instead of re-shipping the 256 MB window set every epoch.
        X_dev, y_dev = jnp.asarray(X_mini), jnp.asarray(y_mini)

    val_fn = make_val_fn(exact_apply_fn, validation)

    def epoch_step(params, opt_state, epoch):
        if jit_epoch:
            xs, ys, keys = shuffled_epoch_batches(
                X_dev, y_dev, X_mini.shape[0], cfg, epoch, dropout_rng
            )
            params, opt_state, mean_loss = epoch_scan(
                params, opt_state, xs, ys, keys
            )
            return params, opt_state, float(mean_loss)
        losses = []
        for i, (xb, yb) in enumerate(window_epoch_iterator(
            X_mini, y_mini, cfg.batch_size, seed=cfg.seed + epoch
        )):
            rng_b = None
            if dropout_rng is not None:
                rng_b = jax.random.fold_in(
                    jax.random.fold_in(dropout_rng, epoch), i
                )
            params, opt_state, loss = step(
                params, opt_state, jnp.asarray(xb), jnp.asarray(yb), rng_b
            )
            losses.append(loss)
        return params, opt_state, float(jnp.mean(jnp.stack(losses)))

    return drive_epochs(
        cfg, params, opt_state, epoch_step,
        val_fn=val_fn, checkpoint_path=checkpoint_path, verbose=verbose,
    )


def predict_full_run(
    params: Any,
    X: np.ndarray,
    apply_fn: Callable = stacked_lstm_apply,
) -> np.ndarray:
    """Whole-run sequence prediction, (1, T, d) -> (T,) — the reference's
    return_sequences=True evaluation clone (code/train_full_model_v4.py:129-141)."""
    f = jax.jit(lambda p, x: apply_fn(p, x, return_sequences=True))
    out = f(params, jnp.asarray(X))
    return np.asarray(out)[0, :, 0]
