"""Sharded training step: data parallel × tensor parallel via shard_map.

Parallelism design (scaling-book style — pick a mesh, shard, let XLA hand
the collectives to NCCL):

* **dp** — the batch of training windows is sharded across the ``dp`` axis;
  each device computes grads on its shard, then ``pmean`` over ``dp``.
* **tp** — Megatron-style gate-column sharding of every LSTM layer: device
  ``s`` of the ``tp`` axis holds column slice ``[s·n/tp, (s+1)·n/tp)`` of
  EACH of the four gate blocks of ``W``/``U``/``b`` plus the matching slice
  of ``h``/``c``. Per step each device all-gathers ``h`` over ``tp`` (the
  only per-step collective) and computes its local gates/state slice. The
  backward of the all-gather is a reduce-scatter — inserted automatically
  by shard_map's transpose rules.
* **pp** — layer stages with a chunked-time wavefront schedule for the one
  workload dp cannot shard, batch-1 whole-run inference over a single long
  sequence — see ``parallel/pipeline.py``.
* **sp / ep** — deliberately not used: the recurrence is sequential in
  time (no ring/Ulysses analog is exact for a nonlinear scan; context is
  bounded by windowed BPTT — SURVEY.md §5) and there is no expert
  structure. Sequence-level scaling is instead obtained by sharding
  *independent sequences* over ``dp`` (batched multi-sequence inference,
  the BASELINE stretch config).

The reference has no analog of any of this — it is single-process Keras
(SURVEY.md §2).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svd_lstm_tpu.models.lstm import (
    DenseParams,
    LSTMLayerParams,
    StackedLSTMParams,
    gate_update,
)
from svd_lstm_tpu.utils.linalg import zeros_varying_like


# ---------------------------------------------------------------------------
# tp layout: per-gate column slices
# ---------------------------------------------------------------------------

def shard_layer_tp(layer: LSTMLayerParams, tp: int, index: int) -> LSTMLayerParams:
    """Extract tp-shard ``index``'s local slice of a layer: columns
    ``[index·n/tp, (index+1)·n/tp)`` of each gate block; all rows."""
    n = layer.units
    assert n % tp == 0, f"units {n} not divisible by tp {tp}"
    k = n // tp
    cols = jnp.concatenate(
        [jnp.arange(g * n + index * k, g * n + (index + 1) * k) for g in range(4)]
    )
    return LSTMLayerParams(
        W=layer.W[:, cols], U=layer.U[:, cols], b=layer.b[cols]
    )


def _local_layer_apply(layer: LSTMLayerParams, x_seq, tp_axis: str | None):
    """One LSTM layer where W/U/b and h/c are tp-local gate slices.

    x_seq: (B, T, d_full) replicated across tp. Returns local h slice
    (B, T, n/tp); the caller all-gathers when the next consumer needs the
    full width.
    """
    B, T, _ = x_seq.shape
    k = layer.W.shape[1] // 4  # local width n/tp (U keeps full rows n)
    xp = jnp.einsum("btd,dg->btg", x_seq, layer.W) + layer.b
    xp_t = jnp.swapaxes(xp, 0, 1)
    U = layer.U
    # vma bookkeeping (check_vma=True): the scan carry must enter with the
    # same varying-axes type its outputs have — h/c depend on xp, which
    # varies over every axis xp does (dp via x, tp via the local weights)
    h0 = zeros_varying_like(xp, (B, k), x_seq.dtype)
    c0 = zeros_varying_like(xp, (B, k), x_seq.dtype)

    def step(carry, xp_step):
        h_local, c_local = carry
        if tp_axis is not None:
            h_full = jax.lax.all_gather(h_local, tp_axis, axis=1, tiled=True)
        else:
            h_full = h_local
        z = xp_step + h_full @ U
        h_local, c_local = gate_update(z, c_local)
        return (h_local, c_local), h_local

    _, h_seq = jax.lax.scan(step, (h0, c0), xp_t)
    return jnp.swapaxes(h_seq, 0, 1)


def _forward_local(params: StackedLSTMParams, x, tp_axis: str | None):
    """Forward through tp-local layer slices; output head is computed on the
    gathered last hidden state (head is tiny — replicated)."""
    h = x
    for layer in params.layers:
        h_local = _local_layer_apply(layer, h, tp_axis)
        if tp_axis is not None:
            h = jax.lax.all_gather(h_local, tp_axis, axis=2, tiled=True)
        else:
            h = h_local
    return h[:, -1] @ params.head.w + params.head.b


# ---------------------------------------------------------------------------
# sharded train step
# ---------------------------------------------------------------------------

def _local_value_and_grad(loss_fn, params, axes):
    """``value_and_grad`` of this shard's loss alone. Parameters replicated
    over ``axes`` are typed invariant there, and the gradient of a varying
    loss with respect to an invariant input is summed over the axes by
    autodiff; differentiating at a varying copy keeps the gradient local,
    so the caller's ``pmean`` is the one reduction."""
    local = jax.tree.map(lambda a: jax.lax.pcast(a, axes, to="varying"), params)
    return jax.value_and_grad(loss_fn)(local)


def shard_params_for_mesh(params: StackedLSTMParams, mesh: Mesh) -> StackedLSTMParams:
    """Build the host-side tp-sharded parameter pytree: per-layer W/U/b carry
    their gate-column slices laid out contiguously along the column axis so
    a plain P(None, 'tp') sharding puts slice s on tp-device s."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return jax.device_put(
            params, NamedSharding(mesh, P())
        )
    layers = []
    for layer in params.layers:
        slices = [shard_layer_tp(layer, tp, s) for s in range(tp)]
        layers.append(
            LSTMLayerParams(
                W=jnp.concatenate([s.W for s in slices], axis=1),
                U=jnp.concatenate([s.U for s in slices], axis=1),
                b=jnp.concatenate([s.b for s in slices]),
            )
        )
    packed = StackedLSTMParams(layers=tuple(layers), head=params.head)
    shardings = StackedLSTMParams(
        layers=tuple(
            LSTMLayerParams(
                W=NamedSharding(mesh, P(None, "tp")),
                U=NamedSharding(mesh, P(None, "tp")),
                b=NamedSharding(mesh, P("tp")),
            )
            for _ in packed.layers
        ),
        head=DenseParams(
            w=NamedSharding(mesh, P()), b=NamedSharding(mesh, P())
        ),
    )
    return jax.device_put(packed, shardings)


def unshard_params_from_mesh(packed: StackedLSTMParams, tp: int) -> StackedLSTMParams:
    """Inverse of ``shard_params_for_mesh``'s column packing: recover the
    Keras-layout model from the tp-contiguous slice layout (used by the
    driver dryrun's parity asserts against the unsharded step)."""
    import numpy as np

    if tp == 1:
        return packed
    layers = []
    for layer in packed.layers:
        n = layer.U.shape[0]
        k = n // tp
        # packed column p = s·4k + g·k + j holds original column g·n + s·k + j
        perm = np.concatenate(
            [
                np.arange(g * n + s * k, g * n + (s + 1) * k)
                for s in range(tp)
                for g in range(4)
            ]
        )
        inv = np.argsort(perm)
        layers.append(
            LSTMLayerParams(
                W=layer.W[:, inv], U=layer.U[:, inv], b=layer.b[inv]
            )
        )
    return StackedLSTMParams(layers=tuple(layers), head=packed.head)


def make_sharded_train_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
) -> Callable:
    """Jitted (params, opt_state, x, y) -> (params, opt_state, loss) with
    x sharded over dp and params gate-column-sharded over tp."""
    tp = mesh.shape["tp"]
    tp_axis = "tp" if tp > 1 else None

    def local_step(params, opt_state, x, y):
        # params: tp-local slices; x: (B/dp, T, d); y: (B/dp,)
        def loss_fn(p):
            pred = _forward_local(p, x, tp_axis)[..., 0]
            # every tp device holds the same loss (pred comes from the
            # gathered h and the replicated head); autodiff sums the
            # cotangents of all tp copies, so each copy carries 1/tp
            return jnp.mean(jnp.square(pred - y)) / tp

        loss, grads = _local_value_and_grad(loss_fn, params, "dp")
        loss = jax.lax.pmean(loss, "dp")
        grads = jax.lax.pmean(grads, "dp")
        if tp_axis is not None:
            loss = jax.lax.psum(loss, tp_axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def specs_like(params):
        spec = P(None, "tp") if tp > 1 else P()
        bspec = P("tp") if tp > 1 else P()
        return StackedLSTMParams(
            layers=tuple(
                LSTMLayerParams(W=spec, U=spec, b=bspec) for _ in params.layers
            ),
            head=DenseParams(w=P(), b=P()),
        )

    @jax.jit
    def step(params, opt_state, x, y):
        pspec = specs_like(params)
        # adam's mu/nu mirror the param tree; counts/scalars stay replicated
        ospec = optax.tree_map_params(
            optimizer,
            lambda _, s: s,
            opt_state,
            pspec,
            transform_non_params=lambda _: P(),
        )
        return shard_map(
            local_step,
            mesh=mesh,
            in_specs=(pspec, ospec, P("dp", None, None), P("dp")),
            out_specs=(pspec, ospec, P()),
            # vma checking ON: the one static guard against a mis-sharded
            # collective — this step is pure XLA, so
            # the check is meaningful (unlike the pallas_call shard_map)
            check_vma=True,
        )(params, opt_state, x, y)

    return step


# ---------------------------------------------------------------------------
# dp-sharded training for ANY model pytree (dense, singular, reduced)
# ---------------------------------------------------------------------------

def make_dp_train_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    apply_fn: Callable,
    loss_extra: Callable | None = None,
) -> Callable:
    """Data-parallel train step generic over the model family: params and
    optimizer state replicated, the window batch sharded across EVERY mesh
    axis, gradients ``pmean``-reduced. This is how the compressed models
    (singular fine-tune, reduced) scale — their factor pytrees have no
    natural gate-column tp layout, and at their sizes dp is the right axis
    anyway.

    ``loss_extra(params) -> scalar`` carries the fine-tune regularizers
    (Hoyer/orthogonality), matching ``train.loop.fit``'s hook.
    """
    axes = tuple(mesh.axis_names)

    def local_step(params, opt_state, x, y):
        def loss_fn(p):
            pred = apply_fn(p, x, return_sequences=False)[..., 0]
            loss = jnp.mean(jnp.square(pred - y))
            if loss_extra is not None:
                # regularizers are pure functions of the (replicated)
                # params — identical on every shard, so no reduction needed
                loss = loss + loss_extra(p)
            return loss

        loss, grads = _local_value_and_grad(loss_fn, params, axes)
        loss = jax.lax.pmean(loss, axes)
        grads = jax.lax.pmean(grads, axes)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    @jax.jit
    def step(params, opt_state, x, y):
        pspec = jax.tree.map(lambda _: P(), params)
        ospec = jax.tree.map(lambda _: P(), opt_state)
        return shard_map(
            local_step,
            mesh=mesh,
            in_specs=(pspec, ospec, P(axes, None, None), P(axes)),
            out_specs=(pspec, ospec, P()),
            # pure-XLA step: vma checking on
            check_vma=True,
        )(params, opt_state, x, y)

    return step


def make_dp_finetune_step(
    mesh: Mesh,
    sparams,
    factor_cfg=None,
    learning_rate: float = 1e-3,
):
    """dp-sharded singular fine-tune step: σ-only (or +UV) gradient routing
    via the optax mask, Hoyer/orthogonality in the loss — the sharded
    counterpart of ``train.finetune.finetune``. Returns (step, opt_state).
    """
    from svd_lstm_tpu.config import FactorConfig
    from svd_lstm_tpu.models.singular import singular_lstm_apply
    from svd_lstm_tpu.train.finetune import (
        make_finetune_optimizer,
        regularization_loss,
    )

    if factor_cfg is None:
        factor_cfg = FactorConfig()
    # family dispatch: the conv hybrid fine-tunes through its own forward
    # (same rule as train.finetune / parallel.fit.finetune_dp)
    apply_fn = singular_lstm_apply
    if hasattr(sparams, "inner"):  # ConvSingularParams
        from svd_lstm_tpu.models.conv import conv_singular_apply

        apply_fn = conv_singular_apply
    optimizer = make_finetune_optimizer(sparams, factor_cfg, learning_rate)
    opt_state = optimizer.init(sparams)
    step = make_dp_train_step(
        mesh,
        optimizer,
        apply_fn,
        loss_extra=lambda p: regularization_loss(p, factor_cfg),
    )
    return step, opt_state


# ---------------------------------------------------------------------------
# batched multi-sequence inference (BASELINE stretch config)
# ---------------------------------------------------------------------------

def make_batched_inference(mesh: Mesh, apply_fn) -> Callable:
    """Shard a batch of independent sequences over every mesh device
    (recurrence stays sequential in time; parallelism is across sequences —
    SURVEY.md §5 'long-context' row). GSPMD partitions any pure-XLA
    ``apply_fn``, including ``predict(..., precision="fast")``."""
    n_dev = mesh.devices.size
    flat_mesh = Mesh(mesh.devices.reshape(-1), ("b",))

    @jax.jit
    def run(params, X):  # X: (B, T, d), B % n_dev == 0
        X = jax.device_put(X, NamedSharding(flat_mesh, P("b", None, None)))
        params_r = jax.device_put(params, NamedSharding(flat_mesh, P()))
        return apply_fn(params_r, X, return_sequences=True)

    return run
