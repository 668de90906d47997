"""Dense stacked-LSTM regressor.

Weight layout is Keras-compatible so the reference's CSV fixtures load
directly (reference code/load_preprocess.py:93-126 stores per-gate blocks of
the same matrices):

* ``W``: (input_dim, 4*units), gate columns ordered [i | f | c | o]
* ``U``: (units, 4*units), same gate order
* ``b``: (4*units,)

and the cell math is the standard Keras LSTM
(reference code/old_versions/svd_classes.py:35-42 spells it out):

    z = x @ W + h @ U + b
    i, f, g, o = split(z, 4)
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Structure: the input projection ``x @ W + b`` for a whole sequence
is hoisted out of the recurrence into ONE large matmul (T×d @ d×4n) that XLA
hands to cuBLAS; only the inherently-sequential hidden-state product
``h @ U`` stays inside ``lax.scan``. This is what lets the full-sequence
forward pass run orders of magnitude faster than the reference's
``backend.rnn`` interpreter loop (code/svd_classes_v3.py:408-419).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svd_lstm_tpu.utils.linalg import zeros_varying_like


class LSTMLayerParams(NamedTuple):
    W: jax.Array  # (input_dim, 4*units)  [i|f|c|o]
    U: jax.Array  # (units, 4*units)
    b: jax.Array  # (4*units,)

    @property
    def units(self) -> int:
        return self.U.shape[0]

    @property
    def input_dim(self) -> int:
        return self.W.shape[0]


class DenseParams(NamedTuple):
    w: jax.Array  # (in, out)
    b: jax.Array  # (out,)


class StackedLSTMParams(NamedTuple):
    layers: Tuple[LSTMLayerParams, ...]
    head: DenseParams


def split_gates(z: jax.Array) -> Tuple[jax.Array, ...]:
    """(..., 4n) pre-activations -> the four (..., n) blocks [i, f, c, o]."""
    n = z.shape[-1] // 4
    return tuple(z[..., g * n : (g + 1) * n] for g in range(4))


def cell_update(zi, zf, zg, zo, c):
    """The cell on per-gate pre-activations: returns ``(h', c')``. The one
    source of the cell math, shared by the scans and the recurrence
    kernels (ops/gpu_recurrence.py), which keep each gate in its own
    block because the Triton route cannot slice a value in registers."""
    i = jax.nn.sigmoid(zi)
    f = jax.nn.sigmoid(zf)
    g = jnp.tanh(zg)
    o = jax.nn.sigmoid(zo)
    c_new = f * c + i * g
    return o * jnp.tanh(c_new), c_new


def gate_update(z: jax.Array, c: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Fused carry/output update. z: (..., 4n); c: (..., n)."""
    return cell_update(*split_gates(z), c)


def cell_update_bwd(zi, zf, zg, zo, c_prev, c_t, dh, dc):
    """Reverse of :func:`cell_update` at one step, from the recomputed
    pre-activations and the saved cell states. ``dh`` must already hold
    every contribution into h_t (output cotangent + recurrent carry).
    Returns ``((dzi, dzf, dzg, dzo), dc_prev)``.

    The one source of the cell gradient: the backward kernel
    (ops/gpu_recurrence.py) calls it; jax autodiff of the scan is the
    independent oracle in tests/test_pallas_train.py."""
    i = jax.nn.sigmoid(zi)
    f = jax.nn.sigmoid(zf)
    g = jnp.tanh(zg)
    o = jax.nn.sigmoid(zo)
    tc = jnp.tanh(c_t)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    dz = (
        dc_tot * g * i * (1.0 - i),
        dc_tot * c_prev * f * (1.0 - f),
        dc_tot * i * (1.0 - g * g),
        dh * tc * o * (1.0 - o),
    )
    return dz, dc_tot * f


def chunked_remat_scan(step, make_xp, x_t, carry0, K: int):
    """Shared chunked-time rematerialized recurrence (dense + singular
    layers): ``lax.scan(step, carry0, make_xp(x_t))`` but with
    ``jax.checkpoint`` around inner chunks of ``K`` steps, so autodiff
    saves only the raw input chunks and the chunk-boundary carries and
    recomputes ``make_xp`` + gate intermediates on the backward pass.

    x_t: (T, B, d) time-major input; make_xp: (T', B, d) -> (T', B, 4n);
    step: scan body over xp rows. Returns ``(carryT, h_seq)`` with h_seq
    time-major (T, B, n). Caller guarantees 0 < K < T.
    """
    T, B, d = x_t.shape
    n_chunks, tail = divmod(T, K)

    @jax.checkpoint
    def chunk_body(carry, x_chunk):  # x_chunk: (K, B, d)
        return jax.lax.scan(step, carry, make_xp(x_chunk))

    x_main = x_t[: n_chunks * K].reshape(n_chunks, K, B, d)
    carry, h_main = jax.lax.scan(chunk_body, carry0, x_main)
    h_seq = h_main.reshape(n_chunks * K, B, h_main.shape[-1])
    if tail:
        carry, h_tail = jax.lax.scan(step, carry, make_xp(x_t[n_chunks * K :]))
        h_seq = jnp.concatenate([h_seq, h_tail], axis=0)
    return carry, h_seq


def lstm_cell_step(
    params: LSTMLayerParams, x: jax.Array, h: jax.Array, c: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """One LSTM step on (batch, d) input — the real-time batch-1 deployment
    semantics (reference code/old_versions/svd_classes.py:104-119)."""
    z = x @ params.W + h @ params.U + params.b
    return gate_update(z, c)


def lstm_layer_apply(
    params: LSTMLayerParams,
    x_seq: jax.Array,
    h0: jax.Array | None = None,
    c0: jax.Array | None = None,
    return_state: bool = False,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng: jax.Array | None = None,
    remat_chunk: int = 0,
):
    """Run one LSTM layer over a sequence.

    x_seq: (batch, T, d). Returns (batch, T, units) hidden sequence
    (optionally plus final (h, c)).

    Dropout follows Keras LSTM semantics (reference SingularLSTMCell
    supports the same masks, code/svd_classes_v3.py:121-137): one inverted
    -scaled mask per gate, drawn once and reused at every timestep, applied
    to the inputs (``dropout``) and to h_{t-1} (``recurrent_dropout``).
    Requires ``rng`` when a rate is nonzero.

    ``remat_chunk > 0`` rematerializes BPTT activations in time chunks of
    that length (``jax.checkpoint`` around an inner scan): autodiff then
    saves only the raw input chunks and the (h, c) carries at chunk
    boundaries and recomputes each chunk's input projection and gate
    intermediates during the backward pass — O(T/K + K) live activation
    memory instead of O(T), for ~2× extra forward FLOPs. Identical values
    (the recompute is the same arithmetic); use it to train window lengths
    whose saved activations exceed HBM. No effect on inference (no grad →
    nothing is saved either way).
    """
    B, T, d = x_seq.shape
    n = params.units
    dtype = x_seq.dtype
    if h0 is None:
        h0 = zeros_varying_like(x_seq, (B, n), dtype)
    if c0 is None:
        c0 = zeros_varying_like(x_seq, (B, n), dtype)

    use_dp = dropout > 0.0
    use_rdp = recurrent_dropout > 0.0
    if (use_dp or use_rdp) and rng is None:
        raise ValueError("dropout requires an rng key")
    if use_dp or use_rdp:
        k_dp, k_rdp = jax.random.split(rng)

    if use_dp:
        # per-gate input masks, constant across time (Keras count=4)
        keep = 1.0 - dropout
        dp = jax.random.bernoulli(k_dp, keep, (4, B, d)).astype(dtype) / keep

    def make_xp(x_tbd):
        """Input projection for (T', B, d) time-major input -> (T', B, 4n).
        One large matmul (the hoisted-projection design); under remat it
        runs per chunk inside the checkpointed body so the projection is
        recomputed, not saved."""
        if use_dp:
            parts = [
                jnp.einsum(
                    "tbd,dn->tbn", x_tbd * dp[g][None], params.W[:, g * n : (g + 1) * n]
                )
                for g in range(4)
            ]
            return jnp.concatenate(parts, axis=-1) + params.b
        return jnp.einsum("tbd,dg->tbg", x_tbd, params.W) + params.b

    U = params.U
    if use_rdp:
        keep_r = 1.0 - recurrent_dropout
        rdp = jax.random.bernoulli(k_rdp, keep_r, (4, B, n)).astype(dtype) / keep_r

    def step(carry, xp_step):
        h, c = carry
        if use_rdp:
            z = xp_step + jnp.concatenate(
                [(h * rdp[g]) @ U[:, g * n : (g + 1) * n] for g in range(4)], axis=-1
            )
        else:
            z = xp_step + h @ U
        h, c = gate_update(z, c)
        return (h, c), h

    x_t = jnp.swapaxes(x_seq, 0, 1)  # (T, B, d) — scan over leading axis

    if remat_chunk and 0 < remat_chunk < T:
        (hT, cT), h_seq = chunked_remat_scan(
            step, make_xp, x_t, (h0, c0), int(remat_chunk)
        )
    else:
        (hT, cT), h_seq = jax.lax.scan(step, (h0, c0), make_xp(x_t))
    h_seq = jnp.swapaxes(h_seq, 0, 1)  # (B, T, n)
    if return_state:
        return h_seq, (hT, cT)
    return h_seq


def stacked_lstm_apply(
    params: StackedLSTMParams,
    x_seq: jax.Array,
    return_sequences: bool = True,
    remat_chunk: int = 0,
) -> jax.Array:
    """Stacked LSTM + Dense head.

    return_sequences=True  -> (batch, T, head_dim)   (whole-run evaluation,
                              reference code/train_full_model_v4.py:129-139)
    return_sequences=False -> (batch, head_dim)      (many-to-one training,
                              reference code/train_full_model_v4.py:109-115)
    remat_chunk > 0        -> chunked-time activation rematerialization in
                              every layer (see :func:`lstm_layer_apply`) for
                              long-window BPTT beyond the HBM activation
                              budget; identical values.
    """
    h = x_seq
    for layer in params.layers:
        h = lstm_layer_apply(layer, h, remat_chunk=remat_chunk)
    if not return_sequences:
        h = h[:, -1]
    return h @ params.head.w + params.head.b


def _glorot_uniform(key, shape, dtype):
    fan_in, fan_out = shape[0], shape[1]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def _orthogonal_gates(key, n, units, dtype):
    """Keras recurrent_initializer='orthogonal': one orthogonal (n, n) block
    per gate, concatenated along columns."""
    keys = jax.random.split(key, 4)
    blocks = [jax.nn.initializers.orthogonal()(k, (n, units), dtype) for k in keys]
    return jnp.concatenate(blocks, axis=1)


def init_lstm_layer(key, input_dim: int, units: int, dtype=jnp.float32) -> LSTMLayerParams:
    kW, kU = jax.random.split(key)
    W = _glorot_uniform(kW, (input_dim, 4 * units), dtype)
    U = _orthogonal_gates(kU, units, units, dtype)
    # Keras unit_forget_bias=True: forget-gate bias initialized to 1.
    b = jnp.concatenate(
        [
            jnp.zeros((units,), dtype),
            jnp.ones((units,), dtype),
            jnp.zeros((2 * units,), dtype),
        ]
    )
    return LSTMLayerParams(W=W, U=U, b=b)


def init_stacked_lstm(
    key,
    input_dim: int = 16,
    units: Sequence[int] = (40, 40, 40, 40),
    head_dim: int = 1,
    dtype=jnp.float32,
) -> StackedLSTMParams:
    keys = jax.random.split(key, len(units) + 1)
    layers = []
    d = input_dim
    for k, n in zip(keys[:-1], units):
        layers.append(init_lstm_layer(k, d, n, dtype))
        d = n
    w = _glorot_uniform(keys[-1], (d, head_dim), dtype)
    b = jnp.zeros((head_dim,), dtype)
    return StackedLSTMParams(layers=tuple(layers), head=DenseParams(w=w, b=b))
