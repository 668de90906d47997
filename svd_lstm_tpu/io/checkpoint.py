"""Parameter checkpointing.

Covers the reference's checkpoint/resume surface (SURVEY.md §5): Keras'
``ModelCheckpoint(save_best_only)`` + ``model.save/load_model``
(reference old_versions/train_full_model.py:108-116,
train_full_model_v4.py:128,159) become explicit save/load of parameter
pytrees. Arrays are stored as a compressed ``.npz`` plus a JSON treedef so
checkpoints are portable and inspectable (no pickle).
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from svd_lstm_tpu.models.conv import (
    ConvLSTMParams,
    ConvParams,
    ConvReducedParams,
    ConvSingularParams,
)
from svd_lstm_tpu.models.lstm import DenseParams, LSTMLayerParams, StackedLSTMParams
from svd_lstm_tpu.models.reduced import ReducedLayerParams, ReducedModelParams
from svd_lstm_tpu.models.singular import SingularLayerParams, SingularModelParams
from svd_lstm_tpu.utils.quantize import QuantizedTensor

_NODE_TYPES = {
    cls.__name__: cls
    for cls in [
        DenseParams,
        LSTMLayerParams,
        StackedLSTMParams,
        SingularLayerParams,
        SingularModelParams,
        ReducedLayerParams,
        ReducedModelParams,
        ConvParams,
        ConvLSTMParams,
        ConvSingularParams,
        ConvReducedParams,
        QuantizedTensor,
    ]
}


def _spec_of(obj: Any, leaves: list) -> Any:
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple node
        # Fail at SAVE time for node types load can't rebuild — otherwise
        # e.g. save_params(path, result.opt_state) (optax states are
        # NamedTuples) silently writes a checkpoint that load_params can
        # only answer with a KeyError.
        if type(obj).__name__ not in _NODE_TYPES:
            raise TypeError(
                f"cannot checkpoint node type {type(obj).__name__!r}: only "
                f"{sorted(_NODE_TYPES)} round-trip through load_params. "
                "For optimizer state, convert to plain dict/tuple/arrays "
                "(e.g. jax.tree.map over flattened leaves) before saving."
            )
        return {
            "__node__": type(obj).__name__,
            "fields": {k: _spec_of(v, leaves) for k, v in obj._asdict().items()},
        }
    if isinstance(obj, tuple):
        return {"__tuple__": [_spec_of(v, leaves) for v in obj]}
    if isinstance(obj, list):
        return {"__list__": [_spec_of(v, leaves) for v in obj]}
    if isinstance(obj, dict):
        return {"__dict__": {k: _spec_of(v, leaves) for k, v in obj.items()}}
    # leaf array
    idx = len(leaves)
    leaves.append(np.asarray(obj))
    return {"__leaf__": idx}


def _build(spec: Any, leaves) -> Any:
    if "__leaf__" in spec:
        return jnp.asarray(leaves[spec["__leaf__"]])
    if "__node__" in spec:
        cls = _NODE_TYPES[spec["__node__"]]
        return cls(**{k: _build(v, leaves) for k, v in spec["fields"].items()})
    if "__tuple__" in spec:
        return tuple(_build(v, leaves) for v in spec["__tuple__"])
    if "__list__" in spec:
        return [_build(v, leaves) for v in spec["__list__"]]
    if "__dict__" in spec:
        return {k: _build(v, leaves) for k, v in spec["__dict__"].items()}
    raise ValueError(f"bad checkpoint spec node: {spec}")


def save_params(path: str, params: Any) -> None:
    """Save a parameter pytree (dense/singular/reduced model) to ``path``
    (a ``.npz`` file; parent dirs are created). ``np.savez`` appends
    ``.npz`` to suffix-less names, so ``load_params`` accepts either form."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    leaves: list = []
    spec = _spec_of(jax.device_get(params), leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    np.savez_compressed(path, __spec__=json.dumps(spec), **arrays)


def load_params(path: str) -> Any:
    """Load a pytree saved by :func:`save_params` (``.npz``) or
    :func:`save_params_orbax` (directory) — format is detected from the path.
    A suffix-less ``path`` falls back to ``path + '.npz'`` (what
    ``np.savez`` actually wrote for a suffix-less save)."""
    if os.path.isdir(path):
        return load_params_orbax(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        leaves = [z[f"leaf_{i}"] for i in range(sum(1 for k in z.files if k.startswith("leaf_")))]
    return _build(spec, leaves)


def save_params_orbax(path: str, params: Any) -> None:
    """Save a parameter pytree as an Orbax checkpoint directory.

    The production format (SURVEY.md §5 names Orbax as the
    checkpoint/resume equivalent of the reference's Keras ``model.save`` —
    reference train_full_model_v4.py:128,159): sharded-array-aware, atomic
    (tmp dir renamed only on success), and async-friendly. The model
    structure travels with the checkpoint as a JSON item, so restore needs
    no template pytree — exactly like the ``.npz`` path.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    leaves: list = []
    spec = _spec_of(jax.device_get(params), leaves)
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        ckptr.save(
            path,
            args=ocp.args.Composite(
                arrays=ocp.args.StandardSave({"leaves": leaves}),
                spec=ocp.args.JsonSave(spec),
            ),
            force=True,
        )


def load_params_orbax(path: str) -> Any:
    """Restore a pytree saved by :func:`save_params_orbax`."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        restored = ckptr.restore(
            path,
            args=ocp.args.Composite(
                arrays=ocp.args.StandardRestore(),
                spec=ocp.args.JsonRestore(),
            ),
        )
    return _build(restored["spec"], restored["arrays"]["leaves"])
