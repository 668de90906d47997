"""svd_lstm_tpu — a JAX framework for SVD-accelerated LSTMs on the GPU.

From-scratch rebuild of the capabilities of
`dncoble/LSTM-acceleration-with-singular-value-decomposition`:

* train a stacked LSTM regressor on the DROPBEAR structural-dynamics dataset
  (reference: code/train_full_model_v4.py),
* factorize every kernel / recurrent kernel as U·Σ·Vᵀ and fine-tune with a
  Hoyer (L1/L2) sparsity regularizer on the singular values plus an
  orthogonality penalty on the factors (reference: code/svd_classes_v3.py),
* truncate to an exact low-rank two-step cell `z = [xB, (xB)C]` with
  `B=(UΣ)V₁`, `C=V₁⁻¹V₂` (reference: code/svd_classes_v3.py:604-676),
* run the recurrence of narrow stacks as a Pallas (Triton) kernel on the
  GPU that keeps h and c on chip for the whole run — the reference's
  Python/Keras compressed model ran ~1.3× slower than its full one
  (reference: plots/timing_plot.png, slide 15).

Design: pure-functional parameter pytrees, `lax.scan` over time, the input
projection of every layer hoisted out of the recurrence into one large
matmul, and `jax.sharding.Mesh` + `shard_map` for batch/model parallel
execution.
"""

__version__ = "0.1.0"

import jax as _jax

# Full-f32 matmuls by default: on the GPU XLA may otherwise run f32
# operands in TF32 (10 mantissa bits), which breaks exact-reconstruction
# numerics (singular/reduced models must match the dense model to tight
# tolerance at every rank — SURVEY.md §7 hard part (a)). bfloat16-dtype
# params are unaffected; speed modes opt in explicitly (precision="high" /
# "fast"). Pallas kernels ignore this setting: ops/gpu_recurrence.py passes
# its dot precision (HIGHEST or DEFAULT) to every in-kernel dot itself.
_jax.config.update("jax_default_matmul_precision", "float32")

from svd_lstm_tpu.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    FactorConfig,
    SweepConfig,
)
from svd_lstm_tpu.models.lstm import (
    LSTMLayerParams,
    StackedLSTMParams,
    init_stacked_lstm,
    stacked_lstm_apply,
)
from svd_lstm_tpu.models.singular import (
    SingularLayerParams,
    singular_lstm_apply,
)
from svd_lstm_tpu.models.reduced import (
    ReducedLayerParams,
    reduced_lstm_apply,
)
from svd_lstm_tpu.models.conv import (
    ConvLSTMParams,
    ConvSingularParams,
    ConvReducedParams,
    init_conv_lstm,
    conv_lstm_apply,
    conv_singular_apply,
    conv_reduced_apply,
)
from svd_lstm_tpu.factor.svd import (
    factorize_lstm_params,
    make_singular_model,
    make_reduced_model,
    make_conv_singular_model,
    make_conv_reduced_model,
    conv_singular_to_dense,
    singular_to_dense,
    reduce_matrix_rank,
    reduce_two_step,
    get_model_singular_values,
    set_model_matrix_rank,
)
from svd_lstm_tpu.factor.regularizers import (
    hoyer_penalty,
    orthogonal_penalty,
    trace_norm_penalty,
)
from svd_lstm_tpu.train.metrics import rmse, nrmse, signaltonoise
from svd_lstm_tpu.api import predict
from svd_lstm_tpu.io.checkpoint import load_params, save_params
from svd_lstm_tpu.utils.precision import cast_params
from svd_lstm_tpu.utils.quantize import (
    QuantizedTensor,
    dequantize_params,
    fake_quantize_params,
    qat_apply,
    quantize_params,
    quantized_apply,
)
