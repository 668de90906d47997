"""Execution layer: the recurrence kernel pair and layout transforms.

* gpu_recurrence — the Pallas (Triton route) forward/backward recurrence
  kernels for narrow stacks, their custom-VJP training apply and the
  batch-1 / batched inference forward
* singular_train — the SVD fine-tune through the same kernels via a
  differentiable dense reconstruction (exact chain-rule factor gradients)
* reduced_train — the post-truncation recovery fine-tune through the same
  kernels via the exact two-step dense view (beyond-reference: the
  reference's reduced cell is frozen)
* conv_train — the Conv1D+LSTM hybrids through the same kernels via the
  hoisted conv front end (standard XLA VJP feeding the stack kernels)
* layouts — storage-vs-execution layout transforms for reduced models
"""

from svd_lstm_tpu.ops.conv_train import (
    conv_lstm_apply_fast_train,
    conv_reduced_apply_fast_train,
    conv_singular_apply_fast_train,
)
from svd_lstm_tpu.ops.gpu_recurrence import (
    lstm_recurrence,
    stack_forward,
    stacked_lstm_apply_fast_train,
)
from svd_lstm_tpu.ops.layouts import (
    reconstruct_dense_model,
    reduced_forward_dense_recurrent,
)
from svd_lstm_tpu.ops.reduced_train import (
    reduced_dense_view,
    reduced_lstm_apply_fast_train,
)
from svd_lstm_tpu.ops.singular_train import (
    singular_dense_view,
    singular_lstm_apply_fast_train,
)
