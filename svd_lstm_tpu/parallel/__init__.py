from svd_lstm_tpu.parallel.mesh import make_mesh
from svd_lstm_tpu.parallel.fit import finetune_dp, finetune_reduced_dp, fit_dp
from svd_lstm_tpu.parallel.pipeline import make_pipeline_inference
from svd_lstm_tpu.parallel.train import (
    make_sharded_train_step,
    make_batched_inference,
    make_dp_train_step,
    make_dp_finetune_step,
    shard_params_for_mesh,
    shard_layer_tp,
    unshard_params_from_mesh,
)
