"""Hoyer-efficacy experiment: does the fine-tune actually sparsify σ
so that cutoff-truncation removes weights at negligible RMSE cost?

Mirrors the reference experiment end-to-end (train → factorize →
hoyer-finetune → truncate → compare), on the synthetic DROPBEAR surrogate,
and records the numbers for the README's accuracy claims.
"""
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

import svd_lstm_tpu as st
from svd_lstm_tpu.config import DataConfig, FactorConfig, TrainConfig
from svd_lstm_tpu.data.dropbear import preprocess_raw
from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw
from svd_lstm_tpu.train.finetune import finetune, harvest_sigmas
from svd_lstm_tpu.train.loop import fit, predict_full_run
from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent

t0 = time.time()
print("devices:", jax.devices(), flush=True)

ds = preprocess_raw(synthetic_dropbear_raw(duration=30.0), DataConfig(split_time=22.0))
print(f"data: T={ds.X.shape[1]} train={ds.X_train.shape[1]} test={ds.X_test.shape[1]}", flush=True)

units = (40, 40, 40, 40)
params = st.init_stacked_lstm(jax.random.PRNGKey(0), 16, units)
res = fit(params, ds.X_train, ds.y_train,
          TrainConfig(num_windows=8192, window_len=200, epochs=8, batch_size=64),
          verbose=True)
print(f"train done at {time.time()-t0:.0f}s", flush=True)

smodel = st.make_singular_model(res.params, merged_kernel=False)

for hoyer in (0.0, 0.01, 0.03):
    fres = finetune(
        smodel, ds.X_train, ds.y_train,
        FactorConfig(hoyer=hoyer),
        TrainConfig(num_windows=8192, window_len=200, epochs=6, batch_size=64),
    )
    sig = harvest_sigmas(fres.params)
    below = sum(int((su < 0.05).sum()) for _, su in sig) + sum(
        int((sw < 0.05).sum()) for sw, _ in sig
    )
    total = sum(su.size for _, su in sig) + sum(sw.size for sw, _ in sig)

    rmodel = st.make_reduced_model(fres.params, cutoff=0.05)
    red_w = sum(l.weight_count() for l in rmodel.layers)
    full_w = sum(int(np.asarray(x).size) for L in res.params.layers for x in L)

    y_m = ds.pin_scaler.inverse_transform(ds.y_test.reshape(-1, 1)).ravel()
    pf = predict_full_run(res.params, ds.X_test)
    pf_m = ds.pin_scaler.inverse_transform(pf.reshape(-1, 1)).ravel()
    red_fn = jax.jit(lambda p, xx: reduced_forward_dense_recurrent(p, xx, return_sequences=True))
    pr = np.asarray(red_fn(rmodel, jnp.asarray(ds.X_test)))[0, :, 0]
    pr_m = ds.pin_scaler.inverse_transform(pr.reshape(-1, 1)).ravel()

    print(json.dumps({
        "hoyer": hoyer,
        "finetune_loss": fres.history[-1] if fres.history else None,
        "sigma_below_cutoff": f"{below}/{total}",
        "weights": f"{full_w}->{red_w}",
        "weight_reduction_pct": round(100 - 100 * red_w / full_w, 2),
        "rmse_full_mm": round(st.rmse(y_m, pf_m) * 1000, 3),
        "rmse_reduced_mm": round(st.rmse(y_m, pr_m) * 1000, 3),
        "snr_reduced_db": round(st.signaltonoise(y_m, pr_m), 2),
        "elapsed_s": round(time.time() - t0),
    }), flush=True)
