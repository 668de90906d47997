"""End-to-end drive of the public API: the full reference workflow —
preprocess → train → factorize → fine-tune(Hoyer) → truncate → predict →
metrics → checkpoint → recurrence-kernel inference → native consumer.
Runs on the GPU, or on the CPU with the kernel in interpret mode."""
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

import svd_lstm_tpu as st
from svd_lstm_tpu.config import DataConfig, FactorConfig, TrainConfig
from svd_lstm_tpu.data import preprocess, split_train_random
from svd_lstm_tpu.io.checkpoint import load_params, save_params
from svd_lstm_tpu.train.finetune import finetune, harvest_sigmas
from svd_lstm_tpu.train.loop import fit, predict_full_run

print("== devices:", jax.devices())

# 1. data (synthetic surrogate; raw DROPBEAR JSON is gitignored upstream).
# 16 s run -> T = 32 000 frames at the 500 us frame clock.
from svd_lstm_tpu.data.dropbear import preprocess_raw
from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw

ds = preprocess_raw(synthetic_dropbear_raw(duration=16.0), DataConfig(split_time=8.0))
print(f"== data: X{ds.X.shape} y{ds.y.shape} train_T={ds.X_train.shape[1]} test_T={ds.X_test.shape[1]}")

# 2. train a small full model briefly (2 epochs, small batch count)
params = st.init_stacked_lstm(jax.random.PRNGKey(0), 16, (40, 40))
res = fit(params, ds.X_train, ds.y_train,
          TrainConfig(num_windows=2048, window_len=100, epochs=2, batch_size=64))
print(f"== train: loss {res.history[0]:.4f} -> {res.history[-1]:.4f} rollbacks={res.rollbacks}")
assert res.history[-1] < res.history[0]

# 3. factorize + fine-tune with Hoyer
smodel = st.make_singular_model(res.params, merged_kernel=False)
fres = finetune(smodel, ds.X_train, ds.y_train,
                FactorConfig(hoyer=0.01),
                TrainConfig(num_windows=1024, window_len=100, epochs=1, batch_size=64))
sig = harvest_sigmas(fres.params)
print(f"== finetune: loss {fres.history[-1]:.4f}; layer0 sigma_u head {sig[0][1][0][:4].round(3)}")

# 4. truncate
rmodel = st.make_reduced_model(fres.params, cutoff=0.05)
w_red = sum(l.weight_count() for l in rmodel.layers)
w_full = sum(int(np.asarray(x).size) for L in res.params.layers for x in L)
print(f"== reduce: weights {w_full} -> {w_red} ({100-100*w_red/w_full:.1f}% smaller)")

# 5. whole-run predict + metrics (scan path)
pred_full = predict_full_run(res.params, ds.X_test)
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
pred_red = predict_full_run(fres.params, ds.X_test, apply_fn=st.singular_lstm_apply)
pred_red2 = predict_full_run(rmodel, ds.X_test, apply_fn=reduced_lstm_apply)
y_m = ds.pin_scaler.inverse_transform(ds.y_test.reshape(-1, 1)).ravel()
pf = ds.pin_scaler.inverse_transform(pred_full.reshape(-1, 1)).ravel()
pr = ds.pin_scaler.inverse_transform(pred_red2.reshape(-1, 1)).ravel()
print(f"== metrics: full RMSE {st.rmse(y_m, pf)*1000:.2f} mm  reduced RMSE {st.rmse(y_m, pr)*1000:.2f} mm  "
      f"SNR(full) {st.signaltonoise(y_m, pf):.1f} dB  noise(red vs full) {st.signaltonoise(pf, pr, invert=True):.1f} dB")

# 6. checkpoint roundtrip
work = tempfile.mkdtemp(prefix="verify_e2e_")
save_params(os.path.join(work, "ckpt.npz"), rmodel)
r2 = load_params(os.path.join(work, "ckpt.npz"))
assert all(np.array_equal(np.asarray(a), np.asarray(b))
           for a, b in zip(jax.tree.leaves(rmodel), jax.tree.leaves(r2)))
print("== checkpoint: roundtrip exact")

# 7. the recurrence kernel (predict impl="fused") vs the scan (interpret
# mode on the CPU, where the run is shortened)
Tk = 256 if jax.default_backend() == "cpu" else ds.X_test.shape[1]
xt = jnp.asarray(ds.X_test[0, :Tk], jnp.float32)
y_kernel_full = np.asarray(st.predict(res.params, xt, impl="fused"))[:, 0]
y_kernel_red = np.asarray(st.predict(rmodel, xt, impl="fused"))[:, 0]
e1 = np.abs(y_kernel_full - pred_full[:Tk]).max()
e2 = np.abs(y_kernel_red - pred_red2[:Tk]).max()
print(f"== kernel: |fused_full - scan| {e1:.2e}  |fused_reduced - scan| {e2:.2e}")
assert e1 < 1e-4 and e2 < 1e-4

# 8. native C++ consumer: export the reduced model, load through the
# ctypes bindings, frame-at-a-time parity vs the JAX scan (the LabVIEW
# deployment role, reference code/load_preprocess.py:93-128)
try:
    from svd_lstm_tpu.io.native import NativeModel, save_reduced_weights_as_csv

    ndir = os.path.join(work, "native_export")
    save_reduced_weights_as_csv(rmodel, ndir)
    nm = NativeModel(
        ndir,
        [f"lstm_{i}" for i in range(len(rmodel.layers))],
        kinds="r" * len(rmodel.layers),
    )
    Tn = 128
    y_native = nm.run(np.asarray(ds.X_test[0, :Tn], np.float32))
    e_native = np.abs(y_native - pred_red2[:Tn]).max()
    print(f"== native: C++ runtime vs JAX scan |Δ| {e_native:.2e}")
    assert e_native < 1e-4
except OSError as e:  # no g++ on a bare consumer box — report, don't fail
    print(f"== native: SKIPPED (toolchain unavailable: {e})")

# PROBE: cutoff above every sigma must keep >=1 value per gate, still run
rm_extreme = st.make_reduced_model(fres.params, cutoff=1e9)
pe = predict_full_run(rm_extreme, ds.X_test[:, :50], apply_fn=reduced_lstm_apply)
print(f"== probe extreme cutoff: rank-1 model runs, finite={np.isfinite(pe).all()}, "
      f"weights={sum(l.weight_count() for l in rm_extreme.layers)}")

# PROBE: batch label edge — window at the very end of the run
Xm, ym = split_train_random(ds.X_train, ds.y_train, 4, ds.X_train.shape[1] - 1, seed=0)
print(f"== probe max-length window: X{Xm.shape} labels finite={np.isfinite(ym).all()}")

print("ALL E2E CHECKS PASSED")
