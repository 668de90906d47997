"""Roofline accounting + multi-run batcher."""

import numpy as np

from svd_lstm_tpu.bench.roofline import dense_step_cost, reduced_step_cost, report
from svd_lstm_tpu.data.batcher import split_train_random_multi


class TestRoofline:
    def test_dense_cost_positive_and_scales(self):
        small = dense_step_cost(16, (40,) * 4)
        big = dense_step_cost(16, (512,) * 4)
        assert big.bytes_streamed > small.bytes_streamed
        assert big.macs > small.macs
        assert small.bandwidth_floor_us() > small.compute_floor_us()

    def test_reduced_less_streaming_at_wide(self):
        dense = dense_step_cost(16, (512,) * 3)
        red = reduced_step_cost(16, (512,) * 3, (32,) * 3, merged=True)
        assert red.bytes_streamed < dense.bytes_streamed / 2

    def test_report_string(self):
        s = report(dense_step_cost(16, (40,) * 4), measured_us_per_step=0.664)
        assert "roofline" in s and "ns/step" in s

    def test_train_cost_wide_vs_narrow(self):
        from svd_lstm_tpu.bench.roofline import train_step_cost

        w = train_step_cost(16, (512,) * 3, B=128, T=200)
        # model MACs = 3x forward
        d, fwd = 16, 0
        for n in (512,) * 3:
            fwd += 128 * 200 * (d * 4 * n + n * 4 * n)
            d = n
        assert w.macs_model == 3 * fwd
        # at n=512 the gate width is n: no padding, the kernel's 12 dots
        # per layer-step plus the unpadded XLA products exceed 3x forward
        # only by the backward's gate recompute
        assert w.macs_executed > w.macs_model

        nar = train_step_cost(16, (40,) * 4, B=512, T=200)
        # n=40 pads each gate to 64 columns: executed MACs exceed model MACs
        assert nar.macs_executed > 2 * nar.macs_model
        # 18 G-wide f32 rows per layer-step (6 forward, 12 backward)
        assert nar.hbm_bytes == 4 * 18 * 512 * 200 * 64 * 4
        # mfu is monotone in measured time
        pk = 989e12
        assert 0 < nar.mfu(4.0, pk) < nar.mfu(2.5, pk) < 1

    def test_train_cost_narrow_rounds_batch_to_8(self):
        """The kernel pads the batch to whole 16-row tiles (Triton's least
        dot height), so B=9 executes what B=16 does; model MACs count the
        true B."""
        from svd_lstm_tpu.bench.roofline import train_step_cost

        a = train_step_cost(16, (40,) * 4, B=9, T=10)
        b = train_step_cost(16, (40,) * 4, B=16, T=10)
        assert a.hbm_bytes == b.hbm_bytes
        assert a.macs_model < b.macs_model

    def test_peaks_keyed_by_device_kind(self):
        import pytest

        from svd_lstm_tpu.bench.roofline import peaks, roofline_ms

        pk = peaks("NVIDIA H100 80GB HBM3")
        assert pk.bf16_flops == 989e12 and pk.hbm_bytes_per_s == 3.35e12
        with pytest.raises(KeyError):
            peaks("Unlisted Accelerator 9000")
        # 1 GFLOP of work and 1 byte: compute-bound at every precision
        ms, bound = roofline_ms(0.5e9, 1, pk, "bfloat16")
        assert bound == "compute" and abs(ms - 1e9 / 989e12 * 1e3) < 1e-12
        ms, bound = roofline_ms(1, 3.35e9, pk)
        assert bound == "memory" and abs(ms - 1.0) < 1e-9


class TestMultiRunBatcher:
    def test_shapes_and_run_sampling(self):
        R, T, d = 5, 200, 3
        X = np.zeros((R, T, d), np.float32)
        for r in range(R):
            X[r] = r
        y = np.tile(np.arange(T, dtype=np.float32), (R, 1))
        Xm, ym = split_train_random_multi(X, y, batch_size=16, train_len=20, seed=0)
        assert Xm.shape == (16, 20, d) and ym.shape == (16,)
        # every window comes from a single run (constant feature value)
        assert (Xm.min(axis=(1, 2)) == Xm.max(axis=(1, 2))).all()
        # labels are window-end values
        assert ((ym >= 20) & (ym < T)).all()
