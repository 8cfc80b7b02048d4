"""The port's failure detection and recovery (nx_signal_tpu_torch/parallel/
failure.py), case by case after TestHeartbeat and TestRunWithRecovery of
tests/test_failure_metrics.py: a streaming FIR under an injected failure
recovers BITWISE (the carry checkpoint is exact and each chunk's work
depends only on its shape, state and samples), and its output agrees with
the JAX package's run of the same loop at the FIR gate of the streaming
tests (1e-5 absolute, 1e-4 relative: f32 convolutions summed in other
orders). The probe thread has the heartbeat's own deadline.
"""

import os
import time

import numpy as np
import pytest
import torch

from nx_signal_tpu.parallel.failure import run_with_recovery as jax_run_with_recovery
from nx_signal_tpu.parallel.streaming import StreamingFIR as JaxStreamingFIR
from nx_signal_tpu_torch.parallel.failure import FailureDetected, heartbeat, run_with_recovery
from nx_signal_tpu_torch.parallel.streaming import StreamingFIR


@pytest.fixture
def rng():
    return np.random.default_rng(3)


class TestHeartbeat:
    def test_healthy(self):
        dt = heartbeat(timeout=60.0, device="cpu")
        assert 0.0 <= dt < 60.0

    def test_hang_detected(self):
        with pytest.raises(FailureDetected, match="did not complete"):
            heartbeat(timeout=0.2, probe=lambda: time.sleep(2.0))

    def test_probe_error_wrapped(self):
        def bad():
            raise RuntimeError("peer connection lost")

        with pytest.raises(FailureDetected, match="peer connection lost"):
            heartbeat(timeout=5.0, probe=bad)

    def test_no_card_and_no_cpu_request_is_a_failure(self, monkeypatch):
        """The default probe runs on the card unless asked for the CPU: with
        no CUDA device its error is reported as a failed probe."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(FailureDetected, match="device='cpu'"):
            heartbeat(timeout=5.0)
        assert heartbeat(timeout=5.0, device="cpu") >= 0.0


class TestRunWithRecovery:
    def _setup(self, rng):
        taps = rng.normal(size=33).astype(np.float32)
        x = rng.normal(size=(2, 40 * 64)).astype(np.float32)
        return taps, x

    def _run(self, taps, x, tmp_path, fail_at=None, jax_side=False, **kwargs):
        fir = JaxStreamingFIR(taps) if jax_side else StreamingFIR(taps)
        out = np.zeros_like(x)
        state0 = (fir.init_state(batch_shape=(2,)) if jax_side
                  else fir.init_state(batch_shape=(2,), device="cpu"))
        failures = {"armed": fail_at is not None}

        def step(state, i):
            if failures["armed"] and i == fail_at:
                failures["armed"] = False  # transient: fails exactly once
                raise RuntimeError("injected device preemption")
            chunk = x[:, i * 64:(i + 1) * 64]
            new_state, y = fir.process(state, chunk if jax_side else torch.from_numpy(
                np.ascontiguousarray(chunk)))
            out[:, i * 64:(i + 1) * 64] = np.asarray(y)  # idempotent sink
            return new_state

        os.makedirs(tmp_path, exist_ok=True)
        ckpt = os.path.join(tmp_path, "carry.npz")
        run = jax_run_with_recovery if jax_side else run_with_recovery
        run(step, state0, 40, checkpoint_path=ckpt, checkpoint_every=7, **kwargs)
        return out

    def test_bitwise_recovery_after_injected_failure(self, rng, tmp_path):
        taps, x = self._setup(rng)
        clean = self._run(taps, x, str(tmp_path / "a"))
        restarts = []
        recovered = self._run(taps, x, str(tmp_path / "b"), fail_at=17,
                              on_restart=lambda step, exc: restarts.append((step, str(exc))))
        assert restarts == [(17, "injected device preemption")]
        np.testing.assert_array_equal(recovered, clean)
        jax_recovered = self._run(taps, x, str(tmp_path / "c"), fail_at=17, jax_side=True)
        np.testing.assert_allclose(recovered, jax_recovered, atol=1e-5, rtol=1e-4)

    def test_resume_from_existing_checkpoint(self, rng, tmp_path):
        taps, x = self._setup(rng)
        fir = StreamingFIR(taps)
        d = str(tmp_path)

        def make_step(buf):
            def step(state, i):
                new_state, y = fir.process(
                    state, torch.from_numpy(np.ascontiguousarray(x[:, i * 64:(i + 1) * 64])))
                buf[:, i * 64:(i + 1) * 64] = y.numpy()
                return new_state
            return step

        ckpt = os.path.join(d, "carry.npz")
        out = np.zeros_like(x)
        run_with_recovery(make_step(out), fir.init_state(batch_shape=(2,), device="cpu"), 20,
                          checkpoint_path=ckpt, checkpoint_every=5)
        # a fresh loop (a restarted process) resumes at step 20: blocks
        # 0..19 are not recomputed
        out2 = np.zeros_like(x)
        run_with_recovery(make_step(out2), fir.init_state(batch_shape=(2,), device="cpu"), 40,
                          checkpoint_path=ckpt, checkpoint_every=5)
        assert not out2[:, :20 * 64].any()
        clean = self._run(taps, x, str(tmp_path / "clean"))
        np.testing.assert_array_equal(out2[:, 20 * 64:], clean[:, 20 * 64:])

    def test_max_restarts_exceeded(self, rng, tmp_path):
        def always_fail(state, i):
            raise RuntimeError("permanent failure")

        with pytest.raises(RuntimeError, match="permanent failure"):
            run_with_recovery(always_fail, torch.zeros(2), 10,
                              checkpoint_path=os.path.join(str(tmp_path), "c.npz"),
                              max_restarts=2)

    def test_heartbeat_in_loop(self, rng, tmp_path):
        taps, x = self._setup(rng)
        out = self._run(taps, x, str(tmp_path), heartbeat_every=10, heartbeat_timeout=60.0,
                        heartbeat_device="cpu")
        clean = self._run(taps, x, str(tmp_path / "c2"))
        np.testing.assert_array_equal(out, clean)

    def test_failed_heartbeat_replays_from_the_checkpoint(self, rng, tmp_path, monkeypatch):
        """With no card and no device='cpu', the loop's probe fails: every
        try is a restart, and past max_restarts the failure is raised."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        taps, x = self._setup(rng)
        restarts = []
        with pytest.raises(FailureDetected):
            self._run(taps, x, str(tmp_path), heartbeat_every=10, max_restarts=2,
                      on_restart=lambda step, exc: restarts.append(step))
        assert restarts == [0, 0]
