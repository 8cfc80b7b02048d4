"""The cell `logmel16k.whisper` (Whisper large-v3's log-mel front end): its
reference against numpy, its stage's work by hand, its reader on a
hand-made trace, and whole CPU runs at 3 clips x 2 s: the program correct,
its control and each planted fault (tests/logmel_faults.py) not.

Importing this file also gives the shared CPU runs of test_portbench_runs.py
(every one-card cell, its control, the generic faults) this cell's small
size, which its table SMALL has no entry for."""

import json
import math

import numpy as np
import pytest
import torch

import test_portbench_runs as runs
from conftest import ROOT
from portbench.core.peaks import least_seconds
from portbench.core.spec import Bench
from portbench.references import logmel as ref
from test_portbench_runs import cpu, small  # noqa: F401  (small: a fixture)
from test_portbench_spans import _launch, _read, _span

CELL = "logmel16k.whisper"
runs.SMALL.setdefault("logmel16k", (3, 32000))
FAULTS = ["batch_floor", "last_frame_kept", "edge_3016", "no_floor"]
CFG = json.loads((ROOT / "portbench/configs/logmel16k.json").read_text())


def test_the_program_is_correct_and_its_control_is_not(small):  # noqa: F811
    line, _ = cpu(small, CELL)
    assert line["correct"] is True, line["checks"]
    line, _ = cpu(small, CELL, "--mode", "control")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(small, fault):  # noqa: F811
    line, _ = cpu(small, CELL, "--patch", f"portbench.tests.logmel_faults:{fault}")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0


def test_a_traced_cpu_run_prints_the_cells_metrics(small):  # noqa: F811
    line, _ = cpu(small, CELL, "--trace", "1")
    got = line["metrics"]
    # the CPU has no peaks, so no roofline; the CPU ops launch nothing on a device
    assert "logmel_roofline" not in got
    assert got["mel_ms"]["value"] == 0.0
    assert got["weight_builds_per_call.logmel"]["value"] == 0.0


def test_the_stage_is_0_528_ms_by_bytes():
    # 512 x 480 000 f32 read, 512 x 128 x 3000 f32 written: 1.769 GB
    flops, nbytes = Bench(ROOT).module("stages", "logmel").work(CFG)
    assert nbytes == 4.0 * 512 * (480000 + 128 * 3000)
    seconds, bound = least_seconds(flops, nbytes, "NVIDIA H100 80GB HBM3")
    assert bound == "bytes" and seconds * 1e3 == pytest.approx(0.528, abs=5e-4)
    # the window, a 400-point real FFT and |.|^2 of 3001 frames, 394 nonzeros of 3000
    assert int((ref.filterbank(128, 16000.0, 400) != 0).sum()) == 394
    per_frame = 400 + 2.5 * 400 * math.log2(400) + 3 * 201
    assert flops == pytest.approx(512 * (3001 * per_frame + 3000 * 2 * 394), rel=1e-12)
    assert flops == pytest.approx(16.0e9, rel=5e-3)


def test_the_reader_takes_the_device_time_under_nx_mel(tmp_path):
    events = [_span("call", 1000, 1100), _span("nx.mel", 1010, 1050),
              *_launch(1011, 1, "sgemm", 1020, 1045), *_launch(1030, 2, "log10", 1045, 1052),
              _span("call", 1100, 1200), _span("nx.mel", 1110, 1150),
              *_launch(1111, 3, "sgemm", 1120, 1150)]
    assert _read(events, tmp_path, "mel_ms") == pytest.approx((32 + 30) / 2 * 1e-3)
    assert _read([e for e in events if e["name"] != "nx.mel"], tmp_path, "mel_ms") is None


def test_the_reference_is_whispers_stft_and_librosas_filterbank():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4000))
    # numpy: reflect-pad n_fft / 2 each side, frames at hop 160, periodic hann
    pad = np.pad(x, [(0, 0), (200, 200)], mode="reflect")
    idx = np.arange(400)[None, :] + 160 * np.arange(4000 // 160 + 1)[:, None]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 400)
    power = np.abs(np.fft.rfft(pad[:, idx] * win, axis=-1)) ** 2        # (2, frames, 201)
    fb = ref.filterbank(128, 16000.0, 400).numpy()
    mel = np.einsum("mk,cfk->cmf", fb, power[:, :-1])
    log = np.log10(np.maximum(mel, 1e-10))
    log = np.maximum(log, log.max(axis=(1, 2), keepdims=True) - 8.0)
    got = ref.log_mel(torch.from_numpy(x), 128, 16000.0, 400, 160).numpy()
    np.testing.assert_allclose(got, (log + 4.0) / 4.0, rtol=0, atol=1e-12)
    # librosa's Slaney scale: 8 kHz is mel 45.2456...; each triangle peaks at 2 / its width
    assert ref.hz_to_mel(8000.0) == pytest.approx(15.0 + 27.0 * math.log(8.0) / math.log(6.4),
                                                  rel=1e-15)
    assert ref.mel_to_hz(torch.tensor([ref.hz_to_mel(3000.0)], dtype=torch.float64)).item() \
        == pytest.approx(3000.0, rel=1e-14)
    assert float(ref.filterbank(128, 16000.0, 400)[:, -1].abs().max()) == 0.0


def test_the_control_is_tf32_and_reads_above_the_limit():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 32000)).astype(np.float32))
    exact = ref.log_mel(x, 128, 16000.0, 400, 160)
    err = ref.errors(ref.control_log_mel(x, 128, 16000.0, 400, 160), x, 128, 16000.0, 400,
                     160)
    assert 2e-5 < err < 1e-3
    assert ref.errors(exact.float(), x, 128, 16000.0, 400, 160) < 1e-6


def test_the_clips_are_drawn_from_the_seed(small):  # noqa: F811
    entries = Bench(small).module("entries", "logmel")
    traffic = json.loads((ROOT / "portbench/traffic/whisper.json").read_text())
    gen = torch.Generator().manual_seed(4294967311)
    x = entries.clips(gen, 2, 64, 48000, CFG, traffic, "cpu")
    again = entries.clips(torch.Generator().manual_seed(4294967311), 2, 64, 48000, CFG, traffic,
                          "cpu")
    assert torch.equal(x, again)
    nonzero = (x != 0).flatten(0, 1)
    lengths = nonzero.shape[-1] - nonzero.flip(-1).float().argmax(-1)
    # 1 to 30 s of a 30 s chunk, scaled to 48 000 samples: 1600 to 48 000
    assert int(lengths.min()) >= 1600 - 1 and int(lengths.max()) <= 48000
    assert int((lengths < 48000).sum()) > 100          # most clips end in zeros
    rms = x.flatten(0, 1)[:, :1600].pow(2).mean(-1).sqrt()
    db = 20 * torch.log10(rms)
    assert -42 < float(db.min()) < -30 and -8 < float(db.max()) < 2
