"""The port's host IO (nx_signal_tpu_torch/io/wav.py, raw.py) on its own
native library, case by case after tests/test_io.py: WAV round trips
(scipy.io.wavfile as the oracle), chunked reads, the ring buffer, the
prefetching readers and raw captures on both the native and the numpy
path. Files written by each package read back bitwise in the other (the
same C++ source decodes them). The library is built at first use into
`io/_build/`; builds that race each other (test workers) each compile to a
name of their own and rename the finished file into place.

Every test that starts a thread joins it with a deadline, and every reader
is closed in `finally` or by its context manager.
"""

import shutil
import struct
import subprocess
import threading
import time
import warnings

import numpy as np
import pytest
import scipy.io.wavfile as swav

from nx_signal_tpu.io import raw as jraw
from nx_signal_tpu.io import wav as jwav
from nx_signal_tpu_torch.io import (RingBuffer, WavReader, load_state, read_wav, save_state,
                                    stream_wav, write_wav)
from nx_signal_tpu_torch.io import raw as raw_mod
from nx_signal_tpu_torch.io import wav as wav_mod


@pytest.fixture
def tone():
    t = np.arange(8000) / 8000.0
    return np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 880 * t)]).astype(
        np.float32
    )


def test_io_names_are_the_jax_packages():
    import nx_signal_tpu.io as jio

    import nx_signal_tpu_torch.io as tio

    assert tio.__all__ == jio.__all__
    assert raw_mod.__all__ == jraw.__all__ and wav_mod.__all__ == jwav.__all__
    assert callable(load_state) and callable(save_state)


def test_native_library_builds():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the pure-Python fallback is the supported path here")
    assert wav_mod._load() is not None, "native wav_io failed to compile"
    assert wav_mod.library_path().exists()
    assert wav_mod.library_path().parent.name == "_build"


def test_racing_builds_each_load_a_finished_library(tmp_path, monkeypatch):
    """Three builds at once into an empty directory: each compiles to a
    name of its own, renames it into place, and the file that stands is a
    whole library (no temporary file is left)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    monkeypatch.setattr(wav_mod, "_BUILD_DIR", tmp_path / "_build")
    path = wav_mod.library_path()
    errors = []

    def build():
        try:
            wav_mod._build_native(path)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    import ctypes

    assert ctypes.CDLL(str(path)).wav_open(b"/nonexistent.wav") == 0


def test_fallback_when_the_library_cannot_build(tmp_path, monkeypatch):
    def fail(path):
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(wav_mod, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wav_mod, "_build_native", fail)
    monkeypatch.setattr(wav_mod, "_lib", None)
    monkeypatch.setattr(wav_mod, "_native_failed", False)
    with pytest.warns(UserWarning, match="Python fallback"):
        assert wav_mod._load() is None
    x = np.sin(np.arange(1000) / 10).astype(np.float32)
    p = tmp_path / "fb.wav"
    write_wav(p, x, 16000)   # PCM16 through the stdlib
    data, rate = read_wav(p)
    assert rate == 16000 and data.shape == (1, 1000)
    np.testing.assert_allclose(data[0], x, atol=1.0 / 16000)
    with pytest.raises(RuntimeError, match="native"):
        write_wav(p, x, 16000, float32=True)


class TestWavRoundtrip:
    def test_float32(self, tone, tmp_path):
        p = tmp_path / "t.wav"
        write_wav(p, tone, 8000, float32=True)
        data, rate = read_wav(p)
        assert rate == 8000
        np.testing.assert_array_equal(data, tone)

    def test_pcm16(self, tone, tmp_path):
        p = tmp_path / "t.wav"
        write_wav(p, tone, 8000)
        data, rate = read_wav(p)
        np.testing.assert_allclose(data, tone, atol=1.0 / 16000)  # 16-bit LSB

    def test_mono_1d(self, tmp_path):
        x = np.sin(np.arange(1000) / 10).astype(np.float32)
        p = tmp_path / "m.wav"
        write_wav(p, x, 16000)
        data, rate = read_wav(p)
        assert data.shape == (1, 1000)

    def test_reads_scipy_written_pcm16(self, tone, tmp_path):
        p = tmp_path / "s.wav"
        swav.write(p, 8000, (tone.T * 32767).astype(np.int16))
        data, rate = read_wav(p)
        assert rate == 8000
        np.testing.assert_allclose(data, tone, atol=1.0 / 16000)

    def test_reads_scipy_written_int32_and_float(self, tone, tmp_path):
        p = tmp_path / "s32.wav"
        swav.write(p, 8000, (tone.T * 2147483000).astype(np.int32))
        data, _ = read_wav(p)
        np.testing.assert_allclose(data, tone, atol=1e-3)
        p2 = tmp_path / "f32.wav"
        swav.write(p2, 8000, tone.T.astype(np.float32))
        data2, _ = read_wav(p2)
        np.testing.assert_array_equal(data2, tone)

    def test_scipy_reads_ours(self, tone, tmp_path):
        p = tmp_path / "ours.wav"
        write_wav(p, tone, 8000, float32=True)
        rate, data = swav.read(p)
        assert rate == 8000
        np.testing.assert_array_equal(data.T, tone)

    @pytest.mark.parametrize("float32", [False, True])
    def test_each_package_reads_the_others_files_bitwise(self, tone, tmp_path, float32):
        ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
        write_wav(ours, tone, 8000, float32=float32)
        jwav.write_wav(theirs, tone, 8000, float32=float32)
        assert ours.read_bytes() == theirs.read_bytes()
        for p in (ours, theirs):
            got, want = read_wav(p), jwav.read_wav(p)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])


class TestChunkedReads:
    def test_stream_matches_full(self, tone, tmp_path):
        p = tmp_path / "t.wav"
        write_wav(p, tone, 8000, float32=True)
        chunks = list(stream_wav(p, 999))
        np.testing.assert_array_equal(np.concatenate(chunks, axis=1), tone)
        assert chunks[-1].shape[1] == 8000 - 999 * 8
        for a, b in zip(chunks, jwav.stream_wav(p, 999)):
            np.testing.assert_array_equal(a, b)

    def test_seek(self, tone, tmp_path):
        p = tmp_path / "t.wav"
        write_wav(p, tone, 8000, float32=True)
        with WavReader(p) as r:
            r.seek(4000)
            np.testing.assert_array_equal(r.read(100), tone[:, 4000:4100])
            with pytest.raises(ValueError, match="seek"):
                r.seek(8001)

    def test_missing_file(self):
        with pytest.raises(OSError):
            WavReader("/nonexistent/file.wav")


class TestRingBuffer:
    def test_basic(self):
        rb = RingBuffer(1024)
        try:
            assert rb.capacity >= 1024
            data = np.arange(100, dtype=np.float32)
            assert rb.push(data) == 100
            assert len(rb) == 100
            np.testing.assert_array_equal(rb.pop(100), data)
            assert len(rb) == 0
        finally:
            rb.close()

    def test_partial_pop_and_wraparound(self):
        rb = RingBuffer(128)
        try:
            cap = rb.capacity
            for round_ in range(5):
                x = np.full(cap - 3, float(round_), np.float32)
                assert rb.push(x) == cap - 3
                np.testing.assert_array_equal(rb.pop(cap), x)
        finally:
            rb.close()

    def test_full_buffer_partial_push(self):
        rb = RingBuffer(64)
        try:
            cap = rb.capacity
            assert rb.push(np.zeros(cap, np.float32)) == cap
            assert rb.push(np.ones(10, np.float32)) == 0  # full
        finally:
            rb.close()

    def test_producer_consumer_threads(self):
        rb = RingBuffer(1 << 14)
        total = 1 << 18
        src = np.random.default_rng(0).normal(size=total).astype(np.float32)
        received, stop = [], threading.Event()

        def producer():
            sent = 0
            while sent < total and not stop.is_set():
                sent += rb.push(src[sent:sent + 4096])

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            got, deadline = 0, time.monotonic() + 60
            while got < total and time.monotonic() < deadline:
                out = rb.pop(4096)
                received.append(out)
                got += len(out)
        finally:
            stop.set()
            t.join(timeout=60)
            rb.close()
        assert not t.is_alive()
        np.testing.assert_array_equal(np.concatenate(received), src)


def test_reads_wave_format_extensible_float32(tone, tmp_path):
    p = tmp_path / "ext.wav"
    interleaved = tone.T.astype("<f4").tobytes()
    channels, bits, rate = 2, 32, 8000
    block = channels * bits // 8
    guid = struct.pack("<H", 3) + bytes(14)  # KSDATAFORMAT_SUBTYPE_IEEE_FLOAT
    fmt = struct.pack("<HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits)
    fmt += struct.pack("<HHI", 22, bits, 0x3) + guid
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(interleaved)) + interleaved
    p.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    data, rate_read = read_wav(p)
    assert rate_read == 8000
    np.testing.assert_array_equal(data, tone)


def test_rejects_inconsistent_block_align(tmp_path):
    p = tmp_path / "bad.wav"
    fmt = struct.pack("<HHIIHH", 1, 2, 8000, 8000 * 2, 2, 32)  # block_align too small
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", 64) + bytes(64)
    p.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    with pytest.raises(OSError):
        WavReader(p)


class TestPrefetchingWavReader:
    def test_blocks_match_batch_read(self, tmp_path):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(2, 44100)).astype(np.float32) * 0.5
        path = str(tmp_path / "pf.wav")
        write_wav(path, data, 44100, float32=True)
        whole, _ = read_wav(path)
        got = []
        with wav_mod.PrefetchingWavReader(path, block_frames=4096) as pf:
            assert pf.channels == 2 and pf.sample_rate == 44100
            assert pf.num_frames == 44100
            for block in pf:
                assert block.shape[0] == 2
                got.append(block)
        np.testing.assert_array_equal(np.concatenate(got, axis=1), whole)
        assert got[-1].shape[1] == 44100 - 10 * 4096
        with jwav.PrefetchingWavReader(path, block_frames=4096) as pf:
            for a, b in zip(got, pf):
                np.testing.assert_array_equal(a, b)

    def test_overlapped_production(self, tmp_path):
        """The producer runs ahead: after a slow consumer step, several
        blocks are already buffered."""
        data = np.random.default_rng(1).normal(size=(1, 200_000)).astype(np.float32) * 0.1
        path = str(tmp_path / "pf2.wav")
        write_wav(path, data, 48000, float32=True)
        with wav_mod.PrefetchingWavReader(path, block_frames=8192, depth_blocks=8) as pf:
            assert pf.next_block() is not None
            deadline = time.monotonic() + 10
            while pf.buffered_samples <= 3 * 8192 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert pf.buffered_samples > 3 * 8192

    def test_open_failure(self, tmp_path):
        with pytest.raises(OSError):
            wav_mod.PrefetchingWavReader(str(tmp_path / "missing.wav"), 1024)
        p = str(tmp_path / "x.wav")
        write_wav(p, np.zeros((1, 10), np.float32), 8000)
        with pytest.raises(ValueError):
            wav_mod.PrefetchingWavReader(p, 0)


class TestRawStream:
    """Headerless raw/IQ stream IO. The `raw_mode` fixture runs the chunked,
    seek and closed-reader cases on both the native C++ path and the numpy
    fallback (the same edge semantics)."""

    @pytest.fixture(params=["native", "fallback"])
    def raw_mode(self, request, monkeypatch):
        if request.param == "fallback":
            monkeypatch.setattr(raw_mod, "_load", lambda: None)
        return request.param

    @pytest.mark.parametrize("dtype,atol", [
        ("f32", 0.0), ("i16", 1 / 32768), ("i8", 1 / 128), ("u8", 1 / 128), ("i32", 1e-7),
    ])
    def test_roundtrip_all_dtypes(self, dtype, atol, tmp_path, raw_mode):
        x = np.random.default_rng(0).uniform(-0.99, 0.99, size=(3, 777)).astype(np.float32)
        p = str(tmp_path / f"cap.{dtype}")
        raw_mod.write_raw(p, x, dtype=dtype)
        y = raw_mod.read_raw(p, dtype=dtype, channels=3)
        assert y.shape == x.shape and y.dtype == np.float32
        np.testing.assert_allclose(y, x, atol=atol + 1e-7)
        # the JAX package reads the same file to the same bits
        np.testing.assert_array_equal(y, jraw.read_raw(p, dtype=dtype, channels=3))

    @pytest.mark.parametrize("dtype", ["f32", "i16", "u8"])
    def test_each_package_reads_the_others_captures_bitwise(self, dtype, tmp_path, raw_mode):
        x = np.random.default_rng(4).uniform(-0.9, 0.9, size=(2, 513)).astype(np.float32)
        ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
        raw_mod.write_raw(str(ours), x, dtype=dtype)
        jraw.write_raw(str(theirs), x, dtype=dtype)
        assert ours.read_bytes() == theirs.read_bytes()
        np.testing.assert_array_equal(raw_mod.read_raw(str(theirs), dtype=dtype, channels=2),
                                      jraw.read_raw(str(ours), dtype=dtype, channels=2))

    def test_chunked_reads_and_seek(self, tmp_path, raw_mode):
        x = np.linspace(-0.9, 0.9, 2000, dtype=np.float32)[None]
        p = str(tmp_path / "cap.i16")
        raw_mod.write_raw(p, x, dtype="i16")
        with raw_mod.RawStreamReader(p, dtype="i16", channels=1) as r:
            assert (r.channels, r.num_frames) == (1, 2000)
            b1 = r.read(500)
            r.seek(1500)
            b2 = r.read(1000)   # truncated at EOF
            r.seek(r.num_frames)          # seek TO EOF is legal...
            assert r.read(10).shape == (1, 0)
            with pytest.raises(ValueError, match="seek"):
                r.seek(r.num_frames + 1)  # ...one past is not, both paths
            with pytest.raises(ValueError, match="seek"):
                r.seek(-1)
        assert b1.shape == (1, 500) and b2.shape == (1, 500)
        np.testing.assert_allclose(b2, x[:, 1500:], atol=1e-4)

    def test_closed_reader_raises(self, tmp_path, raw_mode):
        p = str(tmp_path / "cap.f32")
        raw_mod.write_raw(p, np.zeros((1, 16), np.float32), dtype="f32")
        r = raw_mod.RawStreamReader(p, dtype="f32", channels=1)
        r.close()
        with pytest.raises(ValueError, match="closed"):
            r.read(4)
        with pytest.raises(ValueError, match="closed"):
            r.seek(0)
        r.close()   # idempotent

    def test_iq_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        z = (rng.normal(size=100) + 1j * rng.normal(size=100)).astype(np.complex64) * 0.3
        p = str(tmp_path / "cap.iq")
        raw_mod.write_iq(p, z, dtype="i16")
        z2 = raw_mod.read_iq(p, dtype="i16")
        assert z2.dtype == np.complex64
        np.testing.assert_allclose(z2, z, atol=1e-4)
        np.testing.assert_array_equal(z2, jraw.read_iq(p, dtype="i16"))

    def test_prefetching_reader_blocks(self, tmp_path, raw_mode):
        x = np.random.default_rng(2).uniform(-0.9, 0.9, size=(2, 10000)).astype(np.float32)
        p = str(tmp_path / "cap.u8")
        raw_mod.write_raw(p, x, dtype="u8")
        with raw_mod.PrefetchingRawReader(p, dtype="u8", channels=2, block_frames=3000) as pf:
            blocks = list(pf)
        assert [b.shape for b in blocks] == [(2, 3000)] * 3 + [(2, 1000)]
        got = np.concatenate(blocks, axis=1)
        np.testing.assert_allclose(got, x, atol=1 / 128 + 1e-7)
        np.testing.assert_array_equal(got, jraw.read_raw(p, dtype="u8", channels=2))

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError, match="dtype"):
            raw_mod.read_raw(str(tmp_path / "x.bin"), dtype="bogus")
        with pytest.raises(ValueError, match="channels"):
            raw_mod.RawStreamReader(str(tmp_path / "x.bin"), channels=0)
        with pytest.raises(OSError):
            raw_mod.RawStreamReader(str(tmp_path / "missing.bin"))
        with pytest.raises(ValueError, match="block_frames"):
            raw_mod.PrefetchingRawReader(str(tmp_path / "x.bin"), block_frames=0)


def test_no_warning_on_the_native_path(tone, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        write_wav(tmp_path / "w.wav", tone, 8000)
        read_wav(tmp_path / "w.wav")
