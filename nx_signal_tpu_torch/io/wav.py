"""Audio IO: ctypes bindings over the native C++ loader (io/native/wav_io.cpp),
the counterpart of nx_signal_tpu/io/wav.py. Host code: every reader and
writer takes and returns numpy arrays.

The native library decodes PCM -> planar float32 off the GIL at memory
bandwidth. It is compiled at first use with g++ into `io/_build/`, named by
a hash of the source, so a changed source rebuilds: each process compiles
to a name of its own and renames the finished library into place, so
processes that build at once (test workers) never load a half-written
file. A pure-Python fallback (stdlib `wave`) covers environments without a
compiler, with a warning.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "write_wav", "stream_wav", "WavReader", "RingBuffer", "PrefetchingWavReader"]

_SRC = Path(__file__).parent / "native" / "wav_io.cpp"
_BUILD_DIR = Path(__file__).parent / "_build"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_native_failed = False


def library_path() -> Path:
    """Where the native library of this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libnxsignal_io_{digest[:16]}.so"


def _build_native(path: Path):
    """Compile to a name of this process and thread, then rename it into
    place: `path` only ever names a finished library."""
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    """The native library (built at first use), or None where it cannot be
    built or loaded: the readers then take the Python fallback."""
    global _lib, _native_failed
    with _lock:
        if _lib is not None or _native_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build_native(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
            warnings.warn(f"native wav_io unavailable ({e}); using Python fallback")
            _native_failed = True
            return None
        lib.wav_open.restype = ctypes.c_void_p
        lib.wav_open.argtypes = [ctypes.c_char_p]
        lib.wav_channels.argtypes = [ctypes.c_void_p]
        lib.wav_sample_rate.argtypes = [ctypes.c_void_p]
        lib.wav_bits.argtypes = [ctypes.c_void_p]
        lib.wav_frames.restype = ctypes.c_int64
        lib.wav_frames.argtypes = [ctypes.c_void_p]
        lib.wav_read.restype = ctypes.c_int64
        lib.wav_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64]
        lib.wav_seek.restype = ctypes.c_int64
        lib.wav_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.wav_close.argtypes = [ctypes.c_void_p]
        lib.wav_write.restype = ctypes.c_int32
        lib.wav_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_uint64]
        for name in ("ring_capacity", "ring_size"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        for name in ("ring_push", "ring_pop"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                           ctypes.c_uint64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.raw_open.restype = ctypes.c_void_p
        lib.raw_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.raw_channels.argtypes = [ctypes.c_void_p]
        lib.raw_frames.restype = ctypes.c_int64
        lib.raw_frames.argtypes = [ctypes.c_void_p]
        lib.raw_read.restype = ctypes.c_int64
        lib.raw_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64]
        lib.raw_seek.restype = ctypes.c_int64
        lib.raw_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.raw_close.argtypes = [ctypes.c_void_p]
        lib.prefetch_start.restype = ctypes.c_void_p
        lib.prefetch_start.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.prefetch_start_raw.restype = ctypes.c_void_p
        lib.prefetch_start_raw.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64]
        lib.prefetch_channels.argtypes = [ctypes.c_void_p]
        lib.prefetch_sample_rate.argtypes = [ctypes.c_void_p]
        lib.prefetch_total_frames.restype = ctypes.c_int64
        lib.prefetch_total_frames.argtypes = [ctypes.c_void_p]
        lib.prefetch_next.restype = ctypes.c_int64
        lib.prefetch_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float)]
        lib.prefetch_buffered.restype = ctypes.c_uint64
        lib.prefetch_buffered.argtypes = [ctypes.c_void_p]
        lib.prefetch_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class WavReader:
    """Chunked WAV reader: planar float32 (channels, frames) blocks.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.wav import read_wav, write_wav
    >>> p = os.path.join(tempfile.mkdtemp(), 't.wav')
    >>> x = np.sin(0.05 * np.arange(400, dtype=np.float32))[None].repeat(2, 0)
    >>> write_wav(p, x, 8000, float32=True)
    >>> from nx_signal_tpu_torch.io.wav import WavReader
    >>> with WavReader(p) as r:
    ...     meta = (r.channels, r.num_frames, r.sample_rate)
    ...     block = r.read(100)
    >>> meta, block.shape
    ((2, 400, 8000), (2, 100))
    """

    def __init__(self, path):
        self._lib = _load()
        self._path = os.fspath(path)
        if self._lib is not None:
            self._h = self._lib.wav_open(self._path.encode())
            if not self._h:
                raise OSError(f"cannot open WAV file: {path}")
            self.channels = self._lib.wav_channels(self._h)
            self.sample_rate = self._lib.wav_sample_rate(self._h)
            self.num_frames = self._lib.wav_frames(self._h)
            self.bits = self._lib.wav_bits(self._h)
        else:  # pure-Python fallback
            import wave

            self._wave = wave.open(self._path, "rb")
            self.channels = self._wave.getnchannels()
            self.sample_rate = self._wave.getframerate()
            self.num_frames = self._wave.getnframes()
            self.bits = self._wave.getsampwidth() * 8
            self._h = None

    def read(self, frames: int) -> np.ndarray:
        """Read up to `frames` frames; (channels, n) float32, n==0 at EOF."""
        if self._h is not None:
            out = np.empty((self.channels, frames), dtype=np.float32)
            got = self._lib.wav_read(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames
            )
            if got < 0:
                raise OSError("wav read failed")
            return out[:, :got]
        raw = self._wave.readframes(frames)
        width = self.bits // 8
        if width == 2:
            data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        return data.reshape(-1, self.channels).T.copy()

    def seek(self, frame: int):
        if self._h is not None:
            if self._lib.wav_seek(self._h, frame) < 0:
                raise ValueError(f"seek out of range: {frame}")
        else:
            self._wave.setpos(frame)

    def close(self):
        if self._h is not None:
            self._lib.wav_close(self._h)
            self._h = None
        elif getattr(self, "_wave", None) is not None:
            self._wave.close()
            self._wave = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path):
    """Read a whole WAV file -> ((channels, frames) float32, sample_rate).

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.wav import read_wav, write_wav
    >>> p = os.path.join(tempfile.mkdtemp(), 't.wav')
    >>> x = np.sin(0.05 * np.arange(400, dtype=np.float32))[None].repeat(2, 0)
    >>> write_wav(p, x, 8000, float32=True)
    >>> y, sr = read_wav(p)
    >>> y.shape, sr
    ((2, 400), 8000)
    """
    with WavReader(path) as r:
        data = r.read(r.num_frames)
        return data, r.sample_rate


def write_wav(path, data, sample_rate: int, *, float32: bool = False):
    """Write planar (channels, frames) float32 data as PCM16 (default) or
    IEEE float32 WAV.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.wav import read_wav, write_wav
    >>> p = os.path.join(tempfile.mkdtemp(), 't.wav')
    >>> x = np.sin(0.05 * np.arange(400, dtype=np.float32))[None].repeat(2, 0)
    >>> write_wav(p, x, 8000, float32=True)
    >>> y, sr = read_wav(p)
    >>> y.shape, sr, float(np.abs(y - x).max())   # float32 round-trip is exact
    ((2, 400), 8000, 0.0)
    """
    data = np.ascontiguousarray(np.atleast_2d(np.asarray(data, dtype=np.float32)))
    lib = _load()
    if lib is not None:
        rc = lib.wav_write(
            os.fspath(path).encode(),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.shape[0], data.shape[1], int(sample_rate), int(float32),
        )
        if rc == -2:
            raise ValueError(
                "WAV data exceeds the RIFF 4 GiB limit; split the stream"
            )
        if rc != 0:
            raise OSError(f"cannot write WAV file: {path}")
        return
    if float32:
        raise RuntimeError(
            "float32 WAV output requires the native wav_io library (the "
            "stdlib fallback only writes PCM16)"
        )
    import wave  # fallback: PCM16 only

    with wave.open(os.fspath(path), "wb") as w:
        w.setnchannels(data.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2")
        w.writeframes(pcm.T.tobytes())


def stream_wav(path, chunk_frames: int):
    """Generator of (channels, chunk_frames) float32 blocks (last may be
    short) — feeds the streaming processors (parallel/streaming.py).

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.wav import read_wav, write_wav
    >>> p = os.path.join(tempfile.mkdtemp(), 't.wav')
    >>> x = np.sin(0.05 * np.arange(400, dtype=np.float32))[None].repeat(2, 0)
    >>> write_wav(p, x, 8000, float32=True)
    >>> from nx_signal_tpu_torch.io.wav import stream_wav
    >>> [b.shape for b in stream_wav(p, 150)]
    [(2, 150), (2, 150), (2, 100)]
    """
    with WavReader(path) as r:
        while True:
            block = r.read(chunk_frames)
            if block.shape[1] == 0:
                return
            yield block


class RingBuffer:
    """Lock-free SPSC float32 ring buffer (native). Producer thread pushes
    decoded samples; the thread feeding the card pops fixed-size chunks.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.io.wav import RingBuffer
    >>> rb = RingBuffer(1024)
    >>> rb.push(np.arange(6, dtype=np.float32))   # returns frames queued
    6
    >>> rb.pop(4)
    array([0., 1., 2., 3.], dtype=float32)
    """

    def __init__(self, min_capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ring buffer requires the compiled library")
        self._lib = lib
        self._h = lib.ring_create(min_capacity)
        if not self._h:
            raise MemoryError("ring_create failed")

    @property
    def capacity(self):
        return self._lib.ring_capacity(self._h)

    def __len__(self):
        return self._lib.ring_size(self._h)

    def push(self, data) -> int:
        data = np.ascontiguousarray(data, dtype=np.float32).ravel()
        return self._lib.ring_push(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size
        )

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        got = self._lib.ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
        )
        return out[:got]

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchingWavReader:
    """Double-buffered WAV block stream: a NATIVE background thread decodes
    `depth_blocks` blocks ahead into the lock-free ring while the caller
    (e.g. the loop feeding the card) consumes — disk + PCM decode overlap with
    compute, entirely off the GIL (the blocking prefetch_next call is a
    plain C call, so other Python threads keep running).

    Iterate to get (channels, frames)
    float32 blocks (the last one may be short).
    
    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.wav import read_wav, write_wav
    >>> p = os.path.join(tempfile.mkdtemp(), 't.wav')
    >>> x = np.sin(0.05 * np.arange(400, dtype=np.float32))[None].repeat(2, 0)
    >>> write_wav(p, x, 8000, float32=True)
    >>> from nx_signal_tpu_torch.io.wav import PrefetchingWavReader
    >>> with PrefetchingWavReader(p, block_frames=128) as pf:
    ...     total = sum(b.shape[1] for b in pf)   # background-thread decode
    >>> total
    400
    """

    def __init__(self, path, block_frames: int, *, depth_blocks: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "PrefetchingWavReader requires the native wav_io library")
        if block_frames < 1 or depth_blocks < 1:
            raise ValueError("block_frames and depth_blocks must be >= 1")
        self._lib = lib
        self._h = lib.prefetch_start(
            os.fspath(path).encode(), block_frames, depth_blocks)
        if not self._h:
            raise OSError(f"cannot open WAV file: {path}")
        self.block_frames = int(block_frames)
        self.channels = lib.prefetch_channels(self._h)
        self.sample_rate = lib.prefetch_sample_rate(self._h)
        self.num_frames = lib.prefetch_total_frames(self._h)

    @property
    def buffered_samples(self) -> int:
        """Samples currently decoded ahead (incl. block headers)."""
        return self._lib.prefetch_buffered(self._h)

    def next_block(self):
        """Next (channels, frames) float32 block; None at end of stream.
        Blocks (off the GIL) until the producer has one ready."""
        out = np.empty((self.channels, self.block_frames), dtype=np.float32)
        got = self._lib.prefetch_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got < 0:
            raise OSError("wav decode failed in prefetch thread")
        if got == 0:
            return None
        if got == self.block_frames:
            return out
        # short final block: planar with row stride == got
        return out.ravel()[: got * self.channels].reshape(self.channels, got)

    def __iter__(self):
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def close(self):
        if self._h:
            self._lib.prefetch_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
