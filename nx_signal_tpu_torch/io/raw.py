"""Raw (headerless) sample-stream IO, the SDR ingest path (counterpart of
nx_signal_tpu/io/raw.py). Host code: every reader and writer takes and
returns numpy arrays.

A wideband capture is a containerless file of interleaved fixed-dtype
samples (an IQ recording is the channels=2 case). Decoding rides the same
native C++ library as io/wav.py (planar f32 off the GIL, chunked +
seekable, background prefetch into the lock-free ring); a numpy
`fromfile` fallback covers compiler-less environments.

Sample dtypes: 'f32' (no scaling), 'i16' (/32768), 'i8' (/128),
'u8' (offset-128, /128), 'i32' (/2^31) - the common SDR capture
formats (RTL-SDR u8, bladeRF/USRP i16, simulation f32).
"""

import ctypes
import os

import numpy as np

from nx_signal_tpu_torch.io.wav import _load

__all__ = ["RawStreamReader", "PrefetchingRawReader", "read_raw",
           "write_raw", "read_iq", "write_iq"]

#: name -> (native dtype code, numpy dtype, full-scale divisor, u8 offset)
_DTYPES = {
    "f32": (0, np.float32, 1.0, 0.0),
    "i16": (1, np.int16, 32768.0, 0.0),
    "i8": (2, np.int8, 128.0, 0.0),
    "u8": (3, np.uint8, 128.0, 128.0),
    "i32": (4, np.int32, 2147483648.0, 0.0),
}


def _dtype_spec(dtype: str):
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(
            f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}"
        ) from None


class RawStreamReader:
    """Chunked reader of a headerless interleaved stream: planar float32
    (channels, frames) blocks, seekable — the raw-capture sibling of
    io.wav.WavReader.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import RawStreamReader, write_raw
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.iq')
    >>> x = np.linspace(-0.5, 0.5, 200, dtype=np.float32).reshape(2, 100)
    >>> write_raw(p, x, dtype='i16')
    >>> with RawStreamReader(p, dtype='i16', channels=2) as r:
    ...     meta = (r.channels, r.num_frames)
    ...     block = r.read(60)
    >>> meta, block.shape, float(np.abs(block - x[:, :60]).max()) < 1e-4
    ((2, 100), (2, 60), True)
    """

    def __init__(self, path, *, dtype: str = "f32", channels: int = 1):
        code, np_dtype, scale, offset = _dtype_spec(dtype)
        if channels < 1:
            raise ValueError(f"channels must be >= 1, got {channels}")
        self._closed = False
        self._lib = _load()
        self._path = os.fspath(path)
        self.dtype = dtype
        self.channels = channels
        self._np_spec = (np_dtype, scale, offset)
        if self._lib is not None:
            self._h = self._lib.raw_open(self._path.encode(), code, channels)
            if not self._h:
                raise OSError(f"cannot open raw stream: {path}")
            self.num_frames = self._lib.raw_frames(self._h)
        else:  # pure-numpy fallback
            self._h = None
            elem = np.dtype(np_dtype).itemsize
            self.num_frames = os.path.getsize(self._path) // (elem * channels)
            self._file = open(self._path, "rb")

    def read(self, frames: int) -> np.ndarray:
        """Read up to `frames` frames; (channels, n) float32, n==0 at EOF."""
        if self._closed:
            raise ValueError("I/O operation on closed reader")
        if self._h is not None:
            out = np.empty((self.channels, frames), dtype=np.float32)
            got = self._lib.raw_read(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames)
            if got < 0:
                raise OSError("raw read failed")
            return out[:, :got]
        np_dtype, scale, offset = self._np_spec
        raw = np.fromfile(self._file, dtype=np_dtype,
                          count=frames * self.channels)
        n = raw.size // self.channels
        planar = raw[: n * self.channels].reshape(n, self.channels).T
        return ((planar.astype(np.float32) - offset) / scale).copy()

    def seek(self, frame: int):
        if self._closed:
            raise ValueError("I/O operation on closed reader")
        if self._h is not None:
            if self._lib.raw_seek(self._h, frame) < 0:
                raise ValueError(f"seek out of range: {frame}")
        else:
            if frame < 0 or frame > self.num_frames:  # match native contract
                raise ValueError(f"seek out of range: {frame}")
            np_dtype, _, _ = self._np_spec
            elem = np.dtype(np_dtype).itemsize
            self._file.seek(frame * elem * self.channels)

    def close(self):
        self._closed = True
        if self._h is not None:
            self._lib.raw_close(self._h)
            self._h = None
        elif getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_raw(path, *, dtype: str = "f32", channels: int = 1):
    """Read a whole headerless stream -> (channels, frames) float32.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import read_raw, write_raw
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.bin')
    >>> x = np.asarray([[0.0, 0.25, -0.5]], np.float32)
    >>> write_raw(p, x, dtype='f32')
    >>> read_raw(p, dtype='f32', channels=1)
    array([[ 0.  ,  0.25, -0.5 ]], dtype=float32)
    """
    with RawStreamReader(path, dtype=dtype, channels=channels) as r:
        return r.read(r.num_frames)


def write_raw(path, data, *, dtype: str = "f32"):
    """Write planar (channels, frames) float32 data as an interleaved
    headerless stream of `dtype` samples (the inverse of `read_raw`;
    host-side numpy — writing is not a hot path).

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import read_raw, write_raw
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.u8')
    >>> write_raw(p, np.asarray([[-1.0, 0.0, 0.9921875]], np.float32),
    ...           dtype='u8')
    >>> read_raw(p, dtype='u8', channels=1)
    array([[-1.       ,  0.       ,  0.9921875]], dtype=float32)
    """
    _, np_dtype, scale, offset = _dtype_spec(dtype)
    data = np.atleast_2d(np.asarray(data, dtype=np.float32))
    interleaved = data.T.reshape(-1)
    if dtype == "f32":
        encoded = interleaved
    else:
        info = np.iinfo(np_dtype)
        encoded = np.clip(np.rint(interleaved * scale + offset),
                          info.min, info.max).astype(np_dtype)
    encoded.tofile(os.fspath(path))


def read_iq(path, *, dtype: str = "i16"):
    """Read an interleaved I/Q capture -> 1-D complex64 baseband.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import read_iq, write_iq
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.iq')
    >>> z = np.asarray([0.5 + 0.25j, -0.25 - 0.5j], np.complex64)
    >>> write_iq(p, z, dtype='i16')
    >>> out = read_iq(p, dtype='i16')
    >>> out.dtype, bool(np.abs(out - z).max() < 1e-4)
    (dtype('complex64'), True)
    """
    planar = read_raw(path, dtype=dtype, channels=2)
    return (planar[0] + 1j * planar[1]).astype(np.complex64)


def write_iq(path, z, *, dtype: str = "i16"):
    """Write a 1-D complex baseband as an interleaved I/Q capture.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import read_raw, write_iq
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.iq')
    >>> write_iq(p, np.asarray([0.5 + 0.25j], np.complex64), dtype='f32')
    >>> read_raw(p, dtype='f32', channels=2)   # interleaved I, Q
    array([[0.5 ],
           [0.25]], dtype=float32)
    """
    z = np.asarray(z)
    write_raw(path, np.stack([z.real, z.imag]).astype(np.float32),
              dtype=dtype)


class PrefetchingRawReader:
    """Double-buffered raw-stream block iterator: a NATIVE background
    thread decodes `depth_blocks` ahead into the lock-free ring — the
    SDR data-loader sibling of io.wav.PrefetchingWavReader. Iterate to
    get (channels, frames) float32 blocks.

    Examples:

    >>> import numpy as np
    >>> import tempfile, os
    >>> from nx_signal_tpu_torch.io.raw import PrefetchingRawReader, write_raw
    >>> p = os.path.join(tempfile.mkdtemp(), 'cap.i16')
    >>> x = np.linspace(-0.5, 0.5, 1000, dtype=np.float32)[None]
    >>> write_raw(p, x, dtype='i16')
    >>> with PrefetchingRawReader(p, dtype='i16', channels=1,
    ...                           block_frames=256) as pf:
    ...     total = sum(b.shape[1] for b in pf)
    >>> total
    1000
    """

    def __init__(self, path, *, dtype: str = "f32", channels: int = 1,
                 block_frames: int = 65536, depth_blocks: int = 4):
        code, _, _, _ = _dtype_spec(dtype)
        if channels < 1:
            raise ValueError(f"channels must be >= 1, got {channels}")
        if block_frames < 1 or depth_blocks < 1:
            raise ValueError(
                "block_frames and depth_blocks must be >= 1, got "
                f"{block_frames}, {depth_blocks}")
        lib = _load()
        self._fallback = None
        if lib is None:  # chunked fallback (no background thread)
            self._fallback = RawStreamReader(path, dtype=dtype,
                                             channels=channels)
            self._lib = None
            self._h = None
        else:
            self._lib = lib
            self._h = lib.prefetch_start_raw(
                os.fspath(path).encode(), code, channels, block_frames,
                depth_blocks)
            if not self._h:
                raise OSError(f"cannot open raw stream: {path}")
        self.channels = channels
        self.block_frames = block_frames

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._fallback is not None:
            block = self._fallback.read(self.block_frames)
            if block.shape[1] == 0:
                raise StopIteration
            return block
        out = np.empty((self.channels, self.block_frames), dtype=np.float32)
        got = self._lib.prefetch_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got < 0:
            raise OSError("raw prefetch failed")
        if got == 0:
            raise StopIteration
        # short final blocks arrive compacted to row stride = got
        return out.ravel()[: got * self.channels].reshape(self.channels, got)

    def close(self):
        if self._h is not None:
            self._lib.prefetch_stop(self._h)
            self._h = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
