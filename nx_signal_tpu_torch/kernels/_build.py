"""Build and load the hand-written CUDA kernels of `kernels/csrc/`.

At first use in a process, the sources are compiled with nvcc for Hopper
(sm_90a), one nvcc process per source, all started together, and linked
into one shared library with a plain C interface, which ctypes loads. The
library lands in `kernels/_build/`, named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is loaded as it
is, with ptxas's report of every kernel (registers, spills) beside it
(`ptxas_log_path`). No PyTorch header is compiled, which keeps a build to
seconds.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).with_name("csrc")
_BUILD_DIR = Path(__file__).with_name("_build")
_SOURCES = ("framed_dft.cu", "framed_fft.cu", "framed_dft_tc.cu", "overlap_add.cu",
            "shared_dft.cu", "halo.cu", "log_mel.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry points: name -> argument types; each returns its cudaError_t
_SIGNATURES = {
    # x, laid-out weights, out, channels, length, stride, krows_pad,
    # pad_left, num_frames, bins, packed, power, stream (all on the current
    # device)
    "nx_framed_dft_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, out, channels, length, stride, frame_length, n_fft,
    # num_frames, bins, plan (0: power of two), points (the plan's FFT
    # length, 0 for a power of two), power, stream (all on the current
    # device)
    "nx_framed_fft_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # z, win, tw, out, frames, zbins, frame_length, n_fft, stream (kernel
    # B-ifft, all on the current device)
    "nx_framed_ifft_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # stride, krows_pad, address of the int64 frames-per-CTA it sets
    "nx_framed_dft_tc_frames": (_I, _I, _P),
    # x, laid-out split weights, out, channels, length, stride, krows_pad,
    # pad_left, num_frames, bins, packed, passes, stream (all on the current
    # device)
    "nx_framed_dft_tc_power_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # frames, init (or null), out, channels, num_frames, frame_length,
    # stride, out_length, stream (all on the current device)
    "nx_overlap_add_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, laid-out weights, laid-out twiddles, wc, out, channels, length,
    # stride, krows_pad, pad_left, num_frames, bins, j_taps, ncoef, stream
    # (all on the current device)
    "nx_shared_dft_power_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # stride, krows_pad, j_taps, address of the int64 CTAs per SM it sets
    "nx_shared_dft_ctas_per_sm": (_I, _I, _I, _P),
    # z, band table, packed weights, out, 2 x clips scratch, clips, mels,
    # frames, zframes, bins, stream (kernel M, all on the current device)
    "nx_log_mel_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # halo.cu (kernel E, its peer buffers and its signals), on the current
    # device: address of the int64 flush flag it sets
    "nx_stream_ops_init": (_P,),
    # stream, address of a 64-bit counter of this process, value, flush
    "nx_stream_wait_geq": (_P, _P, _I, _I),
    # stream, address of a 64-bit counter (a neighbour's mapped one), value
    "nx_stream_write": (_P, _P, _I),
    # bytes, address of the pointer it sets (the buffer zeroed)
    "nx_halo_alloc": (_I, _P),
    # pointer from nx_halo_alloc
    "nx_halo_free": (_P,),
    # device pointer, address of the int64 device ordinal it sets
    "nx_pointer_device": (_P, _P),
    # pointer from nx_halo_alloc, address of a 64-byte handle it writes
    "nx_ipc_get_handle": (_P, _P),
    # address of a 64-byte handle of another process, address of the
    # pointer it sets
    "nx_ipc_open_handle": (_P, _P),
    # pointer from nx_ipc_open_handle
    "nx_ipc_close_handle": (_P,),
    # x, the right neighbour's left slot (or null), the left neighbour's
    # right slot (or null), rows, and in 4-byte words: block, left halo,
    # right halo; stream
    "nx_halo_put": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, ext, rows, and in 4-byte words: block, left halo, right halo; zero
    # the left halo, zero the right halo; stream
    "nx_halo_interior": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # received left slot (or null), received right slot (or null), ext,
    # rows, and in 4-byte words: block, left halo, right halo; stream
    "nx_halo_edges": (_P, _P, _P, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit (nvcc) found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libnx_signal_kernels_{digest.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    """Where the build of the current sources leaves ptxas's report."""
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. The library is built in a temporary directory and renamed into
    place, so concurrent builds never load a half-written file."""
    path = library_path()
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{Path(name).stem}.o") for name in _SOURCES]
        compiles = [[nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / name)]
                    for name, obj in zip(_SOURCES, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        logs = [proc.communicate()[0] for proc in procs]  # wait for every compile
        link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objects]
        for cmd, proc, log in zip(compiles, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
            f.write("".join(logs))
        os.replace(os.path.join(tmp, "ptxas.txt"), ptxas_log_path())
        os.replace(os.path.join(tmp, "lib.so"), path)   # last: the library marks a whole build
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library once per process,
    with the argument and result types of every entry point declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.nx_error_string.argtypes = [ctypes.c_int]
    lib.nx_error_string.restype = ctypes.c_char_p
    return lib
