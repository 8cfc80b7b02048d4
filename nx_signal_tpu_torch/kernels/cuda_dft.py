"""Hand-written CUDA kernels for Hopper and their wrappers (counterpart of
nx_signal_tpu/kernels/pallas_dft.py).

== ================================== ================================ ==================================
   wrapper                            kernel (kernels/csrc/)           replaces (pallas_dft.py)
== ================================== ================================ ==================================
A  fir_framed_dft_power_cuda          framed_dft.cu, POWER, FIR fold   fir_framed_dft_power_pallas
B  framed_dft_cuda                    framed_dft.cu, no fold           framed_dft_pallas
C  overlap_add_cuda                   overlap_add.cu                   overlap_add_pallas
D  fir_framed_dft_power_shared_cuda   shared_dft.cu                    fir_framed_dft_power_shared_pallas
== ================================== ================================ ==================================

Each wrapper takes the tensor's device as its dispatch rule: on a CPU
tensor it returns its plain PyTorch version (`_framed_matmul_torch` and
`_shared_power_torch` in kernels/dft.py, `_ola_fold_torch` in
spectral/framing.py); on a CUDA tensor it launches its kernel, built at
first use (kernels/_build.py), or raises. Nothing falls back. Each wrapper
counts its launches in its `launches` attribute, a plain integer that
callers may reset.

Kernels A, B and D run exact f32 FMA for every `precision` of their
callers, at least as accurate as the JAX package's modes (whose 'high' is a
bf16x3 split on the TPU). Kernel C is bitwise equal to the plain fold.
"""

import torch

from nx_signal_tpu_torch.kernels._build import load_library
from nx_signal_tpu_torch.kernels.dft import _framed_matmul_torch, _shared_power_torch
from nx_signal_tpu_torch.spectral.framing import _ola_fold_torch, _ola_seed
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["fir_framed_dft_power_cuda", "framed_dft_cuda", "overlap_add_cuda",
           "fir_framed_dft_power_shared_cuda"]

# Kernel D's limits: window coefficients (so at most 7 neighbour bins each
# side of a 96-column tile) and hop blocks per frame (a CTA holds 64 blocks)
_SHARED_MAX_COEFFS = 8
_SHARED_MAX_BLOCKS = 64


def _on_card(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.nx_error_string(err).decode()} ({err})")


def _launch_framed(x, weights, *, stride, pad_left, num_frames, bins, power):
    """Launch framed_dft.cu on the (..., L) CUDA tensor x with the
    (krows, 2*bins) weights; returns (..., num_frames, bins or 2*bins)."""
    if weights.device != x.device:
        raise ValueError(f"weights on {weights.device}, signal on {x.device}")
    if weights.ndim != 2 or weights.shape[1] != 2 * bins:
        raise ValueError(f"weights must be (rows, {2 * bins}), got {tuple(weights.shape)}")
    if stride < 1 or num_frames < 1 or x.numel() == 0:
        raise ValueError(f"bad geometry: stride={stride}, num_frames={num_frames}, "
                         f"shape={tuple(x.shape)}")
    batch, length = x.shape[:-1], x.shape[-1]
    xf = x.to(DEFAULT_FLOAT).reshape(-1, length).contiguous()
    w = weights.to(DEFAULT_FLOAT).contiguous()
    cols = bins if power else 2 * bins
    out = torch.empty((xf.shape[0], num_frames, cols), dtype=DEFAULT_FLOAT, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        err = lib.nx_framed_dft_f32(
            xf.data_ptr(), w.data_ptr(), out.data_ptr(), xf.shape[0], length, stride,
            w.shape[0], pad_left, num_frames, bins, int(power),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "framed_dft kernel")
    return out.reshape(*batch, num_frames, cols)


def fir_framed_dft_power_cuda(x, weights, *, stride: int, pad_left: int,
                              num_frames: int, bins: int):
    """Kernel A: the one-sided power spectrum of the FIR-filtered, framed,
    windowed signal, |frames_ext(x) @ W|^2 with W the folded (frame + K - 1,
    2*bins) weights of `kernels.dft.fir_dft_fold_weights`. Extended frame m
    covers x[m*stride - pad_left : ...], zeros outside the signal; any hop
    >= 1. Returns (..., num_frames, bins) f32.

    Runs exact f32 FMA whatever precision the caller asked for. On a CPU
    tensor it returns the plain version (conv1d + re^2 + im^2)."""
    x = torch.as_tensor(x)
    if not _on_card(x):
        return _framed_matmul_torch(x, weights, stride=stride, pad_left=pad_left,
                                    num_frames=num_frames, bins=bins, power=True)
    out = _launch_framed(x, weights, stride=stride, pad_left=pad_left,
                         num_frames=num_frames, bins=bins, power=True)
    fir_framed_dft_power_cuda.launches += 1
    return out


fir_framed_dft_power_cuda.launches = 0


def framed_dft_cuda(x, weights, *, stride: int, num_frames: int, bins: int,
                    output: str = "complex"):
    """Kernel B: the windowed framed DFT frames(x) @ W of the (..., L) real
    signal, W the (frame, 2*bins) [Re | Im] weights of
    `kernels.dft._dft_weights`. The kernel writes the stacked f32
    [Re | Im]; this returns it as complex64 (..., num_frames, bins), or
    with `output='power'` the kernel's re^2 + im^2. Exact f32 FMA. On a CPU
    tensor it returns the plain version."""
    if output not in ("complex", "power"):
        raise ValueError(f"output must be 'complex' or 'power', got {output!r}")
    x = torch.as_tensor(x)
    power = output == "power"
    if not _on_card(x):
        acc = _framed_matmul_torch(x, weights, stride=stride, pad_left=0,
                                   num_frames=num_frames, bins=bins, power=power)
    else:
        acc = _launch_framed(x, weights, stride=stride, pad_left=0,
                             num_frames=num_frames, bins=bins, power=power)
        framed_dft_cuda.launches += 1
    if power:
        return acc
    return torch.complex(acc[..., :bins], acc[..., bins:])


framed_dft_cuda.launches = 0


def overlap_add_cuda(frames, *, stride: int, out_length: int, init=None):
    """Kernel C: overlap-add of (..., M, N) float32 frames at hop `stride`
    into (..., out_length), every output sample summing its frames in
    increasing frame order — bitwise equal to the plain fold. Any hop >= 1.
    `init` (..., any length), cut to out_length and zero-padded, seeds each
    sample's sum (`spectral.framing._ola_fold`). On a CPU tensor it returns
    the plain fold."""
    frames = torch.as_tensor(frames)
    if frames.dtype != DEFAULT_FLOAT or frames.ndim < 2:
        raise ValueError(f"expected float32 frames of rank >= 2, got {frames.dtype} "
                         f"rank {frames.ndim}")
    if not _on_card(frames):
        return _ola_fold_torch(frames, stride, out_length, init=init)
    *batch, num_frames, frame_length = frames.shape
    if stride < 1 or out_length < 1 or frames.numel() == 0:
        raise ValueError(f"bad geometry: stride={stride}, out_length={out_length}, "
                         f"frames={num_frames}")
    f = frames.reshape(-1, num_frames, frame_length).contiguous()
    seed = None
    if init is not None:
        seed = _ola_seed(init, batch, out_length, DEFAULT_FLOAT)
        if seed.device != frames.device:
            raise ValueError(f"init on {seed.device}, frames on {frames.device}")
        seed = seed.reshape(-1, out_length).contiguous()
    out = torch.empty((f.shape[0], out_length), dtype=DEFAULT_FLOAT, device=frames.device)
    lib = load_library()
    with torch.cuda.device(frames.device):
        err = lib.nx_overlap_add_f32(
            f.data_ptr(), None if seed is None else seed.data_ptr(), out.data_ptr(),
            f.shape[0], num_frames, frame_length, stride, out_length,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "overlap_add kernel")
    overlap_add_cuda.launches += 1
    return out.reshape(*batch, out_length)


overlap_add_cuda.launches = 0


def fir_framed_dft_power_shared_cuda(x, weights, twiddles, window_coeffs, *, stride: int,
                                     pad_left: int, num_frames: int, bins: int):
    """Kernel D: the one-sided power spectrum of the FIR-filtered, framed,
    windowed signal through shared hop-block partial DFTs. `weights` are
    the (stride + K - 1, 2*bins) folded partial-DFT rows of
    `kernels.dft.shared_fold_weights`, `twiddles` the (2, J, bins) table of
    `kernels.dft.shared_twiddles`, `window_coeffs` the cosine-sum
    coefficients (b_0, b_1, ...) of the window. Hop block b covers
    x[b*stride - pad_left : ...], zeros outside the signal; frame m
    combines blocks m .. m + J - 1. Returns (..., num_frames, bins) f32.

    Runs exact f32 whatever precision the caller asked for. On a CPU
    tensor it returns the plain version (a conv1d with f64 sums, then the
    combine and the spectral window as torch ops). On a CUDA tensor it
    needs at most 8 coefficients, fewer than bins - 1, and J <= 64."""
    x = torch.as_tensor(x)
    coeffs = tuple(float(b) for b in window_coeffs)
    if not _on_card(x):
        return _shared_power_torch(x, weights, twiddles, coeffs, stride=stride,
                                   pad_left=pad_left, num_frames=num_frames, bins=bins)
    j_taps = twiddles.shape[1]
    if not 1 <= len(coeffs) <= min(_SHARED_MAX_COEFFS, bins - 1):
        raise ValueError(f"kernel D takes 1..{min(_SHARED_MAX_COEFFS, bins - 1)} window "
                         f"coefficients, got {len(coeffs)}")
    if j_taps > _SHARED_MAX_BLOCKS:
        raise ValueError(f"kernel D takes at most {_SHARED_MAX_BLOCKS} hop blocks per frame "
                         f"(n_fft / stride), got {j_taps}")
    for name, t in (("weights", weights), ("twiddles", twiddles)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, signal on {x.device}")
    if weights.ndim != 2 or weights.shape[1] != 2 * bins:
        raise ValueError(f"weights must be (rows, {2 * bins}), got {tuple(weights.shape)}")
    if twiddles.shape != (2, j_taps, bins):
        raise ValueError(f"twiddles must be (2, J, {bins}), got {tuple(twiddles.shape)}")
    if stride < 1 or num_frames < 1 or x.numel() == 0:
        raise ValueError(f"bad geometry: stride={stride}, num_frames={num_frames}, "
                         f"shape={tuple(x.shape)}")
    batch, length = x.shape[:-1], x.shape[-1]
    xf = x.to(DEFAULT_FLOAT).reshape(-1, length).contiguous()
    w = weights.to(DEFAULT_FLOAT).contiguous()
    tw = twiddles.to(DEFAULT_FLOAT).contiguous()
    # the kernel's epilogue multiplies by b_0, then b_c / 2 (rounded to f32
    # as the plain version's python-float scalars are)
    wc = torch.tensor([coeffs[0]] + [b / 2.0 for b in coeffs[1:]], dtype=DEFAULT_FLOAT,
                      device=x.device)
    out = torch.empty((xf.shape[0], num_frames, bins), dtype=DEFAULT_FLOAT, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.nx_shared_dft_power_f32(
            xf.data_ptr(), w.data_ptr(), tw.data_ptr(), wc.data_ptr(), out.data_ptr(),
            xf.shape[0], length, stride, w.shape[0], pad_left, num_frames, bins, j_taps,
            len(coeffs), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "shared_dft kernel")
    fir_framed_dft_power_shared_cuda.launches += 1
    return out.reshape(*batch, num_frames, bins)


fir_framed_dft_power_shared_cuda.launches = 0
