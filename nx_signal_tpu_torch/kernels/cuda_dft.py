"""Hand-written CUDA kernels for Hopper and their wrappers (counterpart of
nx_signal_tpu/kernels/pallas_dft.py).

====== ================================ ==========================================
       wrapper                          kernel (kernels/csrc/)
====== ================================ ==========================================
A      fir_framed_dft_power_cuda        framed_dft.cu, POWER, FIR fold (exact f32)
A-tc   fir_framed_dft_power_tc_cuda     framed_dft_tc.cu (wgmma, 3xTF32 or one TF32 pass)
B-fft  framed_fft_cuda                  framed_fft.cu (a real FFT per frame)
B-ifft framed_ifft_cuda                 framed_fft.cu (an inverse real FFT per frame)
B      framed_dft_cuda                  framed_dft.cu, no fold (exact f32)
C      overlap_add_cuda                 overlap_add.cu
D      fir_framed_dft_power_shared_cuda shared_dft.cu
====== ================================ ==========================================

They replace the TPU kernels of nx_signal_tpu/kernels/pallas_dft.py: A and
A-tc fir_framed_dft_power_pallas, B-fft and B framed_dft_pallas, C
overlap_add_pallas, D fir_framed_dft_power_shared_pallas. B-ifft replaces
no TPU kernel: it runs the one-sided `kernels.dft.framed_idft`, an XLA
product in the JAX package, as an inverse FFT per frame.

Each wrapper takes the tensor's device as its dispatch rule: on a CPU
tensor it returns its plain PyTorch version (`_framed_matmul_torch`,
`_framed_matmul_tf32_torch` and `_shared_power_torch` in kernels/dft.py,
`_ola_fold_torch` here); on a CUDA tensor it launches its
kernel, built at first use (kernels/_build.py), or raises. Nothing falls
back. Each wrapper counts its launches in its `launches` attribute, a plain
integer that callers may reset.

Precision of the power chain (`fir_framed_dft_power_cuda`'s `precision`,
the JAX package's modes): 'highest' is kernel A, exact f32 FMA; 'high' and
'default' are kernel A-tc on the tensor cores, 3xTF32 (about f32 accuracy)
and one TF32 pass (about three digits), wherever A-tc's staged window fits
in shared memory, and kernel A elsewhere (more accurate than asked). The
framed DFT (kernel B) splits by n_fft: B-fft for every n_fft from 8 to 65536
and any frame length, the dense B for an n_fft below 8 or above 65536
(`fft_kernel_takes`). Kernels A and B take any hop: where the staged window
of x does not fit in shared memory, the contraction streams x through its
weight ring, in the same order of sums.
Kernels B, B-fft, B-ifft and D run f32 whatever the caller's precision; C
is bitwise equal to the plain fold.
"""

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels._build import load_library
from nx_signal_tpu_torch.kernels.dft import (
    _bluestein_plan, _dft_weights, _fft_plan, _fft_twiddles, _framed_idft_torch,
    _framed_matmul_tf32_torch, _framed_matmul_torch, _host_f64, _radices, _shared_power_torch,
    _tf32_passes, _tf32_split, good_matmul_fft_length)
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span
from nx_signal_tpu_torch.utils.shapes import _frame_block_widths

__all__ = ["fir_framed_dft_power_cuda", "fir_framed_dft_power_tc_cuda", "framed_fft_cuda",
           "framed_ifft_cuda", "framed_dft_cuda", "overlap_add_cuda",
           "fir_framed_dft_power_shared_cuda", "fft_kernel_takes", "ifft_kernel_takes"]

# Kernel D's limits: window coefficients (so at most 7 neighbour bins each
# side of a 96-column tile) and hop blocks per frame (a CTA holds 64 blocks);
# its weight layout: bin columns per tile, and the rows of its chunk sums,
# the row multiple of its weights (shared_dft.cu)
_SHARED_MAX_COEFFS = 8
_SHARED_MAX_BLOCKS = 64
_D_SLOTS = 96
_D_SUM_ROWS = 32
# Kernel B-fft's n_fft range, most passes and points of a plan, and kernels
# A's and A-tc's weight layouts: bins per tile and the row multiple of their
# weight chunks (framed_fft.cu, framed_dft.cu, framed_dft_tc.cu)
_FFT_MIN, _FFT_MAX = 8, 65536
_FFT_MAX_PASSES = 8
_FFT_MAX_POINTS = 131072   # Bluestein's M at the longest L, 65535 (odd n_fft)
# Up to this n_fft a power of two runs B-fft's first radix-8 kernel
# (framed_fft_kernel, one CTA per tile of frames); past it the persistent
# loop kernel (framed_fft_loop_kernel), which scripts/torch_kernel_variants.py
# section 2 times against it
_SMALL_FFT_MAX = 1024
# The card's cuts for the framed DFT under method='auto', by length class
# (`_card_takes_kernel`), each the kernels that class runs: up to
# _CARD_FFT_CUT a power-of-two n_fft (radix 8), up to _CARD_SMOOTH_CUT any
# other 13-smooth n_fft (the mixed-radix kernel) and up to
# _CARD_BLUESTEIN_CUT any other (Bluestein's transform) on a CUDA float32
# signal takes framed_dft (kernel B-fft), past them torch.fft. Each is the
# largest timed n_fft of its class up to which B-fft was no slower than
# torch.stft at every timed length of the class, from chip_smoke.py phase 7
# on an NVIDIA H100 80GB HBM3 at 700 W (64 x 480000, hann frame n_fft, hop
# n_fft / 4, PERF.md section 6; B-fft / torch.stft): every power of two
# from 1024 to 16384 0.60-0.88, but 32768 2.19 and 65536 2.24 (clusters of
# 2 and 4 CTAs); 3375 0.55, 6561 0.59 (radix 9; 1.14 on radix 3) and 12000
# 0.83, but 15625 1.50, 19683 1.42 and 20000 1.28; Bluestein's 1031 1.03
# (4093 1.34, 32749 2.50, 65535 2.92)
_CARD_FFT_CUT = 16384
_CARD_SMOOTH_CUT = 12000
_CARD_BLUESTEIN_CUT = 1024
_A_TILE_BINS = 64
_A_CHUNK = 32
_TC_TILE_BINS = 64
_TC_CHUNK = 32


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


def _a_columns(bins: int, packed: bool):
    """Kernel A's weight layout (framed_dft.cu) as indices into the columns
    of the (krows, 2*bins) [Re | Im] weights: a (tiles, 128) array, -1 for
    a zero column. Tile t holds, at wn*64 + part*32 + bg*4 + j (wn, part in
    0..1, bg in 0..7, j in 0..3), the Re (part 0) or Im (part 1) column of
    bin slot t*64 + wn*32 + bg + 8j. Slot s is bin s; `packed` drops the DC
    bin's Im column and puts the last bin's Re column in its place, so
    bins - 1 slots cover every bin.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import _a_columns
    >>> cols = _a_columns(257, packed=True)
    >>> cols.shape, cols[0, :5].tolist(), int(cols[0, 32]), int(cols[3, 127])
    ((4, 128), [0, 8, 16, 24, 1], 256, 512)
    """
    slots = bins - 1 if packed else bins
    tiles = -(-slots // _A_TILE_BINS)
    t, wn, part, bg, j = np.meshgrid(np.arange(tiles), np.arange(2), np.arange(2), np.arange(8),
                                     np.arange(4), indexing="ij")
    slot = t * _A_TILE_BINS + wn * 32 + bg + 8 * j
    cols = np.where(part == 0, slot, bins + slot)
    if packed:
        cols[(slot == 0) & (part == 1)] = bins - 1
    cols[slot >= slots] = -1
    return cols.reshape(tiles, 2 * _A_TILE_BINS)


def _a_packs(weights, bins: int) -> bool:
    """Whether kernel A packs the weights (`_a_columns`): the DC bin's Im
    column is exactly zero, and the last bin's Im column is below f32
    resolution of its Re column (2^-24 of its max), as in the one-sided
    weights of an even n_fft (sin 0, and sin(pi n) in f64). One sync."""
    if bins < 2:
        return False
    last_im = weights[:, 2 * bins - 1].abs().max()
    last_re = weights[:, bins - 1].abs().max()
    return bool(((weights[:, bins] == 0).all() & (last_im <= last_re * 2.0 ** -24)).item())


def _a_weights(weights, bins: int):
    """Kernel A's weights: the (krows, 2*bins) f32 weights laid out by
    `_a_columns` as (tiles, krows_pad, 128), zero rows up to a multiple of
    the kernel's chunk (`_A_CHUNK` rows); returns them and whether they are
    packed."""
    packed = _a_packs(weights, bins)
    cols = torch.as_tensor(_a_columns(bins, packed), device=weights.device)
    w = torch.nn.functional.pad(weights.to(DEFAULT_FLOAT),
                                (0, 1, 0, -weights.shape[0] % _A_CHUNK))  # column -1: zeros
    return w[:, cols].permute(1, 0, 2).contiguous(), packed


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
    w, packed = _a_weights(weights, bins)
    cols = bins if power else 2 * bins
    out = torch.empty((xf.shape[0], num_frames, cols), dtype=DEFAULT_FLOAT, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):  # the kernel launches on the current device
        err = lib.nx_framed_dft_f32(
            xf.data_ptr(), w.data_ptr(), out.data_ptr(), xf.shape[0], length, stride,
            w.shape[1], pad_left, num_frames, bins, int(packed), int(power),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "framed_dft kernel")
    return out.reshape(*batch, num_frames, cols)


def fir_framed_dft_power_cuda(x, weights, *, stride: int, pad_left: int,
                              num_frames: int, bins: int, precision: str = "highest"):
    """Kernel A: the one-sided power spectrum of the FIR-filtered, framed,
    windowed signal, |frames_ext(x) @ W|^2 with W the folded (frame + K - 1,
    2*bins) weights of `kernels.dft.fir_dft_fold_weights`. Extended frame m
    covers x[m*stride - pad_left : ...], zeros outside the signal; any hop
    >= 1. Returns (..., num_frames, bins) f32.

    `precision` 'highest' runs exact f32 FMA (on a CPU tensor the plain
    version, conv1d + re^2 + im^2). 'high' and 'default' are
    `fir_framed_dft_power_tc_cuda` (kernel A-tc) on a CPU tensor and on a
    CUDA one whose geometry A-tc takes (`_tc_takes`); on a CUDA tensor
    outside it they run exact f32 as 'highest' does.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_cuda
    >>> from nx_signal_tpu_torch.kernels.dft import fir_dft_fold_weights
    >>> w = fir_dft_fold_weights([0.25, 0.5, 0.25], torch.hann_window(64), 64, True, device="cpu")
    >>> fir_framed_dft_power_cuda(torch.ones(2, 512), w, stride=16, pad_left=1,
    ...                           num_frames=29, bins=33).shape
    torch.Size([2, 29, 33])
    """
    x = as_signal(x)
    if precision != "highest" and (not _on_card(x) or _tc_takes(stride, weights.shape[0])):
        return fir_framed_dft_power_tc_cuda(x, weights, stride=stride, pad_left=pad_left,
                                            num_frames=num_frames, bins=bins,
                                            precision=precision)
    if not _on_card(x):
        return _framed_matmul_torch(x, weights, stride=stride, pad_left=pad_left,
                                    num_frames=num_frames, bins=bins, power=True)
    out = _launch_framed(x, weights, stride=stride, pad_left=pad_left,
                         num_frames=num_frames, bins=bins, power=True)
    fir_framed_dft_power_cuda.launches += 1
    return out


fir_framed_dft_power_cuda.launches = 0


def _tc_krows_pad(krows: int) -> int:
    return -(-krows // _TC_CHUNK) * _TC_CHUNK


def _tc_takes(stride: int, krows: int) -> bool:
    """Whether kernel A-tc's staged window (its frames' span of x, in f32,
    beside its weight stages) fits in the card's shared memory for this hop
    and weight-row count."""
    lib = load_library()
    frames = ctypes.c_int64(0)
    _check(lib, lib.nx_framed_dft_tc_frames(stride, _tc_krows_pad(krows),
                                            ctypes.byref(frames)), "framed_dft_tc query")
    return frames.value > 0


def _tc_columns(bins: int, packed: bool):
    """Kernel A-tc's column layout (framed_dft_tc.cu) as indices into the
    columns of the (krows, 2*bins) [Re | Im] weights: a (tiles, 128) array,
    -1 for a zero column. Tile t holds the Re columns of bin slots t*64 ..
    t*64 + 63, then their Im columns. Slot s is bin s; `packed` (as for
    kernel A, `_a_columns`) drops the DC bin's Im column and puts the last
    bin's Re column in its place, so bins - 1 slots cover every bin.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import _tc_columns
    >>> cols = _tc_columns(257, packed=True)
    >>> cols.shape, cols[0, :3].tolist(), [int(c) for c in cols[0, 64:66]], int(cols[3, 127])
    ((4, 128), [0, 1, 2], [256, 258], 512)
    """
    slots = bins - 1 if packed else bins
    tiles = -(-slots // _TC_TILE_BINS)
    t, part, c = np.meshgrid(np.arange(tiles), np.arange(2), np.arange(_TC_TILE_BINS),
                             indexing="ij")
    slot = t * _TC_TILE_BINS + c
    cols = np.where(part == 0, slot, bins + slot)
    if packed:
        cols[(slot == 0) & (part == 1)] = bins - 1
    cols[slot >= slots] = -1
    return cols.reshape(tiles, 2 * _TC_TILE_BINS)


def _tc_weights(weights, bins: int, passes: int):
    """Kernel A-tc's weights: the (krows, 2*bins) f32 [Re | Im] weights in
    the columns of `_tc_columns`, zero rows up to krows_pad (a multiple of
    `_TC_CHUNK`), rounded to TF32 (hi = tf32(W), lo = tf32(W - hi),
    `kernels.dft._tf32_split`), as the (tiles, stages, 16 KB) images of the
    kernel's shared-memory ring: per stage of `_TC_CHUNK` rows (W_hi alone,
    passes 1) or `_TC_CHUNK`/2 rows (W_hi then W_lo, passes 3), each k-step
    of 8 rows as W^T in wgmma's K-major core matrices (k-step, 4-row half,
    column group of 8, column, row). Returns them, f32 (tiles, stages,
    kStageBytes / 4) on the weights' device, and whether they are packed
    (`_a_packs`, one sync)."""
    with span("nx.weights.a_tc"):
        packed = _a_packs(weights, bins)
        cols = torch.as_tensor(_tc_columns(bins, packed), device=weights.device)
        krows = weights.shape[0]
        krows_pad = _tc_krows_pad(krows)
        w = torch.nn.functional.pad(weights.to(DEFAULT_FLOAT),
                                    (0, 1, 0, krows_pad - krows))   # column -1: zeros
        tiled = w[:, cols].permute(1, 0, 2)                         # (tiles, krows_pad, 128)
        tiles = tiled.shape[0]
        rows = _TC_CHUNK if passes == 1 else _TC_CHUNK // 2

        def image(part):   # k = ((stage*steps + step)*2 + half)*4 + kk, n = group*8 + col
            return part.reshape(tiles, krows_pad // rows, rows // 8, 2, 4, 16, 8).permute(
                0, 1, 2, 3, 5, 6, 4)

        hi, lo = _tf32_split(tiled)
        laid = image(hi) if passes == 1 else torch.stack([image(hi), image(lo)], dim=2)
        return laid.reshape(tiles, krows_pad // rows, -1).contiguous(), packed


def fir_framed_dft_power_tc_cuda(x, weights, *, stride: int, pad_left: int,
                                 num_frames: int, bins: int, precision: str = "high"):
    """Kernel A-tc: kernel A's function (see `fir_framed_dft_power_cuda`) on
    the tensor cores (wgmma). x and W are split into TF32 parts (round to
    nearest, ties away: `kernels.dft._round_tf32`); 'high' sums x_lo W_hi +
    x_hi W_lo + x_hi W_hi (3xTF32), 'default' x_hi W_hi alone (and reads
    only W_hi), with f32 accumulation, each frame's k-steps and products in
    one fixed order. The weights are laid out by `_tc_weights`, packed where
    `_a_packs` holds. Returns (..., num_frames, bins) f32.

    On a CPU tensor it returns the plain version
    (`kernels.dft._framed_matmul_tf32_torch`, the same products summed in
    f64). On a CUDA tensor it raises where the staged window of x does not
    fit in shared memory (`_tc_takes`).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_tc_cuda
    >>> from nx_signal_tpu_torch.kernels.dft import fir_dft_fold_weights
    >>> w = fir_dft_fold_weights([0.25, 0.5, 0.25], torch.hann_window(64), 64, True, device="cpu")
    >>> fir_framed_dft_power_tc_cuda(torch.ones(2, 512), w, stride=16, pad_left=1,
    ...                              num_frames=29, bins=33).shape
    torch.Size([2, 29, 33])
    """
    passes = _tf32_passes(precision)
    x = as_signal(x)
    if not _on_card(x):
        return _framed_matmul_tf32_torch(x, weights, passes=passes, stride=stride,
                                         pad_left=pad_left, num_frames=num_frames, bins=bins)
    if weights.device != x.device:
        raise ValueError(f"weights on {weights.device}, signal on {x.device}")
    if weights.ndim != 2 or weights.shape[1] != 2 * bins:
        raise ValueError(f"weights must be (rows, {2 * bins}), got {tuple(weights.shape)}")
    if stride < 1 or num_frames < 1 or x.numel() == 0:
        raise ValueError(f"bad geometry: stride={stride}, num_frames={num_frames}, "
                         f"shape={tuple(x.shape)}")
    if not _tc_takes(stride, weights.shape[0]):
        raise ValueError(f"kernel A-tc cannot stage the window of hop {stride} with "
                         f"{weights.shape[0]} weight rows in shared memory; use "
                         "precision='highest' (kernel A)")
    batch, length = x.shape[:-1], x.shape[-1]
    xf = x.to(DEFAULT_FLOAT).reshape(-1, length).contiguous()
    w, packed = _tc_weights(weights, bins, passes)
    out = torch.empty((xf.shape[0], num_frames, bins), dtype=DEFAULT_FLOAT, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.nx_framed_dft_tc_power_f32(
            xf.data_ptr(), w.data_ptr(), out.data_ptr(), xf.shape[0], length, stride,
            _tc_krows_pad(weights.shape[0]), pad_left, num_frames, bins, int(packed), passes,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "framed_dft_tc kernel")
    fir_framed_dft_power_tc_cuda.launches += 1
    return out.reshape(*batch, num_frames, bins)


fir_framed_dft_power_tc_cuda.launches = 0


def _thirteen_smooth(n: int) -> bool:
    """Whether n has no prime factor above 13: B-fft then runs n_fft = n on
    its direct plan (`kernels.dft._fft_plan`), any other n on Bluestein's."""
    return _radices(n) is not None


def _pack_plan(plan) -> int:
    """The plan word of nx_framed_fft_f32: pass p in byte p, radix | pad << 4."""
    return sum((r | c << 4) << 8 * p for p, (r, c) in enumerate(zip(plan.radices, plan.pads)))


@functools.cache
def _device_fft_plan(n_fft: int, device):
    """Kernel B-fft's table, packed plan and FFT points, built once per
    n_fft and device: for a power of two up to `_SMALL_FFT_MAX` the
    twiddles of `kernels.dft._fft_twiddles`, plan 0 and points 0 (its first
    radix-8 kernel); else the plan, `kernels.dft._fft_plan` for a 13-smooth
    n_fft and `kernels.dft._bluestein_plan` for any other, its f64 table
    cast to f32 and its points M (a power-of-two M to 8192, 4096 for odd
    n_fft, runs the persistent radix-8 loop kernel; any other the
    mixed-radix kernel, over a cluster of 2 to 16 CTAs where one does not
    hold its buffers)."""
    if n_fft & (n_fft - 1) == 0 and n_fft <= _SMALL_FFT_MAX:
        return _fft_twiddles(n_fft, device=device), 0, 0
    plan = _fft_plan(n_fft) if _thirteen_smooth(n_fft) else _bluestein_plan(n_fft)
    return (torch.as_tensor(plan.table.astype(np.float32), device=device), _pack_plan(plan),
            plan.points)


def fft_kernel_takes(n_fft: int) -> bool:
    """Whether kernel B-fft serves this n_fft: every n_fft from 8 to 65536,
    with any frame length. A power of two runs radix 8, a 13-smooth n_fft
    such as 400, 441, 572, 600, 12000, 15625, 19683 or 20000 the
    mixed-radix plan, any other, such as 1021, 1031, 4093, 8191, 12289,
    16382, 32749 or 65535, Bluestein's chirp-z transform (on power-of-two
    radix-8 passes, or on a 13-smooth M where the power of two would nearly
    double it, `kernels.dft._bluestein_points`); a transform whose buffers
    do not fit one CTA (an L or Bluestein's M past about 14000 points) is
    spread over a cluster of 2, 4, 8 or 16 CTAs (16 only for Bluestein's M
    past about 116000 points, an odd n_fft past about 58000). The dense
    kernel B serves an n_fft below 8 or above 65536.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import fft_kernel_takes
    >>> [fft_kernel_takes(n) for n in (512, 1031, 16384, 19683, 32749, 65535, 65536)]
    [True, True, True, True, True, True, True]
    >>> [fft_kernel_takes(n) for n in (4, 65537)]
    [False, False]
    """
    return _FFT_MIN <= n_fft <= _FFT_MAX


def _card_takes_kernel(n_fft: int) -> bool:
    """The card's route rule for the framed DFT: kernel B-fft takes this
    n_fft (`fft_kernel_takes`) and it is within the card's measured cut of
    its length class: `_CARD_FFT_CUT` for a power of two,
    `_CARD_SMOOTH_CUT` for any other 13-smooth n_fft, `_CARD_BLUESTEIN_CUT`
    for the rest (Bluestein's transform).

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import _card_takes_kernel
    >>> [_card_takes_kernel(n) for n in (1021, 1031, 2048, 3375, 4093, 6561, 15625, 32768)]
    [True, False, True, True, False, True, False, False]
    """
    if n_fft & (n_fft - 1) == 0:
        cut = _CARD_FFT_CUT
    elif _thirteen_smooth(n_fft):
        cut = _CARD_SMOOTH_CUT
    else:
        cut = _CARD_BLUESTEIN_CUT
    return fft_kernel_takes(n_fft) and n_fft <= cut


def _auto_takes_kernel(x, n_fft: int) -> bool:
    """Whether method='auto' runs the framed DFT of the real signal x as
    `kernels.dft.framed_dft` rather than torch.fft: on a CUDA float32 tensor
    by the card's measured cuts (`_card_takes_kernel`), on any other where
    the JAX package puts it (`kernels.dft.good_matmul_fft_length`). Its one
    caller is the route of the framed DFT, `spectral.stft._framed_spectrum`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import _auto_takes_kernel
    >>> [_auto_takes_kernel(torch.zeros(8), n) for n in (512, 1024, 2048)]   # the CPU's cut
    [True, True, False]
    """
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return _card_takes_kernel(n_fft)
    return good_matmul_fft_length(n_fft)


def framed_fft_cuda(x, window, *, stride: int, n_fft: int, onesided: bool = False,
                    output: str = "complex"):
    """Kernel B-fft: the windowed framed DFT of the (..., L) real signal as
    a real FFT per frame (framed_fft.cu): frame m is x[m*stride : ... +
    frame_length] times `window` (a host array or tensor of frame_length
    samples; a tensor already on x's device is used with no copy from the
    host), zero-padded to n_fft or, where longer, folded modulo n_fft (the
    DFT's period: the JAX package's frame_length-row weights). Returns
    complex64 (..., M, bins), bins = n_fft//2 + 1 (`onesided`) or n_fft, M =
    (L - frame)//stride + 1, or with `output='power'` re^2 + im^2 f32. On a
    CUDA tensor n_fft must be from 8 to 65536 (`fft_kernel_takes`): a power
    of two runs radix 8 (to 1024 one CTA per tile of frames, to 16384 the
    persistent loop kernel, past it the mixed kernel), a 13-smooth n_fft
    the mixed-radix kernel of `kernels.dft._fft_plan`, any other
    Bluestein's transform of `kernels.dft._bluestein_plan` (on the loop
    kernel for a power-of-two M to 8192, 4096 for odd n_fft); the mixed
    kernel spreads a transform whose two buffers do not fit one CTA over a
    cluster of 2, 4, 8 or 16 CTAs.
    Each writes the complex64 tensor directly and reads the frames and the
    window from global memory where they do not fit beside the FFT buffers.
    On a CPU tensor it returns the plain version (the dense [Re | Im]
    contraction of `_framed_matmul_torch`).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import framed_fft_cuda
    >>> z = framed_fft_cuda(torch.ones(2, 512), torch.hann_window(64), stride=16, n_fft=64,
    ...                     onesided=True)
    >>> z.shape, z.dtype
    (torch.Size([2, 29, 33]), torch.complex64)
    >>> framed_fft_cuda(torch.ones(2, 512), torch.hann_window(96), stride=16, n_fft=64,
    ...                 onesided=True).shape   # a frame folded modulo n_fft
    torch.Size([2, 27, 33])
    """
    if output not in ("complex", "power"):
        raise ValueError(f"output must be 'complex' or 'power', got {output!r}")
    x = as_signal(x)
    window = (window if isinstance(window, torch.Tensor) else _host_f64(window)).reshape(-1)
    frame_length = window.shape[0]
    num_frames = (x.shape[-1] - frame_length) // stride + 1
    bins = n_fft // 2 + 1 if onesided else n_fft
    power = output == "power"
    if stride < 1 or num_frames < 1:
        raise ValueError(f"bad geometry: stride={stride}, frame={frame_length}, "
                         f"n_fft={n_fft}, shape={tuple(x.shape)}")
    if not _on_card(x):
        weights = torch.as_tensor(
            _dft_weights(_host_f64(window), frame_length, n_fft, onesided, np.float32))
        acc = _framed_matmul_torch(x, weights, stride=stride, pad_left=0,
                                   num_frames=num_frames, bins=bins, power=power)
        return acc if power else torch.complex(acc[..., :bins], acc[..., bins:])
    if not fft_kernel_takes(n_fft):
        raise ValueError(f"kernel B-fft takes an n_fft from {_FFT_MIN} to {_FFT_MAX}, "
                         f"got {n_fft}")
    batch, length = x.shape[:-1], x.shape[-1]
    xf = x.to(DEFAULT_FLOAT).reshape(-1, length).contiguous()
    win = torch.as_tensor(window, device=x.device).to(DEFAULT_FLOAT).contiguous()
    tw, plan, points = _device_fft_plan(n_fft, x.device)
    out = torch.empty((xf.shape[0], num_frames, bins),
                      dtype=DEFAULT_FLOAT if power else torch.complex64, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.nx_framed_fft_f32(
            xf.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), xf.shape[0], length,
            stride, frame_length, n_fft, num_frames, bins, plan, points, int(power),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, f"framed_fft kernel (n_fft {n_fft}, frame {frame_length}, hop {stride}: "
                     "one FFT's buffers must fit in a CTA's shared memory)")
    framed_fft_cuda.launches += 1
    return out.reshape(*batch, num_frames, bins)


framed_fft_cuda.launches = 0


def ifft_kernel_takes(n_fft: int, frame_length: int, onesided: bool) -> bool:
    """Whether kernel B-ifft serves this framed inverse DFT: a one-sided
    spectrum, n_fft a power of two from 8 to 1024 (the sizes of B-fft's
    first radix-8 kernel, where `istft`'s method='auto' takes
    `kernels.dft.framed_idft`), and a window of 1 to n_fft samples.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import ifft_kernel_takes
    >>> [ifft_kernel_takes(n, 256, True) for n in (4, 256, 512, 600, 1024, 2048)]
    [False, True, True, False, True, False]
    >>> ifft_kernel_takes(512, 400, True), ifft_kernel_takes(512, 600, True)
    (True, False)
    >>> ifft_kernel_takes(512, 512, False)   # two-sided: the dense product
    False
    """
    return (onesided and _FFT_MIN <= n_fft <= _SMALL_FFT_MAX and n_fft & (n_fft - 1) == 0
            and 1 <= frame_length <= n_fft)


def framed_ifft_cuda(z, window, *, n_fft: int, onesided: bool = True):
    """Kernel B-ifft: the windowed frames of a one-sided spectrum,
    irfft(z, n_fft)[..., :frame_length] * window, as an inverse real FFT
    per frame (framed_fft.cu): (..., M, bins) complex64 -> (..., M,
    frame_length) float32, bins zero-padded or cut to n_fft//2 + 1, the
    imaginary parts of the DC and Nyquist bins ignored. `window` is a host
    array or tensor of frame_length samples (one already on z's device is
    used with no copy from the host). On a CUDA tensor the kernel takes
    what `ifft_kernel_takes` admits (n_fft a power of two from 8 to 1024,
    the window no longer than n_fft, onesided) and complex64, and raises
    on anything else; it reads z where it lies, builds nothing on the host
    (the twiddles are B-fft's, cached per n_fft and device) and does not
    sync. f32 FFT arithmetic; each frame's output depends on its own bins
    alone. On a CPU tensor it returns the plain version, the dense weights
    product of `kernels.dft._framed_idft_torch`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import framed_ifft_cuda
    >>> x = torch.randn(2, 5, 64, dtype=torch.float64)
    >>> z = torch.fft.rfft(x).to(torch.complex64)
    >>> f = framed_ifft_cuda(z, torch.hann_window(64), n_fft=64)
    >>> f.shape, f.dtype
    (torch.Size([2, 5, 64]), torch.float32)
    >>> bool((f - (x * torch.hann_window(64, dtype=torch.float64))).abs().max() < 1e-5)
    True
    >>> framed_ifft_cuda(z, torch.ones(40), n_fft=64).shape   # a shorter window
    torch.Size([2, 5, 40])
    """
    z = as_signal(z)
    if not _on_card(z):
        return _framed_idft_torch(z, window, n_fft=n_fft, onesided=onesided)
    window = (window if isinstance(window, torch.Tensor) else _host_f64(window)).reshape(-1)
    frame_length = window.shape[0]
    if not ifft_kernel_takes(n_fft, frame_length, onesided):
        raise ValueError(f"kernel B-ifft takes a one-sided spectrum, a power-of-two n_fft from "
                         f"{_FFT_MIN} to {_SMALL_FFT_MAX} and a window of 1 to n_fft samples, "
                         f"got n_fft {n_fft}, window {frame_length}, onesided={onesided}")
    if z.dtype != torch.complex64:
        raise ValueError(f"kernel B-ifft takes a complex64 spectrum, got {z.dtype}")
    batch, zbins = z.shape[:-1], z.shape[-1]
    zf = torch.resolve_conj(z).reshape(math.prod(batch), zbins).contiguous()
    out = torch.empty((zf.shape[0], frame_length), dtype=DEFAULT_FLOAT, device=z.device)
    if zf.shape[0] == 0:
        return out.reshape(*batch, frame_length)
    win = torch.as_tensor(window, device=z.device).to(DEFAULT_FLOAT).contiguous()
    tw, _, _ = _device_fft_plan(n_fft, z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        err = lib.nx_framed_ifft_f32(
            zf.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), zf.shape[0], zbins,
            frame_length, n_fft, torch.cuda.current_stream().cuda_stream)
    _check(lib, err, f"framed_ifft kernel (n_fft {n_fft}, frame {frame_length})")
    framed_ifft_cuda.launches += 1
    return out.reshape(*batch, frame_length)


framed_ifft_cuda.launches = 0


def framed_dft_cuda(x, weights, *, stride: int, num_frames: int, bins: int,
                    output: str = "complex"):
    """Kernel B (dense): the windowed framed DFT frames(x) @ W of the
    (..., L) real signal, W the (frame, 2*bins) [Re | Im] weights of
    `kernels.dft._dft_weights`, for what kernel B-fft does not take
    (`fft_kernel_takes`): an n_fft below 8 or above 65536. Any hop: where
    16 frames' window of x does not fit beside the weight ring in shared
    memory, the kernel streams x through the ring with the weights.
    The kernel writes the stacked f32 [Re | Im]; this returns it as
    complex64 (..., num_frames, bins), or with `output='power'` the
    kernel's re^2 + im^2. Exact f32 FMA. On a CPU tensor it returns the
    plain version.

    Examples:

    >>> import math, torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import framed_dft_cuda
    >>> angle = 2 * math.pi * torch.arange(64.0)[:, None] * torch.arange(33.0) / 64
    >>> w = torch.cat([torch.cos(angle), -torch.sin(angle)], dim=1)   # [Re | Im]
    >>> framed_dft_cuda(torch.ones(2, 512), w, stride=16, num_frames=29, bins=33).shape
    torch.Size([2, 29, 33])
    """
    if output not in ("complex", "power"):
        raise ValueError(f"output must be 'complex' or 'power', got {output!r}")
    x = as_signal(x)
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


def _ola_seed(init, batch, length: int, dtype):
    """The (*batch, length) seed of a fold: `init` cut to `length` samples
    and zero-padded to it, in `dtype`."""
    init = torch.as_tensor(init)
    if tuple(init.shape[:-1]) != tuple(batch):
        raise ValueError(f"init must have the frames' batch shape {tuple(batch)}, "
                         f"got {tuple(init.shape[:-1])}")
    init = init[..., :length].to(dtype)
    return F.pad(init, (0, length - init.shape[-1]))


def _part_seeds(init):
    """The (real part, imaginary part) seeds of a complex fold: a complex
    seed's parts, a real seed for the real part only, or none."""
    if init is None:
        return None, None
    init = torch.as_tensor(init)
    return (init.real, init.imag) if init.is_complex() else (init, None)


def _ola_fold_torch(frames, stride: int, out_length: int, init=None):
    """Plain deterministic overlap-add: a left fold of the C shifted blocks,
    j descending, so sample p = q*stride + s receives frames[q - j,
    s + j*stride] in increasing frame order.

    The (rows, stride) accumulator grid starts at `init` (cut to
    rows*stride samples, zero-padded), or at +0.0 without one, and every
    block is added to the whole grid, zeros outside its row range, as the
    JAX fold does: a seed of -0.0 then meets the same +0.0 terms.

    Complex frames fold their real and imaginary parts apart: torch's
    complex add computes a + 1*b, and the complex product 1*b turns a real
    part of -0.0 into +0.0 where the imaginary part is negative."""
    if frames.is_complex():
        seeds = _part_seeds(init)
        re = _ola_fold_torch(frames.real, stride, out_length, init=seeds[0])
        im = _ola_fold_torch(frames.imag, stride, out_length, init=seeds[1])
        return torch.complex(re, im)
    *batch, num_frames, window_length = frames.shape
    widths = _frame_block_widths(window_length, stride)
    num_rows = -(-out_length // stride)
    grid = (*batch, num_rows, stride)
    if init is None:
        acc = torch.zeros(grid, dtype=frames.dtype, device=frames.device)
    else:
        acc = _ola_seed(init, batch, num_rows * stride, frames.dtype).reshape(grid)
        acc = acc.to(frames.device, copy=True)
    block = torch.empty_like(acc)
    for j in range(len(widths) - 1, -1, -1):
        rows = max(min(num_frames, num_rows - j), 0)
        w = widths[j]
        block.zero_()
        block[..., j:j + rows, :w] = frames[..., :rows, j * stride:j * stride + w]
        acc += block
    return acc.reshape(*batch, num_rows * stride)[..., :out_length]


def overlap_add_cuda(frames, *, stride: int, out_length: int, init=None):
    """Kernel C: overlap-add of (..., M, N) float32 frames at hop `stride`
    into (..., out_length), every output sample summing its frames in
    increasing frame order — bitwise equal to the plain fold. Any hop >= 1.
    `init` (..., any length), cut to out_length and zero-padded, seeds each
    sample's sum (`spectral.framing._ola_fold`). On a CPU tensor it returns
    the plain fold.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import overlap_add_cuda
    >>> overlap_add_cuda(torch.ones(1, 3, 4), stride=2, out_length=8)
    tensor([[1., 1., 2., 2., 2., 2., 1., 1.]])
    """
    frames = as_signal(frames)
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


def _d_columns(bins: int, halo: int):
    """Kernel D's column layout (shared_dft.cu) for `bins` one-sided bins
    and `halo` neighbour bins on each side: tile t gives the 96 - 2*halo
    bins from t*(96 - 2*halo) on, and its column s (0..95) is bin position
    kl = t*(96 - 2*halo) - halo + s, which reads bin kl, or its mirror
    through DC (-kl) or Nyquist (2*(bins - 1) - kl) within `halo` of them.
    Returns the (tiles, 192) indices into the columns of the (krows,
    2*bins) [Re | Im] weights: column s's Re at wn*64 + bg*4 + j and its Im
    32 further, where s = wn*32 + bg + 8j (wn in 0..2, bg in 0..7, j in
    0..3), -1 (a zero column) past the mirror range.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_dft import _d_columns
    >>> cols = _d_columns(257, 1)
    >>> cols.shape, cols[0, :5].tolist(), int(cols[0, 32]), int((cols[2] < 0).sum())
    ((3, 192), [1, 7, 15, 23, 0], 258, 50)
    """
    tile_k = _D_SLOTS - 2 * halo
    tiles = -(-bins // tile_k)
    t, s = np.meshgrid(np.arange(tiles), np.arange(_D_SLOTS), indexing="ij")
    kl = t * tile_k - halo + s
    kp = np.where(kl < 0, -kl, np.where(kl > bins - 1, 2 * (bins - 1) - kl, kl))
    kp[kl > bins - 1 + halo] = -1
    pos = (s // 32) * 64 + (s % 8) * 4 + (s // 8) % 4
    cols = np.full((tiles, 2 * _D_SLOTS), -1)
    cols[t, pos] = kp
    cols[t, pos + 32] = np.where(kp >= 0, bins + kp, -1)
    return cols


@functools.cache
def _d_index(bins: int, halo: int, device):
    """`_d_columns` as an index tensor on `device`, copied there once per
    (bins, halo, device)."""
    return torch.as_tensor(_d_columns(bins, halo), device=device)


def _d_weights(weights, bins: int, halo: int):
    """Kernel D's weights: the (krows, 2*bins) [Re | Im] f32 partial-DFT
    weights in the columns of `_d_columns`, as (tiles, krows_pad, 192),
    zero rows up to a multiple of `_D_SUM_ROWS`; one gather on the
    weights' device (no sync once `_d_index` holds the geometry)."""
    cols = _d_index(bins, halo, weights.device)
    w = torch.nn.functional.pad(weights.to(DEFAULT_FLOAT),
                                (0, 1, 0, -weights.shape[0] % _D_SUM_ROWS))  # column -1: zeros
    return w[:, cols].permute(1, 0, 2).contiguous()


def _d_twiddles(twiddles, bins: int, halo: int):
    """Kernel D's twiddles: the (2, J, bins) f32 cos and sin table of
    `kernels.dft.shared_twiddles` as the (J, 2*bins) [cos | sin] rows, laid
    out by the weights' columns (`_d_columns`: a column's cos where its Re
    weights sit, its sin where its Im weights sit, zeros past the mirror
    range), as (tiles, J, 192); one gather on the table's device."""
    cols = _d_index(bins, halo, twiddles.device)
    t = torch.nn.functional.pad(torch.cat([twiddles[0], twiddles[1]], dim=-1)
                                .to(DEFAULT_FLOAT), (0, 1))   # column -1: zeros
    return t[:, cols].permute(1, 0, 2).contiguous()


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
    needs at most 8 coefficients, fewer than bins - 1, and J <= 64; the
    weights and twiddles are laid out per tile of 96 bin columns by
    `_d_weights` and `_d_twiddles` (two gathers on the card).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_shared_cuda
    >>> from nx_signal_tpu_torch.kernels.dft import shared_fold_weights, shared_twiddles
    >>> taps = [0.25, 0.5, 0.25]
    >>> p = fir_framed_dft_power_shared_cuda(
    ...     torch.ones(2, 512), shared_fold_weights(taps, 16, 64, device="cpu"),
    ...     shared_twiddles(16, 64, device="cpu"), (0.5, -0.5), stride=16, pad_left=1,
    ...     num_frames=29, bins=33)
    >>> p.shape
    torch.Size([2, 29, 33])
    """
    x = as_signal(x)
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
    w = _d_weights(weights, bins, len(coeffs) - 1)
    tw = _d_twiddles(twiddles, bins, len(coeffs) - 1)
    # the kernel's epilogue multiplies by b_0, then b_c / 2 (rounded to f32
    # as the plain version's python-float scalars are)
    wc = torch.tensor([coeffs[0]] + [b / 2.0 for b in coeffs[1:]], dtype=DEFAULT_FLOAT,
                      device=x.device)
    out = torch.empty((xf.shape[0], num_frames, bins), dtype=DEFAULT_FLOAT, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.nx_shared_dft_power_f32(
            xf.data_ptr(), w.data_ptr(), tw.data_ptr(), wc.data_ptr(), out.data_ptr(),
            xf.shape[0], length, stride, w.shape[1], pad_left, num_frames, bins, j_taps,
            len(coeffs), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "shared_dft kernel")
    fir_framed_dft_power_shared_cuda.launches += 1
    return out.reshape(*batch, num_frames, bins)


fir_framed_dft_power_shared_cuda.launches = 0
