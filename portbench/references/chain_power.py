"""Plain reference of the FIR + framed power chain, in float64 PyTorch: the
'same' FIR of each row (numpy.convolve(row, taps)[(K-1)//2:][:L], here by
an f64 FFT of the row), its frames at the hop, the window, an f64 real
FFT and |.|^2. It imports nothing of the program and takes only the
inputs, taps and window that the benchmark made.

Its control (`control_*`) is the same arithmetic in TF32: every operand
of a product rounded to TF32 (10 bits of mantissa, to nearest, ties away,
as the tensor cores take float32), the products and sums in float32 and
the DFT as a product with its weights. It stands in the program's place
where the program has no lower-precision path of its own.
"""

import contextlib
import math

import torch

ROWS = 32   # rows a block: the f64 frames of 32 x 480 000 samples take ~0.5 GB


def fir_same(x, taps, s0: int, s1: int):
    """Samples [s0, s1) of the 'same' FIR of each row of x (R, L), f64;
    zeros stand outside [0, L)."""
    x, taps = x.double(), taps.double()
    k, length = taps.shape[-1], x.shape[-1]
    lo, hi = k - 1 - (k - 1) // 2, (k - 1) // 2
    a, b = s0 - lo, s1 + hi
    seg = x[..., max(a, 0):min(b, length)]
    seg = torch.nn.functional.pad(seg, (max(a, 0) - a, b - min(b, length)))
    n = 1 << math.ceil(math.log2(seg.shape[-1] + k - 1))
    full = torch.fft.irfft(torch.fft.rfft(seg, n) * torch.fft.rfft(taps, n), n)
    return full[..., k - 1:k - 1 + (s1 - s0)]


def frames_power(y, window, hop: int, n_fft: int):
    """|rfft(frames(y) * window, n_fft)|^2 of every whole frame of y, f64."""
    frames = y.unfold(-1, window.shape[-1], hop) * window.double()
    return torch.fft.rfft(frames, n_fft).abs() ** 2


def power(x, taps, window, hop: int, n_fft: int, f0: int, f1: int):
    """Frames [f0, f1) of the chain's power of each row of x, f64."""
    y = fir_same(x, taps, f0 * hop, (f1 - 1) * hop + window.shape[-1])
    return frames_power(y, window, hop, n_fft)


def bin_errors(got, want):
    """(max |got - want|, max |want|) of each bin (last axis), f64."""
    dims = tuple(range(want.ndim - 1))
    return (got.double() - want).abs().amax(dim=dims), want.abs().amax(dim=dims)


def power_errors(x, got, taps, window, hop: int, n_fft: int, f0: int, f1: int):
    """Per-bin (error, scale) of the program's power `got` (R, f1 - f0,
    bins) against this reference, over blocks of ROWS rows."""
    taps, window = torch.as_tensor(taps, device=x.device), torch.as_tensor(window, device=x.device)
    err = scale = None
    for r in range(0, x.shape[0], ROWS):
        e, s = bin_errors(got[r:r + ROWS], power(x[r:r + ROWS], taps, window, hop, n_fft, f0, f1))
        err = e if err is None else torch.maximum(err, e)
        scale = s if scale is None else torch.maximum(scale, s)
    return err.cpu(), scale.cpu()


# ------------------------------------------------------------- the control
@contextlib.contextmanager
def exact_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32(t):
    """float32 rounded to TF32: 10 bits of mantissa, to nearest, ties away."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dft_weights(n: int, n_fft: int, device):
    """(n, 2*bins) float32 [cos | -sin] weights of a real DFT of n points."""
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=device)
    t = torch.arange(n, dtype=torch.float64, device=device)
    angle = 2.0 * math.pi * torch.outer(t, k) / n_fft
    return torch.cat([torch.cos(angle), -torch.sin(angle)], dim=1).float()


def control_fir(x, taps):
    """The 'same' FIR of each row in TF32 (odd number of taps)."""
    k = taps.shape[-1]
    with exact_f32():
        return torch.nn.functional.conv1d(
            tf32(x).unsqueeze(-2), tf32(taps).flip(-1).reshape(1, 1, k),
            padding=(k - 1) // 2).squeeze(-2)


def control_spectrum(y, window, hop: int, n_fft: int):
    """(re, im) of the windowed frames' DFT in TF32, float32."""
    w = dft_weights(window.shape[-1], n_fft, y.device)
    with exact_f32():
        out = tf32(y.unfold(-1, window.shape[-1], hop) * window) @ tf32(w)
    bins = n_fft // 2 + 1
    return out[..., :bins], out[..., bins:]


def control_power(x, taps, window, hop: int, n_fft: int):
    """The chain's power in TF32, ROWS rows at a time, float32."""
    out = []
    for r in range(0, x.shape[0], ROWS):
        re, im = control_spectrum(control_fir(x[r:r + ROWS], taps), window, hop, n_fft)
        out.append(re * re + im * im)
    return torch.cat(out)
