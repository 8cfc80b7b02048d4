"""Plain reference of the STFT -> ISTFT round trip, in float64 PyTorch, with
the program's semantics ('valid' frames at the hop, the window, a
one-sided real FFT; then the inverse real FFT, the synthesis window, the
overlap-add and the division by the overlap-added squared window where
it exceeds 1e-10). It imports nothing of the program and takes only the
inputs and window that the benchmark made.

Its control (`control_roundtrip`) is the same arithmetic in TF32 (the
operands of every product rounded to TF32, products and sums in float32,
each DFT a product with its weights): the program's framed inverse DFT is
an exact float32 product with TF32 off, and this is the step below it.
"""

import math

import torch

ROWS = 8      # rows a block: 8 x 20 668 frames of 512 f64 samples take ~0.7 GB
GUARD = 1e-10


def _tf32(t):
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def overlap_add(frames, hop: int):
    """Sum of (..., M, F) frames placed hop apart: (..., (M - 1) hop + F);
    F a multiple of hop."""
    m, f = frames.shape[-2:]
    q = f // hop
    if q * hop != f:
        raise ValueError(f"frame {f} is not a multiple of the hop {hop}")
    parts = frames.reshape(*frames.shape[:-1], q, hop)
    out = frames.new_zeros(*frames.shape[:-2], m + q - 1, hop)
    for j in range(q):
        out[..., j:j + m, :] += parts[..., j, :]
    return out.reshape(*frames.shape[:-2], -1)


def envelope(window, num_frames: int, hop: int):
    """The overlap-added squared window, before the guard, f64."""
    w2 = window.double() ** 2
    return overlap_add(w2.expand(num_frames, w2.shape[-1]), hop)


def stft(x, window, hop: int, n_fft: int):
    return torch.fft.rfft(x.double().unfold(-1, window.shape[-1], hop) * window.double(), n_fft)


def istft(z, window, hop: int, n_fft: int):
    frames = torch.fft.irfft(z, n_fft)[..., :window.shape[-1]] * window.double()
    norm = envelope(window, z.shape[-2], hop)
    return overlap_add(frames, hop) / torch.where(norm > GUARD, norm, torch.ones_like(norm))


def errors(x, z, y, window, hop: int, n_fft: int):
    """Per-bin (error, scale) of z against the reference spectrum, and
    (error, scale) of y: the largest |y - y_ref| weighted by the envelope
    over its largest value (1 where every frame overlaps, falling toward
    the ends, where the division magnifies any error), and max |y_ref|."""
    window = torch.as_tensor(window, device=x.device)
    weight = envelope(window, z.shape[-2], hop)
    weight = weight / weight.max()
    z_err = z_scale = None
    y_err = y_scale = 0.0
    for r in range(0, x.shape[0], ROWS):
        z_ref = stft(x[r:r + ROWS], window, hop, n_fft)
        dims = tuple(range(z_ref.ndim - 1))
        e = (z[r:r + ROWS].to(torch.complex128) - z_ref).abs().amax(dim=dims)
        s = z_ref.abs().amax(dim=dims)
        z_err = e if z_err is None else torch.maximum(z_err, e)
        z_scale = s if z_scale is None else torch.maximum(z_scale, s)
        y_ref = istft(z_ref, window, hop, n_fft)
        y_err = max(y_err, float(((y[r:r + ROWS].double() - y_ref).abs() * weight).max()))
        y_scale = max(y_scale, float(y_ref.abs().max()))
    return z_err.cpu(), z_scale.cpu(), y_err, y_scale


def control_roundtrip(x, window, hop: int, n_fft: int):
    """(z, y) of the round trip in TF32, ROWS rows at a time."""
    frame = window.shape[-1]
    bins = n_fft // 2 + 1
    k = torch.arange(bins, dtype=torch.float64, device=x.device)
    t = torch.arange(frame, dtype=torch.float64, device=x.device)
    angle = 2.0 * math.pi * torch.outer(t, k) / n_fft
    fwd = _tf32(torch.cat([torch.cos(angle), -torch.sin(angle)], dim=1).float())
    factor = torch.full((bins, 1), 2.0, dtype=torch.float64, device=x.device)
    factor[0] = 1.0
    if n_fft % 2 == 0:
        factor[-1] = 1.0
    inv = torch.cat([factor * torch.cos(angle.T), -factor * torch.sin(angle.T)]) / n_fft
    inv = _tf32((inv * window.double()).float())
    norm = envelope(window, (x.shape[-1] - frame) // hop + 1, hop).float()
    norm = torch.where(norm > GUARD, norm, torch.ones_like(norm))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        zs, ys = [], []
        for r in range(0, x.shape[0], ROWS):
            spec = _tf32(x[r:r + ROWS].unfold(-1, frame, hop) * window) @ fwd
            zs.append(torch.complex(spec[..., :bins], spec[..., bins:]))
            ys.append(overlap_add(_tf32(spec) @ inv, hop) / norm)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return torch.cat(zs), torch.cat(ys)
