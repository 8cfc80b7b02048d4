"""ShortTimeFFT, scipy.signal's class API of the STFT (counterpart of
nx_signal_tpu/spectral/short_time_fft.py).

A window `win` slides by `hop` samples; slice p is centred at sample
p*hop (it covers [p*hop - m_num_mid, p*hop - m_num_mid + m_num)), the
slices at the signal's edges are padded by a choosable mode, with four
fft_modes, inversion by the canonical dual window, and 'magnitude' / 'psd'
scaling. The window, its dual and the slice bookkeeping are host numpy, as
in the JAX package.

* The forward transform frames the padded signal once; scipy's per-slice
  roll by the phase shift is a per-bin phase factor (fft(roll(v, -s))[k] =
  fft(v)[k] exp(2j pi k s / mfft)). On a CUDA float32 signal with a real
  window, no detrend, a one-sided fft_mode and an mfft within the card's
  cut (`kernels.cuda_dft._card_takes_kernel`) it is
  `kernels.dft.framed_dft` (kernel B-fft: no frame matrix is built);
  otherwise torch.fft of the windowed frames (`fft_method` 'matmul' or
  'fft' forces one route). This rule is its own, not `stft`'s
  (`spectral.stft._framed_spectrum`): off the card 'auto' keeps torch.fft
  at every mfft, as the JAX class keeps its matmul DFT off the CPU.
* `istft` is an inverse FFT per slice times the dual window, then the
  deterministic left fold `spectral.framing._ola_fold` (kernel C on a CUDA
  float32 tensor; complex frames fold their real and imaginary parts
  apart).
"""

import math

import numpy as np
import torch

from nx_signal_tpu_torch.kernels.cuda_dft import _card_takes_kernel, fft_kernel_takes
from nx_signal_tpu_torch.kernels.dft import framed_dft
from nx_signal_tpu_torch.spectral.framing import _ola_fold, as_windowed
from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_MODES = ("zeros", "edge", "even", "odd")


def _canonical_dual(win, hop: int):
    """Canonical dual window win / sum_j |win|^2 shifted by j*hop, which makes
    the overlap-add inversion exact; raises where that envelope has
    (near-)zeros (the STFT is not invertible)."""
    win = np.asarray(win)
    if hop > len(win):
        raise ValueError(f"hop={hop} is larger than window length of {len(win)} => STFT not "
                         "invertible!")
    if np.issubdtype(win.dtype, np.integer):
        raise ValueError("Parameter 'win' cannot be of integer type, but "
                         f"win.dtype={win.dtype!r} => STFT not invertible!")
    w2 = win.real ** 2 + win.imag ** 2
    envelope = w2.copy()
    for shift in range(hop, len(win), hop):
        envelope[shift:] += w2[:-shift]
        envelope[:-shift] += w2[shift:]
    if not np.all(envelope >= np.finfo(win.dtype).resolution * envelope.max()):
        raise ValueError("Short-time Fourier Transform not invertible!")
    return win / envelope


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *, scaled: bool = True):
    """The dual window of `win` (hop `hop`) closest to `desired_dual` in
    least squares, scipy.signal.closest_STFT_dual_window semantics; host
    numpy in f64. The duality constraint decouples over the hop residue
    classes r, r + hop, ...: within a class it is <w_r, d_r> = 1, so a dual
    is alpha * desired_dual plus a multiple of `win` per class; with
    `scaled=True` alpha is optimized too (in closed form), else it is 1.
    Returns (dual_win, alpha).

    Examples:

    A periodic Hann window at half-window hop is COLA, so its dual closest
    to the rectangular window is the rectangular window:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.spectral.short_time_fft import closest_STFT_dual_window
    >>> d, alpha = closest_STFT_dual_window(np.hanning(9)[:8], 4)
    >>> d.round(4), round(alpha, 4)
    (array([1., 1., 1., 1., 1., 1., 1., 1.]), 1.0)
    """
    w = np.asarray(win)
    if w.ndim != 1 or w.size == 0:
        raise ValueError("win must be a non-empty 1-D array")
    if not np.all(np.isfinite(w)):
        raise ValueError("win must contain only finite values")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= w.size):
        raise ValueError(f"hop={hop} is not an integer in [1, {w.size}]")
    if desired_dual is None:
        g = np.ones_like(w, dtype=np.result_type(w.dtype, np.float64))
    else:
        g = np.asarray(desired_dual)
        if g.shape != w.shape:
            raise ValueError("desired_dual must be a 1-D array of the same length as win")
        if not np.all(np.isfinite(g)):
            raise ValueError("desired_dual must contain only finite values")
    # per-residue-class energy and overlap with the desired dual
    m = w.size
    energy = np.zeros(hop, dtype=np.float64)
    overlap = np.zeros(hop, dtype=np.result_type(w.dtype, g.dtype, np.float64))
    for r in range(hop):
        wr, gr = w[r::hop], g[r::hop]
        energy[r] = np.sum(wr.real ** 2 + wr.imag ** 2)
        overlap[r] = np.sum(np.conj(wr) * gr)
    if np.any(energy <= m * np.finfo(np.float64).eps * energy.max()):
        raise ValueError("Closest dual window is numerically unstable! A residue class of "
                         "win (mod hop) has no energy, so no dual window exists.")
    if scaled:
        # d = alpha g + mu_r w, mu_r = (1 - alpha c_r) / e_r; minimizing
        # sum_r |1 - alpha c_r|^2 / e_r gives alpha below
        denom = np.sum(np.abs(overlap) ** 2 / energy)
        if denom <= m * np.finfo(np.float64).eps:
            raise ValueError("Closest dual window is numerically unstable! win and "
                             "desired_dual are orthogonal in every residue class, so the "
                             "optimal scale degenerates.")
        alpha = np.sum(np.conj(overlap) / energy) / denom
    else:
        alpha = 1.0
    d = (alpha * g).astype(np.result_type(overlap.dtype, type(alpha)))
    for r in range(hop):
        d[r::hop] += ((1.0 - alpha * overlap[r]) / energy[r]) * w[r::hop]
    if not (np.iscomplexobj(w) or np.iscomplexobj(g)):
        alpha = float(np.real(alpha))
        d = np.real(d)
    return d, alpha


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT's short-time FFT; the spectra are torch
    tensors (..., f_pts, slices), the window and its dual numpy arrays.

    `fft_method` ('auto', 'fft' or 'matmul') picks the forward transform of
    the one-sided modes: 'auto' runs kernel B-fft through `framed_dft` on a
    CUDA float32 signal (real window, no detrend, mfft within the card's
    cut) and torch.fft otherwise; 'matmul' takes `framed_dft` on any device (its
    plain conv1d on the CPU) wherever its contract holds.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
    >>> S = ShortTimeFFT(np.hanning(64), hop=16, fs=1000.0)
    >>> sig = torch.sin(0.1 * torch.arange(1000.0))
    >>> Z = S.stft(sig)
    >>> tuple(Z.shape)   # (bins, slices)
    (33, 66)
    >>> bool((S.istft(Z, k1=1000) - sig).abs().max() < 1e-4)   # invertible
    True
    """

    fft_method = "auto"

    def __init__(self, win, hop: int, fs: float, *, fft_mode: str = "onesided",
                 mfft: int = None, dual_win=None, scale_to: str = None, phase_shift=0):
        win = np.asarray(win)
        if win.ndim != 1 or win.size == 0:
            raise ValueError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must have finite entries")
        if not (hop >= 1 and isinstance(hop, (int, np.integer))):
            raise ValueError(f"hop={hop} must be a positive integer")
        self._win = win.astype(np.result_type(win.dtype, np.float32))
        self._hop = int(hop)
        self._fs = float(fs)
        self._mfft = int(mfft) if mfft is not None else len(win)
        if self._mfft < len(win):
            raise ValueError("mfft must be >= window length")
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            if dual_win.shape != win.shape:
                raise ValueError("dual_win must have the same shape as win")
        self._dual_win = dual_win
        self._scaling = None
        if scale_to is not None:
            self.scale_to(scale_to)
        self._fft_mode = None
        self.fft_mode = fft_mode  # validated by the setter (needs the scaling)
        if phase_shift is not None:
            if not isinstance(phase_shift, (int, np.integer)):
                raise ValueError(f"phase_shift={phase_shift} has to be an integer or None")
            if not -self.mfft < phase_shift < self.mfft:
                raise ValueError(f"phase_shift must satisfy -mfft < phase_shift < "
                                 f"mfft={self.mfft}")
        self._phase_shift = phase_shift

    # ------------------------------------------------------- constructors
    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int, noverlap: int, *,
                    symmetric_win: bool = False, fft_mode: str = "onesided", mfft: int = None,
                    scale_to: str = None, phase_shift=0):
        """Build from a window spec of `ops.windows.get_window`,
        scipy.signal.ShortTimeFFT.from_window semantics."""
        from nx_signal_tpu_torch.ops.windows import get_window

        if not 0 <= noverlap < nperseg:
            raise ValueError("noverlap must satisfy 0 <= noverlap < nperseg")
        win = get_window(win_param, nperseg, periodic=not symmetric_win,
                         dtype=torch.float64, device="cpu").numpy()
        return cls(win, hop=nperseg - noverlap, fs=fs, fft_mode=fft_mode, mfft=mfft,
                   scale_to=scale_to, phase_shift=phase_shift)

    @classmethod
    def from_dual(cls, dual_win, hop: int, fs: float, **kwargs):
        """Build from the synthesis window (win becomes its canonical dual),
        scipy.signal.ShortTimeFFT.from_dual semantics."""
        dual_win = np.asarray(dual_win)
        return cls(_canonical_dual(dual_win, hop), hop, fs, dual_win=dual_win, **kwargs)

    @classmethod
    def from_win_equals_dual(cls, desired_win, hop: int, fs: float, *,
                             fft_mode: str = "onesided", mfft: int = None, scale_to: str = None,
                             phase_shift=0):
        """The instance whose window is its own dual (up to `scale_to`),
        closest to `desired_win`: each hop residue class of `desired_win`
        normalized to unit energy, scipy.signal.ShortTimeFFT.
        from_win_equals_dual semantics; `scale_to` also takes 'unitary'
        (win / sqrt(mfft))."""
        g = np.asarray(desired_win)
        if g.ndim != 1 or g.size == 0:
            raise ValueError("desired_win must be a non-empty 1-D array")
        if not np.all(np.isfinite(g)):
            raise ValueError("desired_win must have finite entries")
        w = g.astype(np.result_type(g.dtype, np.float64)).copy()
        for r in range(int(hop)):
            nrm = np.sqrt(np.sum(np.abs(g[r::hop]) ** 2))
            if nrm <= g.size * np.finfo(np.float64).eps:
                raise ValueError("Parameter desired_win does not have a valid STFT dual "
                                 f"window for hop={hop}!")
            w[r::hop] = g[r::hop] / nrm
        unitary = scale_to == "unitary"
        sft = cls(w, int(hop), fs, fft_mode=fft_mode, mfft=mfft, dual_win=w.copy(),
                  scale_to=None if unitary else scale_to, phase_shift=phase_shift)
        if unitary:
            fac = 1.0 / np.sqrt(sft.mfft)
            sft._win = sft._win * fac
            sft._dual_win = sft._dual_win / fac
            sft._scaling = "unitary"
        return sft

    # ------------------------------------------------------- basic properties
    @property
    def win(self):
        return self._win

    @property
    def hop(self):
        return self._hop

    @property
    def fs(self):
        return self._fs

    @property
    def T(self):
        return 1.0 / self._fs

    @property
    def delta_t(self):
        return self._hop * self.T

    @property
    def m_num(self):
        return len(self._win)

    @property
    def m_num_mid(self):
        return self.m_num // 2

    @property
    def mfft(self):
        return self._mfft

    @property
    def fft_mode(self):
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, mode):
        if mode not in _FFT_MODES:
            raise ValueError(f"fft_mode={mode!r} not in {_FFT_MODES}")
        if mode == "onesided2X" and self.scaling is None:
            raise ValueError("fft_mode 'onesided2X' requires 'magnitude' or 'psd' scaling — "
                             "call scale_to() first")
        self._fft_mode = mode

    @property
    def onesided_fft(self):
        return self._fft_mode in ("onesided", "onesided2X")

    @property
    def scaling(self):
        return self._scaling

    @property
    def phase_shift(self):
        return self._phase_shift

    @property
    def f_pts(self):
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def delta_f(self):
        return self._fs / self.mfft

    @property
    def f(self):
        if self.onesided_fft:
            return np.arange(self.f_pts) * self.delta_f
        freqs = np.fft.fftfreq(self.mfft, d=self.T)
        return np.fft.fftshift(freqs) if self._fft_mode == "centered" else freqs

    # ------------------------------------------------------- slice ranges
    @property
    def p_min(self):
        return self._pre_padding()[1]

    @property
    def k_min(self):
        return self._pre_padding()[0]

    def p_max(self, n: int) -> int:
        return self._post_padding(n)[1]

    def k_max(self, n: int) -> int:
        return self._post_padding(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    def _w2(self):
        return self._win.real ** 2 + self._win.imag ** 2

    def _pre_padding(self):
        """(k_min, p_min): start sample and index of the leftmost slice that
        still touches the signal (zero-leading windows shrink the reach)."""
        w2 = self._w2()
        start = -self.m_num_mid
        p = 0
        while True:
            nxt = start - self._hop
            if nxt + self.m_num <= 0 or not w2[nxt:].any():
                return start, -p
            start, p = nxt, p + 1

    def _post_padding(self, n: int):
        """(k_max, p_max) of an n-sample signal."""
        if n < self.m_num - self.m_num_mid:
            raise ValueError("Parameter n must be >= ceil(m_num/2) = "
                             f"{self.m_num - self.m_num_mid}!")
        w2 = self._w2()
        q = n // self._hop
        start = q * self._hop - self.m_num_mid
        while True:
            nxt = start + self._hop
            if nxt >= n or not w2[: n - nxt].any():
                return start + self.m_num, q + 1
            start, q = nxt, q + 1

    def p_range(self, n: int, p0=None, p1=None):
        p_max = self.p_max(n)
        p0 = self.p_min if p0 is None else p0
        p1 = p_max if p1 is None else p1
        if not (self.p_min <= p0 < p1 <= p_max):
            raise ValueError(f"Invalid slice range [{p0}, {p1}): requires "
                             f"{self.p_min} <= p0 < p1 <= {p_max} for n={n}")
        return p0, p1

    def t(self, n: int, p0=None, p1=None, k_offset: int = 0):
        """Slice times of an n-sample signal."""
        p0, p1 = self.p_range(n, p0, p1)
        return (np.arange(p0, p1) * self._hop + k_offset) * self.T

    @property
    def lower_border_end(self):
        """(sample, slice) where the left boundary region ends."""
        w2 = self._w2()
        m0 = int(np.flatnonzero(w2)[0])
        start = -self.m_num_mid + m0
        q = 0
        while start <= self._hop:
            if start + self._hop >= 0:
                return (start + self.m_num, q + 1)
            start += self._hop
            q += 1
        return (0, max(self.p_min, 0))

    def upper_border_begin(self, n: int):
        """(sample, slice) where the right boundary region begins."""
        if n < self.m_num - self.m_num_mid:
            raise ValueError("Parameter n must be >= ceil(m_num/2) = "
                             f"{self.m_num - self.m_num_mid}!")
        w2 = self._w2()
        q = n // self._hop + 1
        q_stop = max((n - self.m_num) // self._hop - 1, -1)
        while q > q_stop:
            end = q * self._hop + (self.m_num - self.m_num_mid)
            if end <= n or not w2[n - end:].any():
                return ((q + 1) * self._hop - self.m_num_mid, q + 1)
            q -= 1
        raise RuntimeError("unreachable")

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        """The nearest sample on the slice grid (ties toward `left`)."""
        p_q, remainder = divmod(k, self._hop)
        if remainder == 0:
            return k
        return p_q * self._hop if left else (p_q + 1) * self._hop

    # ------------------------------------------------------- dual window
    @property
    def dual_win(self):
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self):
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    # ------------------------------------------------------- scaling
    @property
    def fac_magnitude(self):
        if self._scaling == "magnitude":
            return 1.0
        return 1.0 / abs(np.sum(self._win))

    @property
    def fac_psd(self):
        if self._scaling == "psd":
            return 1.0
        return 1.0 / math.sqrt(float(np.sum(self._w2())) / self.T)

    def scale_to(self, scaling: str):
        if scaling not in ("magnitude", "psd"):
            raise ValueError(f"scaling={scaling!r} not in {{'magnitude', 'psd'}}!")
        if self._scaling == scaling:
            return
        factor = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * factor
        if self._dual_win is not None:
            self._dual_win = self._dual_win / factor
        self._scaling = scaling

    # ------------------------------------------------------- transforms
    def _phase_factor(self, inverse: bool, device):
        """Per-bin factor of scipy's pre-FFT circular roll by -(phase_shift +
        m_num_mid): fft(roll(v, -s))[k] = fft(v)[k] exp(2j pi k s / mfft)."""
        if self._phase_shift is None:
            return None
        shift = (self._phase_shift + self.m_num_mid) % self.m_num
        if shift == 0:
            return None
        if self.onesided_fft:
            k = np.arange(self.mfft // 2 + 1)
        elif self._fft_mode == "centered":
            k = np.fft.fftshift(np.fft.fftfreq(self.mfft) * self.mfft)
        else:
            k = np.fft.fftfreq(self.mfft) * self.mfft
        sign = -1.0 if inverse else 1.0
        return torch.as_tensor(np.exp(sign * 2j * np.pi * k * shift / self.mfft), device=device)

    def _onesided2x(self, inverse: bool, device):
        """The per-bin factor of fft_mode 'onesided2X' (its inverse when
        `inverse`): sqrt(2) ('psd') or 2 on the bins but DC and Nyquist."""
        factor = math.sqrt(2) if self._scaling == "psd" else 2.0
        stop = self.mfft // 2 + 1 - (1 if self.mfft % 2 == 0 else 0)
        scale_vec = np.ones(self.f_pts)
        scale_vec[1:stop] = 1.0 / factor if inverse else factor
        return torch.as_tensor(scale_vec, device=device)

    def _pad_signal(self, x, k0: int, k1: int, padding: str):
        """x (last axis) cut or extended to cover samples [k0, k1)."""
        if padding not in _PAD_MODES:
            raise ValueError(f"Parameter padding={padding!r} not in {_PAD_MODES}!")
        n = x.shape[-1]
        lo, hi = max(-k0, 0), max(k1 - n, 0)
        core = x[..., max(k0, 0): min(k1, n)]
        if lo == 0 and hi == 0:
            return core
        if padding == "zeros":
            return torch.nn.functional.pad(core, (lo, hi))
        if padding in ("edge", "even"):
            idx = np.pad(np.arange(core.shape[-1]), (lo, hi),
                         mode="edge" if padding == "edge" else "reflect")
            return core.index_select(-1, torch.as_tensor(idx, device=x.device))
        # odd reflection: 2 * edge - the mirrored values
        parts = [core]
        if lo:
            parts.insert(0, 2 * core[..., :1] - core[..., 1: lo + 1].flip(-1))
        if hi:
            parts.append(2 * core[..., -1:] - core[..., -hi - 1: -1].flip(-1))
        return torch.cat(parts, dim=-1)

    def stft(self, x, p0=None, p1=None, *, k_offset: int = 0, padding: str = "zeros",
             axis: int = -1):
        """Short-time FFT: complex (..., f_pts, slices) with the frequency
        axis at `axis` (the slices always last), scipy semantics."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset, padding=padding, axis=axis)

    def _kernel_route(self, x, detr) -> bool:
        """Whether the one-sided forward transform is `framed_dft`."""
        method = getattr(self, "fft_method", "auto")
        if method not in ("auto", "fft", "matmul"):
            raise ValueError(f"fft_method must be 'auto', 'fft' or 'matmul', got {method!r}")
        takes = (detr is None and not np.iscomplexobj(self._win) and not x.is_complex()
                 and fft_kernel_takes(self.mfft))
        if method == "matmul":
            return takes
        return (method == "auto" and takes and x.is_cuda and x.dtype == torch.float32
                and _card_takes_kernel(self.mfft))

    def stft_detrend(self, x, detr, p0=None, p1=None, *, k_offset: int = 0,
                     padding: str = "zeros", axis: int = -1):
        """STFT with an optional per-slice detrend ('constant', 'linear', or
        a callable on the last axis of the frame matrix)."""
        x = as_signal(x)
        if self.onesided_fft and x.is_complex():
            raise ValueError(f"Complex-valued `x` not allowed for fft_mode={self._fft_mode!r}! "
                             "Set fft_mode to 'twosided' or 'centered'.")
        n = x.shape[axis]
        if n < self.m_num - self.m_num_mid:
            raise ValueError("signal length along axis must be >= ceil(m_num/2) = "
                             f"{self.m_num - self.m_num_mid}")
        ndim = x.ndim
        x = x.movedim(axis, -1)
        p0, p1 = self.p_range(n, p0, p1)
        k_lo = p0 * self._hop - self.m_num_mid + k_offset
        k_hi = (p1 - 1) * self._hop - self.m_num_mid + self.m_num + k_offset
        ext = self._pad_signal(x, k_lo, k_hi, padding)
        if self.onesided_fft and self._kernel_route(ext, detr):
            spec = framed_dft(ext, self._win.astype(np.float64), stride=self._hop,
                              n_fft=self.mfft, onesided=True)
        else:
            frames = as_windowed(ext, window_length=self.m_num, stride=self._hop)
            if detr is not None:
                if isinstance(detr, str):
                    from nx_signal_tpu_torch.ops.filters import detrend as _detrend

                    frames = _detrend(frames, type=detr)
                elif callable(detr):
                    frames = detr(frames)
                else:
                    raise ValueError(f"Parameter detr={detr!r} is not a str, function or None!")
            real = frames.real.dtype if frames.is_complex() else frames.dtype
            if not real.is_floating_point:
                real = torch.float32
            win = torch.as_tensor(np.conj(self._win), device=x.device)
            v = frames * win.to(win.dtype if win.is_complex() else real)
            if self.onesided_fft:
                spec = torch.fft.rfft(v, n=self.mfft, dim=-1)
            else:
                spec = torch.fft.fft(v, n=self.mfft, dim=-1)
                if self._fft_mode == "centered":
                    spec = torch.fft.fftshift(spec, dim=-1)
        if self._fft_mode == "onesided2X":
            spec = spec * self._onesided2x(False, x.device).to(spec.real.dtype)
        phase = self._phase_factor(False, x.device)
        if phase is not None:
            spec = spec * phase.to(spec.dtype)
        spec = spec.transpose(-1, -2)  # (..., f_pts, slices)
        if ndim > 1:
            spec = spec.movedim(-2, axis if axis >= 0 else axis - 1)
        return spec

    def spectrogram(self, x, y=None, *, p0=None, p1=None, k_offset: int = 0,
                    padding: str = "zeros", axis: int = -1):
        """S_x = x's STFT times conj(y's) (|S_x|^2 when y is None), scipy
        semantics."""
        s_x = self.stft(x, p0, p1, k_offset=k_offset, padding=padding, axis=axis)
        if y is None:
            return s_x.real ** 2 + s_x.imag ** 2
        s_y = self.stft(y, p0, p1, k_offset=k_offset, padding=padding, axis=axis)
        return s_x * torch.conj(s_y)

    def _synthesis_frames(self, s):
        """(..., slices, m_num) time frames of the (..., f_pts, slices)
        spectrum: an inverse FFT per slice (the phase factor and the
        'onesided2X' scale undone), times the dual window; what `istft`
        overlap-adds."""
        spec = s.transpose(-1, -2)  # (..., slices, f_pts)
        if not spec.is_complex():
            spec = spec.to(torch.complex64)
        phase = self._phase_factor(True, s.device)
        if phase is not None:
            spec = spec * phase.to(spec.dtype)
        if self.onesided_fft:
            if self._fft_mode == "onesided2X":
                spec = spec * self._onesided2x(True, s.device).to(spec.real.dtype)
            frames = torch.fft.irfft(spec, n=self.mfft, dim=-1)
        elif self._fft_mode == "centered":
            frames = torch.fft.ifft(torch.fft.ifftshift(spec, dim=-1), n=self.mfft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, n=self.mfft, dim=-1)
        dual = torch.as_tensor(self.dual_win, device=s.device)
        real = frames.real.dtype if frames.is_complex() else frames.dtype
        return frames[..., :self.m_num] * dual.to(dual.dtype if dual.is_complex() else real)

    def istft(self, s, k0: int = 0, k1: int = None, *, f_axis: int = -2, t_axis: int = -1):
        """Inverse STFT over samples [k0, k1) by the dual window's
        deterministic overlap-add, scipy semantics: `s` starts at slice
        p_min (the whole output of stft())."""
        s = as_signal(s)
        if f_axis == t_axis:
            raise ValueError(f"f_axis={f_axis} may not equal t_axis={t_axis}!")
        if s.shape[f_axis] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={s.shape[f_axis]} must equal "
                             f"f_pts={self.f_pts} (S.shape={tuple(s.shape)})!")
        n_min = self.m_num - self.m_num_mid
        q_num = self.p_num(n_min)
        if s.shape[t_axis] < q_num:
            raise ValueError(f"S.shape[t_axis]={s.shape[t_axis]} needs at least {q_num} "
                             f"slices (S.shape={tuple(s.shape)})!")
        fa, ta = f_axis % s.ndim, t_axis % s.ndim
        moved = (fa, ta) != (s.ndim - 2, s.ndim - 1)
        if moved:
            s = s.movedim((fa, ta), (-2, -1))
        q_max = s.shape[-1] + self.p_min
        k_max = (q_max - 1) * self._hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"(k_min={self.k_min}) <= (k0={k0}) < (k1={k1}) <= "
                             f"(k_max={k_max}) is false!")
        if k1 - k0 < n_min:
            raise ValueError(f"(k1={k1}) - (k0={k0}) = {k1 - k0} has to be at least half the "
                             f"window length {n_min}!")

        frames = self._synthesis_frames(s)
        # overlap-add of every slice on the full grid, then samples [k0, k1)
        full_len = (s.shape[-1] - 1) * self._hop + self.m_num
        acc = _ola_fold(frames, self._hop, full_len)
        grid0 = self.p_min * self._hop - self.m_num_mid  # the sample of acc[0]
        out = acc[..., k0 - grid0: k1 - grid0]
        if moved:
            out = out.movedim(-1, fa if fa < out.ndim else ta)
        return out

    def extent(self, n: int, axes_seq: str = "tf", center_bins: bool = False):
        """(t0, t1, f0, f1) plot extent, scipy semantics."""
        if axes_seq not in ("tf", "ft"):
            raise ValueError(f"Parameter axes_seq={axes_seq!r} not in ['tf', 'ft']!")
        if self._fft_mode in ("twosided", "centered"):
            q0 = -self.mfft // 2
            q1 = self.mfft + q0
        else:
            q0, q1 = 0, self.f_pts
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = self.delta_t * (p0 - 0.5), self.delta_t * (p1 - 0.5)
            f0, f1 = self.delta_f * (q0 - 0.5), self.delta_f * (q1 - 0.5)
        else:
            t0, t1 = self.delta_t * p0, self.delta_t * p1
            f0, f1 = self.delta_f * q0, self.delta_f * q1
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)
