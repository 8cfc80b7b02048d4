"""The benchmark's own filter and window designs, frozen in numpy f64
(scipy.signal's formulas), and the seeded inputs. The same float32 arrays
go to the program and to the reference, so neither side takes a number
that the other made."""

import numpy as np
import torch


def hann(n: int, periodic: bool = True) -> np.ndarray:
    """scipy.signal.windows.hann(n, sym=not periodic), f64."""
    m = n + 1 if periodic else n
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(m) / (m - 1)))[:n]


def hamming(n: int) -> np.ndarray:
    """scipy.signal.windows.hamming(n) (symmetric, as filter design takes it), f64."""
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


_WINDOWS = {"hann": hann, "hamming": lambda n, periodic=False: hamming(n)}


def lowpass_firwin(num_taps: int, cutoff_hz: float, sampling_rate: float,
                   window: str = "hamming") -> np.ndarray:
    """scipy.signal.firwin(num_taps, cutoff_hz, fs=sampling_rate, window=window)
    for one low-pass band, scaled to unit gain at DC, f64."""
    c = cutoff_hz / (sampling_rate / 2.0)
    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = c * np.sinc(c * m) * _WINDOWS[window](num_taps, periodic=False)
    return h / h.sum()


def taps_and_window(cfg: dict):
    """(taps, window) of a configuration as float32 numpy arrays (taps None
    for a configuration with no filter)."""
    win = cfg["window"]
    window = _WINDOWS[win["name"]](win["length"], periodic=win["periodic"]).astype(np.float32)
    fir = cfg.get("fir")
    taps = None if fir is None else lowpass_firwin(
        fir["taps"], fir["cutoff_hz"], cfg["sampling_rate"], fir["window"]).astype(np.float32)
    return taps, window


def signals(gen: torch.Generator, blocks: int, rows: int, samples: int, device):
    """`blocks` distinct (rows, samples) float32 blocks of unit white noise,
    drawn on `device` from `gen` in one call: the same seed gives the same
    blocks."""
    return torch.randn((blocks, rows, samples), generator=gen, device=device,
                       dtype=torch.float32)
