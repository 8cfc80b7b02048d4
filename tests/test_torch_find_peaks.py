"""Parity of the port's find_peaks, peak_prominences, peak_widths and
find_peaks_cwt (nx_signal_tpu_torch/ops/find_peaks.py) with the JAX
package's, on the CPU, with the same numpy inputs made from a seed.

Indices, counts and the integer properties are equal; the float
properties are held at the JAX tests' gate, 1e-4, and the sample-valued
ones (widths, crossings) at the float32 resolution of a position in the
signal (the port computes them in f64 from the float32 samples and rounds
once, the JAX package in float32). The distance
filter (rounds over the valid peaks, then the host scan after
`_MAX_ROUNDS`) keeps the JAX package's greedy set: ties among equal
heights, a ramp of peaks closer than `distance`, a capacity below the
count and plateaus. On long random walks the port's width decisions are
scipy's (`test_width_decisions_are_scipys_on_a_long_walk`).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import find_peaks as jfp
from nx_signal_tpu_torch.ops import find_peaks as tfp

# one length for every signal: the JAX package compiles each primitive once
# per shape, and the file's tests then share those compilations
N = 1200
_RNG = np.random.default_rng(0)
WALK = (np.cumsum(_RNG.normal(size=N)) + _RNG.normal(size=N)).astype(np.float32)
TIED = np.round(_RNG.normal(size=N) * 2).astype(np.float32)
SPIKES = np.zeros(N, np.float32)
SPIKES[5:N - 5:3] = 1.0  # equal heights 3 apart
RAMP = np.zeros(N, np.float32)
RAMP[1:N - 1:2] = np.arange(1, N // 2)  # rising peaks 2 apart
PLATEAUS = np.resize(np.array([0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 1, 1, 0, 2, 2, 2, 2, 0],
                              np.float32), N)
# positions past ~1000 keep three decimals in float32: the sample-valued
# properties (widths, interpolated crossings) are held at that resolution
POSITION_ATOL = N * 2.0 ** -22


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same_peaks(got, want):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices.dtype == torch.int32 and got.valid_count.dtype == torch.int32
    assert int(got.valid_count) == int(want.valid_count)
    assert set(got.properties) == set(want.properties)
    for key, w in want.properties.items():
        g, w = got.properties[key].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            atol = POSITION_ATOL if key in ("widths", "left_ips", "right_ips") else 1e-4
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("x,kwargs", [
    (WALK, {}),
    (WALK, dict(height=0.0, distance=20, prominence=1.0, width=2.0)),
    (WALK, dict(height=(None, 10.0), threshold=(0.1, 3.0), wlen=51, prominence=(1.0, 30.0),
                width=(1.0, 8.0), rel_height=0.7)),
    (WALK, dict(distance=30.5, max_peaks=100)),
    (WALK, dict(distance=7, max_peaks=40, height=0.0)),
    (TIED, dict(distance=3)),
    (TIED, dict(distance=7, prominence=2.0)),
    (SPIKES, dict(distance=5)),
    (SPIKES, dict(distance=4.5)),
    (SPIKES, dict(distance=7, width=0.5)),
    (RAMP, dict(distance=10)),
    (RAMP[::-1].copy(), dict(distance=10, height=100.0)),
    (PLATEAUS, dict(plateau_size=(2, None), distance=2)),
    (PLATEAUS, dict(plateau_size=3, threshold=0.5, prominence=0.5)),
], ids=["plain", "all", "intervals", "distance-cap", "cap-below-count", "ties-3",
        "ties-7-prom", "spikes-5", "spikes-4.5", "spikes-width", "ramp", "ramp-down",
        "plateaus", "plateau-size"])
def test_find_peaks_matches_jax(x, kwargs):
    same_peaks(tfp.find_peaks(T(x), **kwargs), jfp.find_peaks(x, **kwargs))


def test_array_conditions_match_jax():
    kwargs = dict(height=(np.linspace(-5.0, 5.0, N), None), threshold=np.full(N, 0.2),
                  distance=4)
    same_peaks(tfp.find_peaks(T(WALK), **kwargs), jfp.find_peaks(WALK, **kwargs))


def test_distance_filter_host_scan_after_the_round_cap(monkeypatch):
    """A ramp needs one round per kept peak: with the cap at 8 rounds the
    host scan finishes the undecided peaks, and the set is the JAX one."""
    monkeypatch.setattr(tfp, "_MAX_ROUNDS", 8)
    scans = []
    scan = tfp._scan_host
    monkeypatch.setattr(tfp, "_scan_host", lambda *a: scans.append(1) or scan(*a))
    same_peaks(tfp.find_peaks(T(RAMP), distance=10), jfp.find_peaks(RAMP, distance=10))
    assert scans == [1]


def test_distance_filter_runs_rounds_over_valid_peaks_only(monkeypatch):
    """The tied walk needs a few rounds (one sparse table each), not one
    step per slot as the JAX package's fori_loop."""
    tables = []
    build = tfp._range_max_tables
    monkeypatch.setattr(tfp, "_range_max_tables", lambda r: tables.append(r.shape[0]) or build(r))
    got = tfp.find_peaks(T(TIED), distance=7)
    count = int((tfp.find_peaks(T(TIED)).indices >= 0).sum())
    assert tables and all(size == count for size in tables)
    assert len(tables) <= 4 * tfp._ROUNDS_PER_CHECK
    assert int(got.valid_count) == int(jfp.find_peaks(TIED, distance=7).valid_count)


@pytest.mark.parametrize("wlen", [None, 2, 21, 100])
def test_prominences_and_widths_match_jax(wlen):
    found = np.asarray(jfp.find_peaks(WALK).indices)
    peaks = np.array([-1, *found[:3], *found[found >= 0][-2:], 17, 250, -1])  # -1 padded
    got = tfp.peak_prominences(T(WALK), peaks, wlen=wlen)
    want = jfp.peak_prominences(WALK, peaks, wlen=wlen)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for rel in (0.5, 1.0, 0.25):
        got = tfp.peak_widths(T(WALK), peaks, rel_height=rel, wlen=wlen)
        want = jfp.peak_widths(WALK, peaks, rel_height=rel, wlen=wlen)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=POSITION_ATOL)


def test_width_decisions_are_scipys_on_a_long_walk():
    """2^16 samples: the float32 crossings of the JAX package keep two
    decimals past sample 32 768, and the width condition follows them;
    the port's f64 properties give scipy's set and its values."""
    rng = np.random.default_rng(3)
    x = (np.cumsum(rng.normal(size=1 << 16)) + 2 * rng.normal(size=1 << 16)).astype(np.float32)
    kwargs = dict(height=float(np.median(x)), distance=50, prominence=1.0, width=1.0)
    got = tfp.find_peaks(T(x), **kwargs)
    want, props = sps.find_peaks(x.astype(np.float64), **kwargs)
    count = int(got.valid_count)
    np.testing.assert_array_equal(got.indices[:count].numpy(), want)
    scale = float(np.abs(x).max())
    for key, w in props.items():
        g = got.properties[key][:count].numpy()
        if key in ("left_bases", "right_bases"):
            np.testing.assert_array_equal(g, w)
        elif key in ("widths", "left_ips", "right_ips"):  # float32 positions
            np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale, err_msg=key)


def test_find_peaks_errors_match_jax():
    with pytest.raises(ValueError, match="1-D"):
        tfp.find_peaks(T(np.ones((2, 4))))
    with pytest.raises(ValueError, match="max_peaks"):
        tfp.find_peaks(T(WALK), max_peaks=0)
    with pytest.raises(ValueError, match="distance"):
        tfp.find_peaks(T(WALK), distance=0.5)
    with pytest.raises(ValueError, match="wlen"):
        tfp.peak_prominences(T(WALK), [3], wlen=1)
    with pytest.raises(ValueError, match="rel_height"):
        tfp.peak_widths(T(WALK), [3], rel_height=-1)
    with pytest.raises(ValueError, match="same length"):
        tfp.find_peaks(T(WALK), height=np.ones(5))
    with pytest.raises(ValueError, match="min, max"):
        tfp.find_peaks(T(WALK), height=(1.0, 2.0, 3.0))


@pytest.mark.parametrize("kwargs", [
    dict(widths=np.arange(1, 11)), dict(widths=np.arange(2, 9), min_snr=2.0, noise_perc=20),
    dict(widths=[1.0, 2.0, 4.0, 8.0], gap_thresh=2, min_length=2, window_size=50)])
def test_find_peaks_cwt_matches_jax(kwargs):
    x = WALK - np.convolve(WALK, np.ones(25) / 25, mode="same")
    got = tfp.find_peaks_cwt(T(x), **kwargs)
    want = jfp.find_peaks_cwt(x, **kwargs)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="nonempty"):
        tfp.find_peaks_cwt(x, [])
