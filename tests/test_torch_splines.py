"""Parity of the port's B-spline family (nx_signal_tpu_torch/ops/splines.py)
with the JAX package's, on the CPU, with the same numpy inputs made from a
seed: float64 signals at 1e-7 (both run the same recursions and full
closed-form mirror sums; the port's `lfilter` / `sosfilt` chunked form
against the JAX package's scans), float32 signals at 1e-5 of the max.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import splines as js
from nx_signal_tpu_torch.ops import splines as ts

_RNG = np.random.default_rng(7)
X1 = _RNG.normal(size=(3, 150))
IMG = _RNG.normal(size=(48, 48))  # square: both passes share one shape


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol=1e-7):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_basis_functions_match_jax():
    x = np.linspace(-3, 3, 61)
    for n in (1, 3, 5):
        close(ts.gauss_spline(T(x), n), js.gauss_spline(x, n))
    close(ts.cubic_bspline(T(x)), js.cubic_bspline(x))
    close(ts.quadratic_bspline(T(x)), js.quadratic_bspline(x))
    assert ts.cubic_bspline(T(x.astype(np.float32))).dtype == torch.float32


@pytest.mark.parametrize("c0,z1", [(1.0, 0.5), (2.5, -0.3), (0.7, 0.8)])
def test_symiirorder1_matches_jax(c0, z1):
    close(ts.symiirorder1(T(X1), c0, z1), js.symiirorder1(X1, c0, z1))


@pytest.mark.parametrize("r,omega", [(0.5, 0.3), (0.3, 1.1), (0.7, 0.05)])
def test_symiirorder2_matches_jax(r, omega):
    close(ts.symiirorder2(T(X1), r, omega), js.symiirorder2(X1, r, omega))


@pytest.mark.parametrize("name,args", [("symiirorder1", (2.5, -0.3)), ("symiirorder2", (0.5, 0.3)),
                                       ("cspline1d", (2.0,)), ("qspline1d", ())])
def test_float32_signals_match_jax(name, args):
    x32 = X1.astype(np.float32)
    got = getattr(ts, name)(T(x32), *args)
    assert got.dtype == torch.float32
    want = np.asarray(getattr(js, name)(x32, *args))
    close(got, want, 1e-5 * np.abs(want).max())


def test_symiir_errors_match_jax():
    with pytest.raises(ValueError, match="z1"):
        ts.symiirorder1(T(np.zeros(10)), 1.0, 1.5)
    with pytest.raises(ValueError, match="converge"):
        ts.symiirorder1(T(np.zeros(4)), 1.0, 0.99999)
    with pytest.raises(ValueError, match="r must be"):
        ts.symiirorder2(T(np.zeros(10)), 1.2, 0.3)


@pytest.mark.parametrize("name,lamb", [("cspline1d", 0.0), ("cspline1d", 2.0),
                                       ("qspline1d", 0.0)])
def test_spline1d_matches_jax(name, lamb):
    close(getattr(ts, name)(T(X1), lamb), getattr(js, name)(X1, lamb))
    close(getattr(ts, name)(T(X1[0, :1]), lamb) if lamb == 0.0 else torch.zeros(1),
          getattr(js, name)(X1[0, :1], lamb) if lamb == 0.0 else np.zeros(1))
    with pytest.raises(ValueError, match="lambda must be zero"):
        ts.qspline1d(T(X1), 1.0)


@pytest.mark.parametrize("name", ["cspline1d_eval", "qspline1d_eval"])
@pytest.mark.parametrize("dx,x0", [(1.0, 0), (1.75, 2.0)])
def test_spline_eval_matches_jax(name, dx, x0):
    cj = sps.cspline1d(X1[0])
    newx = np.linspace(-5, 160, 257)  # mirror regions on both sides
    close(getattr(ts, name)(T(cj), T(newx), dx, x0), getattr(js, name)(cj, newx, dx, x0))
    close(getattr(ts, name)(T(cj), newx[:5], dx, x0), getattr(js, name)(cj, newx[:5], dx, x0))


@pytest.mark.parametrize("hrow,hcol", [
    ([1.0, 4.0, 1.0], [1.0, 4.0, 1.0]), ([0.25, 0.5, 1.0, 0.5, 0.25], [1.0, 4.0, 1.0]),
    ([1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0], [1.0]), (np.ones(61), [0.5, 1.0, 0.5])])
def test_sepfir2d_matches_jax(hrow, hcol):
    """Taps wider than the image (61 on 48 columns) take numpy's repeated
    'symmetric' reflection."""
    close(ts.sepfir2d(T(IMG), hrow, hcol), js.sepfir2d(IMG, hrow, hcol))
    with pytest.raises(ValueError, match="odd length"):
        ts.sepfir2d(T(IMG), [1.0, 1.0], hcol)
    with pytest.raises(ValueError, match="2-D"):
        ts.sepfir2d(T(X1[0]), hrow, hcol)


@pytest.mark.parametrize("name,lamb,precision", [
    ("cspline2d", 0.0, -1.0), ("cspline2d", 3.0, -1.0), ("cspline2d", 3.0, 1e-9),
    ("qspline2d", 0.0, -1.0)])
def test_spline2d_matches_jax(name, lamb, precision):
    close(getattr(ts, name)(T(IMG), lamb, precision), getattr(js, name)(IMG, lamb, precision))


def test_spline_filter_matches_jax():
    x = np.eye(48)
    x[12, :] = 1.0
    for img, lmbda in ((x, 0.1), (IMG, 5.0)):
        got = ts.spline_filter(T(img), lmbda)
        assert got.dtype == torch.float64
        close(got, js.spline_filter(img, lmbda))
    with pytest.raises(TypeError, match="Invalid data type"):
        ts.spline_filter(T(np.ones((24, 24), np.int64)))
    with pytest.raises(ValueError, match="negative or zero"):
        ts.qspline2d(T(IMG), 1.0)
