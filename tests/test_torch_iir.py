"""Parity of the port's IIR filtering (nx_signal_tpu_torch/ops/iir.py) with
the JAX package's (nx_signal_tpu/ops/iir.py), on the CPU, with the same
numpy inputs and coefficients.

Tolerances: f64 signals at the JAX package's gates (tests/test_iir.py),
1e-9 absolute and 1e-7 relative (the two packages sum the recurrence in
another order: a log-depth scan or `lax.scan` there, the chunked Toeplitz
form or an f64 step per sample here); float32 signals within 1e-4 of the
max of the JAX package's f64 result (the port computes orders <= 2 in
float32, the JAX package under x64 in f64). The host design math
(lfilter_zi, lfiltic, sosfilt_zi) 1e-12.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import iir as ji
from nx_signal_tpu_torch.ops import convolution as tc
from nx_signal_tpu_torch.ops import iir as ti

DESIGNS = {
    "order1": lambda: sps.butter(1, 0.4),
    "order2": lambda: sps.butter(2, 0.3),
    "order2_double_pole": lambda: ([0.25, 0.0, 0.0], [1.0, -1.8, 0.81]),
    "order4": lambda: sps.cheby1(4, 1.0, 0.35),
    "order6": lambda: sps.butter(6, 0.2),
    # poles clustered near the unit circle: the per-sample f64 form
    "butter8_0.05": lambda: sps.butter(8, 0.05),
    "ellip8": lambda: sps.ellip(8, 0.5, 60, 0.15),
}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def f64_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-7)


def f32_close(got, want):
    assert got.dtype == torch.float32
    got, want = got.numpy().astype(np.float64), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("design", DESIGNS, ids=str)
def test_lfilter_matches_jax(design, rng):
    b, a = DESIGNS[design]()
    x = rng.normal(size=(3, 400))
    want = ji.lfilter(b, a, jnp.asarray(x))
    f64_close(ti.lfilter(b, a, T(x)), want)
    f32_close(ti.lfilter(b, a, T(x.astype(np.float32))), want)


def _lfilter_extended(b, a, x):
    """The direct-form recurrence in numpy's long double (64-bit mantissa
    on x86-64), from the same f64 coefficients."""
    ld = np.longdouble
    b, a = np.asarray(b, ld) / ld(a[0]), np.asarray(a, ld) / ld(a[0])
    x = x.astype(ld)
    v = np.zeros_like(x)
    for j in range(len(b)):
        v[..., j:] += b[j] * x[..., :x.shape[-1] - j]
    y = np.zeros_like(x)
    for t in range(x.shape[-1]):
        acc = v[..., t].copy()
        for i in range(1, min(len(a) - 1, t) + 1):
            acc -= a[i] * y[..., t - i]
        y[..., t] = acc
    return y.astype(np.float64)


@pytest.mark.parametrize("design", ["butter8_0.05", "ellip8"])
@pytest.mark.parametrize("length", [1000, 3000])
def test_high_order_ba_is_as_close_to_exact_as_jax(design, length, rng):
    """Orders above 2 with poles clustered near the unit circle, longer
    than the JAX package's 400 samples: there two f64 recurrences that sum
    in another order differ by more than 1e-9 (the JAX package's own
    distance from the long-double recurrence reaches 2e-9 at butter(8,
    0.05)). The port's per-sample f64 form stays within twice the JAX
    package's distance from the long-double result, and 1e-4 of the max in
    float32."""
    b, a = DESIGNS[design]()
    x = rng.normal(size=(2, length))
    exact = _lfilter_extended(b, a, x)
    jax_err = np.abs(np.asarray(ji.lfilter(b, a, jnp.asarray(x))) - exact).max()
    port_err = np.abs(ti.lfilter(b, a, T(x)).numpy() - exact).max()
    assert port_err <= 2 * jax_err + 1e-12
    f32_close(ti.lfilter(b, a, T(x.astype(np.float32))), exact)


@pytest.mark.parametrize("design", ["order2", "order4", "ellip8"])
def test_lfilter_zi_and_zf_match_jax(design, rng):
    b, a = DESIGNS[design]()
    n = len(a) - 1
    x = rng.normal(size=(3, 100))
    zi = np.broadcast_to(ti.lfilter_zi(b, a), (3, n)) * x[:, :1]
    y1, zf1 = ti.lfilter(b, a, T(x), zi=zi)
    y2, zf2 = ji.lfilter(b, a, jnp.asarray(x), zi=zi)
    f64_close(y1, y2)
    f64_close(zf1, zf2)
    y3, zf3 = ti.lfilter(b, a, T(x.astype(np.float32)), zi=zi)  # the same f64 zi
    f32_close(y3, y2)
    f32_close(zf3, zf2)


@pytest.mark.parametrize("design", ["order2", "order4"])
def test_streaming_chunks_equal_whole(design, rng):
    """Carrying zf across chunks reproduces the one-shot filter."""
    b, a = DESIGNS[design]()
    x = rng.normal(size=256)
    whole = ti.lfilter(b, a, T(x))
    z = np.zeros(len(a) - 1)
    parts = []
    for chunk in np.split(x, [50, 100, 180]):
        y, z = ti.lfilter(b, a, T(chunk), zi=z)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts), whole.numpy(), atol=1e-10, rtol=1e-8)
    f64_close(whole, ji.lfilter(b, a, jnp.asarray(x)))


@pytest.mark.parametrize("order,length", [(5, 3), (2, 1), (2, 2)])
def test_signal_shorter_than_the_order(order, length, rng):
    """The zi carries over into zf (the closed form's short-signal term)."""
    b, a = sps.butter(order, 0.3)
    x = rng.normal(size=length)
    zi = rng.normal(size=order)
    y1, zf1 = ti.lfilter(b, a, T(x), zi=zi)
    y2, zf2 = ji.lfilter(b, a, jnp.asarray(x), zi=zi)
    f64_close(y1, y2)
    f64_close(zf1, zf2)


@pytest.mark.parametrize("order", [2, 3])
def test_axis_and_batching(order, rng):
    b, a = sps.butter(order, 0.3)
    x = rng.normal(size=(6, 64, 3))
    f64_close(ti.lfilter(b, a, T(x), axis=1), ji.lfilter(b, a, jnp.asarray(x), axis=1))
    x = rng.normal(size=(4, 5, 128))
    f64_close(ti.lfilter(b, a, T(x)), ji.lfilter(b, a, jnp.asarray(x)))
    x = rng.normal(size=(6, 40, 3))
    zi = rng.normal(size=(6, order, 3))
    y1, zf1 = ti.lfilter(b, a, T(x), axis=1, zi=zi)
    y2, zf2 = ji.lfilter(b, a, jnp.asarray(x), axis=1, zi=zi)
    f64_close(y1, y2)
    f64_close(zf1, zf2)


def test_fir_only_and_complex(rng):
    b = sps.firwin(31, 0.4)
    x = rng.normal(size=200)
    f64_close(ti.lfilter(b, [1.0], T(x)), ji.lfilter(b, [1.0], jnp.asarray(x)))
    xc = x + 1j * rng.normal(size=200)
    bc, ac = [1.0, 0.5j], [1.0, -0.3 + 0.4j, 0.1]
    f64_close(ti.lfilter(bc, ac, T(xc)), ji.lfilter(bc, ac, jnp.asarray(xc)))


def test_dtype_rule(rng):
    """float32 at least; f64 stays f64; coefficient tensors join the
    promotion, numpy coefficients do not widen the signal."""
    b, a = sps.butter(2, 0.3)
    x = rng.normal(size=64)
    assert ti.lfilter(b, a, T(x.astype(np.float32))).dtype == torch.float32
    assert ti.lfilter(b, a, T(x.astype(np.int32))).dtype == torch.float32
    assert ti.lfilter(b, a, T(x)).dtype == torch.float64
    assert ti.lfilter(T(b), T(a), T(x.astype(np.float32))).dtype == torch.float64
    assert ti.sosfilt(sps.butter(4, 0.3, output="sos"), T(x.astype(np.float32))).dtype \
        == torch.float32


@pytest.mark.parametrize("design", ["order2", "order4", "ellip8"])
def test_state_helpers_match_jax(design):
    b, a = DESIGNS[design]()
    np.testing.assert_allclose(ti.lfilter_zi(b, a), ji.lfilter_zi(b, a), atol=1e-12, rtol=1e-12)
    y, x = [1.0, -0.5, 0.25], [0.3, 0.1]
    np.testing.assert_allclose(ti.lfiltic(b, a, y, x), ji.lfiltic(b, a, y, x), atol=1e-12,
                               rtol=1e-12)
    np.testing.assert_allclose(ti.lfiltic(b, a, y), ji.lfiltic(b, a, y), atol=1e-12)
    sos = sps.cheby1(6, 1.0, 0.3, output="sos")
    np.testing.assert_allclose(ti.sosfilt_zi(sos), ji.sosfilt_zi(sos), atol=1e-12, rtol=1e-10)


def test_lfiltic_reproduces_the_past(rng):
    """lfiltic's zi continues a filter from its past inputs and outputs."""
    b, a = sps.butter(3, 0.25)
    x = rng.normal(size=80)
    y = ti.lfilter(b, a, T(x)).numpy()
    zi = ti.lfiltic(b, a, y[39::-1], x[39::-1])
    tail, _ = ti.lfilter(b, a, T(x[40:]), zi=zi)
    np.testing.assert_allclose(tail.numpy(), y[40:], atol=1e-10, rtol=1e-8)


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
@pytest.mark.parametrize("design", ["order2", "order4"])
def test_filtfilt_matches_jax(padtype, design, rng):
    b, a = DESIGNS[design]()
    x = rng.normal(size=(2, 300))
    want = ji.filtfilt(b, a, jnp.asarray(x), padtype=padtype)
    f64_close(ti.filtfilt(b, a, T(x), padtype=padtype), want)
    f32_close(ti.filtfilt(b, a, T(x.astype(np.float32)), padtype=padtype), want)


def test_filtfilt_axis_padlen_and_errors(rng):
    b, a = sps.butter(4, 0.25)
    x = rng.normal(size=(3, 250, 2))
    f64_close(ti.filtfilt(b, a, T(x), axis=1), ji.filtfilt(b, a, jnp.asarray(x), axis=1))
    f64_close(ti.filtfilt(b, a, T(x), axis=1, padlen=20),
              ji.filtfilt(b, a, jnp.asarray(x), axis=1, padlen=20))
    with pytest.raises(ValueError, match="padlen, which is 15"):
        ti.filtfilt(b, a, torch.zeros(10))
    with pytest.raises(ValueError, match="padtype"):
        ti.filtfilt(b, a, torch.zeros(100), padtype="wrap")


SOS = {
    "butter8": lambda: sps.butter(8, 0.3, output="sos"),
    "butter8_0.05": lambda: sps.butter(8, 0.05, output="sos"),
    "ellip8": lambda: sps.ellip(8, 0.5, 60, 0.15, output="sos"),
    "ellip16": lambda: sps.ellip(16, 0.5, 80.0, 0.3, output="sos"),
}


@pytest.mark.parametrize("design", SOS, ids=str)
def test_sosfilt_matches_jax(design, rng):
    sos = SOS[design]()
    x = rng.normal(size=(4, 700))
    want = ji.sosfilt(sos, jnp.asarray(x))
    f64_close(ti.sosfilt(sos, T(x)), want)
    f32_close(ti.sosfilt(sos, T(x.astype(np.float32))), want)
    np.testing.assert_allclose(ti.sosfilt(sos, T(x)).numpy(), sps.sosfilt(sos, x), atol=1e-9,
                               rtol=1e-7)


def test_sosfilt_zi_zf_axis_and_errors(rng):
    sos = sps.cheby1(6, 1.0, 0.3, output="sos")
    x = rng.normal(size=(200, 3))
    zi = sps.sosfilt_zi(sos)[:, None, :] * x[0][None, :, None]
    zi = zi.transpose(0, 2, 1)  # (sections, 2, 3): the state axis where x's time axis is
    y1, zf1 = ti.sosfilt(sos, T(x), axis=0, zi=zi)
    y2, zf2 = ji.sosfilt(sos, jnp.asarray(x), axis=0, zi=zi)
    f64_close(y1, y2)
    f64_close(zf1, zf2)
    with pytest.raises(ValueError, match="n_sections"):
        ti.sosfilt(np.zeros((2, 5)), torch.zeros(10))


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_sosfiltfilt_matches_jax(padtype, rng):
    sos = sps.butter(6, 0.2, output="sos")
    x = rng.normal(size=(2, 400))
    want = ji.sosfiltfilt(sos, jnp.asarray(x), padtype=padtype)
    f64_close(ti.sosfiltfilt(sos, T(x), padtype=padtype), want)
    f32_close(ti.sosfiltfilt(sos, T(x.astype(np.float32)), padtype=padtype), want)


def test_long_signal_chains_many_chunks(rng):
    """Thousands of chunks of the order <= 2 form (the doubling scan over
    chunks) against scipy f64 and the JAX package."""
    sos = sps.ellip(8, 0.5, 60, 0.15, output="sos")
    x = rng.normal(size=(2, 150_001))
    want = sps.sosfilt(sos, x)
    np.testing.assert_allclose(ti.sosfilt(sos, T(x)).numpy(), want, atol=1e-9, rtol=1e-7)
    f32_close(ti.sosfilt(sos, T(x.astype(np.float32))), want)


@pytest.mark.parametrize("num,den", [([1.0, 3.0, 3.0, 1.0], [1.0, 1.0]),
                                     ([2.0, 1.0, 0.5, 4.0, 1.0, 0.3], [2.0, -0.5, 0.25, 0.1])])
def test_deconvolve_runs_on_the_ports_lfilter(num, den, monkeypatch):
    """deconvolve's quotient is ops.iir.lfilter's impulse response (no
    scipy)."""
    calls = []
    real = tc.lfilter

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tc, "lfilter", spy)
    q, r = tc.deconvolve(torch.tensor(num), torch.tensor(den))
    assert calls
    want_q, want_r = sps.deconvolve(num, den)
    np.testing.assert_allclose(q.numpy(), want_q, atol=1e-5 * np.abs(want_q).max())
    np.testing.assert_allclose(r.numpy(), want_r, atol=1e-5 * np.abs(num).max())


REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_runs_without_scipy():
    """scipy is the tests' oracle, not a dependency: with every `import
    scipy` raising, the port imports, designs and filters, and no source
    line of it imports scipy."""
    for path in sorted((REPO / "nx_signal_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] == "scipy"), path
    code = (
        "import sys\n"
        "sys.modules['scipy'] = None\n"
        "import torch\n"
        "import nx_signal_tpu_torch as nt\n"
        "x = torch.randn(2, 3000, dtype=torch.float64)\n"
        "y = nt.sosfiltfilt(nt.butter(4, 0.2, output='sos'), nt.lfilter(*nt.cheby1(3, 1.0, 0.3), x))\n"
        "q, r = nt.deconvolve(torch.tensor([1.0, 3.0, 3.0, 1.0]), torch.tensor([1.0, 1.0]))\n"
        "h = nt.remez(21, [0, 0.2, 0.3, 0.5], [1, 0], sampling_rate=1.0, device='cpu')\n"
        "assert y.shape == x.shape and q.tolist() == [1.0, 2.0, 1.0] and h.shape == (21,)\n"
        "print('NO_SCIPY_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert "NO_SCIPY_OK" in proc.stdout
