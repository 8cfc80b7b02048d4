"""Waveform generators (counterpart of nx_signal_tpu/ops/waveforms.py),
scipy.signal semantics: sawtooth, square, gaussian_pulse / gausspulse,
chirp, polynomial_sweep / sweep_poly, unit_impulse and sinc.

Each generator is an elementwise map of a time signal `t`, which goes
through `utils.devices.as_signal` (a tensor stays on its device, anything
else goes to the card); integer times become float32. The arithmetic is
the JAX package's, in the signal's dtype and in its order: a float32
`chirp` accumulates its phase in float32, so over long signals it drifts
from a float64 chirp exactly as the reference does (ROADMAP.md, queue 3,
"chirp's f32 phase"). The periodic waveforms reduce the time with
`torch.remainder`, which takes the divisor's sign, as `jnp.mod` does.
`unit_impulse` is built from a shape, on the card unless `device=` says
otherwise, as the windows are (`utils.devices.target_device`).
"""

import math
from typing import NamedTuple

import torch

from nx_signal_tpu_torch.kernels.dft import _exact_f32
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = [
    "sawtooth",
    "square",
    "gaussian_pulse",
    "gausspulse",
    "GaussianPulse",
    "chirp",
    "polynomial_sweep",
    "sweep_poly",
    "unit_impulse",
    "sinc",
]

_TWO_PI = 2.0 * math.pi


def _as_float(t) -> torch.Tensor:
    """The time signal as a tensor (`as_signal`), integers as float32."""
    t = as_signal(t)
    if not (t.dtype.is_floating_point or t.dtype.is_complex):
        t = t.to(DEFAULT_FLOAT)
    return t


def sawtooth(t, *, width: float = 1.0):
    """Periodic sawtooth with period 2*pi: rises -1 -> 1 over [0, 2*pi*width],
    falls back over the rest.

    Examples:

    >>> import math, torch
    >>> from nx_signal_tpu_torch.ops.waveforms import sawtooth
    >>> t = torch.tensor([0.0, math.pi / 2, math.pi, 3 * math.pi / 2])
    >>> sawtooth(t).numpy().round(4)
    array([-1. , -0.5,  0. ,  0.5], dtype=float32)
    """
    if not 0 <= width <= 1:
        raise ValueError(f"width must be between 0 and 1, inclusive. Got: {width}")
    t = _as_float(t)
    tmod = torch.remainder(t, _TWO_PI)
    if width == 1:
        return tmod / (math.pi * width) - 1.0
    if width == 0:
        return (math.pi * (width + 1.0) - tmod) / (math.pi * (1.0 - width))
    return torch.where(
        tmod < _TWO_PI * width,
        tmod / (math.pi * width) - 1.0,
        (math.pi * (width + 1.0) - tmod) / (math.pi * (1.0 - width)),
    )


def square(t, *, duty=0.5):
    """Periodic square wave with period 2*pi: +1 while t mod 2*pi <
    2*pi*duty, else -1. `duty` may be an array for a time-varying duty
    cycle. Returns int32 (+1 / -1).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import square
    >>> square(torch.tensor([0.0, 1.0, 2.0, 3.5, 5.0]))
    tensor([ 1,  1,  1, -1, -1], dtype=torch.int32)
    """
    t = _as_float(t)
    if not isinstance(duty, (int, float)):
        duty = torch.as_tensor(duty, device=t.device)
    tmod = torch.remainder(t, _TWO_PI)
    one = torch.ones((), dtype=torch.int32, device=t.device)
    return torch.where(tmod < duty * _TWO_PI, one, -one)


class GaussianPulse(NamedTuple):
    envelope: torch.Tensor
    in_phase: torch.Tensor
    quadrature: torch.Tensor


def _gauss_coefficient(fc, bw, bwr) -> float:
    ref = 10.0 ** (bwr / 20.0)
    return -((math.pi * fc * bw) ** 2) / (4.0 * math.log(ref))


def gaussian_pulse(t, *, center_frequency: float = 1000.0, bandwidth: float = 0.5,
                   bandwidth_reference_level: float = -6.0):
    """Gaussian-modulated sinusoid e^{-a t^2} (cos, sin)(2 pi fc t); returns
    GaussianPulse(envelope, in_phase, quadrature).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import gaussian_pulse
    >>> out = gaussian_pulse(torch.tensor([-0.001, 0.0, 0.001]), center_frequency=1000.0)
    >>> torch.stack(out[:2]).numpy().round(4)
    array([[0.4094, 1.    , 0.4094],
           [0.4094, 1.    , 0.4094]], dtype=float32)
    """
    fc, bw, bwr = center_frequency, bandwidth, bandwidth_reference_level
    if fc < 0:
        raise ValueError(f"Center frequency must be greater than or equal to 0, got: {fc}")
    if bw <= 0:
        raise ValueError(f"Bandwidth must be greater than 0, got: {bw}")
    if bwr >= 0:
        raise ValueError(f"Bandwidth reference level must be less than 0, got: {bwr}")
    t = _as_float(t)
    a = _gauss_coefficient(fc, bw, bwr)
    envelope = torch.exp(-a * t * t)
    phase = _TWO_PI * fc * t
    return GaussianPulse(envelope, envelope * torch.cos(phase), envelope * torch.sin(phase))


def chirp(t, f0: float, t1: float, f1: float, *, method: str = "linear",
          phi: float = 0.0, vertex_zero: bool = True):
    """Swept-frequency cosine from f0 at t=0 to f1 at t=t1,
    scipy.signal.chirp semantics. Methods: 'linear', 'quadratic' (with
    `vertex_zero`), 'logarithmic' (NaN if f0*f1 <= 0), 'hyperbolic'. The
    phase is computed in the signal's dtype, in the JAX package's order.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import chirp
    >>> chirp(torch.arange(4) / 4.0, f0=1.0, t1=1.0, f1=2.0).numpy().round(4)
    array([ 1.    , -0.1951, -0.7071,  0.9808], dtype=float32)
    """
    t = _as_float(t)
    if method == "linear":
        beta = (f1 - f0) / t1
        phase = _TWO_PI * (f0 * t + 0.5 * beta * t * t)
    elif method == "quadratic":
        beta = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            phase = _TWO_PI * (f0 * t + beta * t**3 / 3.0)
        else:
            phase = _TWO_PI * (f1 * t + beta * ((t1 - t) ** 3 - t1**3) / 3.0)
    elif method == "logarithmic":
        if f0 * f1 <= 0:
            return torch.full(t.shape, math.nan, dtype=t.dtype, device=t.device)
        if f0 == f1:
            phase = _TWO_PI * f0 * t
        else:
            beta = t1 / math.log(f1 / f0)
            phase = _TWO_PI * beta * f0 * ((f1 / f0) ** (t / t1) - 1.0)
    elif method == "hyperbolic":
        if f0 == f1:
            phase = _TWO_PI * f0 * t
        else:
            singular = -f1 * t1 / (f0 - f1)
            phase = _TWO_PI * (-singular * f0) * torch.log(torch.abs(1.0 - t / singular))
    else:
        raise ValueError(
            "invalid method, must be one of ['linear', 'quadratic', 'logarithmic', "
            f"'hyperbolic'], got: {method}"
        )
    return torch.cos(phase + phi)


def polynomial_sweep(t, coefs, *, phi: float = 0.0, phi_unit: str = "radians"):
    """Cosine whose instantaneous frequency is the polynomial `coefs`
    (highest power first), integrated analytically; scipy.signal.sweep_poly
    semantics with `phi` in `phi_unit`. `t` is 1-D; the phase is one exact
    (no TF32) product of the integrated coefficients with the powers of t.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import polynomial_sweep
    >>> polynomial_sweep(torch.tensor([0.0, 0.5, 1.0]), [2.0, 1.0]).numpy().round(4)
    array([1., 0., 1.], dtype=float32)
    """
    t = _as_float(t)
    coefs = torch.as_tensor(coefs, device=t.device).to(t.dtype).reshape(-1)
    n = coefs.shape[0]
    powers = n - torch.arange(n, dtype=t.dtype, device=t.device)  # n, n-1, ..., 1
    t_poly = t[None, :] ** powers[:, None]
    with _exact_f32():
        phase = (coefs / powers) @ t_poly
    if phi_unit == "degrees":
        phi = phi * math.pi / 180.0
    elif phi_unit != "radians":
        raise ValueError(f"phi_unit must be 'radians' or 'degrees', got: {phi_unit}")
    return torch.cos(_TWO_PI * phase + phi)


def sweep_poly(t, poly, phi: float = 0.0):
    """scipy.signal.sweep_poly spelling of `polynomial_sweep`: `poly` is a
    coefficient sequence (highest power first) or np.poly1d, `phi` is in
    degrees.

    Examples:

    Instantaneous frequency 2t + 1: the phase crosses whole cycles at t=0.5, 1:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import sweep_poly
    >>> sweep_poly(torch.tensor([0.0, 0.5, 1.0]), [2.0, 1.0]).numpy().round(4)
    array([1., 0., 1.], dtype=float32)
    """
    coefs = getattr(poly, "coefficients", poly)
    return polynomial_sweep(t, coefs, phi=phi, phi_unit="degrees")


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               tpr: float = -60.0, retquad: bool = False, retenv: bool = False):
    """scipy.signal.gausspulse spelling of `gaussian_pulse`: the in-phase
    component, then the quadrature and/or the envelope if asked; t='cutoff'
    returns the time (a float) where the envelope falls to `tpr` dB.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import gausspulse
    >>> gausspulse(torch.linspace(-0.5, 0.5, 5), fc=2.0).numpy().round(4)
    array([ 0.4094, -0.7999,  1.    , -0.7999,  0.4094], dtype=float32)
    """
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError(f"If t is a string, it must be 'cutoff', got: {t}")
        if bwr >= 0:
            raise ValueError(f"Bandwidth reference level must be less than 0, got: {bwr}")
        tref = 10.0 ** (tpr / 20.0)
        return math.sqrt(-math.log(tref) / _gauss_coefficient(fc, bw, bwr))
    pulse = gaussian_pulse(t, center_frequency=fc, bandwidth=bw, bandwidth_reference_level=bwr)
    out = [pulse.in_phase]
    if retquad:
        out.append(pulse.quadrature)
    if retenv:
        out.append(pulse.envelope)
    return out[0] if len(out) == 1 else tuple(out)


def unit_impulse(shape, *, index=0, dtype=DEFAULT_FLOAT, device=None):
    """Delta function: 1 at `index` (an int, an index tuple or array, or
    'midpoint'), 0 elsewhere, built on `device` (None: the card). An
    index past the shape sets nothing, as in the JAX package.

    Examples:

    >>> from nx_signal_tpu_torch.ops.waveforms import unit_impulse
    >>> unit_impulse(5, index=2, device="cpu")
    tensor([0., 0., 1., 0., 0.])
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(d) for d in shape)
    if isinstance(index, str):
        if index != "midpoint":
            raise ValueError(f"index must be an int, tuple, array or 'midpoint', got: {index}")
        idx = tuple(d // 2 for d in shape)
    else:
        idx = tuple(int(i) for i in torch.as_tensor(index).reshape(len(shape)).tolist())
    out = torch.zeros(shape, dtype=dtype, device=target_device(device))
    if all(-d <= i < d for i, d in zip(idx, shape)):
        out[idx] = 1
    return out


def sinc(t):
    """Normalized sinc(t) = sin(pi t) / (pi t) with sinc(0) = 1; integer
    input is promoted to float32.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import sinc
    >>> sinc(torch.tensor([0.0, 0.5, 1.0])).numpy().round(4)
    array([ 1.    ,  0.6366, -0.    ], dtype=float32)
    """
    t = _as_float(t)
    x = t * math.pi
    one = torch.ones((), dtype=t.dtype, device=t.device)
    # substitute 1 where x == 0 before dividing, so no NaN is formed
    safe = torch.where(x == 0, one, x)
    return torch.where(x == 0, one, torch.sin(safe) / safe)
