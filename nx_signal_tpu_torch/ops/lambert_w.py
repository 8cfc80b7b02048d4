"""Lambert W function on any branch, elementwise (counterpart of
nx_signal_tpu/ops/lambert_w.py, scipy.special.lambertw semantics).

The input goes through `utils.devices.as_signal` and is computed in
complex128: the JAX package's x64 configuration, the one its tests run and
its 1e-13 gate against scipy. An initial guess per region (the series
about the branch point -1/e, a Pade approximant near 0 on branch 0, the
asymptotic log z + 2 pi i k - log log z elsewhere), then Halley's method
in one of two stable forms chosen by sign(Re w0), at most 100 iterations,
an entry frozen once its relative step is below `tol`. The loop asks the
device whether every entry is done once every `_STEPS_PER_CHECK`
iterations (one sync each): a frozen entry does not change, so the bits
are those of a check at every step.
"""

import math

import torch

from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["lambert_w"]

_OMEGA = 0.56714329040978387299997  # W(1), the Omega constant
_EXPN1 = 0.36787944117144232159553  # 1/e
_MAX_STEPS = 100
_STEPS_PER_CHECK = 4


def _branchpt(z):
    """Series about the branch point z = -1/e: -1 + p - p^2/3,
    p = sqrt(2 (e z + 1))."""
    p = torch.sqrt(2.0 * (math.e * z + 1.0))
    return -1.0 + p - p * p / 3.0


def _pade0(z):
    """Pade approximant of W about z = 0 (branch 0)."""
    num = z * (1.0 + z * (12.34042553191489361902 + z * 12.85106382978723404255))
    den = 1.0 + z * (14.34042553191489361702 + z * 32.53191489361702127660)
    return num / den


def _asy(z, k):
    """Asymptotic W ~ log z + 2 pi i k - log(log z + 2 pi i k)."""
    w = torch.log(z) + 2.0j * math.pi * k
    return w - torch.log(w)


def _halley_step(w, z, pos):
    """One Halley step in the form for Re w0 >= 0 (e^{-w}) where `pos`, the
    form with e^{w} elsewhere."""
    ew_n = torch.exp(-torch.where(pos, w, 0.0 * w))
    wewz_p = w - z * ew_n
    wn_p = w - wewz_p / (w + 1.0 - (w + 2.0) * wewz_p / (2.0 * w + 2.0))
    ew_p = torch.exp(torch.where(pos, 0.0 * w, w))
    wew = w * ew_p
    wewz_n = wew - z
    wn_n = w - wewz_n / (wew + ew_p - (w + 2.0) * wewz_n / (2.0 * w + 2.0))
    return torch.where(pos, wn_p, wn_n)


def lambert_w(z, k: int = 0, *, tol: float = 1.0e-8):
    """Lambert W on branch `k` (an int), elementwise over `z`; complex128.

    Examples:

    W(1) is the omega constant (omega * e^omega = 1):

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.lambert_w import lambert_w
    >>> complex(round(complex(lambert_w(torch.tensor(1.0))).real, 8))
    (0.56714329+0j)
    """
    z = as_signal(z).to(torch.complex128)
    rz, iz = z.real, z.imag
    absz = torch.abs(z)

    if k == 0:
        near_branchpt = torch.abs(z + _EXPN1) < 0.3
        in_pade_box = ((-1.0 < rz) & (rz < 1.5) & (torch.abs(iz) < 1.0)
                       & (-2.5 * torch.abs(iz) - 0.2 < rz))
        w = torch.where(near_branchpt, _branchpt(z),
                        torch.where(in_pade_box, _pade0(z), _asy(z, k)))
    elif k == -1:
        on_neg_axis = (absz <= _EXPN1) & (iz == 0.0) & (rz < 0.0)
        # log(-x) is real there; the guard keeps the log's argument finite
        safe = torch.where(on_neg_axis, -rz, torch.ones_like(rz))
        w = torch.where(on_neg_axis, torch.log(safe).to(torch.complex128), _asy(z, k))
    else:
        w = _asy(z, k)

    pos = w.real >= 0
    done = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for step in range(_MAX_STEPS):
        if step % _STEPS_PER_CHECK == 0 and bool(done.all()):
            break
        wn = _halley_step(w, z, pos)
        newly_done = torch.abs(wn - w) <= tol * torch.abs(wn)
        w = torch.where(done, w, wn)
        done = done | newly_done

    two_pi_ik = complex(0.0, 2.0 * math.pi * k)
    w = torch.where(torch.isposinf(rz), z + two_pi_ik, w)
    w = torch.where(torch.isneginf(rz), -z + two_pi_ik, w)
    if k == 0:
        w = torch.where(z == 0, torch.zeros((), dtype=w.dtype, device=w.device), w)
        w = torch.where(z == 1, torch.full((), _OMEGA, dtype=w.dtype, device=w.device), w)
    else:
        w = torch.where(z == 0, torch.full((), -math.inf, dtype=w.dtype, device=w.device), w)
    return w
