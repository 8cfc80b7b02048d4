"""Parity of the port's LTI systems (nx_signal_tpu_torch/ops/ltisys.py) with
the JAX package's, on the CPU.

The design math (conversions, cont2discrete, partial fractions, frequency
responses, place_poles) is host f64 numpy in both and returns numpy; it is
held at the gates of tests/test_ltisys_surface.py (1e-12 to 1e-8). The
simulation runs in f64 on the device of its signal: CPU tensors here. With
f64 input it is held to the JAX package's f64 `lax.scan` (x64 on) at 1e-10
absolute, with float32 input at 1e-5 of the largest |y|. The validation
messages are the JAX package's. Where the JAX package's expm is wrong (a
badly scaled block matrix: an analog Butterworth sampled at 48 kHz), the
port is held to scipy instead.
"""

import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import iir_design as jd
from nx_signal_tpu.ops import ltisys as jl
from nx_signal_tpu_torch.ops import ltisys as tl

pytestmark = pytest.mark.filterwarnings("ignore:Badly conditioned filter coefficients")

SYSD = ([1.0, 0.5], [1.0, -0.8], 0.1)
SYSC = ([1.0], [1.0, 2.0, 5.0])
A = np.array([[0.5, 0.1], [0.0, 0.3]])
B = np.array([[1.0], [0.5]])
C = np.array([[1.0, -1.0]])
D = np.array([[0.2]])
# two inputs, two outputs, three states
A3 = np.array([[0.6, 0.2, 0.0], [-0.1, 0.5, 0.1], [0.0, 0.2, 0.4]])
B3 = np.array([[1.0, 0.0], [0.5, 0.3], [0.0, 1.0]])
C3 = np.array([[1.0, 0.0, -1.0], [0.2, 1.0, 0.5]])
D3 = np.array([[0.1, 0.0], [0.0, -0.2]])
AC3 = np.array([[-1.0, 2.0, 0.0], [-2.0, -1.0, 0.5], [0.0, 0.0, -3.0]])
A_MIMO = np.array([[1.380, -0.2077, 6.715, -5.676],
                   [-0.5814, -4.290, 0.0, 0.6750],
                   [1.067, 4.273, -6.654, 5.893],
                   [0.0480, 4.273, 1.343, -2.104]])
B_MIMO = np.array([[0.0, 5.679], [1.136, 1.136], [0.0, 0.0], [-3.146, 0.0]])


def host(v):
    if isinstance(v, torch.Tensor):
        assert v.device.type == "cpu"
        return v.numpy()
    return np.asarray(v)


def close(got, want, atol):
    got, want = host(got), host(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def close_f32(got, want):
    """A float32 result within 1e-5 of the largest |want|."""
    assert got.dtype == torch.float32
    close(got, want, 1e-5 * max(np.abs(host(want)).max(), 1e-30))


def signal(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# ------------------------------------------------------------ host math

@pytest.mark.parametrize("seed,scale,rtol", [(0, 1.0, 1e-10), (1, 1.0, 1e-10),
                                             (2, 1.0, 1e-10), (3, 50.0, 1e-8)])
def test_expm(seed, scale, rtol):
    m = np.random.default_rng(seed).normal(size=(6, 6) if scale == 1.0 else (4, 4)) * scale
    np.testing.assert_allclose(tl._expm(m), jl._expm(m), rtol=rtol, atol=1e-12)


def _analog_butter_block(interp):
    """lsim's block matrix for tf2ss of the analog butter(4, 2 pi 1000)
    sampled at 48 kHz: ||M||_1 ~ 3e10 while ||M^k||^(1/k) ~ 1."""
    a, b, _, _ = jl.tf2ss(*jd.butter(4, 2 * np.pi * 1000.0, analog=True))
    dt, n = 1.0 / 48000.0, a.shape[0]
    if interp:
        m = np.vstack([np.hstack([a * dt, b * dt, np.zeros((n, 1))]),
                       np.hstack([np.zeros((1, n + 1)), np.eye(1)]), np.zeros((1, n + 2))])
    else:
        m = np.vstack([np.hstack([a * dt, b * dt]), np.zeros((1, n + 1))])
    return m.T


@pytest.mark.parametrize("interp", [True, False])
def test_expm_of_a_badly_scaled_matrix(interp):
    """The port chooses its squarings from ||A^k||^(1/k) (Al-Mohy and Higham
    2009), as scipy does; the JAX package's ||A||_1 rule squares 36 times
    here and keeps no correct digit, so scipy is the oracle."""
    import scipy.linalg

    m = _analog_butter_block(interp)
    want = scipy.linalg.expm(m)
    np.testing.assert_allclose(tl._expm(m), want, rtol=1e-12, atol=1e-15 * np.abs(want).max())
    assert np.abs(jl._expm(m) - want).max() > 0.5 * np.abs(want).max()


@pytest.mark.parametrize("interp", [True, False])
def test_lsim_of_an_analog_butterworth_against_scipy(interp):
    """lsim of the analog butter(4, 2 pi 1000) at 48 kHz (chip_smoke.py phase
    14 at a tenth of its length) against scipy.signal.lsim at 1e-9 of the
    max: the JAX package's expm fails on its block matrix."""
    import scipy.signal

    ba = jd.butter(4, 2 * np.pi * 1000.0, analog=True)
    t = np.linspace(0.0, 0.1, 4801)
    u = signal(5, t.shape)
    got = tl.lsim(ba, torch.from_numpy(u), t, interp=interp)
    want = scipy.signal.lsim(ba, u, t, interp=interp)
    for g, w in zip(got[1:], want[1:]):
        close(g, w, 1e-9 * np.abs(w).max())


@pytest.mark.parametrize("ba", [([1.0, 3.0, 3.0], [1.0, 2.0, 1.0]), ([1.0], [1.0, 2.0, 1.0]),
                                ([2.0, 1.0], [1.0, 0.5]), ([3.0], [2.0])])
def test_tf2ss_ss2tf(ba):
    got, want = tl.tf2ss(*ba), jl.tf2ss(*ba)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        close(g, w, 1e-12)
    for g, w in zip(tl.ss2tf(*got), jl.ss2tf(*want)):
        close(g, w, 1e-12)


def test_ss2tf_input_and_mimo():
    for i in (0, 1):
        for g, w in zip(tl.ss2tf(A3, B3, C3, D3, input=i), jl.ss2tf(A3, B3, C3, D3, input=i)):
            close(g, w, 1e-12)
    with pytest.raises(ValueError, match="System does not have the input specified."):
        tl.ss2tf(A3, B3, C3, D3, input=2)


def test_zpk2ss_ss2zpk():
    z, p, k = jd.butter(4, 0.3, output="zpk")
    for g, w in zip(tl.zpk2ss(z, p, k), jl.zpk2ss(z, p, k)):
        close(g, w, 1e-12)
    for g, w in zip(tl.ss2zpk(*tl.zpk2ss(z, p, k)), jl.ss2zpk(*jl.zpk2ss(z, p, k))):
        close(np.sort_complex(np.atleast_1d(g)), np.sort_complex(np.atleast_1d(w)), 1e-8)
    with pytest.raises(ValueError, match="ss2zpk supports single-output systems"):
        tl.ss2zpk(A3, B3, C3, D3)


@pytest.mark.parametrize("ba,fs", [(([1.0], [1.0, 1.0]), 10.0),
                                   (([2.0, 1.0], [1.0, 2.0, 3.0]), 5.0)])
def test_bilinear(ba, fs):
    for g, w in zip(tl.bilinear(*ba, fs=fs), jl.bilinear(*ba, fs=fs)):
        close(g, w, 1e-12)


def test_abcd_normalize():
    kw = dict(a=[[1.0, 0.0], [0.0, 1.0]], b=[[1.0], [0.0]], c=[[1.0, 0.0]])
    for g, w in zip(tl.abcd_normalize(**kw), jl.abcd_normalize(**kw)):
        close(g, w, 0.0)
    for kw, message in ((dict(a=[[1.0, 0.0], [0.0, 1.0]]), "Not enough information"),
                        (dict(a=[[1.0, 2.0]], b=[[1.0]], c=[[1.0]], d=[[0.0]]), "A must be"),
                        (dict(a=A, b=[[1.0, 2.0, 3.0]], c=C, d=D), "B must have shape")):
        with pytest.raises(ValueError, match=message):
            tl.abcd_normalize(**kw)
        with pytest.raises(ValueError, match=message):
            jl.abcd_normalize(**kw)


@pytest.mark.parametrize("method,alpha", [("zoh", None), ("bilinear", None), ("tustin", None),
                                          ("euler", None), ("forward_diff", None),
                                          ("backward_diff", None), ("foh", None),
                                          ("impulse", None), ("gbt", 0.3)])
def test_cont2discrete_ss(method, alpha):
    sys_ = jl.tf2ss([1.0, 1.0], [1.0, 3.0, 2.0])
    got = tl.cont2discrete(sys_, 0.05, method=method, alpha=alpha)
    want = jl.cont2discrete(sys_, 0.05, method=method, alpha=alpha)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    assert got[-1] == want[-1] == 0.05


def test_cont2discrete_tf_zpk_and_messages():
    got, want = tl.cont2discrete(([1.0], [1.0, 2.0]), 0.1), jl.cont2discrete(([1.0], [1.0, 2.0]), 0.1)
    for g, w in zip(got, want):
        close(g, w, 1e-12)
    got = tl.cont2discrete(([-1.0], [-2.0, -3.0], 4.0), 0.1)
    want = jl.cont2discrete(([-1.0], [-2.0, -3.0], 4.0), 0.1)
    close(np.sort_complex(got[1]), np.sort_complex(want[1]), 1e-10)
    close(got[2], want[2], 1e-10)
    sys_ = jl.tf2ss([1.0, 1.0], [1.0, 3.0, 2.0])
    for kw, message in ((dict(method="gbt"), "Alpha parameter must be specified"),
                        (dict(method="gbt", alpha=1.5), "within the interval"),
                        (dict(method="nope"), "Unknown transformation method 'nope'")):
        with pytest.raises(ValueError, match=message):
            tl.cont2discrete(sys_, 0.1, **kw)
    with pytest.raises(ValueError, match="strictly proper"):
        tl.cont2discrete((A, B, C, D), 0.1, method="impulse")
    with pytest.raises(ValueError, match="tuple of 2"):
        tl.cont2discrete(([1.0],), 0.1)


def _same_partial_fractions(got, want, atol):
    (r1, p1, k1), (r2, p2, k2) = got, want
    o1 = np.lexsort((np.asarray(p1).imag, np.asarray(p1).real))
    o2 = np.lexsort((np.asarray(p2).imag, np.asarray(p2).real))
    close(np.asarray(p1)[o1], np.asarray(p2)[o2], atol)
    close(np.asarray(r1)[o1], np.asarray(r2)[o2], atol)
    close(np.atleast_1d(k1), np.atleast_1d(k2), 1e-10)


@pytest.mark.parametrize("b,a", [([1.0, 2.0], [1.0, 5.0, 6.0]), ([1.0], [1.0, 2.0, 1.0]),
                                 ([5.0, 3.0, 1.0], [1.0, 6.0, 11.0, 6.0]),
                                 ([2.0, 3.0, 4.0, 5.0], [1.0, 3.0, 2.0]),
                                 ([1.0], [1.0, 0.0, 1.0])])
def test_residue(b, a):
    _same_partial_fractions(tl.residue(b, a), jl.residue(b, a), 1e-8)


@pytest.mark.parametrize("b,a", [([1.0, -1.0], [1.0, -1.5, 0.5]), ([1.0], [1.0, -1.0, 0.25]),
                                 ([1.0, 2.0, 3.0, 4.0], [1.0, -0.5])])
def test_residuez(b, a):
    _same_partial_fractions(tl.residuez(b, a), jl.residuez(b, a), 1e-8)


def test_invres_invresz_unique_roots():
    r, p, k = jl.residue([1.0, 2.0], [1.0, 5.0, 6.0])
    for g, w in zip(tl.invres(r, p, k), jl.invres(r, p, k)):
        close(g, w, 1e-10)
    r, p, k = jl.residuez([1.0, -1.0], [1.0, -1.5, 0.5])
    for g, w in zip(tl.invresz(r, p, k), jl.invresz(r, p, k)):
        close(g, w, 1e-10)
    roots = [1.0, 1.0005, 2.0, 2.0, 3.0, 1.0 + 1e-9j]
    for rtype in ("min", "max", "avg"):
        for g, w in zip(tl.unique_roots(roots, tol=1e-2, rtype=rtype),
                        jl.unique_roots(roots, tol=1e-2, rtype=rtype)):
            close(g, w, 0.0)
    with pytest.raises(ValueError, match="`rtype` must be one of"):
        tl.unique_roots(roots, rtype="median")
    with pytest.raises(ValueError, match="Denominator `a` is zero."):
        tl.residue([1.0], [0.0])
    with pytest.raises(ValueError, match="First coefficient of determinant `a`"):
        tl.residuez([1.0], [0.0, 1.0])


@pytest.mark.parametrize("system", [SYSC, ([-1.0], [-2.0, -3.0 + 1j, -3.0 - 1j], 2.0),
                                    (A3[:2, :2] - 1.0, B3[:2, :1], C3[:1, :2], D3[:1, :1])])
def test_freqresp_bode(system):
    for g, w in zip(tl.freqresp(system, n=200), jl.freqresp(system, n=200)):
        close(g, w, 1e-12)
    for g, w in zip(tl.freqresp(system, w=[0.5, 1.0, 2.0]),
                    jl.freqresp(system, w=[0.5, 1.0, 2.0])):
        close(g, w, 1e-12)
    for g, w in zip(tl.bode(system, n=50), jl.bode(system, n=50)):
        close(g, w, 1e-10)


@pytest.mark.parametrize("system", [SYSD, (A, B, C, D, 0.05)])
def test_dfreqresp_dbode(system):
    for whole in (False, True):
        for g, w in zip(tl.dfreqresp(system, n=128, whole=whole),
                        jl.dfreqresp(system, n=128, whole=whole)):
            close(g, w, 1e-12)
    for g, w in zip(tl.dbode(system, n=64), jl.dbode(system, n=64)):
        close(g, w, 1e-10)


# ------------------------------------------------------------ simulation

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dlsim_tf(dtype):
    u = np.sin(np.arange(50) * 0.3).astype(dtype)
    t1, y1 = tl.dlsim(SYSD, torch.from_numpy(u))
    t2, y2 = jl.dlsim(SYSD, u.astype(np.float64))
    close(t1, t2, 1e-12)
    assert t1.dtype == torch.float64
    if dtype == np.float64:
        assert y1.dtype == torch.float64
        close(y1, y2, 1e-10)
    else:
        close_f32(y1, y2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("system,x0,shape", [((A, B, C, D, 0.05), [0.3, -0.2], (60,)),
                                             ((A3, B3, C3, D3, 0.5), [1.0, 0.0, -0.5], (60, 2))])
def test_dlsim_ss(system, x0, shape, dtype):
    u = signal(1, shape, dtype)
    t = np.arange(shape[0]) * 0.25
    got = tl.dlsim(system, torch.from_numpy(u), t=t, x0=x0)
    want = jl.dlsim(system, u.astype(np.float64), t=t, x0=x0)
    close(got[0], want[0], 0.0)
    for g, w in zip(got[1:], want[1:]):
        if dtype == np.float64:
            assert g.dtype == torch.float64
            close(g, w, 1e-10)
        else:
            close_f32(g, w)


def test_dlsim_static_gain_and_messages():
    u = signal(2, (20,))
    close(tl.dlsim(([3.0], [2.0], 1.0), torch.from_numpy(u))[1],
          jl.dlsim(([3.0], [2.0], 1.0), u)[1], 1e-12)
    with pytest.raises(ValueError, match="t must have the same length as u"):
        tl.dlsim(SYSD, torch.from_numpy(u), t=np.arange(3.0))
    with pytest.raises(ValueError, match="discrete system tuples must end with dt"):
        tl.dlsim(([1.0],), torch.from_numpy(u))


@pytest.mark.parametrize("system", [SYSD, (A, B, C, D, 0.05), (A3, B3, C3, D3, 0.5)])
def test_dimpulse_dstep(system):
    for tfn, jfn in ((tl.dimpulse, jl.dimpulse), (tl.dstep, jl.dstep)):
        t1, ys1 = tfn(system, n=40, device="cpu")
        t2, ys2 = jfn(system, n=40)
        close(t1, t2, 1e-12)
        assert len(ys1) == len(ys2)
        for g, w in zip(ys1, ys2):
            assert g.dtype == torch.float64
            close(g, w, 1e-10)
    x0 = np.ones(np.atleast_2d(jl._to_dss(system)[0]).shape[0])
    t = torch.arange(30, dtype=torch.float64) * 0.1
    t1, ys1 = tl.dstep(system, x0=x0, t=t)
    t2, ys2 = jl.dstep(system, x0=x0, t=t.numpy())
    close(t1, t2, 0.0)
    for g, w in zip(ys1, ys2):
        close(g, w, 1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("interp", [True, False])
def test_lsim(interp, dtype):
    t = np.linspace(0, 5, 101)
    u = np.sin(2 * np.pi * 0.7 * t).astype(dtype)
    got = tl.lsim(SYSC, torch.from_numpy(u), t, interp=interp)
    want = jl.lsim(SYSC, u.astype(np.float64), t, interp=interp)
    close(got[0], want[0], 0.0)
    for g, w in zip(got[1:], want[1:]):
        if dtype == np.float64:
            close(g, w, 1e-10)
        else:
            close_f32(g, w)


@pytest.mark.parametrize("interp", [True, False])
def test_lsim_mimo_with_x0(interp):
    t = np.linspace(0, 2, 81)
    u = signal(3, (81, 2))
    x0 = [0.5, -1.0, 0.25]
    got = tl.lsim((AC3, B3, C3, D3), torch.from_numpy(u), torch.from_numpy(t), x0=x0,
                  interp=interp)
    want = jl.lsim((AC3, B3, C3, D3), u, t, x0=x0, interp=interp)
    for g, w in zip(got, want):
        close(g, w, 1e-10)


def test_lsim_without_input_and_one_step():
    t = np.linspace(0, 3, 61)
    for u in (None, 0.0, np.zeros(61)):
        arg = torch.from_numpy(u) if isinstance(u, np.ndarray) else u
        got = tl.lsim(SYSC, arg, torch.from_numpy(t), x0=[1.0, -0.5])
        want = jl.lsim(SYSC, u, t, x0=[1.0, -0.5])
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            close(g, w, 1e-10)
    got = tl.lsim(SYSC, torch.tensor([2.0], dtype=torch.float64), np.array([0.0]),
                  x0=[1.0, -0.5])
    want = jl.lsim(SYSC, np.array([2.0]), np.array([0.0]), x0=[1.0, -0.5])
    for g, w in zip(got, want):
        close(g, w, 1e-12)


def test_lsim_messages():
    u = torch.ones(3, dtype=torch.float64)
    for t, message in ((np.array([0.0, 0.1, 0.5]), "Time steps are not equally spaced."),
                       (np.array([1.0, 1.1, 1.2]), "Initial time must be zero"),
                       (np.array([[0.0, 0.1, 0.2]]), "t must be 1-D")):
        with pytest.raises(ValueError, match=message):
            tl.lsim(SYSC, u, t)
        with pytest.raises(ValueError, match=message):
            jl.lsim(SYSC, u.numpy(), t)
    with pytest.raises(ValueError, match="u must have the same number of rows as t"):
        tl.lsim(SYSC, u, np.linspace(0, 1, 4))
    with pytest.raises(ValueError, match="System does not define that many inputs."):
        tl.lsim(SYSC, torch.ones((3, 2), dtype=torch.float64), np.linspace(0, 1, 3))


@pytest.mark.parametrize("system", [SYSC, (AC3, B3[:, :1], C3[:1], D3[:1, :1]),
                                    ([1.0], [1.0, 1.0])])
def test_impulse_step(system):
    for tfn, jfn in ((tl.impulse, jl.impulse), (tl.step, jl.step)):
        t1, y1 = tfn(system, device="cpu")
        t2, y2 = jfn(system)
        close(t1, t2, 1e-12)
        close(y1, y2, 1e-8)
        t1, y1 = tfn(system, n=120, x0=np.full(len(jl._to_ss(system)[0]), 0.5), device="cpu")
        t2, y2 = jfn(system, n=120, x0=np.full(len(jl._to_ss(system)[0]), 0.5))
        close(y1, y2, 1e-8)
        t = torch.linspace(0.0, 4.0, 50, dtype=torch.float64)
        t1, y1 = tfn(system, t=t)
        t2, y2 = jfn(system, t=t.numpy())
        close(t1, t2, 0.0)
        close(y1, y2, 1e-8)


# ------------------------------------------------------------ classes

def test_lti_and_dlti():
    ours, ref = tl.lti([1.0], [1.0, 2.0, 5.0]), jl.lti([1.0], [1.0, 2.0, 5.0])
    assert repr(ours) == repr(ref)
    close(ours.impulse(device="cpu")[1], ref.impulse()[1], 1e-8)
    close(ours.step(device="cpu")[1], ref.step()[1], 1e-8)
    for g, w in zip(ours.bode(n=30), ref.bode(n=30)):
        close(g, w, 1e-9)
    for g, w in zip(ours.freqresp(n=30), ref.freqresp(n=30)):
        close(g, w, 1e-12)
    close(np.sort_complex(ours.poles), np.sort_complex(ref.poles), 1e-10)
    for g, w in zip(ours.to_ss(), ref.to_ss()):
        close(g, w, 0.0)
    for g, w in zip(ours.to_zpk(), ref.to_zpk()):
        close(np.atleast_1d(g), np.atleast_1d(w), 1e-12)
    t = np.linspace(0, 5, 101)
    u = np.sin(t)
    ss = tl.lti(AC3[:2, :2], B3[:2, :1], C3[:1, :2], D3[:1, :1])
    ss_ref = jl.lti(AC3[:2, :2], B3[:2, :1], C3[:1, :2], D3[:1, :1])
    for g, w in zip(ss.output(torch.from_numpy(u), t), ss_ref.output(u, t)):
        close(g, w, 1e-9)
    sd, sd_ref = ours.to_discrete(0.05), ref.to_discrete(0.05)
    assert isinstance(sd, tl.dlti) and sd.dt == sd_ref.dt == 0.05
    for g, w in zip(sd.to_tf(), sd_ref.to_tf()):
        close(g, w, 1e-10)
    d, d_ref = tl.dlti(*SYSD[:2], dt=0.1), jl.dlti(*SYSD[:2], dt=0.1)
    assert repr(d) == repr(d_ref)
    close(d.step(n=30, device="cpu")[1][0], d_ref.step(n=30)[1][0], 1e-10)
    close(d.impulse(n=30, device="cpu")[1][0], d_ref.impulse(n=30)[1][0], 1e-10)
    for g, w in zip(d.freqresp(n=64), d_ref.freqresp(n=64)):
        close(g, w, 1e-10)
    for g, w in zip(d.bode(n=16), d_ref.bode(n=16)):
        close(g, w, 1e-10)
    u = np.sin(np.arange(40) * 0.2)
    for g, w in zip(d.output(torch.from_numpy(u)), d_ref.output(u)):
        close(g, w, 1e-10)
    close(d.zeros, d_ref.zeros, 1e-12)
    close(d.poles, d_ref.poles, 1e-12)
    with pytest.raises(ValueError, match="lti takes 2 \\(tf\\), 3 \\(zpk\\), or 4"):
        tl.lti([1.0])
    with pytest.raises(ValueError, match="dlti takes 2"):
        tl.dlti([1.0], [1.0], [1.0], [1.0], [1.0])


def test_representation_classes():
    tf, ref = tl.TransferFunction([2.0, 3.0], [1.0, 2.0, 10.0]), jl.TransferFunction(
        [2.0, 3.0], [1.0, 2.0, 10.0])
    assert repr(tf) == repr(ref) and tf.dt is None
    zpk, zpk_ref = tf.to_zpk(), ref.to_zpk()
    ss, ss_ref = zpk.to_ss(), zpk_ref.to_ss()
    back = ss.to_tf()
    assert isinstance(zpk, tl.ZerosPolesGain) and isinstance(ss, tl.StateSpace)
    assert isinstance(back, tl.TransferFunction)
    close(np.sort_complex(zpk.poles), np.sort_complex(zpk_ref.poles), 1e-12)
    assert zpk.gain == zpk_ref.gain
    for name in "ABCD":
        close(getattr(ss, name), getattr(ss_ref, name), 1e-12)
    close(back.num, [2.0, 3.0], 1e-10)
    close(back.den, [1.0, 2.0, 10.0], 1e-10)
    copy = tl.StateSpace(tl.TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0]))
    copy_ref = jl.StateSpace(jl.TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0]))
    for name in "ABCD":
        close(getattr(copy, name), getattr(copy_ref, name), 0.0)
    from_lti = tl.ZerosPolesGain(tl.lti([1.0], [1.0, 3.0, 2.0]))
    close(np.sort_complex(from_lti.poles), [-2.0, -1.0], 1e-12)
    t = np.linspace(0.0, 5.0, 200)
    cont = tl.TransferFunction([1.0], [1.0, 0.5, 2.0])
    cont_ref = jl.TransferFunction([1.0], [1.0, 0.5, 2.0])
    close(cont.step(t=torch.from_numpy(t))[1], cont_ref.step(t=t)[1], 1e-8)
    close(cont.impulse(t=torch.from_numpy(t))[1], cont_ref.impulse(t=t)[1], 1e-8)
    close(cont.output(torch.from_numpy(np.cos(t)), t)[1], cont_ref.output(np.cos(t), t)[1],
          1e-10)
    for g, w in zip(cont.bode(n=50), cont_ref.bode(n=50)):
        close(g, w, 1e-8)
    disc = tl.TransferFunction([1.0], [1.0, -0.5], dt=0.1)
    disc_ref = jl.TransferFunction([1.0], [1.0, -0.5], dt=0.1)
    close(disc.step(n=12, device="cpu")[1][0], disc_ref.step(n=12)[1][0], 1e-12)
    close(disc.output(torch.ones(12, dtype=torch.float64))[1], disc_ref.output(np.ones(12))[1],
          1e-12)
    for g, w in zip(disc.freqresp(n=32), disc_ref.freqresp(n=32)):
        close(g, w, 1e-12)
    assert disc.to_zpk().dt == 0.1
    close(disc.to_zpk().poles, [0.5], 1e-12)
    zd = tl.ZerosPolesGain([-1.0], [-2.0, -3.0], 4.0).to_discrete(0.02)
    zd_ref = jl.ZerosPolesGain([-1.0], [-2.0, -3.0], 4.0).to_discrete(0.02)
    assert isinstance(zd, tl.ZerosPolesGain) and zd.dt == 0.02
    close(np.sort_complex(zd.poles), np.sort_complex(zd_ref.poles), 1e-10)
    close(zd.gain, zd_ref.gain, 1e-10)
    with pytest.raises(ValueError, match="TransferFunction takes 2 system arrays"):
        tl.TransferFunction([1.0])
    with pytest.raises(ValueError, match="StateSpace takes 4 system arrays"):
        tl.StateSpace([1.0], [1.0])
    with pytest.raises(ValueError, match="to_discrete is only defined for continuous-time"):
        disc.to_discrete(0.1)


# ------------------------------------------------------------ place_poles

def _placed(a, b, poles, atol):
    res = tl.place_poles(a, b, poles)
    want = np.sort_complex(np.asarray(poles, complex))
    close(np.sort_complex(np.linalg.eigvals(a - b @ res.gain_matrix)), want, atol)
    close(np.sort_complex(res.computed_poles), want, atol)
    assert res.gain_matrix.shape == (b.shape[1], a.shape[0])
    assert np.isrealobj(res.gain_matrix)
    return res


@pytest.mark.parametrize("poles", [[-0.2, -0.5, -5.0566, -8.6659],
                                   [-0.2 + 0.3j, -0.2 - 0.3j, -5.0, -8.0],
                                   [-2.0, -3.0, -4.5, -6.0]])
@pytest.mark.parametrize("method", ["YT", "KNV0"])
def test_place_poles_mimo(poles, method):
    res = _placed(A_MIMO, B_MIMO, poles, 1e-6)
    ref = jl.place_poles(A_MIMO, B_MIMO, poles, method=method)
    close(np.sort_complex(res.computed_poles), np.sort_complex(ref.computed_poles), 1e-6)


@pytest.mark.parametrize("poles", [[-1.0, -2.0, -3.0], [-1.0 + 1.0j, -1.0 - 1.0j, -3.0]])
def test_place_poles_siso_gain(poles):
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((3, 3)), rng.standard_normal((3, 1))
    res = _placed(a, b, poles, 1e-8)
    ref = jl.place_poles(a, b, poles)
    np.testing.assert_allclose(res.gain_matrix, ref.gain_matrix, rtol=1e-8, atol=1e-8)
    assert (res.rtol, res.nb_iter) == (ref.rtol, ref.nb_iter)
    assert repr(res).startswith("PlacePolesResult(gain_matrix=")


def test_place_poles_messages():
    for args, kw, message in (
            ((A_MIMO, B_MIMO, [-1.0, -2.0]), {}, "needs exactly 4 poles, got 2"),
            ((A_MIMO, B_MIMO, [-1.0 + 1j, -2.0, -3.0, -4.0]), {},
             "complex poles must come in conjugate pairs"),
            ((np.eye(2), np.zeros((2, 1)), [-1.0, -1.0 + 0j]), {}, "B is the zero matrix"),
            ((A_MIMO, B_MIMO, [-1.0, -2.0, -3.0, -4.0]), dict(method="nope"),
             "method must be 'YT' or 'KNV0'"),
            ((np.eye(2), np.ones((2, 1)), [-1.0, -1.0]), {}, "multiplicity")):
        with pytest.raises(ValueError, match=message):
            tl.place_poles(*args, **kw)
        with pytest.raises(ValueError, match=message):
            jl.place_poles(*args, **kw)
