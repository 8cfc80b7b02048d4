"""LTI systems (counterpart of nx_signal_tpu/ops/ltisys.py): tf/ss
conversions, discretization, partial fractions, frequency responses, the
system classes, pole placement, and the simulation of discrete and
continuous systems, with scipy.signal semantics.

The design math is host-side f64 numpy, line for line the JAX package's
(small design-time systems), and returns numpy as it does. `expm` is the
module's own (Pade-13 scaling-and-squaring, Higham 2005): the port imports
no scipy.

The simulation (`dlsim`, `lsim` and their callers `dimpulse`, `dstep`,
`impulse`, `step`) runs on a device in f64, where the JAX package scans
with `lax.scan`: the input terms of every step as one matmul, then one
`addmv` per step into a time-major state buffer (the per-sample form of
ops/iir.py; no host round trip per step), then the outputs as one matmul.
A signal `u` goes through `utils.devices.as_signal`, and its dtype, at
least float32, is the result's; a simulation without a signal runs where
a tensor `t` sits, else on `device=` (None: the card), in float64. The
times come back as a float64 tensor on that device.
"""

import math
import warnings

import numpy as np
import torch

from nx_signal_tpu_torch.utils.devices import as_signal, card_device
from nx_signal_tpu_torch.utils.dtypes import result_real_dtype

__all__ = [
    "BadCoefficients",
    "normalize", "bilinear", "tf2ss", "ss2tf", "zpk2ss", "ss2zpk",
    "abcd_normalize", "cont2discrete", "unique_roots", "residue",
    "residuez", "invres", "invresz",
    "dlsim", "dimpulse", "dstep", "lsim", "impulse", "step",
    "findfreqs", "freqresp", "bode", "dfreqresp", "dbode",
    "lti", "dlti",
    "TransferFunction", "ZerosPolesGain", "StateSpace", "place_poles",
]

# ------------------------------------------------------------ helpers

def _real_if_close(c, tol: float = 1e4):
    return np.real_if_close(c, tol=tol)


def _onenorm_power(a, p: int) -> float:
    """||a^p||_1, by p - 1 products (small matrices)."""
    r = a
    for _ in range(p - 1):
        r = r @ a
    return float(np.linalg.norm(r, 1))


def _ell(a, m: int) -> int:
    """The squarings to add so the Pade-m backward error bound holds at
    unit roundoff (Al-Mohy & Higham 2009, eq. 3.11; scipy's `_ell`)."""
    norm_abs = _onenorm_power(np.abs(a), 2 * m + 1)
    if not norm_abs:
        return 0
    c_recip = float(math.comb(2 * m, m) * math.factorial(2 * m + 1))
    alpha = norm_abs / (float(np.linalg.norm(a, 1)) * c_recip)
    return max(int(math.ceil(math.log2(alpha / 2.0 ** -53) / (2 * m))), 0)


def _expm(a):
    """Matrix exponential by Pade-13 scaling-and-squaring, f64/c128. Small
    design-time matrices only.

    The squarings follow Al-Mohy & Higham 2009 (as scipy.linalg.expm does):
    s from ||A^k||^(1/k) at k = 6, 8, 10 against theta_13 = 4.25, plus
    `_ell`'s correction. The JAX package's `_expm` scales by ||A||_1 alone
    (Higham 2005), which overscales a non-normal matrix: lsim's block
    matrix of an analog Butterworth at 1 kHz sampled at 48 kHz has ||A
    dt||_1 ~ 3e10 and ||A^k dt^k||^(1/k) ~ 1, and 36 squarings there leave
    no correct digit."""
    a = np.asarray(a, dtype=np.promote_types(np.asarray(a).dtype, np.float64))
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("expm requires a square matrix")
    eta = min(max(_onenorm_power(a, 6) ** (1 / 6), _onenorm_power(a, 8) ** (1 / 8)),
              max(_onenorm_power(a, 8) ** (1 / 8), _onenorm_power(a, 10) ** (1 / 10)))
    theta13 = 4.25
    s = max(int(math.ceil(math.log2(eta / theta13))), 0) if eta else 0
    s += _ell(a / 2.0 ** s, 13)
    a_s = a / (2.0 ** s)
    b = [64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
         1187353796428800.0, 129060195264000.0, 10559470521600.0,
         670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
         960960.0, 16380.0, 182.0, 1.0]
    ident = np.eye(n, dtype=a_s.dtype)
    a2 = a_s @ a_s
    a4 = a2 @ a2
    a6 = a2 @ a4
    u = a_s @ (a6 @ (b[13] * a6 + b[11] * a4 + b[9] * a2)
               + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident)
    v = (a6 @ (b[12] * a6 + b[10] * a4 + b[8] * a2)
         + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident)
    r = np.linalg.solve(v - u, v + u)
    for _ in range(s):
        r = r @ r
    return r


# ------------------------------------------------------------ tf <-> ss

class BadCoefficients(UserWarning):
    """Warning emitted when a transfer function's numerator carries
    leading near-zero coefficients that get trimmed — scipy.signal
    BadCoefficients semantics (the trimmed filter may be meaningless if
    the zeros were not intentional).

    Examples:

    >>> import warnings
    >>> from nx_signal_tpu_torch.ops.ltisys import BadCoefficients, normalize
    >>> with warnings.catch_warnings(record=True) as rec:
    ...     warnings.simplefilter("always")
    ...     _ = normalize([0.0, 3.0, 6.0], [2.0, 4.0])
    >>> rec[0].category is BadCoefficients
    True
    """


def normalize(b, a):
    """Normalize a transfer function to a[0] == 1, trimming leading-zero
    numerator coefficients — scipy.signal.normalize semantics (b may be
    2-D for multi-output).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import normalize
    >>> b, a = normalize([2.0, 4.0], [2.0, 1.0])
    >>> np.round(b, 4), np.round(a, 4)
    (array([1., 2.]), array([1. , 0.5]))
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64)) + 0j \
        if np.iscomplexobj(b) else np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=b.dtype))
    if a.ndim != 1:
        raise ValueError("Denominator polynomial must be rank-1 array.")
    if b.ndim > 2:
        raise ValueError("Numerator polynomial must be rank-1 or rank-2 array.")
    if np.all(a == 0):
        raise ValueError("Denominator must have at least one nonzero element.")
    b2 = np.atleast_2d(b)
    if b2.shape[-1] > a.shape[0]:
        leading = b2[:, : b2.shape[-1] - a.shape[0]]
        if not np.allclose(leading, 0, atol=1e-14):
            raise ValueError("Improper transfer function. "
                             "`num` is longer than `den`.")
        b2 = b2[:, b2.shape[-1] - a.shape[0]:]
        # scipy warns whenever leading zeros are dropped, including the
        # improper-length case above
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients)
    # strip leading zero columns shared by every row (keep at least 1);
    # scipy's threshold is atol=1e-14 — a genuinely small leading
    # coefficient (e.g. 1e-10) must be KEPT, not trimmed
    if b2.shape[-1] > 1 and np.allclose(b2[:, 0], 0, atol=1e-14):
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients)
        while b2.shape[-1] > 1 and np.allclose(b2[:, 0], 0, atol=1e-14):
            b2 = b2[:, 1:]
    a0 = a[0]
    out_b = b2 / a0
    out_a = a / a0
    if b.ndim == 1:
        out_b = out_b[0]
    return out_b, out_a


def bilinear(b, a, fs: float = 1.0):
    """Tustin (bilinear) transform of an analog (b, a) transfer function —
    scipy.signal.bilinear semantics. Routed through the zpk bilinear
    transform (ops/iir_design.py: bilinear_zpk) for numerical robustness.

    Examples:

    The RC lowpass 1/(s+1) discretized at fs = 1:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import bilinear
    >>> b, a = bilinear([1.0], [1.0, 1.0], fs=1.0)
    >>> np.round(b, 4), np.round(a, 4)
    (array([0.3333, 0.3333]), array([ 1.    , -0.3333]))
    """
    from nx_signal_tpu_torch.ops.iir_design import bilinear_zpk, tf2zpk, zpk2tf

    z, p, k = tf2zpk(b, a)
    zd, pd, kd = bilinear_zpk(z, p, k, fs=float(fs))
    return zpk2tf(zd, pd, kd)


def tf2ss(num, den):
    """Transfer function -> controller-canonical state space —
    scipy.signal.tf2ss semantics.

    Examples:

    H(s) = (s + 2) / (s^2 + 3s + 5):

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import tf2ss
    >>> A, B, C, D = tf2ss([1.0, 2.0], [1.0, 3.0, 5.0])
    >>> np.round(np.asarray(A), 4)
    array([[-3., -5.],
           [ 1.,  0.]])
    >>> np.asarray(C)
    array([[1., 2.]])
    """
    num, den = normalize(num, den)
    num2 = np.atleast_2d(num)
    n = den.shape[0]
    k = num2.shape[-1]
    if k < n:
        num2 = np.hstack([np.zeros((num2.shape[0], n - k), num2.dtype), num2])
    dtype = np.promote_types(num2.dtype, den.dtype)
    if n == 1:
        a = np.zeros((0, 0), dtype)
        b = np.zeros((0, 1), dtype)
        c = np.zeros((num2.shape[0], 0), dtype)
        d = num2[:, :1].astype(dtype)
        return a, b, c, d
    a = np.vstack([-den[1:][None, :], np.eye(n - 2, n - 1, dtype=dtype)]).astype(dtype)
    b = np.eye(n - 1, 1, dtype=dtype)
    c = (num2[:, 1:] - np.outer(num2[:, 0], den[1:])).astype(dtype)
    d = num2[:, :1].astype(dtype)
    return a, b, c, d


def ss2tf(a, b, c, d, input: int = 0):
    """State space -> transfer function (num rows per output, shared den) —
    scipy.signal.ss2tf semantics: den = poly(A),
    num_k = poly(A - B_i C_k) + (D_ki - 1) den.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import ss2tf
    >>> A = [[-3.0, -5.0], [1.0, 0.0]]
    >>> num, den = ss2tf(A, [[1.0], [0.0]], [[1.0, 2.0]], [[0.0]])
    >>> np.round(num, 4), np.round(den, 4)
    (array([[0., 1., 2.]]), array([1., 3., 5.]))
    """
    a, b, c, d = abcd_normalize(a, b, c, d)
    nin = d.shape[1]
    if input >= nin:
        raise ValueError("System does not have the input specified.")
    b = b[:, input: input + 1]
    d = d[:, input: input + 1]
    den = np.atleast_1d(np.poly(a)) if a.size else np.ones(1)
    if b.size == 0 and c.size == 0:
        num = np.ravel(d)
        return np.atleast_2d(num), den
    num_states = a.shape[0]
    dtype = np.promote_types(np.promote_types(a.dtype, b.dtype),
                             np.promote_types(c.dtype, d.dtype))
    num = np.empty((c.shape[0], num_states + 1), dtype)
    for k in range(c.shape[0]):
        ck, dk = c[k: k + 1, :], d[k, 0]
        num[k] = np.poly(a - b @ ck) + (dk - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """Zeros/poles/gain -> state space — scipy.signal.zpk2ss semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import zpk2ss
    >>> A, B, C, D = zpk2ss([1.0], [0.5, 0.25], 2.0)
    >>> np.round(A, 4)
    array([[ 0.75 , -0.125],
           [ 1.   ,  0.   ]])
    """
    from nx_signal_tpu_torch.ops.iir_design import zpk2tf

    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(a, b, c, d, input: int = 0):
    """State space -> zeros/poles/gain — scipy.signal.ss2zpk semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import ss2zpk, tf2ss
    >>> A, B, C, D = tf2ss([1.0, 2.0], [1.0, 3.0, 2.0])
    >>> z, p, k = ss2zpk(A, B, C, D)
    >>> np.round(np.sort_complex(np.asarray(p)), 3), np.round(np.asarray(z), 3)
    (array([-2.+0.j, -1.+0.j]), array([-2.]))
    """
    from nx_signal_tpu_torch.ops.iir_design import tf2zpk

    num, den = ss2tf(a, b, c, d, input=input)
    num = np.atleast_2d(num)
    if num.shape[0] != 1:
        raise ValueError("ss2zpk supports single-output systems; select "
                         "one row of ss2tf's numerator for MIMO")
    return tf2zpk(num[0], den)


def abcd_normalize(a=None, b=None, c=None, d=None):
    """Validate/shape-reconcile state-space matrices, inferring missing
    zero matrices where sizes allow — scipy.signal.abcd_normalize
    semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import abcd_normalize
    >>> A, B, C, D = abcd_normalize([[1.0]], [[1.0]], [[1.0]], [[0.0]])
    >>> np.asarray(A), np.asarray(D)
    (array([[1.]]), array([[0.]]))
    """
    def shape_or_none(m):
        return m.shape if m is not None else (None, None)

    a = np.atleast_2d(np.asarray(a, dtype=np.float64)) if a is not None else None
    b = np.atleast_2d(np.asarray(b, dtype=np.float64)) if b is not None else None
    c = np.atleast_2d(np.asarray(c, dtype=np.float64)) if c is not None else None
    d = np.atleast_2d(np.asarray(d, dtype=np.float64)) if d is not None else None

    p = None  # states
    for m, axis in ((a, 0), (a, 1), (b, 0), (c, 1)):
        if m is not None:
            p = m.shape[axis]
            break
    q = b.shape[1] if b is not None else (d.shape[1] if d is not None else None)
    r = c.shape[0] if c is not None else (d.shape[0] if d is not None else None)
    if p is None or q is None or r is None:
        raise ValueError("Not enough information on the system.")
    a = np.zeros((p, p)) if a is None else a
    b = np.zeros((p, q)) if b is None else b
    c = np.zeros((r, p)) if c is None else c
    d = np.zeros((r, q)) if d is None else d
    if a.shape != (p, p):
        raise ValueError("A must be square.")
    if b.shape != (p, q):
        raise ValueError(f"B must have shape {(p, q)}, got {b.shape}")
    if c.shape != (r, p):
        raise ValueError(f"C must have shape {(r, p)}, got {c.shape}")
    if d.shape != (r, q):
        raise ValueError(f"D must have shape {(r, q)}, got {d.shape}")
    return a, b, c, d


# ------------------------------------------------------------ cont2discrete

def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Discretize a continuous LTI system — scipy.signal.cont2discrete
    semantics. `system` is (num, den), (z, p, k), or (A, B, C, D); returns
    the same representation with `dt` appended. Methods: zoh (block-matrix
    expm), foh, gbt(alpha), bilinear/tustin (gbt 1/2), euler/forward_diff
    (gbt 0), backward_diff (gbt 1), impulse.

    Examples:

    Zero-order hold of 1/(s+1) at dt = 0.5:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import cont2discrete
    >>> num, den, dt = cont2discrete(([1.0], [1.0, 1.0]), 0.5)
    >>> np.round(num, 4), np.round(den, 4), dt
    (array([[0.    , 0.3935]]), array([ 1.    , -0.6065]), 0.5)
    """
    if len(system) == 2:
        sysd = cont2discrete(tf2ss(*system), dt, method=method, alpha=alpha)
        return ss2tf(*sysd[:-1]) + (dt,)
    if len(system) == 3:
        sysd = cont2discrete(zpk2ss(*system), dt, method=method, alpha=alpha)
        return ss2zpk(*sysd[:-1]) + (dt,)
    if len(system) != 4:
        raise ValueError("First argument must either be a tuple of 2 (tf), "
                         "3 (zpk), or 4 (ss) arrays.")
    a, b, c, d = map(lambda m: np.asarray(m, dtype=np.float64), system)
    n = a.shape[0]
    if method == "gbt" and alpha is None:
        raise ValueError("Alpha parameter must be specified for the "
                         "generalized bilinear transform (gbt) method")
    if method in ("bilinear", "tustin"):
        method, alpha = "gbt", 0.5
    elif method in ("euler", "forward_diff"):
        method, alpha = "gbt", 0.0
    elif method == "backward_diff":
        method, alpha = "gbt", 1.0

    if method == "gbt":
        if alpha < 0 or alpha > 1:
            raise ValueError("Alpha parameter must be within the interval "
                             "[0,1] for the gbt method")
        ima = np.eye(n) - alpha * dt * a
        ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * a)
        bd = np.linalg.solve(ima, dt * b)
        cd = np.linalg.solve(ima.T, c.T).T
        dd = d + alpha * (c @ bd)
    elif method == "zoh":
        em = np.block([
            [a, b],
            [np.zeros((b.shape[1], n)), np.zeros((b.shape[1], b.shape[1]))],
        ])
        ms = _expm(em * dt)
        ad = ms[:n, :n]
        bd = ms[:n, n:]
        cd, dd = c, d
    elif method == "foh":
        nb = b.shape[1]
        em = np.block([
            [a, b, np.zeros((n, nb))],
            [np.zeros((nb, n + nb)), np.eye(nb)],
            [np.zeros((nb, n + 2 * nb))],
        ])
        ms = _expm(em * dt)
        phi = ms[:n, :n]
        gamma1 = ms[:n, n: n + nb]
        gamma2 = ms[:n, n + nb:]
        ad = phi
        bd = gamma1 + phi @ gamma2 / dt - gamma2 / dt
        cd = c
        dd = d + c @ (gamma2 / dt)
    elif method == "impulse":
        if not np.allclose(d, 0):
            raise ValueError("Impulse method is only applicable "
                             "to strictly proper systems")
        ad = _expm(a * dt)
        bd = ad @ b * dt
        cd = c
        dd = c @ b * dt
    else:
        raise ValueError(f"Unknown transformation method '{method}'")
    return ad, bd, cd, dd, dt


# ------------------------------------------------------------ partial fractions

def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Cluster close roots into (unique values, multiplicities) —
    scipy.signal.unique_roots semantics: roots within `tol` of a cluster
    join it; the representative is the cluster min/max/mean per `rtype`.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import unique_roots
    >>> vals, mult = unique_roots([1.0, 1.0 + 1e-9, 2.0])
    >>> np.asarray(vals, dtype=np.float64), np.asarray(mult)
    (array([1., 2.]), array([2, 1]))
    """
    p = np.atleast_1d(np.asarray(p))
    if rtype in ("max", "maximum"):
        reduce = np.max
    elif rtype in ("min", "minimum"):
        reduce = np.min
    elif rtype in ("avg", "mean"):
        reduce = np.mean
    else:
        raise ValueError("`rtype` must be one of "
                         "{'max', 'maximum', 'min', 'minimum', 'avg', 'mean'}")
    # greedy clustering in input order (scipy uses cKDTree grouping; for
    # design-scale root counts the O(n^2) sweep is identical in effect)
    assigned = np.full(len(p), -1, dtype=int)
    clusters = []
    for i in range(len(p)):
        if assigned[i] >= 0:
            continue
        members = [i]
        assigned[i] = len(clusters)
        for j in range(i + 1, len(p)):
            if assigned[j] < 0 and abs(p[i] - p[j]) < tol:
                members.append(j)
                assigned[j] = len(clusters)
        clusters.append(members)
    uniq, mult = [], []
    for members in clusters:
        vals = p[members]
        if np.iscomplexobj(vals) and reduce in (np.min, np.max):
            # order complex clusters by real part then imaginary (total
            # order so min/max are well-defined, matching scipy)
            order = np.lexsort((vals.imag, vals.real))
            rep = vals[order[0]] if reduce is np.min else vals[order[-1]]
        else:
            rep = reduce(vals)
        uniq.append(rep)
        mult.append(len(members))
    return np.asarray(uniq), np.asarray(mult)


def _taylor_shift(c, r):
    """Coefficients (descending) of p(t + r) given p's coefficients — the
    Taylor shift used to read series expansions at a root."""
    c = np.asarray(c)
    n = len(c)
    # synthetic division (Horner-Ruffini) n times
    res = np.empty(n, dtype=np.complex128)
    work = c.astype(np.complex128).copy()
    for k in range(n):
        # divide work by (t - (-r))? We expand around r: p(s), s = t + r
        # repeatedly evaluate/deflate at r
        rem = work[0]
        for i in range(1, len(work)):
            rem = rem * r + work[i]
        res[n - 1 - k] = rem
        # deflate: work <- quotient of work / (s - r)
        q = np.empty(len(work) - 1, dtype=np.complex128)
        acc = work[0]
        for i in range(len(work) - 1):
            q[i] = acc
            acc = acc * r + work[i + 1]
        work = q
        if len(work) == 0:
            res[: n - 1 - k] = 0.0
            break
    return res  # descending coeffs of p(t + r): res[0] t^{n-1} ... res[-1]


def _series_div(num_asc, den_asc, nterms):
    """First `nterms` ascending Taylor coefficients of num/den (den[0] != 0)."""
    out = np.empty(nterms, dtype=np.complex128)
    num = list(num_asc) + [0.0] * max(0, nterms - len(num_asc))
    for k in range(nterms):
        acc = num[k]
        for j in range(k):
            acc -= out[j] * (den_asc[k - j] if k - j < len(den_asc) else 0.0)
        out[k] = acc / den_asc[0]
    return out


def _partial_fractions(b, a, tol, rtype):
    """The residue core: b(s)/a(s) in descending powers of s."""
    b = np.atleast_1d(np.asarray(b, dtype=np.complex128))
    a = np.atleast_1d(np.asarray(a, dtype=np.complex128))
    if np.all(a == 0):
        raise ValueError("Denominator `a` is zero.")
    # strip leading zeros of a (descending coeff convention here)
    a = np.trim_zeros(a, "f")
    b = np.trim_zeros(b, "f") if np.any(b) else np.zeros(1, np.complex128)

    # direct (polynomial) part
    if len(b) >= len(a):
        k, b = np.polydiv(b, a)
        b = np.trim_zeros(b, "f") if np.any(b) else np.zeros(1, np.complex128)
    else:
        k = np.zeros(0, np.complex128)

    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    residues = []
    ordered_poles = []
    a0 = a[0]
    for i, (r, m) in enumerate(zip(uniq, mult)):
        # h(s) = (s - r)^m * b(s)/a(s) is analytic at r; its Taylor
        # coefficients h_j at r give res_q = h_{m-q}
        denom = np.ones(1, np.complex128)
        for j, (r2, m2) in enumerate(zip(uniq, mult)):
            if j == i:
                continue
            for _ in range(m2):
                denom = np.convolve(denom, np.array([1.0, -r2]))
        denom = denom * a0
        num_shift = _taylor_shift(b, r)[::-1]       # ascending at r
        den_shift = _taylor_shift(denom, r)[::-1]   # ascending at r
        h = _series_div(num_shift, den_shift, int(m))
        for q in range(1, int(m) + 1):
            residues.append(h[m - q])
            ordered_poles.append(r)
    return (np.asarray(residues), np.asarray(ordered_poles),
            np.asarray(k))


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion b(s)/a(s) = k(s) + sum r_i/(s-p_i)^n —
    scipy.signal.residue semantics (repeated poles listed with increasing
    power). Series-division at each pole cluster instead of scipy's
    derivative recurrences; identical values for well-separated roots.

    Examples:

    1 / ((s+1)(s+2)) = 1/(s+1) - 1/(s+2):

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import residue
    >>> r, p, k = residue([1.0], [1.0, 3.0, 2.0])
    >>> np.round(r, 4), np.round(p, 4)
    (array([-1.,  1.]), array([-2.+0.j, -1.+0.j]))
    """
    r, p, k = _partial_fractions(b, a, tol, rtype)
    return _real_if_close(r), p, _real_if_close(k).astype(np.float64) \
        if k.size else np.array([], dtype=np.float64)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial fractions of b(z)/a(z) in powers of z^-1:
    sum r_i/(1 - p_i z^-1)^n + k(z^-1) — scipy.signal.residuez semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import residuez
    >>> r, p, k = residuez([1.0, -1.0], [1.0, -0.5, 0.06])
    >>> np.round(np.asarray(r), 3), np.round(np.asarray(p), 3)
    (array([-7.,  8.]), array([0.3+0.j, 0.2+0.j]))
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.complex128))
    a = np.atleast_1d(np.asarray(a, dtype=np.complex128))
    if np.all(a == 0):
        raise ValueError("Denominator `a` is zero.")
    if a[0] == 0:
        raise ValueError("First coefficient of determinant `a` must be "
                         "non-zero.")
    # In w = z^-1 (ascending order = the given order), the direct part is
    # the ascending-series quotient; poles of a(z) are the z-poles.
    gain = a[0]
    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    n_direct = len(b) - len(a)
    if n_direct >= 0:
        # long division of reversed (ascending w) polynomials
        k_rev, b_rev = np.polydiv(b[::-1], a[::-1])
        k = k_rev[::-1]
        b = b_rev[::-1]
        b = np.trim_zeros(b, "f") if np.any(b) else np.zeros(1, np.complex128)
    else:
        k = np.zeros(0, np.complex128)
    residues = []
    ordered_poles = []
    for i, (p_i, m) in enumerate(zip(uniq, mult)):
        if p_i == 0:
            raise ValueError("residuez: pole at z = 0")
        w0 = 1.0 / p_i
        m = int(m)
        # h(w) = (1 - p w)^m B(w)/A(w) analytic at w0;
        # res_q = h_{m-q} / (-p)^{m-q}
        denom = np.ones(1, np.complex128) * gain
        for j, (p2, m2) in enumerate(zip(uniq, mult)):
            if j == i:
                continue
            for _ in range(int(m2)):
                # A(w) factor (1 - p2 w) -> descending in w: [-p2, 1]
                denom = np.convolve(denom, np.array([-p2, 1.0]))
        # b is ascending in w already; convert to descending for the shift
        num_desc = b[::-1]
        num_shift = _taylor_shift(num_desc, w0)[::-1]
        den_shift = _taylor_shift(denom, w0)[::-1]
        h = _series_div(num_shift, den_shift, m)
        for q in range(1, m + 1):
            residues.append(h[m - q] / (-p_i) ** (m - q))
        ordered_poles.extend([p_i] * m)
    return (_real_if_close(np.asarray(residues)), np.asarray(ordered_poles),
            _real_if_close(np.asarray(k)))


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of `residue`: reassemble (b, a) from residues/poles/direct —
    scipy.signal.invres semantics.

    Examples:

    The inverse of the residue example: -1/(s+2) + 1/(s+1) = 1/((s+1)(s+2)):

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import invres
    >>> b, a = invres([-1.0, 1.0], [-2.0, -1.0], [])
    >>> np.round(b, 4), np.round(a, 4)
    (array([0., 1.]), array([1., 3., 2.]))
    """
    r = np.atleast_1d(np.asarray(r, dtype=np.complex128))
    p = np.atleast_1d(np.asarray(p, dtype=np.complex128))
    k = np.atleast_1d(np.asarray(k, dtype=np.complex128)) if np.size(k) \
        else np.zeros(0, np.complex128)
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    a = np.ones(1, np.complex128)
    for u, m in zip(uniq, mult):
        for _ in range(int(m)):
            a = np.convolve(a, np.array([1.0, -u]))
    b = np.zeros(1, np.complex128)
    if k.size and np.any(k):
        b = np.convolve(k, a)
    idx = 0
    for i, (u, m) in enumerate(zip(uniq, mult)):
        m = int(m)
        for q in range(1, m + 1):
            # term r/(s-u)^q contributes r * a(s)/(s-u)^q
            term = np.ones(1, np.complex128)
            for j, (u2, m2) in enumerate(zip(uniq, mult)):
                reps = int(m2) - (q if j == i else 0)
                for _ in range(reps):
                    term = np.convolve(term, np.array([1.0, -u2]))
            b = np.polyadd(b, r[idx] * term)
            idx += 1
    return _real_if_close(b), _real_if_close(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of `residuez` — scipy.signal.invresz semantics.

    Examples:

    A single pole at z = 0.5 with unit residue:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import invresz
    >>> b, a = invresz([1.0], [0.5], [])
    >>> np.round(b, 4), np.round(a, 4)
    (array([1.]), array([ 1. , -0.5]))
    """
    r = np.atleast_1d(np.asarray(r, dtype=np.complex128))
    p = np.atleast_1d(np.asarray(p, dtype=np.complex128))
    k = np.atleast_1d(np.asarray(k, dtype=np.complex128)) if np.size(k) \
        else np.zeros(0, np.complex128)
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    # work in w = z^-1, ASCENDING coefficient order
    a_asc = np.ones(1, np.complex128)
    for u, m in zip(uniq, mult):
        for _ in range(int(m)):
            a_asc = np.convolve(a_asc, np.array([1.0, -u]))  # (1 - u w)
    b_asc = np.zeros(1, np.complex128)
    if k.size and np.any(k):
        b_asc = np.convolve(k, a_asc)
    idx = 0
    for i, (u, m) in enumerate(zip(uniq, mult)):
        m = int(m)
        for q in range(1, m + 1):
            term = np.ones(1, np.complex128)
            for j, (u2, m2) in enumerate(zip(uniq, mult)):
                reps = int(m2) - (q if j == i else 0)
                for _ in range(reps):
                    term = np.convolve(term, np.array([1.0, -u2]))
            b_asc = np.polyadd(b_asc[::-1], (r[idx] * term)[::-1])[::-1]
            idx += 1
    return _real_if_close(b_asc), _real_if_close(a_asc)


# ------------------------------------------------------------ simulation

def _to_ss(system):
    """(num, den) | (z, p, k) | (A, B, C, D) -> normalized state space."""
    if len(system) == 2:
        return tf2ss(*system)
    if len(system) == 3:
        return zpk2ss(*system)
    if len(system) == 4:
        return abcd_normalize(*system)
    raise ValueError("system must be a tuple of 2 (tf), 3 (zpk), or "
                     "4 (ss) arrays")


def _to_dss(system):
    """Discrete system tuple (..., dt) -> (A, B, C, D, dt)."""
    if len(system) < 3:
        raise ValueError("discrete system tuples must end with dt")
    *rep, dt = system
    a, b, c, d = _to_ss(tuple(rep))
    return a, b, c, d, float(dt)


def _where(t, device) -> torch.device:
    """The device of a simulation without a signal: where a tensor `t`
    sits, else `device` (None: the card)."""
    if isinstance(t, torch.Tensor):
        return t.device
    return card_device() if device is None else torch.device(device)


def _host(v):
    """`v` (a tensor, an array or a list) as a host f64 array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def _f64(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float64, device=device)


def _states(step, drive, x0, n_steps):
    """x_0 .. x_{n_steps-1} of x_{k+1} = step @ x_k + drive[k] from x0, one
    f64 `addmv` per step into a time-major buffer (rows of `drive` past
    n_steps - 2 are not read)."""
    xs = torch.empty((n_steps, x0.shape[0]), dtype=torch.float64, device=x0.device)
    if n_steps:
        xs[0] = x0
    if x0.shape[0]:
        for k in range(n_steps - 1):
            torch.addmv(drive[k], step, xs[k], out=xs[k + 1])
    return xs


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete-time LTI system — scipy.signal.dlsim semantics:
    `system` is (num, den, dt), (z, p, k, dt), or (A, B, C, D, dt); `u` is
    (n_steps,) or (n_steps, n_inputs). Returns (tout, yout, xout) for
    state-space input, (tout, yout) otherwise: yout (n_steps, n_outputs),
    xout (n_steps, n_states), in u's dtype (at least float32) on u's
    device (`as_signal`), computed in f64.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.ltisys import dlsim
    >>> t, y = dlsim(([0.5], [1.0, -0.5], 1.0), torch.tensor([1.0, 0.0, 0.0]))
    >>> y.ravel()
    tensor([0.0000, 0.5000, 0.2500])
    """
    a, b, c, d, dt = _to_dss(system)
    u = as_signal(u)
    dtype, dev = result_real_dtype(u.dtype), u.device
    u = torch.atleast_1d(u).to(torch.float64)
    if u.ndim == 1:
        u = u[:, None]
    n_steps = u.shape[0]
    if t is None:
        tout = torch.arange(n_steps, dtype=torch.float64, device=dev) * dt
    else:
        tout = _f64(t, dev)
        if tout.shape[0] != n_steps:
            raise ValueError("t must have the same length as u")
    n_states = a.shape[0]
    x0 = np.zeros(n_states) if x0 is None else _host(x0)
    x0 = _f64(x0.reshape(n_states), dev)
    a, b, c, d = (_f64(m, dev) for m in (a, b, c, d))
    xout = _states(a, u @ b.T, x0, n_steps)
    yout = xout @ c.T + u @ d.T
    if len(system) == 5:
        return tout, yout.to(dtype), xout.to(dtype)
    return tout, yout.to(dtype)


def _discrete_responses(system, x0, t, n, device, first_only):
    """dimpulse / dstep: one dlsim per input, that input a unit impulse
    (first_only) or a unit step."""
    a, b, c, d, dt = _to_dss(system)
    dev = _where(t, device)
    if n is None:
        n = 100 if t is None else len(np.atleast_1d(_host(t)))
    n_inputs = b.shape[1]
    youts = []
    tout = None
    for i in range(n_inputs):
        u = torch.zeros((n, n_inputs), dtype=torch.float64, device=dev)
        u[:1 if first_only else n, i] = 1.0
        tout, y, _ = dlsim((a, b, c, d, dt), u, t=t, x0=x0)
        youts.append(y)
    return tout, tuple(youts)


def dimpulse(system, x0=None, t=None, n=None, *, device=None):
    """Discrete impulse response — scipy.signal.dimpulse semantics: returns
    (tout, (y_per_input, ...)), in float64, where a tensor `t` sits, else
    on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import dimpulse
    >>> t, (y,) = dimpulse(([0.5], [1.0, -0.5], 1.0), n=4, device="cpu")
    >>> y.ravel()
    tensor([0.0000, 0.5000, 0.2500, 0.1250], dtype=torch.float64)
    """
    return _discrete_responses(system, x0, t, n, device, first_only=True)


def dstep(system, x0=None, t=None, n=None, *, device=None):
    """Discrete step response — scipy.signal.dstep semantics, on the
    device `dimpulse` takes.

    Examples:

    y[n] = 0.5 x[n] + 0.5 y[n-1] stepping toward 1:

    >>> from nx_signal_tpu_torch.ops.ltisys import dstep
    >>> t, (y,) = dstep(([0.5], [1.0, -0.5], 1.0), n=4, device="cpu")
    >>> y.ravel()
    tensor([0.0000, 0.5000, 0.7500, 0.8750], dtype=torch.float64)
    """
    return _discrete_responses(system, x0, t, n, device, first_only=False)


def _default_response_times(a, n):
    """Time vector covering ~7 time constants of the slowest stable pole
    (scipy's _default_response_times)."""
    vals = np.linalg.eigvals(a) if a.size else np.array([-1.0])
    r = np.min(np.abs(np.real(vals)))
    if r == 0.0:
        r = 1.0
    tc = 1.0 / r
    return np.linspace(0.0, 7.0 * tc, n)


def lsim(system, u, t, x0=None, interp: bool = True, *, device=None):
    """Simulate a continuous-time LTI system over uniformly spaced times —
    scipy.signal.lsim semantics: exact ZOH (interp=False) or
    linearly-interpolated-input (interp=True) discretization via the block
    matrix exponential on the host, then the recurrence on the device.
    Returns (tout, yout, xout). A signal `u` sets the device and the dtype
    (at least float32); with no input (None, 0 or all zeros) the run is in
    float64 where a tensor `t` sits, else on `device` (None: the card).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.ltisys import lsim
    >>> t, y, x = lsim(([1.0], [1.0, 1.0]), torch.ones(3, dtype=torch.float64),
    ...                torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64))
    >>> y.round(decimals=4)
    tensor([0.0000, 0.3935, 0.6321], dtype=torch.float64)
    """
    a, b, c, d = _to_ss(system)
    signal = None if u is None or (np.isscalar(u) and u == 0.0) else as_signal(u)
    dev = _where(t, device) if signal is None else signal.device
    dtype = torch.float64 if signal is None else result_real_dtype(signal.dtype)
    t_host = np.atleast_1d(_host(t))
    if t_host.ndim != 1:
        raise ValueError("t must be 1-D")
    if t_host[0] != 0.0:
        raise ValueError("Initial time must be zero")
    tout = _f64(t if isinstance(t, torch.Tensor) else t_host, dev)
    n_steps = t_host.shape[0]
    n_states, n_inputs = a.shape[0], b.shape[1]
    x0 = np.zeros(n_states) if x0 is None else _host(x0)
    x0 = _f64(x0.reshape(n_states), dev)

    if signal is None or not torch.any(signal):  # one sync on a tensor
        u_arr = torch.zeros((n_steps, n_inputs), dtype=torch.float64, device=dev)
    else:
        u_arr = torch.atleast_1d(signal).to(torch.float64)
        if u_arr.ndim == 1:
            u_arr = u_arr[:, None]
        if u_arr.shape[0] != n_steps:
            raise ValueError("u must have the same number of rows as t")
        if u_arr.shape[1] != n_inputs:
            raise ValueError("System does not define that many inputs.")
    c_t, d_t = _f64(c, dev), _f64(d, dev)
    if n_steps == 1:
        y = x0 @ c_t.T + u_arr[0] @ d_t.T
        return tout, y.squeeze().to(dtype), x0.squeeze().to(dtype)

    dt = t_host[1] - t_host[0]
    if not np.allclose(np.diff(t_host), dt):
        raise ValueError("Time steps are not equally spaced.")

    if not interp:
        m = np.vstack([np.hstack([a * dt, b * dt]),
                       np.zeros((n_inputs, n_states + n_inputs))])
        em = _expm(m.T)
        ad = em[:n_states, :n_states]
        bd0 = em[n_states:, :n_states]
        bd1 = np.zeros_like(bd0)
    else:
        m = np.vstack([
            np.hstack([a * dt, b * dt, np.zeros((n_states, n_inputs))]),
            np.hstack([np.zeros((n_inputs, n_states + n_inputs)),
                       np.eye(n_inputs)]),
            np.zeros((n_inputs, n_states + 2 * n_inputs)),
        ])
        em = _expm(m.T)
        ad = em[:n_states, :n_states]
        bd1 = em[n_states + n_inputs:, :n_states]
        bd0 = em[n_states:n_states + n_inputs, :n_states] - bd1

    # x_{k+1} = x_k ad + u_k bd0 + u_{k+1} bd1 (row vectors, as the JAX scan)
    drive = u_arr[:-1] @ _f64(bd0, dev) + u_arr[1:] @ _f64(bd1, dev)
    xout = _states(_f64(ad.T, dev), drive, x0, n_steps)
    yout = (xout @ c_t.T).squeeze() + (u_arr @ d_t.T).squeeze()
    return tout, yout.to(dtype), xout.squeeze().to(dtype)


def impulse(system, x0=None, t=None, n: int = None, *, device=None):
    """Continuous impulse response — scipy.signal.impulse semantics: the
    impulse enters as an initial state B (plus any x0). In float64 where a
    tensor `t` sits, else on `device` (None: the card).

    Examples:

    h(t) = e^{-t} for 1/(s+1):

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.ltisys import impulse
    >>> t, y = impulse(([1.0], [1.0, 1.0]), t=torch.tensor([0.0, 1.0, 2.0]))
    >>> y.round(decimals=4)
    tensor([1.0000, 0.3679, 0.1353], dtype=torch.float64)
    """
    a, b, c, d = _to_ss(system)
    dev = _where(t, device)
    if n is None:
        n = 100
    t = _default_response_times(a, n) if t is None else t
    x = b.reshape(-1) if x0 is None else b.reshape(-1) + _host(x0).reshape(-1)
    tout, y, _ = lsim((a, b, c, d), None, _f64(t, dev), x0=x, interp=False)
    return tout, y


def step(system, x0=None, t=None, n: int = None, *, device=None):
    """Continuous step response — scipy.signal.step semantics, on the
    device `impulse` takes.

    Examples:

    s(t) = 1 - e^{-t} for 1/(s+1):

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.ltisys import step
    >>> t, y = step(([1.0], [1.0, 1.0]), t=torch.tensor([0.0, 1.0, 2.0]))
    >>> y.round(decimals=4)
    tensor([0.0000, 0.6321, 0.8647], dtype=torch.float64)
    """
    a, b, c, d = _to_ss(system)
    dev = _where(t, device)
    if n is None:
        n = 100
    t = _f64(_default_response_times(a, n) if t is None else t, dev)
    u = torch.ones((t.shape[0], b.shape[1]), dtype=torch.float64, device=dev)
    tout, y, _ = lsim((a, b, c, d), u, t, x0=x0, interp=True)
    return tout, y


def findfreqs(num, den, n: int, kind: str = "ba"):
    """Log-spaced frequency grid covering a system's interesting range —
    scipy.signal.findfreqs semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import findfreqs
    >>> np.round(np.asarray(findfreqs([1.0], [1.0, 1.0], 4)), 4)
    array([ 0.01,  0.1 ,  1.  , 10.  ])
    """
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.atleast_1d(den))) + 0j
        tz = np.atleast_1d(np.roots(np.atleast_1d(num))) + 0j
    elif kind == "zp":
        ep = np.atleast_1d(den) + 0j
        tz = np.atleast_1d(num) + 0j
    else:
        raise ValueError("input must be one of {'ba', 'zp'}")
    if len(ep) == 0:
        ep = np.atleast_1d(-1000.0) + 0j
    ez = np.r_[ep[ep.imag >= 0],
               tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]]
    integ = (np.abs(ez) < 1e-10).astype(float)
    hfreq = np.round(np.log10(np.max(3.0 * np.abs(ez.real + integ)
                                     + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(np.abs((ez + integ).real)
                                           + 2.0 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, n)


def freqresp(system, w=None, n: int = 10000):
    """Frequency response H(jw) of a continuous system —
    scipy.signal.freqresp semantics. Returns (w, H).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import freqresp
    >>> w, h = freqresp(([1.0], [1.0, 1.0]), w=np.asarray([0.5, 1.0, 2.0]))
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([0.8944, 0.7071, 0.4472])
    """
    if len(system) == 2:
        num, den = np.atleast_1d(system[0]), np.atleast_1d(system[1])
    elif len(system) == 3:
        from nx_signal_tpu_torch.ops.iir_design import zpk2tf

        num, den = zpk2tf(*system)
    elif len(system) == 4:
        num, den = ss2tf(*system)
        num = np.atleast_2d(num)[0]
    else:
        raise ValueError("system must be a tuple of 2, 3, or 4 arrays")
    if w is None:
        w = findfreqs(num, den, n)
    else:
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
    s = 1j * w
    h = np.polyval(np.atleast_1d(num), s) / np.polyval(np.atleast_1d(den), s)
    return w, h


def bode(system, w=None, n: int = 100):
    """Bode magnitude/phase of a continuous system — scipy.signal.bode
    semantics: returns (w, mag_dB, unwrapped phase_deg).

    Examples:

    The RC lowpass loses 3 dB at its corner and 20 dB/decade after:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import bode
    >>> w, mag, phase = bode(([1.0], [1.0, 1.0]), w=np.asarray([0.1, 1.0, 10.0]))
    >>> np.round(np.asarray(mag), 4)
    array([ -0.0432,  -3.0103, -20.0432])
    """
    w, h = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w, mag, phase


def dfreqresp(system, w=None, n: int = 10000, whole: bool = False):
    """Frequency response of a discrete system — scipy.signal.dfreqresp
    semantics: returns (w, H) with w in rad/sample.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import dfreqresp
    >>> w, h = dfreqresp(([0.5], [1.0, -0.5], 1.0), w=np.asarray([0.0, np.pi/2]))
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([1.    , 0.4472])
    """
    if len(system) == 3:
        num, den, dt = np.atleast_1d(system[0]), np.atleast_1d(system[1]), system[2]
    else:
        a, b, c, d, dt = _to_dss(system)
        num, den = ss2tf(a, b, c, d)
        num = np.atleast_2d(num)[0]
    if w is None:
        span = 2.0 * np.pi if whole else np.pi
        w = np.linspace(0.0, span, n, endpoint=False)
    else:
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
    z = np.exp(1j * w)
    h = np.polyval(np.atleast_1d(num), z) / np.polyval(np.atleast_1d(den), z)
    return w, h


def dbode(system, w=None, n: int = 100):
    """Bode of a discrete system — scipy.signal.dbode semantics: w is
    returned in rad/s (rad/sample divided by dt).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import dbode
    >>> w, mag, phase = dbode(([1.0, 0.1], [1.0, -0.9], 0.1), n=4)
    >>> np.round(np.asarray(mag), 2)   # dB magnitude over the dlti grid
    array([20.83,  3.31, -2.53, -5.5 ])
    """
    dt = system[-1]
    w, h = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w / dt, mag, phase


# ------------------------------------------------------------ class wrappers

class lti:
    """Continuous-time LTI system — the scipy.signal.lti interface over the
    functional API above. Construct from 2 (num, den), 3 (z, p, k), or
    4 (A, B, C, D) arguments; the instance keeps the given representation
    and converts on demand (scipy returns representation-specific
    subclasses; here one class carries all three views).

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import lti
    >>> sys = lti([1.0], [1.0, 1.0])
    >>> type(sys).__name__
    'lti'
    """

    dt = None

    def __init__(self, *system):
        if len(system) not in (2, 3, 4):
            raise ValueError("lti takes 2 (tf), 3 (zpk), or 4 (ss) arguments")
        self._system = tuple(system)

    def __repr__(self):
        kinds = {2: "tf", 3: "zpk", 4: "ss"}
        return f"lti({kinds[len(self._system)]}, {self._system!r})"

    # -- representations
    def to_ss(self):
        return _to_ss(self._system)

    def to_tf(self):
        if len(self._system) == 2:
            return normalize(*self._system)
        num, den = ss2tf(*self.to_ss())
        return np.atleast_2d(num)[0], den

    def to_zpk(self):
        from nx_signal_tpu_torch.ops.iir_design import tf2zpk

        if len(self._system) == 3:
            return self._system
        return tf2zpk(*self.to_tf())

    @property
    def zeros(self):
        return self.to_zpk()[0]

    @property
    def poles(self):
        return self.to_zpk()[1]

    # -- responses (on the device the functions take, `device` included)
    def impulse(self, X0=None, T=None, N=None, *, device=None):
        return impulse(self._system, x0=X0, t=T, n=N, device=device)

    def step(self, X0=None, T=None, N=None, *, device=None):
        return step(self._system, x0=X0, t=T, n=N, device=device)

    def output(self, U, T, X0=None, *, device=None):
        return lsim(self._system, U, T, x0=X0, device=device)

    def freqresp(self, w=None, n: int = 10000):
        return freqresp(self._system, w=w, n=n)

    def bode(self, w=None, n: int = 100):
        return bode(self._system, w=w, n=n)

    def to_discrete(self, dt, method: str = "zoh", alpha=None):
        sysd = cont2discrete(self._system, dt, method=method, alpha=alpha)
        rep = list(sysd[:-1])
        if len(rep) == 2:  # single-output tf comes back with a 2-D num row
            rep[0] = np.atleast_2d(rep[0])[0]
        return dlti(*rep, dt=sysd[-1])


class dlti:
    """Discrete-time LTI system — the scipy.signal.dlti interface over the
    functional API above (dimpulse/dstep/dlsim/dfreqresp/dbode).

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import dlti
    >>> sys = dlti([0.5], [1.0, -0.5], dt=1.0)
    >>> sys.dt
    1.0
    """

    def __init__(self, *system, dt=True):
        if len(system) not in (2, 3, 4):
            raise ValueError("dlti takes 2 (tf), 3 (zpk), or 4 (ss) arguments")
        self._system = tuple(system)
        self.dt = 1.0 if dt is True else float(dt)

    def __repr__(self):
        kinds = {2: "tf", 3: "zpk", 4: "ss"}
        return f"dlti({kinds[len(self._system)]}, {self._system!r}, dt={self.dt})"

    def _full(self):
        return self._system + (self.dt,)

    def to_ss(self):
        return _to_ss(self._system) + (self.dt,)

    def to_tf(self):
        if len(self._system) == 2:
            return normalize(*self._system) + (self.dt,)
        num, den = ss2tf(*_to_ss(self._system))
        return np.atleast_2d(num)[0], den, self.dt

    def to_zpk(self):
        from nx_signal_tpu_torch.ops.iir_design import tf2zpk

        if len(self._system) == 3:
            return self._system + (self.dt,)
        return tf2zpk(*self.to_tf()[:2]) + (self.dt,)

    @property
    def zeros(self):
        return self.to_zpk()[0]

    @property
    def poles(self):
        return self.to_zpk()[1]

    def impulse(self, x0=None, t=None, n=None, *, device=None):
        return dimpulse(self._full(), x0=x0, t=t, n=n, device=device)

    def step(self, x0=None, t=None, n=None, *, device=None):
        return dstep(self._full(), x0=x0, t=t, n=n, device=device)

    def output(self, u, t=None, x0=None):
        return dlsim(self._full(), u, t=t, x0=x0)

    def freqresp(self, w=None, n: int = 10000, whole: bool = False):
        return dfreqresp(self._full(), w=w, n=n, whole=whole)

    def bode(self, w=None, n: int = 100):
        return dbode(self._full(), w=w, n=n)


# ------------------------------------------------ representation classes

def _convert_rep(system, kind):
    """Convert a bare 2/3/4-tuple representation to `kind` in
    {'tf', 'zpk', 'ss'} (host-side, design-time math)."""
    from nx_signal_tpu_torch.ops.iir_design import tf2zpk, zpk2tf

    n = len(system)
    if kind == "tf":
        if n == 2:
            return normalize(*system)
        if n == 3:
            return normalize(*zpk2tf(*system))
        num, den = ss2tf(*system)
        return np.atleast_2d(num)[0], den
    if kind == "zpk":
        if n == 3:
            z, p, k = system
            return (np.atleast_1d(np.asarray(z)),
                    np.atleast_1d(np.asarray(p)), float(k))
        return tf2zpk(*_convert_rep(system, "tf"))
    if kind == "ss":
        return _to_ss(tuple(system))
    raise ValueError(f"unknown representation kind {kind!r}")


class _SystemClass:
    """Shared machinery for the scipy.signal representation classes
    TransferFunction / ZerosPolesGain / StateSpace. Unlike scipy (where
    `lti(...)` itself returns one of these subclasses), `lti`/`dlti` above
    stay plain tuple-view wrappers; these classes add the named-attribute
    surface (`.num/.den`, `.zeros/.poles/.gain`, `.A/.B/.C/.D`) and
    instance-returning conversions. `dt=None` means continuous time
    (scipy.signal.TransferFunction etc. semantics); any other value —
    `True` for unspecified or a float — means discrete time."""

    _kind = None
    _nargs = None

    def __init__(self, *system, dt=None):
        if len(system) == 1 and isinstance(system[0], (_SystemClass, lti, dlti)):
            src = system[0]
            if isinstance(src, _SystemClass):
                rep, src_dt = src._system, src.dt
            elif isinstance(src, dlti):
                rep, src_dt = src._system, src.dt
            else:
                rep, src_dt = src._system, None
            system = _convert_rep(rep, self._kind)
            dt = src_dt if dt is None else dt
        elif len(system) != self._nargs:
            raise ValueError(
                f"{type(self).__name__} takes {self._nargs} system arrays "
                f"(or one system instance), got {len(system)}")
        else:
            system = _convert_rep(tuple(system), self._kind)
        self._system = tuple(system)
        self.dt = dt

    # -- time-domain semantics
    @property
    def _is_discrete(self):
        return self.dt is not None

    def _dt_value(self):
        return 1.0 if self.dt is True else float(self.dt)

    def _full(self):
        """System tuple for the functional API (discrete includes dt)."""
        if self._is_discrete:
            return self._system + (self._dt_value(),)
        return self._system

    def __repr__(self):
        body = ",\n".join(f"    {np.asarray(s)!r}" if not np.isscalar(s)
                          else f"    {s!r}" for s in self._system)
        return (f"{type(self).__name__}(\n{body},\n    dt: {self.dt}\n)")

    # -- conversions (return class instances, scipy semantics)
    def to_tf(self):
        return TransferFunction(*_convert_rep(self._system, "tf"), dt=self.dt)

    def to_zpk(self):
        return ZerosPolesGain(*_convert_rep(self._system, "zpk"), dt=self.dt)

    def to_ss(self):
        return StateSpace(*_convert_rep(self._system, "ss"), dt=self.dt)

    def to_discrete(self, dt, method: str = "zoh", alpha=None):
        """Discretize a continuous system; returns the same representation
        class with `dt` set (scipy.signal.lti.to_discrete)."""
        if self._is_discrete:
            raise ValueError("to_discrete is only defined for "
                             "continuous-time systems")
        sysd = cont2discrete(self._system, dt, method=method, alpha=alpha)
        rep = list(sysd[:-1])
        if len(rep) == 2:
            rep[0] = np.atleast_2d(rep[0])[0]
        return type(self)(*rep, dt=sysd[-1])

    # -- shared spectral views
    @property
    def zeros(self):
        return _convert_rep(self._system, "zpk")[0]

    @property
    def poles(self):
        return _convert_rep(self._system, "zpk")[1]

    # -- responses (dispatch on continuous/discrete; on the device the
    # functions take, `device` included)
    def impulse(self, x0=None, t=None, n=None, *, device=None):
        if self._is_discrete:
            return dimpulse(self._full(), x0=x0, t=t, n=n, device=device)
        return impulse(self._system, x0=x0, t=t, n=n, device=device)

    def step(self, x0=None, t=None, n=None, *, device=None):
        if self._is_discrete:
            return dstep(self._full(), x0=x0, t=t, n=n, device=device)
        return step(self._system, x0=x0, t=t, n=n, device=device)

    def output(self, u, t=None, x0=None, *, device=None):
        if self._is_discrete:
            return dlsim(self._full(), u, t=t, x0=x0)
        return lsim(self._system, u, t, x0=x0, device=device)

    def freqresp(self, w=None, n: int = 10000):
        if self._is_discrete:
            return dfreqresp(self._full(), w=w, n=n)
        return freqresp(self._system, w=w, n=n)

    def bode(self, w=None, n: int = 100):
        if self._is_discrete:
            return dbode(self._full(), w=w, n=n)
        return bode(self._system, w=w, n=n)


class TransferFunction(_SystemClass):
    """Transfer-function system representation — scipy.signal
    TransferFunction semantics (continuous for `dt=None`, discrete
    otherwise). Not in the reference (nx_signal has no system classes).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import TransferFunction
    >>> sys = TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0])
    >>> sys.num
    array([1., 3.])
    >>> sys.den
    array([1., 2., 1.])
    >>> sys.to_zpk().poles
    array([-1., -1.])
    """

    _kind = "tf"
    _nargs = 2

    @property
    def num(self):
        return self._system[0]

    @property
    def den(self):
        return self._system[1]


class ZerosPolesGain(_SystemClass):
    """Zeros-poles-gain system representation — scipy.signal ZerosPolesGain
    semantics. Not in the reference.

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import ZerosPolesGain
    >>> sys = ZerosPolesGain([0.5], [0.1, 0.2], 2.0)
    >>> sys.gain, sys.to_tf().num.shape
    (2.0, (2,))
    """

    _kind = "zpk"
    _nargs = 3

    @property
    def gain(self):
        return self._system[2]


class StateSpace(_SystemClass):
    """State-space system representation — scipy.signal StateSpace
    semantics. Not in the reference.

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import StateSpace, tf2ss
    >>> ss = StateSpace(*tf2ss([1.0, 2.0], [1.0, 3.0, 2.0]))
    >>> ss.A.shape, ss.D.shape
    ((2, 2), (1, 1))
    """

    _kind = "ss"
    _nargs = 4

    @property
    def A(self):
        return self._system[0]

    @property
    def B(self):
        return self._system[1]

    @property
    def C(self):
        return self._system[2]

    @property
    def D(self):
        return self._system[3]


# ------------------------------------------------------- pole placement

class PlacePolesResult:
    """Result bunch for place_poles — scipy.signal field names
    (gain_matrix, computed_poles, requested_poles, X, rtol, nb_iter)."""

    def __init__(self, gain_matrix, computed_poles, requested_poles,
                 X, rtol, nb_iter):
        self.gain_matrix = gain_matrix
        self.computed_poles = computed_poles
        self.requested_poles = requested_poles
        self.X = X
        self.rtol = rtol
        self.nb_iter = nb_iter

    def __repr__(self):
        return (f"PlacePolesResult(gain_matrix={self.gain_matrix!r}, "
                f"computed_poles={self.computed_poles!r})")


def _pole_subspaces(a, u1, poles):
    """Orthonormal basis S_i of {x : (A - p_i I) x ∈ range(B)} for each
    requested pole, via the SVD null space of U1ᴴ (A − p_i I) where U1
    spans range(B)ᵖᵉʳᵖ."""
    n = a.shape[0]
    bases = []
    for p in poles:
        m = u1.conj().T @ (a - p * np.eye(n))
        _, s, vh = np.linalg.svd(m)
        rank = int(np.sum(s > s[0] * max(m.shape) * np.finfo(float).eps)) \
            if s.size else 0
        basis = vh[rank:].conj().T       # (n, n - rank) orthonormal columns
        if basis.shape[1] == 0:
            raise ValueError(
                "at least one requested pole cannot be assigned: the "
                "constraint subspace for pole %r is empty (B rank too low "
                "for this multiplicity)" % p)
        bases.append(basis)
    return bases


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30):
    """Full-state-feedback pole placement: find K so that the eigenvalues
    of ``A - B K`` are `poles` — scipy.signal.place_poles call surface
    (method/rtol/maxiter accepted; result fields gain_matrix,
    computed_poles, requested_poles, X, rtol, nb_iter). Not in the
    reference.

    Algorithm: Kautsky-Nichols-Van Dooren eigenstructure assignment. For
    each requested pole the admissible eigenvector subspace
    S_i = {x : (A − p_i I) x ∈ range(B)} is computed from the SVD of
    U1ᴴ(A − p_i I); eigenvectors X[:, i] ∈ S_i are then chosen to
    maximize conditioning by cyclic projection sweeps (for rank-1 B each
    S_i is one-dimensional and the solution is unique, as in scipy).
    Complex poles must come in conjugate pairs; their eigenvectors are
    kept conjugate so K is real. K is recovered from
    B K X = A X − X diag(p).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import place_poles
    >>> A = np.array([[0.0, 1.0], [-2.0, -3.0]])
    >>> B = np.array([[0.0], [1.0]])
    >>> res = place_poles(A, B, [-4.0, -5.0])
    >>> np.round(res.gain_matrix, 6)
    array([[18.,  6.]])
    >>> np.sort(res.computed_poles.real)
    array([-5., -4.])
    """
    a = np.atleast_2d(np.asarray(A, dtype=np.float64))
    b = np.atleast_2d(np.asarray(B, dtype=np.float64))
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("A must be square")
    if b.shape[0] != n:
        raise ValueError("A and B must have the same number of rows")
    if method not in ("YT", "KNV0"):
        raise ValueError("method must be 'YT' or 'KNV0'")
    poles = np.atleast_1d(np.asarray(poles, dtype=np.complex128))
    if poles.size != n:
        raise ValueError("needs exactly %d poles, got %d" % (n, poles.size))
    # conjugate-pair validation and canonical ordering (imag-ascending
    # within conjugate pairs so pairing is adjacent)
    poles = poles[np.argsort(np.abs(poles.imag), kind="stable")]
    cplx = poles[np.abs(poles.imag) > 0]
    if cplx.size % 2 or (cplx.size and not np.allclose(
            np.sort_complex(cplx), np.sort_complex(cplx.conj()))):
        raise ValueError("complex poles must come in conjugate pairs")
    # pair order: reals first, then (p, conj(p)) adjacent
    reals = poles[np.abs(poles.imag) == 0].real
    remaining = list(cplx[cplx.imag > 0])
    ordered = list(reals.astype(np.complex128))
    for p in remaining:
        ordered += [p, np.conj(p)]
    poles_ord = np.asarray(ordered)
    n_real = reals.size

    # range(B) split
    q, _ = np.linalg.qr(b, mode="complete")
    rank = int(np.linalg.matrix_rank(b))
    if rank == 0:
        raise ValueError("B is the zero matrix; poles cannot be moved")
    counts = {}
    for p in poles_ord:
        key = complex(np.round(p.real, 12), np.round(p.imag, 12))
        counts[key] = counts.get(key, 0) + 1
        if counts[key] > rank:
            raise ValueError("a pole may not be requested with multiplicity "
                             "greater than rank(B) = %d" % rank)
    u1 = q[:, rank:]                     # orthonormal basis of range(B)^perp

    bases = _pole_subspaces(a.astype(np.complex128), u1.astype(np.complex128),
                            poles_ord)

    # initial X: first basis vector of each subspace, conjugate-paired
    x = np.empty((n, n), dtype=np.complex128)
    for i in range(n):
        if i >= n_real and (i - n_real) % 2 == 1:
            x[:, i] = np.conj(x[:, i - 1])
        else:
            x[:, i] = bases[i][:, 0]

    nb_iter = 0
    if rank > 1 and n > 1:
        # cyclic projection sweeps: move each eigenvector toward the
        # direction orthogonal to the span of the others, projected back
        # into its admissible subspace (KNV conditioning improvement)
        prev_det = 0.0
        for nb_iter in range(1, maxiter + 1):
            for i in range(n):
                if i >= n_real and (i - n_real) % 2 == 1:
                    x[:, i] = np.conj(x[:, i - 1])
                    continue
                others = np.delete(x, i, axis=1)
                qo, _ = np.linalg.qr(others, mode="complete")
                yi = qo[:, -1]            # unit vector ⟂ span(others)
                si = bases[i]
                proj = si @ (si.conj().T @ yi)
                nrm = np.linalg.norm(proj)
                if nrm > 1e-12:
                    x[:, i] = proj / nrm
            det = float(np.abs(np.linalg.det(x)))
            if det <= prev_det * (1.0 + rtol):
                break
            prev_det = det

    cond = np.linalg.cond(x)
    if cond * np.finfo(float).eps > 1e-4:
        warnings.warn("place_poles: the eigenvector matrix is "
                      "ill-conditioned (cond=%.3g); the computed poles may "
                      "be far from the requested ones" % cond)

    # realify X: conjugate pair columns -> (Re, Im) columns; the real X
    # spans the same invariant subspace with a real block-diagonal Lambda
    lam = np.diag(poles_ord)
    m_c = x @ lam @ np.linalg.inv(x)     # A - BK (complex arithmetic)
    m = np.real(m_c)
    # K from B K = A - M, using the economy pseudo-inverse of B
    k = np.linalg.lstsq(b, a - m, rcond=None)[0]
    computed = np.linalg.eigvals(a - b @ k)
    x_real = x.copy()
    for i in range(n_real, n, 2):
        x_real[:, i], x_real[:, i + 1] = np.real(x[:, i]), np.imag(x[:, i])
    return PlacePolesResult(k, np.sort_complex(computed),
                            poles_ord, np.real(x_real), rtol, nb_iter)
