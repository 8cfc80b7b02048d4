"""IIR filter application (counterpart of nx_signal_tpu/ops/iir.py):
lfilter / lfilter_zi / lfiltic / filtfilt / sosfilt / sosfilt_zi /
sosfiltfilt, with scipy.signal semantics: the direct-form II transposed
convention for the states `zi` / `zf`, and (y, zf) returned when zi is
given.

As in the JAX package, the numerator is a causal shift-and-add over its
taps, a given zi enters as forcing on the first N samples, and the final
state comes in closed form from the last N inputs and outputs. What is
left is the denominator's recurrence

    y[n] = v[n] - a_1 y[n-1] - ... - a_N y[n-N]   (zero initial history),

and its form depends on the order N:

* N <= 2 (every section of `sosfilt`): a chunked two-level form, with no
  loop over samples. The signal is cut into chunks of `_CHUNK` samples;
  each chunk's zero-state response is one product with the Toeplitz matrix
  of the truncated impulse response, for every chunk and channel at once;
  each chunk's last N zero-state outputs (its end state) are chained from
  chunk to chunk through T = A^L (A the companion matrix) by a doubling
  scan over the chunks in f64, about log2(chunks) steps; and each chunk's
  incoming state adds its zero-input response as one (rows, N) x (N, L)
  product. The host builds the impulse response, T and the zero-input
  responses in f64.
* N > 2: per sample, as the JAX package's `lax.scan`, in f64 whatever the
  signal's dtype (the JAX package's arithmetic with x64 on and f64
  coefficients). A chunked form chains states through A^L, and for poles
  clustered near the unit circle the companion products grow transiently
  and the chained states lose digits: `scripts/torch_iir_accuracy.py`
  measures it. High orders belong in `sosfilt`, as scipy advises.

The signal goes through `utils.devices.as_signal`. Its dtype, at least
float32, is the result's; coefficient tensors join that promotion, while
coefficients given as numpy arrays or lists are design constants and only
make the result complex when they are (the JAX package with x64 off).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.dft import _exact_f32
from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = [
    "lfilter",
    "lfilter_zi",
    "lfiltic",
    "filtfilt",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
]

# Samples per chunk of the order <= 2 form: the Toeplitz product costs 2L
# operations a sample, against 8 bytes of f32 traffic.
_CHUNK = 64


def _host(c):
    """Coefficients as a host f64 (complex128 if complex) 1-D array."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    c = np.atleast_1d(np.asarray(c))
    return c.astype(np.complex128 if np.iscomplexobj(c) else np.float64)


def _work_dtype(x, *coefs):
    """The result dtype: the signal's, at least float32, promoted with the
    coefficient tensors' dtypes, and complex if any coefficient is."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    for c in coefs:
        if isinstance(c, torch.Tensor):
            dtype = torch.promote_types(dtype, c.dtype)
        elif np.iscomplexobj(np.asarray(c)):
            dtype = torch.promote_types(dtype, torch.complex64)
    return dtype


def _scalar(c):
    return complex(c) if np.iscomplexobj(c) else float(c)


def _causal_fir(x, b):
    """y[n] = sum_j b[j] x[n-j] (same length as x, zero initial history):
    a shift-and-add over the taps, as in the JAX package."""
    acc = x * _scalar(b[0])
    t = x.shape[-1]
    for j in range(1, min(b.shape[0], t)):
        acc[..., j:].add_(x[..., :t - j], alpha=_scalar(b[j]))
    return acc


@functools.lru_cache(maxsize=64)
def _chunk_constants(a_tail: tuple, length: int):
    """Host f64 constants of the chunked form for y[n] = v[n] - sum_i
    a_tail[i-1] y[n-i]: the (L, L) Toeplitz matrix of the impulse response
    (zero-state output of a chunk = v_chunk @ H), its (L, N) columns that
    give the chunk's last N outputs (the end state, newest first), the
    (N, N) transition T of that state over one chunk, and the (L, N)
    zero-input responses G (output j = G[j] . state)."""
    a = np.asarray(a_tail)
    n = a.shape[0]
    cols = np.zeros((n + length, n + 1), a.dtype)
    cols[n - 1 - np.arange(n), np.arange(n)] = 1.0  # column m: y[-1-m] = 1
    for j in range(length):
        cols[n + j] = -(a[:, None] * cols[n + j - 1 - np.arange(n)]).sum(0)
        if j == 0:
            cols[n, n] += 1.0  # column n: the impulse response
    h, g = cols[n:, n], cols[n:, :n]
    idx = np.arange(length)
    lag = idx[None, :] - idx[:, None]
    toeplitz = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
    last = length - 1 - np.arange(n)
    return toeplitz, toeplitz[:, last], g[last], g


@functools.lru_cache(maxsize=64)
def _chunk_constants_on(a_tail: tuple, length: int, device: torch.device):
    """`_chunk_constants` as tensors on `device` (G transposed), copied there
    once per denominator, chunk length and device: a stream filtered chunk
    by chunk reuses them with no host-to-device copy."""
    toeplitz, ends_cols, t_mat, g = _chunk_constants(a_tail, length)
    return tuple(torch.as_tensor(c, device=device) for c in (toeplitz, ends_cols, t_mat, g.T))


def _chained_states(ends, t_mat):
    """The state entering every chunk, from each chunk's zero-state end
    state (..., K, N): s_0 = 0, s_{k+1} = T s_k + ends_k, by a doubling
    (Hillis-Steele) scan over the chunks. Accumulates in `ends`, in place."""
    chunks, n = ends.shape[-2:]
    acc, power, step = ends, t_mat, 1
    while step < chunks:
        prev = acc[..., :-step, :]
        # T^step prev as N broadcast products, all read before the in-place
        # add (an (N, N) matmul per chunk is far slower for N <= 2)
        moved = prev[..., 0:1] * power[:, 0]
        for m in range(1, n):
            moved.addcmul_(prev[..., m:m + 1], power[:, m])
        acc[..., step:, :] += moved
        power = power @ power
        step *= 2
    return F.pad(acc[..., :-1, :], (0, 0, 1, 0))


def _recurrence_chunked(v, a_tail):
    """The order <= 2 form of the module docstring."""
    n = a_tail.shape[0]
    length = _CHUNK
    lead, t = v.shape[:-1], v.shape[-1]
    chunks = -(-t // length)
    toeplitz, ends_cols, t_mat, g_t = _chunk_constants_on(tuple(a_tail.tolist()), length,
                                                          v.device)
    wide = torch.complex128 if v.is_complex() or np.iscomplexobj(a_tail) else torch.float64
    dtype = v.dtype
    vp = F.pad(v, (0, chunks * length - t)) if chunks * length != t else v
    vp = vp.reshape(-1, chunks, length)
    with _exact_f32():
        y = vp @ toeplitz.to(dtype)
        ends = (vp @ ends_cols.to(dtype)).to(wide)
        states = _chained_states(ends, t_mat.to(wide))
        y.reshape(-1, length).addmm_(states.reshape(-1, n).to(dtype), g_t.to(dtype))
    return y.reshape(*lead, chunks * length)[..., :t]


def _recurrence_per_sample(v, a_tail):
    """The order > 2 form: one step per sample over every channel at once,
    in f64 (complex128), the history kept time-major."""
    n = a_tail.shape[0]
    lead, t = v.shape[:-1], v.shape[-1]
    wide = torch.complex128 if v.is_complex() or np.iscomplexobj(a_tail) else torch.float64
    vt = v.reshape(-1, t).to(wide).T.contiguous()
    hist = torch.zeros((t + n, vt.shape[1]), dtype=wide, device=v.device)
    a_rev = torch.as_tensor(a_tail[::-1].copy(), device=v.device).to(wide)
    for i in range(t):
        torch.addmv(vt[i], hist[i:i + n].T, a_rev, alpha=-1, out=hist[i + n])
    return hist[n:].T.reshape(*lead, t).to(v.dtype)


def _linear_recurrence(v, a_tail):
    """Solve y[n] = v[n] - sum_i a_tail[i-1] y[n-i] (zero initial history)
    along the last axis."""
    if a_tail.shape[0] == 0 or v.shape[-1] == 0:
        return v
    if a_tail.shape[0] > 2:
        return _recurrence_per_sample(v, a_tail)
    return _recurrence_chunked(v, a_tail)


def _normalize_ba(b, a):
    """Host (b, a) padded to one length N + 1 and divided by a[0]."""
    b, a = _host(b), _host(a)
    n = max(b.shape[0], a.shape[0]) - 1
    b = np.pad(b, (0, n + 1 - b.shape[0]))
    a = np.pad(a, (0, n + 1 - a.shape[0]))
    return b / a[0], a / a[0], n


def _state(z, device):
    """A state or coefficient array as a tensor on `device` (a numpy view
    such as np.broadcast_to's is copied)."""
    if isinstance(z, torch.Tensor):
        return z.to(device)
    return torch.as_tensor(np.array(z), device=device)


def _lfilter_last_axis(b, a, x, zi=None):
    """lfilter along the last axis of the tensor `x`; zi (if given) has a
    shape broadcastable to x.shape[:-1] + (order,). Returns y or (y, zf).
    Orders above 2 compute in f64 (complex128) from the numerator's FIR on,
    and cast the results back."""
    dtype = _work_dtype(x, b, a)
    b, a, n = _normalize_ba(b, a)
    calc = torch.promote_types(dtype, torch.float64)
    if n > 2 and calc != dtype:
        out = _lfilter_last_axis(b, a, x.to(calc), None if zi is None else _state(zi, x.device))
        return out.to(dtype) if zi is None else (out[0].to(dtype), out[1].to(dtype))
    x = x.to(dtype)
    m = x.shape[-1]

    v = _causal_fir(x, b)
    if zi is not None:
        zi = _state(zi, x.device).to(dtype)
        zi = torch.broadcast_to(zi, x.shape[:-1] + (n,))
        head = min(n, m)
        v[..., :head] += zi[..., :head]
    y = _linear_recurrence(v, a[1:])
    if zi is None:
        return y
    # closed-form final DF2T state from the last samples:
    # zf_i = sum_{k=1..n-i} (b[i+k] x[M-k] - a[i+k] y[M-k])  (+ zi carryover
    # for signals shorter than the order)
    zf = []
    for i in range(n):
        acc = torch.zeros(x.shape[:-1], dtype=dtype, device=x.device)
        for k in range(1, n - i + 1):
            if m - k >= 0:
                acc = acc + _scalar(b[i + k]) * x[..., m - k] - _scalar(a[i + k]) * y[..., m - k]
        if i + m <= n - 1:
            acc = acc + zi[..., i + m]
        zf.append(acc)
    return y, torch.stack(zf, dim=-1)


def _move_zi(zi, x_ndim, axis, device):
    zi = _state(zi, device)
    if zi.ndim == x_ndim:
        return torch.movedim(zi, axis, -1)
    return zi


def lfilter(b, a, x, axis=-1, zi=None):
    """Filter `x` along `axis` with the rational transfer function b/a,
    scipy.signal.lfilter semantics (direct-form II transposed state
    convention for `zi`/`zf`). Returns y, or (y, zf) when zi is given.
    Orders above 2 run one step per sample (module docstring); prefer
    `sosfilt` (cascaded biquads) for high-order filters, as scipy does.

    Examples:

    The impulse response of y[n] = x[n] + 0.5 y[n-1]:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.iir import lfilter
    >>> lfilter([1.0, 0.0], [1.0, -0.5], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    tensor([1.0000, 0.5000, 0.2500, 0.1250])
    """
    x = as_signal(x)
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    zim = _move_zi(zi, x.ndim, axis, x.device) if zi is not None else None
    out = _lfilter_last_axis(b, a, xm, zim)
    if zi is None:
        return torch.movedim(out, -1, axis)
    y, zf = out
    return torch.movedim(y, -1, axis), torch.movedim(zf, -1, axis)


def lfilter_zi(b, a):
    """Initial DF2T state for step-response steady state,
    scipy.signal.lfilter_zi semantics (solve (I - A^T) zi = B with A the
    companion matrix of `a` and B = b[1:] - a[1:] b[0]). Host f64 numpy.

    Examples:

    The one-pole smoother settles to zi = 1 for a unit step:

    >>> from nx_signal_tpu_torch.ops.iir import lfilter_zi
    >>> lfilter_zi([1.0, 0.0], [1.0, -0.5]).round(4)
    array([1.])
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    while len(a) > 1 and a[0] == 0.0:
        a = a[1:]
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    companion = np.zeros((n - 1, n - 1))
    companion[0, :] = -a[1:]
    if n > 2:
        companion[np.arange(1, n - 1), np.arange(0, n - 2)] = 1.0
    iminus_a = np.eye(n - 1) - companion.T
    rhs = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus_a, rhs)


def lfiltic(b, a, y, x=None):
    """DF2T initial state `zi` that reproduces the past outputs
    `y = [y[-1], y[-2], ...]` and past inputs `x = [x[-1], x[-2], ...]`,
    scipy.signal.lfiltic semantics: zi[m] = sum_i b[m+1+i] x[i] -
    sum_i a[m+1+i] y[i] after normalizing to a[0] == 1, with short y/x
    zero-extended. Host f64 numpy.

    Examples:

    >>> from nx_signal_tpu_torch.ops.iir import lfiltic
    >>> lfiltic([1.0, 0.0], [1.0, -0.5], [2.0]).round(4)
    array([1.])
    """
    b, a = _host(b), _host(a)
    if a[0] != 1.0:
        if a[0] == 0.0:
            raise ValueError("a[0] must be nonzero")
        b = b / a[0]
        a = a / a[0]
    n = a.shape[0] - 1
    m = b.shape[0] - 1
    k = max(m, n)
    y = _host(y)
    y = np.pad(y, (0, max(0, n - y.shape[0])))
    x = np.zeros(m) if x is None else _host(x)
    x = np.pad(x, (0, max(0, m - x.shape[0])))
    zi = np.zeros(k, dtype=np.float64)
    for i in range(m):
        zi[i] += np.sum(b[i + 1:] * x[: m - i])
    for i in range(n):
        zi[i] -= np.sum(a[i + 1:] * y[: n - i])
    return zi


def _odd_ext(x, n):
    """Odd extension of length n at both ends of the last axis."""
    left = 2 * x[..., :1] - x[..., 1:n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -n - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _even_ext(x, n):
    left = x[..., 1:n + 1].flip(-1)
    right = x[..., -n - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _const_ext(x, n):
    left = x[..., :1].expand(*x.shape[:-1], n)
    right = x[..., -1:].expand(*x.shape[:-1], n)
    return torch.cat([left, x, right], dim=-1)


def _extend(x, n, padtype):
    if padtype == "odd":
        return _odd_ext(x, n)
    if padtype == "even":
        return _even_ext(x, n)
    if padtype == "constant":
        return _const_ext(x, n)
    raise ValueError(
        f"padtype must be 'odd', 'even', 'constant', or None, got {padtype!r}"
    )


def _edge(length, ntaps, padtype, padlen):
    edge = 0 if padtype is None else (int(3 * ntaps) if padlen is None else int(padlen))
    if edge >= length:
        raise ValueError(
            "The length of the input vector x must be greater than padlen, "
            f"which is {edge}."
        )
    return edge


def filtfilt(b, a, x, axis=-1, padtype="odd", padlen=None):
    """Zero-phase forward-backward filtering, scipy.signal.filtfilt 'pad'
    method semantics: extend by 3*max(len(a), len(b)) (default, odd),
    filter forward and backward with lfilter_zi-scaled initial states,
    slice the extension off.

    Examples:

    Zero-phase smoothing settles onto a step without lag:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.iir import filtfilt
    >>> from nx_signal_tpu_torch.ops.iir_design import butter
    >>> b, a = butter(2, 0.25)
    >>> x = torch.cat([torch.zeros(4), torch.ones(8)])
    >>> filtfilt(b, a, x)[-3:].numpy().round(4)
    array([1.0249, 1.0102, 0.9985], dtype=float32)
    """
    x = as_signal(x)
    axis = axis % x.ndim
    ntaps = max(_host(a).shape[0], _host(b).shape[0])
    edge = _edge(x.shape[axis], ntaps, padtype, padlen)
    xm = torch.movedim(x, axis, -1)
    ext = _extend(xm, edge, padtype) if edge > 0 else xm
    ext = ext.to(_work_dtype(ext, b, a))
    zi = torch.as_tensor(lfilter_zi(_host(b).real, _host(a).real), device=x.device).to(ext.dtype)
    y, _ = _lfilter_last_axis(b, a, ext, zi * ext[..., :1])
    y = y.flip(-1)
    y, _ = _lfilter_last_axis(b, a, y, zi * y[..., :1])
    y = y.flip(-1)
    if edge > 0:
        y = y[..., edge:-edge]
    return torch.movedim(y, -1, axis)


def _sos_host(sos):
    """The (n_sections, 6) host f64 array of `sos`."""
    if isinstance(sos, torch.Tensor):
        sos = sos.detach().cpu().numpy()
    sos = np.asarray(sos)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    return sos.astype(np.complex128 if np.iscomplexobj(sos) else np.float64)


def sosfilt(sos, x, axis=-1, zi=None):
    """Filter with cascaded second-order sections, scipy.signal.sosfilt
    semantics (zi of shape (n_sections, ..., 2) in the DF2T convention).
    Returns y or (y, zf). Each biquad runs the chunked order-2 form of the
    module docstring: no loop over samples at any order.

    Examples:

    A one-pole low-pass (y[n] = 0.5 x[n] + 0.5 y[n-1]) impulse response:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.iir import sosfilt
    >>> sosfilt([[0.5, 0.0, 0.0, 1.0, -0.5, 0.0]], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    tensor([0.5000, 0.2500, 0.1250, 0.0625])
    """
    sos_np = _sos_host(sos)
    x = as_signal(x)
    axis = axis % x.ndim
    out = torch.movedim(x, axis, -1)
    out = out.to(_work_dtype(out, sos))
    zf_list = []
    for s in range(sos_np.shape[0]):
        b, a = sos_np[s, :3], sos_np[s, 3:]
        if zi is not None:
            zi_s = _move_zi(zi[s], x.ndim, axis, x.device)
            out, zf_s = _lfilter_last_axis(b, a, out, zi_s)
            zf_list.append(zf_s)
        else:
            out = _lfilter_last_axis(b, a, out)
    out = torch.movedim(out, -1, axis)
    if zi is None:
        return out
    zf = torch.stack([torch.movedim(z, -1, axis) for z in zf_list], dim=0)
    return out, zf


def sosfilt_zi(sos):
    """Initial states for sosfilt step-response steady state,
    scipy.signal.sosfilt_zi semantics: per-section lfilter_zi scaled by the
    cumulative DC gain of the preceding sections. Host f64 numpy.

    Examples:

    >>> from nx_signal_tpu_torch.ops.iir import sosfilt_zi
    >>> sosfilt_zi([[0.5, 0.0, 0.0, 1.0, -0.5, 0.0]]).round(4)
    array([[0.5, 0. ]])
    """
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for s in range(n_sections):
        b, a = sos[s, :3], sos[s, 3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfiltfilt(sos, x, axis=-1, padtype="odd", padlen=None):
    """Zero-phase forward-backward SOS filtering, scipy.signal.sosfiltfilt
    semantics.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.iir import sosfiltfilt
    >>> from nx_signal_tpu_torch.ops.iir_design import butter
    >>> sos = butter(2, 0.25, output="sos")
    >>> x = torch.cat([torch.zeros(4), torch.ones(8)])
    >>> sosfiltfilt(sos, x)[-3:].numpy().round(4)
    array([1.0249, 1.0102, 0.9985], dtype=float32)
    """
    sos_np = _sos_host(sos)
    x = as_signal(x)
    axis = axis % x.ndim
    n_sections = sos_np.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos_np[:, 2] == 0).sum(), (sos_np[:, 5] == 0).sum())
    edge = _edge(x.shape[axis], ntaps, padtype, padlen)
    xm = torch.movedim(x, axis, -1)
    ext = _extend(xm, edge, padtype) if edge > 0 else xm
    ext = ext.to(_work_dtype(ext, sos))
    zi = torch.as_tensor(sosfilt_zi(sos_np.real), device=x.device).to(ext.dtype)  # (S, 2)

    def run(sig):
        z = zi.reshape((n_sections,) + (1,) * (sig.ndim - 1) + (2,)) * sig[..., :1]
        for s in range(n_sections):
            sig, _ = _lfilter_last_axis(sos_np[s, :3], sos_np[s, 3:], sig, z[s])
        return sig

    y = run(ext)
    y = run(y.flip(-1)).flip(-1)
    if edge > 0:
        y = y[..., edge:-edge]
    return torch.movedim(y, -1, axis)
