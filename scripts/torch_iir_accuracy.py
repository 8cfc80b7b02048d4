#!/usr/bin/env python3
"""Why `nx_signal_tpu_torch/ops/iir.py` runs orders above 2 one step per
sample: the accuracy of chunked (two-level) forms of a direct-form
recurrence at order 8 with poles clustered near the unit circle, against
the same recurrence in numpy's long double (64-bit mantissa on x86-64),
on the CPU (an accuracy measurement; no device time).

For butter(8, 0.05), ellip(8, 0.5, 60, 0.15) and butter(8, 0.1) as (b, a),
on 4 x 3000 standard normal samples from a seed, each chunked form
computes the chunk's zero-state response with the Toeplitz matrix of its
impulse response and chains the chunks' end states through T = A^L, then
adds the incoming state's zero-input response. Its constants (impulse
response, T, zero-input responses) are exact (Python fractions) and
rounded to f64 once, so what is left is the chaining's own rounding. The
forms differ by the state's basis (the last N outputs of the all-pole part
after the numerator's FIR, or the DF2T state of b/a), the chunk length L
(64, 256), and the chain (one chunk after another, or a doubling scan over
the chunks as the order-2 form uses). Printed: each form's largest error in
f64 against the long-double result (the JAX package's gate is 1e-9
absolute and 1e-7 relative), its float32 error relative to the max, the
largest entries of the zero-input responses |G| and of T; then the port's
per-sample f64 form and scipy.signal.lfilter against the same result.

    python3 scripts/torch_iir_accuracy.py     # from the repository root
"""

import os
import sys
from fractions import Fraction

import numpy as np
import scipy.signal as ss
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nx_signal_tpu_torch.ops.iir import lfilter  # noqa: E402


def long_double(b, a, x):
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


def exact_constants(b, a, length, basis):
    """(h, G, T, K) rounded once to f64 from fractions: the impulse response
    h (L), the zero-input responses G (L, N), the transition T (N, N) and
    the map K (L, N) from a chunk's input to its end state."""
    n = len(a) - 1
    af = [Fraction(float(t)) for t in a]
    bf = [Fraction(float(t)) for t in b]
    if basis == "outputs":
        def run(init, impulse):
            y, out = list(init), []
            for j in range(length):
                acc = Fraction(1) if impulse and j == 0 else Fraction(0)
                for i in range(1, n + 1):
                    acc -= af[i] * y[-i]
                y.append(acc)
                out.append(acc)
            return out
        h = run([Fraction(0)] * n, True)
        g = [run([Fraction(int(k == n - 1 - m)) for k in range(n)], False) for m in range(n)]
        g = np.array([[float(g[m][j]) for m in range(n)] for j in range(length)])
        t_mat = g[length - 1 - np.arange(n)]
        k = np.array([[float(h[length - 1 - r - i]) if length - 1 - r - i >= 0 else 0.0
                       for r in range(n)] for i in range(length)])
        return np.array([float(v) for v in h]), g, t_mat, k
    # DF2T: z' = A z + B x, y = C z + D x, C = e0
    a_m = [[Fraction(0)] * n for _ in range(n)]
    for i in range(n):
        a_m[i][0] = -af[i + 1]
        if i + 1 < n:
            a_m[i][i + 1] = Fraction(1)
    b_v = [bf[i + 1] - af[i + 1] * bf[0] for i in range(n)]
    rows, row = [], [Fraction(1)] + [Fraction(0)] * (n - 1)
    for _ in range(length):
        rows.append(row)
        row = [sum(row[k] * a_m[k][m] for k in range(n)) for m in range(n)]
    h = [bf[0]] + [sum(rows[j - 1][k] * b_v[k] for k in range(n)) for j in range(1, length)]
    cols = [b_v]
    for _ in range(1, length):
        cols.append([sum(a_m[i][k] * cols[-1][k] for k in range(n)) for i in range(n)])
    k = np.array([[float(cols[length - 1 - i][m]) for m in range(n)] for i in range(length)])
    power = [[Fraction(int(i == j)) for j in range(n)] for i in range(n)]
    for _ in range(length):
        power = [[sum(power[i][q] * a_m[q][m] for q in range(n)) for m in range(n)]
                 for i in range(n)]
    return (np.array([float(v) for v in h]), np.array([[float(v) for v in r] for r in rows]),
            np.array([[float(v) for v in r] for r in power]), k)


def chunked(x, b, a, length, basis, chain, dtype):
    b = np.asarray(b, float) / a[0]
    a = np.asarray(a, float) / a[0]
    h, g, t_mat, k = exact_constants(b, a, length, basis)
    u = ss.lfilter(b, [1.0], x) if basis == "outputs" else x
    u = torch.from_numpy(u).to(dtype)
    idx = np.arange(length)
    lag = idx[None, :] - idx[:, None]
    toeplitz = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
    rows, t = u.shape
    chunks = -(-t // length)
    up = torch.nn.functional.pad(u, (0, chunks * length - t)).reshape(rows, chunks, length)
    y = up @ torch.as_tensor(toeplitz).to(dtype)
    ends = up.double() @ torch.as_tensor(k)
    tt = torch.as_tensor(t_mat)
    if chain == "one after another":
        states = torch.zeros_like(ends)
        s = torch.zeros_like(ends[:, 0])
        for c in range(chunks):
            states[:, c] = s
            s = s @ tt.T + ends[:, c]
    else:
        acc, power, step = ends, tt, 1
        while step < chunks:
            acc = torch.cat([acc[:, :step], acc[:, step:] + acc[:, :-step] @ power.T], dim=1)
            power = power @ power
            step *= 2
        states = torch.nn.functional.pad(acc[:, :-1], (0, 0, 1, 0))
    y = y + (states @ torch.as_tensor(g).T).to(dtype)
    return y.reshape(rows, -1)[:, :t].double().numpy(), np.abs(g).max(), np.abs(t_mat).max()


def main():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3000))
    designs = {"butter(8, 0.05)": ss.butter(8, 0.05),
               "ellip(8, 0.5, 60, 0.15)": ss.ellip(8, 0.5, 60, 0.15),
               "butter(8, 0.1)": ss.butter(8, 0.1)}
    for name, (b, a) in designs.items():
        exact = long_double(b, a, x)
        for basis in ("outputs", "DF2T"):
            for length in (64, 256):
                for chain in ("one after another", "doubling"):
                    y64, g_max, t_max = chunked(x, b, a, length, basis, chain, torch.float64)
                    y32, _, _ = chunked(x.astype(np.float32), b, a, length, basis, chain,
                                        torch.float32)
                    print(f"{name}, {basis} basis, L = {length}, chain {chain}: f64 max|d| "
                          f"{np.abs(y64 - exact).max():.3g} (gate held: "
                          f"{np.allclose(y64, exact, atol=1e-9, rtol=1e-7)}), f32 "
                          f"{np.abs(y32 - exact).max() / np.abs(exact).max():.3g} of the max, "
                          f"|G| {g_max:.3g}, |T| {t_max:.3g}", flush=True)
        port = lfilter(b, a, torch.from_numpy(x)).numpy()
        port32 = lfilter(b, a, torch.from_numpy(x.astype(np.float32))).double().numpy()
        print(f"{name}: the port's per-sample f64 form max|d| {np.abs(port - exact).max():.3g}"
              f", float32 signal {np.abs(port32 - exact).max() / np.abs(exact).max():.3g} of "
              f"the max; scipy.signal.lfilter max|d| "
              f"{np.abs(ss.lfilter(b, a, x) - exact).max():.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
