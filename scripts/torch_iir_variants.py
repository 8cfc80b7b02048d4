#!/usr/bin/env python3
"""The forms of the IIR recurrence y[n] = v[n] - a1 y[n-1] - a2 y[n-2] of
the PyTorch port (`nx_signal_tpu_torch/ops/iir.py`) timed against the
alternatives in one run, on one NVIDIA GPU, at order 2 (one biquad of
`sosfilt`) on 768 x 480 000 float32 from a seed:

1. the port's chunked form: each 64-sample chunk's zero-state response one
   product with the Toeplitz matrix of the impulse response, the chunks'
   end states chained by a doubling scan over the chunks in f64, each
   chunk's zero-input response one (rows, 2) x (2, 64) product;
2. the same chain and zero-input product, each chunk's zero-state response
   instead one vectorised step per sample inside the chunk (64 steps over
   every chunk and channel at once);
3. the direct port of the JAX package's log-depth scan: a Hillis-Steele
   doubling scan over every sample of the affine maps (A, b), 6 floats a
   sample, double-buffered (19 steps at 480 000 samples);
4. one f64 step per sample over every channel (the form the port runs for
   orders above 2), the JAX package's `lax.scan`.

Each form: median of 5 CUDA-event timings (3 for form 4), its peak memory
above the input (`torch.cuda.max_memory_allocated`), and its largest
per-row error against f64 scipy.signal.lfilter on 8 channels, relative to
the row's max. Then form 1 by stage (medians of 5): the numerator's FIR
that `lfilter` runs first (3 taps), the Toeplitz product, the end states,
the chain over the chunks and the zero-input product. Prints the card's
name and power limit first; writes the numbers to
chiprun_out/iir_variants.json. Imports nothing of JAX.

    python3 scripts/torch_iir_variants.py     # from the repository root
"""

import json
import os
import subprocess
import sys

import numpy as np
import scipy.signal as ss
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nx_signal_tpu_torch.kernels.dft import _exact_f32  # noqa: E402
from nx_signal_tpu_torch.ops import iir  # noqa: E402
from nx_signal_tpu_torch.ops.iir_design import butter  # noqa: E402


def chunked_steps(v, a_tail):
    """Form 2: the chunk's zero-state response by steps inside the chunk."""
    length, n = iir._CHUNK, 2
    rows, t = v.shape
    chunks = t // length
    _, _, t_mat, g = iir._chunk_constants(tuple(a_tail.tolist()), length)
    vp = v.reshape(rows, chunks, length)
    y = torch.empty_like(vp)
    y1 = torch.zeros_like(vp[..., 0])
    y2 = torch.zeros_like(y1)
    for j in range(length):
        yj = vp[..., j] - a_tail[0] * y1 - a_tail[1] * y2
        y[..., j] = yj
        y2, y1 = y1, yj
    ends = torch.stack([y[..., -1], y[..., -2]], dim=-1).double()
    states = iir._chained_states(ends, torch.as_tensor(t_mat, device=v.device))
    with _exact_f32():
        y.reshape(-1, length).addmm_(states.reshape(-1, n).float(),
                                     torch.as_tensor(g.T, device=v.device).float())
    return y.reshape(rows, t)


def hillis_steele(v, a_tail):
    """Form 3: the doubling scan over the samples of the affine maps
    s_n = A s_{n-1} + (v_n, 0), A the companion matrix, kept per sample."""
    a1, a2 = float(a_tail[0]), float(a_tail[1])
    rows, t = v.shape
    m = torch.empty((4, t, rows), dtype=v.dtype, device=v.device)  # A's entries per sample
    m[0], m[1], m[2], m[3] = -a1, -a2, 1.0, 0.0
    b = torch.zeros((2, t, rows), dtype=v.dtype, device=v.device)
    b[0] = v.T
    step = 1
    while step < t:
        # (m2, b2) after (m1, b1): m2 @ m1, m2 @ b1 + b2, for samples >= step
        p, q = m[:, step:], m[:, :-step]
        nm = m.clone()
        nb = b.clone()
        nm[0, step:] = p[0] * q[0] + p[1] * q[2]
        nm[1, step:] = p[0] * q[1] + p[1] * q[3]
        nm[2, step:] = p[2] * q[0] + p[3] * q[2]
        nm[3, step:] = p[2] * q[1] + p[3] * q[3]
        nb[0, step:] = p[0] * b[0, :-step] + p[1] * b[1, :-step] + b[0, step:]
        nb[1, step:] = p[2] * b[0, :-step] + p[3] * b[1, :-step] + b[1, step:]
        m, b = nm, nb
        step *= 2
    return b[0].T.contiguous()


def stages(v, b, a_tail):
    """Form 1's stages, each a function to time, on inputs made once."""
    length, n = iir._CHUNK, 2
    rows, t = v.shape
    chunks = t // length
    toeplitz, ends_cols, t_mat, g = iir._chunk_constants(tuple(a_tail.tolist()), length)
    dev = v.device
    toeplitz, ends_cols = (torch.as_tensor(m, device=dev).float() for m in (toeplitz, ends_cols))
    t_mat, g_t = torch.as_tensor(t_mat, device=dev), torch.as_tensor(g.T, device=dev).float()
    vp = v.reshape(rows, chunks, length)
    with _exact_f32():
        y = vp @ toeplitz
        ends = (vp @ ends_cols).double()
    states = iir._chained_states(ends, t_mat).reshape(-1, n).float()

    def exact(fn):
        def run():
            with _exact_f32():
                return fn()
        return run

    return {
        "numerator FIR (3 taps, shift-and-add)": lambda: iir._causal_fir(v, b),
        "Toeplitz product (the chunks' zero-state responses)": exact(lambda: vp @ toeplitz),
        "end states, to f64": exact(lambda: (vp @ ends_cols).double()),
        "chain over the chunks (doubling scan, f64)": lambda: iir._chained_states(ends, t_mat),
        "zero-input product (addmm_, K = 2)": exact(
            lambda: y.reshape(-1, length).addmm_(states, g_t)),
    }


FORMS = {
    "1 chunked, Toeplitz product (the port)": lambda v, a: iir._recurrence_chunked(v, a),
    "2 chunked, a step per sample in the chunk": chunked_steps,
    "3 Hillis-Steele scan over the samples": hillis_steele,
    "4 one f64 step per sample (orders > 2)": lambda v, a: iir._recurrence_per_sample(v, a),
}


def main():
    if not torch.cuda.is_available():
        print("torch_iir_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rows, t = 768, 480_000
    b, a = butter(2, 0.1)
    a_tail = a[1:] / a[0]
    gen = torch.Generator(device=dev).manual_seed(11)
    v = torch.randn((rows, t), generator=gen, device=dev)
    want = ss.lfilter([1.0], a, v[:8].double().cpu().numpy())
    results = {"card": card, "shape": [rows, t], "design": "butter(2, 0.1) denominator"}
    for name, fn in FORMS.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        y = fn(v, a_tail)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        got = y[:8].double().cpu().numpy()
        rel = float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())
        del y
        times = []
        for _ in range(3 if name.startswith("4") else 5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(v, a_tail)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        results[name] = dict(ms=ms, peak_gib=peak, rel_err=rel)
        print(f"{name}: {ms:.3f} ms, peak {peak:.3f} GiB above the input, per-row error "
              f"{rel:.3g} of the row's max vs f64 scipy ({rows}x{t} f32; {card})", flush=True)
        torch.cuda.empty_cache()
    results["stages of form 1"] = {}
    for name, fn in stages(v, b, a_tail).items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[2]
        results["stages of form 1"][name] = ms
        print(f"form 1, {name}: {ms:.3f} ms ({rows}x{t} f32; {card})", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "iir_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
