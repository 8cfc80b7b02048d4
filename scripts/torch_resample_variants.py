#!/usr/bin/env python3
"""The polyphase constants of the PyTorch port (`nx_signal_tpu_torch/ops/
resample.py`) timed against their alternatives in one run, on one NVIDIA
GPU, float32 from a seed:

1. the output tile R of `upfirdn` (`_TILE_OUTPUTS`, a multiple of `up`
   near it; 1 gives the minimal R = up), each with the 'conv' and the
   'materialize' strategy forced, for `resample_poly(x, 1, 3)` and
   `upfirdn` (31 taps, up 2, down 3) at 64 x 2 880 000 (BASELINE.json
   config 4 at 60 s), and for `upfirdn` (21 taps, down 1000) at 8 x 2 880
   000, with and without the fallback to R = up (`_TILE_MAX_WEIGHTS`);
2. the cut between the 'materialize' and the banded 'conv' strategies
   (`_MATERIALIZE_MAX_BLOCKS`, 8 hop blocks per frame; the JAX package
   takes 'conv' up to 32 and 'materialize' past it): both forced, on a pure
   FIR (`upfirdn(h, x, 1, 1)`, R = 128) and a decimation by 3, at 8 x 2 880
   000, with filters long enough to span 2 to 65 hop blocks;
3. the polyphase sum of `pfb_analyze(strategy='factored')`
   (`_polyphase_sum`): one depthwise conv1d against tpc shifted
   multiply-adds, at 16, 64, 256 and 1024 bands, tpc 8, on 8 x 4 194 304
   (BASELINE.json config 5), beside the whole factored PFB in each mode,
   its DFT matmul, and the sum's bytes bound (read the signal once, write
   the sum once, at 3.35 TB/s).

Each variant: median of 5 CUDA-event timings, peak memory above the input
(`torch.cuda.max_memory_allocated`), and its largest difference from the
port's default, relative to the max. Prints the card's name and power
limit first; writes the numbers to chiprun_out/resample_variants.json.
Imports nothing of JAX.

    python3 scripts/torch_resample_variants.py     # from the repository root
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nx_signal_tpu_torch.kernels.dft import _exact_f32  # noqa: E402
from nx_signal_tpu_torch.ops import resample as rs  # noqa: E402
from nx_signal_tpu_torch.ops.filters import firwin  # noqa: E402

_PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def time_ms(fn):
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times[1:])[2]  # the first is a warm-up


def measure(fn, ref=None):
    """(median ms, peak GiB above what was allocated, max|y - ref| / max|ref|)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    err = 0.0 if ref is None else float((y - ref).abs().max() / ref.abs().max())
    del y
    return time_ms(fn), peak, err


class Constants:
    """Set module constants of ops/resample.py for the duration."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: getattr(rs, k) for k in self.values}
        for k, v in self.values.items():
            setattr(rs, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(rs, k, v)


def shifted_sum(u, w):
    """The polyphase sum as tpc shifted multiply-adds in tap order (the JAX
    package's 'shifts' lowering), against the port's depthwise conv1d."""
    tpc = w.shape[0]
    frames = u.shape[-2] - tpc + 1
    s = w[0] * u[..., :frames, :]
    for j in range(1, tpc):
        s = s + w[j] * u[..., j:j + frames, :]
    return s


def factored_with_shifts(x, proto, m, tpc):
    """`ops.resample._pfb_factored` with the shifted-add sum."""
    nb = x.shape[-1] // m
    u = x[..., :nb * m].reshape(*x.shape[:-1], nb, m)
    s = shifted_sum(u, proto.to(x.device).reshape(tpc, m))
    with _exact_f32():
        acc = torch.matmul(s.reshape(-1, m), rs._pfb_dft_matrix(m, x.device))
    acc = acc.reshape(*s.shape[:-1], 2 * m)
    return torch.complex(acc[..., :m], acc[..., m:])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    report = {"card": card, "tile": {}, "cut": {}, "pfb_sum": {}}

    def randn(seed, shape):
        return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    # 1. the output tile R, with each strategy forced, at the phase-11
    # shapes; then at down = 1000, where the port falls back to R = up
    x = randn(1, (64, 2_880_000))
    h31 = torch.randn(31, generator=torch.Generator().manual_seed(31))
    calls = {"resample_poly 1/3 64x2880000": lambda: rs.resample_poly(x, 1, 3),
             "upfirdn 31 taps 2/3 64x2880000": lambda: rs.upfirdn(h31, x, 2, 3)}
    x8 = randn(4, (8, 2_880_000))
    h21 = torch.randn(21, generator=torch.Generator().manual_seed(21))
    calls["upfirdn 21 taps 1/1000 8x2880000"] = lambda: rs.upfirdn(h21, x8, 1, 1000)
    for name, fn in calls.items():
        ref = fn()
        tiles = (1, 32, 128) if "1000" in name else (1, 16, 32, 64, 128, 256)
        weights = (1 << 22, 1 << 40) if "1000" in name else (1 << 22,)
        for tile in tiles:
            for max_weights in weights:
                for strategy, cut in (("conv", 0), ("materialize", 10**9)):
                    with Constants(_TILE_OUTPUTS=tile, _TILE_MAX_WEIGHTS=max_weights,
                                   _MATERIALIZE_MAX_BLOCKS=cut):
                        ms, peak, err = measure(fn, ref)
                    key = f"{name} R~{tile} {strategy}" + (
                        "" if max_weights == 1 << 22 else " no fallback")
                    report["tile"][key] = dict(ms=ms, peak_gib=peak, rel_err=err)
                    print(f"1 {key}: {ms:.3f} ms, peak {peak:.3f} GiB, max|d| / max "
                          f"{err:.2g} ({card})", flush=True)
        del ref
    del x, x8

    # 2. the 'conv' / 'materialize' cut: hop blocks per frame C =
    # ceil((T + (R/up - 1) down) / ((R/up) down)) at R = 128
    x = randn(2, (8, 2_880_000))
    for up, down, lengths in ((1, 1, (31, 255, 1023, 2047, 4095, 8191)),
                              (1, 3, (61, 1021, 4093, 12285))):
        for k in lengths:
            h = torch.randn(k, generator=torch.Generator().manual_seed(k))
            stride = 128 * down
            c_blocks = -(-(k + 127 * down) // stride)
            fn = lambda: rs.upfirdn(h, x, up, down)  # noqa: E731
            with Constants(_MATERIALIZE_MAX_BLOCKS=0):
                ref = fn()
                conv = measure(fn, ref)
            with Constants(_MATERIALIZE_MAX_BLOCKS=10**9):
                mat = measure(fn, ref)
            del ref
            key = f"up {up} down {down} taps {k} C {c_blocks}"
            report["cut"][key] = dict(conv_ms=conv[0], conv_peak_gib=conv[1],
                                      materialize_ms=mat[0], materialize_peak_gib=mat[1],
                                      rel_err=mat[2])
            print(f"2 upfirdn {key} 8x2880000: conv {conv[0]:.3f} ms (peak {conv[1]:.3f} GiB), "
                  f"materialize {mat[0]:.3f} ms (peak {mat[1]:.3f} GiB), max|d| / max "
                  f"{mat[2]:.2g} ({card})", flush=True)
    del x

    # 3. the polyphase sum of the factored PFB
    x = randn(3, (8, 4_194_304))
    tpc = 8
    for m in (16, 64, 256, 1024):
        proto = firwin(m * tpc, [1.0 / m], window=("kaiser", 5.0), device="cpu")
        nb = x.shape[-1] // m
        u = x[..., :nb * m].reshape(x.shape[0], nb, m)
        w = proto.to(dev).reshape(tpc, m)
        ref = shifted_sum(u, w)
        s_conv = measure(lambda: rs._polyphase_sum(u, w), ref)
        s_shift = measure(lambda: shifted_sum(u, w), ref)
        pfb_ref = factored_with_shifts(x, proto, m, tpc)
        p_conv = measure(lambda: rs._pfb_factored(x, proto, m, tpc), pfb_ref)
        p_shift = measure(lambda: factored_with_shifts(x, proto, m, tpc), pfb_ref)
        f_mat = rs._pfb_dft_matrix(m, dev)
        flat = ref.reshape(-1, m)

        def dft():
            with _exact_f32():
                return flat @ f_mat

        dft_ms = measure(dft)[0]
        bound = 4.0 * (x.numel() + ref.numel()) / _PEAK_BYTES * 1e3
        report["pfb_sum"][m] = dict(
            sum_conv_ms=s_conv[0], sum_shifts_ms=s_shift[0], sum_conv_err=s_conv[2],
            pfb_conv_ms=p_conv[0], pfb_shifts_ms=p_shift[0], pfb_conv_peak_gib=p_conv[1],
            pfb_shifts_peak_gib=p_shift[1], dft_ms=dft_ms, sum_bound_ms=bound)
        print(f"3 pfb {m} bands tpc {tpc} 8x4194304: sum conv {s_conv[0]:.3f} ms, shifts "
              f"{s_shift[0]:.3f} ms (bytes bound {bound:.3f}; max|d| / max {s_conv[2]:.2g}); "
              f"factored PFB with conv {p_conv[0]:.3f} ms (peak {p_conv[1]:.3f} GiB), with "
              f"shifts {p_shift[0]:.3f} ms (peak {p_shift[1]:.3f} GiB); DFT matmul "
              f"{dft_ms:.3f} ms ({card})", flush=True)
        del ref, pfb_ref, u, flat
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "resample_variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
