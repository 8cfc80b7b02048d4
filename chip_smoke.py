#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nx_signal_tpu_torch`) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version, drives the port's main path through its public entry points and
times the kernels.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure raises, and the exit code is not 0):
  0. the card's name and power limit (nvidia-smi); no CUDA device is a failure.
  1. build the kernels of nx_signal_tpu_torch/kernels/csrc with nvcc (sm_90a),
     one nvcc process per source, all at once.
  2. each kernel against its plain version on the same device tensors:
     A (fused FIR + framed DFT + power) at 768 x 480000 with the bench chain
     (firwin 255 taps @ 48 kHz, hann 512, hop 128, n_fft 512) and B (framed
     DFT) at 64 x 480000, each bin within 1e-4 x that bin's max|plain| (a
     per-bin gate, so the low-pass chain's small stopband bins are held as
     tightly as its passband); C (overlap-add) on the (64, 3747, 512) frames
     of framed_idft, bitwise; then two ragged geometries (even taps, hop not
     dividing the frame, length not a multiple of the hop, a hop whose
     window needs the small frame tile), and stft_fir_chain with
     frame_chunks=4, which must launch kernel A once. D (the shared
     hop-block chain) at 768 x 480000 with the bench chain against its
     plain version and against A given the window D applies (the periodic
     hann in f64), per bin at 1e-4; then D on the geometries of the JAX
     package's shared-kernel tests (Blackman with 63 taps on a (3, 2)
     batch, Hamming with hop 256 and no taps, n_fft 1024 with 129 taps)
     and on a length that is not a multiple of the hop with even taps, a
     hop of 50, and a hop of 1000 (whose window needs the 16-block tile),
     with random taps as those tests use.
  3. the fused chain, models.pipeline.stft_fir_chain(return_filtered=False,
     precision='high') on 768 x 480000, held on two channels against an
     f64 numpy reference (convolve, frame, window, rfft, |.|^2), per bin.
  4. stft -> istft (onesided, hann 512, overlap 384) on 64 x 480000 through
     the public functions; interior reconstruction error <= 1e-5 x max|x|.
  5. the shared path: fir_framed_dft(kernel='cuda_shared') and
     fir_framed_dft_shared(output='power', onesided=True) on 768 x 480000,
     each held on two channels against the f64 numpy reference with the
     periodic f64 hann, per bin.
  6. the filtered chain: stft_fir_chain(return_filtered=True) on 768 x
     480000, on two channels: the filtered signal against np.convolve
     'same', the power against the f64 DFT of that filtered signal and end
     to end against the f64 numpy reference, each within 1e-4 x max and
     per bin within 5e-3 of the bin's max (an f32 filtered signal has no
     digits for a per-bin 1e-4 at its deepest stopband bins); then
     FIRFilterChain on the same signal against np.convolve 'same' (within
     1e-4 x max).
     Phases 3-6 drive the main paths through their public entry points:
     the launch counters are zeroed just before each and read just after,
     and each must have launched the kernels of its path.
  7. median of 5 CUDA-event timings of each kernel and its plain version,
     taken in turns, at the phase-2 shapes; then of the filtered chain's
     two stages (the direct FIR and kernel B) at 768 x 480000.
The line before the last is one JSON object describing the kernels; the last
is the device line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time


def _gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _check_close(name, got, want, rel=1e-4) -> float:
    """Gate each bin (last axis) at rel x that bin's own max|want|; returns
    the max abs error over all bins."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    dims = tuple(range(want.ndim - 1))
    err_bin = (got - want).abs().amax(dim=dims)
    scale_bin = want.abs().amax(dim=dims)
    rel_bin = err_bin / scale_bin
    worst = int(rel_bin.argmax())
    err, worst_rel = float(err_bin.max()), float(rel_bin[worst])
    print(f"  {name}: max|d| = {err:.6g}, max|plain| = {float(scale_bin.max()):.6g}, "
          f"largest per-bin rel = {worst_rel:.3g} at bin {worst} of {want.shape[-1]} "
          f"(gate {rel:g})", flush=True)
    if not worst_rel <= rel:
        raise AssertionError(f"{name}: bin {worst} max|d| {float(err_bin[worst])} > "
                             f"{rel} x {float(scale_bin[worst])}")
    return err


def _check_bitwise(name, got, want) -> float:
    """Fail unless got and want are bitwise equal; returns max|d| (0.0)."""
    import torch

    same = got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))
    print(f"  {name}: bitwise equal = {same}", flush=True)
    if not same:
        raise AssertionError(f"{name}: not bitwise equal to the plain fold "
                             f"(max|d| = {_max_err(got, want)})")
    return _max_err(got, want)


def _time_ms(fn) -> float:
    """One run of fn timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _run_path(name, kernels, expect, fn):
    """Zero every launch counter, run one main path, and fail unless each
    kernel of `expect` was launched on it; returns the counts."""
    for kernel in kernels:
        kernel.launches = 0
    fn()
    counts = {k.__name__: k.launches for k in kernels}
    print(f"  launches on {name}: {counts}", flush=True)
    for kernel in expect:
        if counts[kernel.__name__] < 1:
            raise AssertionError(f"{kernel.__name__} was not launched on {name}")
    return counts


def _numpy_filter(x2, taps):
    """f64 numpy 'same' convolution of each row with the taps."""
    import numpy as np

    k, length = taps.shape[0], x2.shape[-1]
    return np.stack([np.convolve(c, taps)[(k - 1) // 2:][:length] for c in x2])


def _numpy_power(y2, window, *, hop, num_frames, n_fft):
    """f64 numpy framing, window, rfft and |.|^2 of each row."""
    import numpy as np

    fr = np.lib.stride_tricks.sliding_window_view(y2, window.shape[0], axis=-1)
    return np.abs(np.fft.rfft(fr[:, ::hop][:, :num_frames] * window, n=n_fft)) ** 2


def main() -> int:
    import numpy as np
    import torch

    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    print(_gpu_name_and_power_limit(), flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}", flush=True)

    from nx_signal_tpu_torch.kernels import cuda_dft
    from nx_signal_tpu_torch.kernels._build import library_path, load_library
    from nx_signal_tpu_torch.kernels.dft import (
        _dft_weights, _framed_matmul_torch, _same_pad_left, _shared_power_torch,
        fir_dft_fold_weights, fir_framed_dft, fir_framed_dft_shared, framed_idft,
        recognize_cosine_window, shared_fold_weights, shared_twiddles)
    from nx_signal_tpu_torch.models.pipeline import FIRFilterChain, stft_fir_chain
    from nx_signal_tpu_torch.ops import windows
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.spectral.framing import _ola_fold_torch
    from nx_signal_tpu_torch.spectral.stft import istft, stft

    A = cuda_dft.fir_framed_dft_power_cuda
    B = cuda_dft.framed_dft_cuda
    C = cuda_dft.overlap_add_cuda
    D = cuda_dft.fir_framed_dft_power_shared_cuda
    kernels = (A, B, C, D)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    load_library()
    print(f"phase 1: built {library_path().name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---------------------------------------------------------------- 2
    channels, length, rate = 768, 480000, 48000.0
    num_taps, frame, hop, n_fft = 255, 512, 128, 512
    bins = n_fft // 2 + 1
    num_frames = (length - frame) // hop + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((channels, length), generator=gen, device=dev)
    taps = firwin(num_taps, [2000.0], sampling_rate=rate).numpy()
    window = hann(frame).numpy()
    pad_left = (num_taps - 1) - (num_taps - 1) // 2

    print("phase 2: kernels against their plain versions", flush=True)
    w_fold = fir_dft_fold_weights(taps, window, n_fft, True, device=dev)
    args_a = dict(stride=hop, pad_left=pad_left, num_frames=num_frames, bins=bins)
    got = A(x, w_fold, **args_a)
    want = _framed_matmul_torch(x, w_fold, power=True, **args_a)
    err_a = _check_close(f"A {channels}x{length}", got, want)
    del got, want

    x64 = x[:64]
    w_dft = torch.as_tensor(_dft_weights(window, frame, n_fft, True, np.float32), device=dev)
    args_b = dict(stride=hop, num_frames=num_frames, bins=bins)
    z_kernel = B(x64, w_dft, **args_b)
    acc = _framed_matmul_torch(x64, w_dft, pad_left=0, power=False, **args_b)
    z_plain = torch.complex(acc[..., :bins], acc[..., bins:])
    err_b = _check_close("B 64x480000 complex", z_kernel, z_plain)
    _check_close("B 64x480000 power", B(x64, w_dft, output="power", **args_b),
                 acc[..., :bins] ** 2 + acc[..., bins:] ** 2)
    del z_kernel, acc

    frames = framed_idft(z_plain, window, n_fft=n_fft, onesided=True)
    out_length = num_frames * hop + (frame - hop)
    err_c = _check_bitwise(f"C {tuple(frames.shape)}",
                           C(frames, stride=hop, out_length=out_length),
                           _ola_fold_torch(frames, hop, out_length))
    del z_plain

    ragged = [  # channels, length, taps, frame, hop, n_fft, B onesided
        (4, 48037, 100, 400, 150, 512, True),
        (3, 50001, 64, 1024, 1000, 1024, False),
    ]
    for ch, n, k, fl, hp, nf, onesided in ragged:
        xr = torch.randn((ch, n), generator=gen, device=dev)
        tr = firwin(k, [3000.0], sampling_rate=rate).numpy()
        wr = hann(fl).numpy()
        m = (n - fl) // hp + 1
        tag = f"{ch}x{n} K={k} frame={fl} hop={hp} n_fft={nf}"
        wf = fir_dft_fold_weights(tr, wr, nf, True, device=dev)
        args = dict(stride=hp, pad_left=(k - 1) - (k - 1) // 2, num_frames=m,
                    bins=nf // 2 + 1)
        _check_close(f"A {tag}", A(xr, wf, **args),
                     _framed_matmul_torch(xr, wf, power=True, **args))
        nb = nf // 2 + 1 if onesided else nf
        wd = torch.as_tensor(_dft_weights(wr, fl, nf, onesided, np.float32), device=dev)
        acc = _framed_matmul_torch(xr, wd, stride=hp, pad_left=0, num_frames=m, bins=nb,
                                   power=False)
        _check_close(f"B {tag} onesided={onesided}",
                     B(xr, wd, stride=hp, num_frames=m, bins=nb),
                     torch.complex(acc[..., :nb], acc[..., nb:]))
        fr = torch.randn((ch, m, fl), generator=gen, device=dev)
        ol = m * hp + (fl - hp)
        _check_bitwise(f"C {tuple(fr.shape)} hop={hp}", C(fr, stride=hp, out_length=ol),
                       _ola_fold_torch(fr, hp, ol))

    # frame_chunks shapes only the plain path: the chain still runs kernel A
    chain_args = dict(fft_length=n_fft, overlap_length=frame - hop, sampling_rate=rate,
                      onesided=True, return_filtered=False, precision="high",
                      frame_chunks=4)
    xs = x[:4, :48000]
    before = A.launches
    got = stft_fir_chain(xs, taps, window, **chain_args)
    if A.launches != before + 1:
        raise AssertionError(f"stft_fir_chain(frame_chunks=4) launched kernel A "
                             f"{A.launches - before} times, not once")
    want = fir_framed_dft(xs, taps, window, stride=hop, n_fft=n_fft, onesided=True,
                          output="power", frame_chunks=4, kernel="torch")
    _check_close("A via stft_fir_chain(frame_chunks=4) vs chunked plain", got, want)
    del got, want

    # D applies the window as its exact cosine sum: A is given the same
    # window, the periodic hann in f64 (the f32 samples of hann(512) differ
    # from it by up to 6e-8, which the low-pass chain's stopband bins see)
    window64 = hann(frame, dtype=torch.float64).numpy()
    coeffs = recognize_cosine_window(window64, n_fft)
    w_shared = shared_fold_weights(taps, hop, n_fft, device=dev)
    tw_shared = shared_twiddles(hop, n_fft, device=dev)
    args_d = dict(stride=hop, pad_left=pad_left, num_frames=num_frames, bins=bins)
    got_d = D(x, w_shared, tw_shared, coeffs, **args_d)
    err_d = _check_close(f"D {channels}x{length}", got_d,
                         _shared_power_torch(x, w_shared, tw_shared, coeffs, **args_d))
    w_fold64 = fir_dft_fold_weights(taps, window64, n_fft, True, device=dev)
    _check_close(f"D vs A {channels}x{length}", got_d, A(x, w_fold64, **args_a))
    del got_d

    rng = np.random.default_rng(0)
    shared_ragged = [  # batch, length, taps (None: no FIR), hop, n_fft, window
        ((3, 2), 9000, 63, 128, 512, "blackman"),
        ((1,), 40000, None, 256, 512, "hamming"),
        ((2,), 20000, 129, 128, 1024, "hann"),
        ((2,), 48037, 100, 128, 512, "hann"),
        ((1,), 30001, 32, 50, 400, "blackman"),
        ((1,), 50001, 64, 1000, 2000, "hann"),   # the 16-block tile
    ]
    for batch, n, k, hp, nf, wname in shared_ragged:
        xr = torch.randn((*batch, n), generator=gen, device=dev)
        tr = None if k is None else rng.normal(size=k)
        wr = getattr(windows, wname)(nf, dtype=torch.float64).numpy()
        cr = recognize_cosine_window(wr, nf)
        args = dict(stride=hp, pad_left=0 if k is None else _same_pad_left(k),
                    num_frames=(n - nf) // hp + 1, bins=nf // 2 + 1)
        ws, tws = shared_fold_weights(tr, hp, nf, device=dev), shared_twiddles(hp, nf, device=dev)
        tag = f"{batch}x{n} K={k} hop={hp} n_fft={nf} {wname}"
        got = D(xr, ws, tws, cr, **args)
        _check_close(f"D {tag}", got, _shared_power_torch(xr, ws, tws, cr, **args))
        wa = fir_dft_fold_weights(np.ones(1) if k is None else tr, wr, nf, True, device=dev)
        _check_close(f"D vs A {tag}", got, A(xr, wa, **args))
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    print("phase 3: stft_fir_chain(return_filtered=False, precision='high')", flush=True)
    out = {}

    def fused_chain():
        t0 = time.perf_counter()
        out["power"] = stft_fir_chain(x, torch.as_tensor(taps), torch.as_tensor(window),
                                      fft_length=n_fft, overlap_length=frame - hop,
                                      sampling_rate=rate, onesided=True,
                                      return_filtered=False, precision="high")
        torch.cuda.synchronize()
        print(f"  {tuple(out['power'].shape)} in {time.perf_counter() - t0:.3f} s "
              "(first call)", flush=True)

    launches = _run_path("the fused chain", kernels, (A,), fused_chain)
    power = out.pop("power")
    if tuple(power.shape) != (channels, num_frames, bins):
        raise AssertionError(f"chain output shape {tuple(power.shape)}")
    if not bool(torch.isfinite(power).all()):
        raise AssertionError("chain output is not finite")
    xh = x[:2].double().cpu().numpy()
    taps64 = taps.astype(np.float64)
    ref_kw = dict(hop=hop, num_frames=num_frames, n_fft=n_fft)
    ref_y = _numpy_filter(xh, taps64)
    ref = torch.as_tensor(_numpy_power(ref_y, window.astype(np.float64), **ref_kw))
    ref_y = torch.as_tensor(ref_y)
    _check_close("chain vs f64 numpy reference (2 channels)", power[:2].double().cpu(), ref)
    del power

    print("phase 4: stft -> istft round trip, 64 x 480000", flush=True)
    win_t = hann(frame, device=dev)

    def round_trip():
        z = stft(x64, win_t, sampling_rate=rate, fft_length=n_fft,
                 overlap_length=frame - hop, onesided=True).z
        out["y"] = istft(z, win_t, fft_length=n_fft, overlap_length=frame - hop,
                         onesided=True, sampling_rate=rate)
        torch.cuda.synchronize()

    counts = _run_path("the round trip", kernels, (B, C), round_trip)
    launches = {name: launches[name] + counts[name] for name in launches}
    y = out.pop("y")
    if tuple(y.shape) != (64, out_length) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"istft output {tuple(y.shape)} not finite or wrong shape")
    err = _max_err(y[:, frame:-frame], x64[:, frame:out_length - frame])
    scale = float(x64.abs().max())
    print(f"  interior reconstruction max|d| = {err:.6g} (gate 1e-5 x {scale:.6g})",
          flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"round trip error {err} > 1e-5 x {scale}")
    del y

    # ---------------------------------------------------------------- 5
    print("phase 5: the shared path, fir_framed_dft(kernel='cuda_shared') and "
          "fir_framed_dft_shared", flush=True)
    ref_exact = torch.as_tensor(_numpy_power(ref_y.numpy(), window64, **ref_kw))

    def shared_path():
        out["shared"] = fir_framed_dft(x, taps, window, stride=hop, n_fft=n_fft,
                                       onesided=True, output="power", kernel="cuda_shared")
        out["shared_direct"] = fir_framed_dft_shared(
            x, taps, stride=hop, n_fft=n_fft, window_coeffs=coeffs, onesided=True,
            output="power")
        torch.cuda.synchronize()

    counts = _run_path("the shared path", kernels, (D,), shared_path)
    launches = {name: launches[name] + counts[name] for name in launches}
    for name in ("shared", "shared_direct"):
        got = out.pop(name)
        if tuple(got.shape) != (channels, num_frames, bins) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"{name} output {tuple(got.shape)} not finite or wrong shape")
        _check_close(f"{name} vs f64 numpy reference, periodic f64 hann (2 channels)",
                     got[:2].double().cpu(), ref_exact)
        del got

    # ---------------------------------------------------------------- 6
    print("phase 6: the filtered chain, stft_fir_chain(return_filtered=True), and "
          "FIRFilterChain", flush=True)
    fir_chain = FIRFilterChain()

    def filtered_chain():
        t0 = time.perf_counter()
        out["y"], out["power"] = stft_fir_chain(
            x, taps, window, fft_length=n_fft, overlap_length=frame - hop,
            sampling_rate=rate, onesided=True, return_filtered=True)
        torch.cuda.synchronize()
        print(f"  filtered {tuple(out['y'].shape)}, power {tuple(out['power'].shape)} in "
              f"{time.perf_counter() - t0:.3f} s (first call)", flush=True)
        out["fir"] = fir_chain(x)
        torch.cuda.synchronize()

    counts = _run_path("the filtered chain", kernels, (B, C), filtered_chain)
    launches = {name: launches[name] + counts[name] for name in launches}
    y, power, fir = out.pop("y"), out.pop("power"), out.pop("fir")
    for name, got, shape in (("filtered", y, (channels, length)),
                             ("power", power, (channels, num_frames, bins)),
                             ("FIRFilterChain", fir, (channels, length))):
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} output {tuple(got.shape)} not finite or wrong shape")
    # one 'bin' over all samples: the filtered signal within 1e-4 x max
    _check_close("filtered vs np.convolve 'same' (2 channels)",
                 y[:2].double().cpu().reshape(-1, 1), ref_y.reshape(-1, 1))
    # Held within 1e-4 x the global max, and per bin within 5e-3 of each
    # bin's own max. The filtered signal is f32, with passband and deepest
    # stopband 81 dB apart: its rounding and the f32 sums of the FIR and of
    # any DFT of it leave up to ~1e-3 of those bins' own max (the fused
    # chain folds the FIR into the weights in f64, so its stopband weights
    # are small and phase 3 holds it per bin at 1e-4; kernel B is held per
    # bin at 1e-4 against its plain version in phase 2). The per-bin gate
    # still fails a bin tile that is wrong or missing.
    y2 = y[:2].double().cpu().numpy()
    ref_b = torch.as_tensor(_numpy_power(y2, window.astype(np.float64), **ref_kw))
    for tag, want in (("f64 DFT of its filtered signal", ref_b),
                      ("f64 numpy reference", ref)):
        name = f"filtered chain power vs {tag} (2 channels)"
        got = power[:2].double().cpu()
        _check_close(f"{name}, all bins", got.reshape(-1, 1), want.reshape(-1, 1))
        _check_close(name, got, want, rel=5e-3)
    fir_taps = fir_chain.taps.double().numpy()
    fir_ref = np.stack([np.convolve(c, fir_taps)[(fir_taps.size - 1) // 2:][:length]
                        for c in xh])
    _check_close("FIRFilterChain vs np.convolve 'same' (2 channels)",
                 fir[:2].double().cpu().reshape(-1, 1), torch.as_tensor(fir_ref).reshape(-1, 1))
    del y, power, fir

    # ---------------------------------------------------------------- 7
    print("phase 7: median of 5 CUDA-event timings, kernel vs plain", flush=True)
    cases = [
        ("A", channels * length, lambda: A(x, w_fold, **args_a),
         lambda: _framed_matmul_torch(x, w_fold, power=True, **args_a)),
        ("B", 64 * length, lambda: B(x64, w_dft, **args_b),
         lambda: torch.complex(*_framed_matmul_torch(
             x64, w_dft, pad_left=0, power=False, **args_b).split(bins, dim=-1))),
        ("C", 64 * out_length, lambda: C(frames, stride=hop, out_length=out_length),
         lambda: _ola_fold_torch(frames, hop, out_length)),
        ("D", channels * length, lambda: D(x, w_shared, tw_shared, coeffs, **args_d),
         lambda: _shared_power_torch(x, w_shared, tw_shared, coeffs, **args_d)),
    ]
    timings = {}
    for name, samples, kernel_fn, plain_fn in cases:
        kernel_fn(), plain_fn()  # warm up
        torch.cuda.synchronize()
        k_ms, p_ms = [], []
        for _ in range(5):  # in turns: kernel, plain, kernel, plain, ...
            k_ms.append(_time_ms(kernel_fn))
            p_ms.append(_time_ms(plain_fn))
        k_ms, p_ms = sorted(k_ms)[2], sorted(p_ms)[2]
        timings[name] = (k_ms, p_ms)
        print(f"  {name}: kernel {k_ms:.3f} ms ({samples / k_ms / 1e3:.1f} Msamples/s), "
              f"plain {p_ms:.3f} ms ({samples / p_ms / 1e3:.1f} Msamples/s)", flush=True)

    # where the filtered chain's time goes: the direct FIR, then kernel B
    from nx_signal_tpu_torch.kernels.dft import framed_dft
    from nx_signal_tpu_torch.ops.convolution import convolve

    taps_t = torch.as_tensor(taps, device=dev).reshape(1, -1)
    y = convolve(x, taps_t, mode="same")
    stages = [("FIR (convolve 'same', cuDNN conv1d)", lambda: convolve(x, taps_t, mode="same")),
              ("framed_dft power (kernel B)",
               lambda: framed_dft(y, window, stride=hop, n_fft=n_fft, onesided=True,
                                  output="power"))]
    for name, fn in stages:
        fn()
        torch.cuda.synchronize()
        print(f"  filtered chain at {channels}x{length}, {name}: "
              f"{sorted(_time_ms(fn) for _ in range(5))[2]:.3f} ms", flush=True)
    del y

    rows = [
        (A, "framed_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:342", err_a, "A"),
        (B, "framed_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:127", err_b, "B"),
        (C, "overlap_add.cu", "nx_signal_tpu/kernels/pallas_dft.py:924", err_c, "C"),
        (D, "shared_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:687", err_d, "D"),
    ]
    print(json.dumps({"kernels": [
        {"name": k.__name__, "route": "cuda",
         "source": f"nx_signal_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
         "launches": launches[k.__name__], "max_abs_err": err,
         "ms": timings[tag][0], "plain_ms": timings[tag][1]}
        for k, src, replaces, err, tag in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
