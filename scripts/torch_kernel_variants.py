#!/usr/bin/env python3
"""Design probe of six hand-written kernels of the PyTorch/CUDA port on one
NVIDIA GPU: the choices that `kernels/csrc/framed_dft.cu` (kernel A),
`kernels/csrc/framed_dft_tc.cu` (A-tc), `kernels/csrc/shared_dft.cu` (D),
`kernels/csrc/framed_fft.cu` (B-fft, B-ifft) and `kernels/csrc/log_mel.cu`
(M) fix, timed against the alternatives in one run, on one card.

    python3 scripts/torch_kernel_variants.py     # from the repository root

1. Kernel A's weight ring: the source compiled again with other (rows per
   chunk, stages) pairs, each checked bitwise against the built kernel (the
   k order of every frame is the same) and timed at the bench chain (768 x
   480000, 255 taps, hann 512, hop 128, n_fft 512), medians of 7 CUDA-event
   timings, two rounds.
2. Kernel B-fft at every power of two from 8 to 1024 (64 x 480000, frame
   n_fft, hop n_fft/4): its first radix-8 kernel (framed_fft_kernel, plan
   0) against the persistent loop kernel driven by the host plan of the
   same n_fft (`kernels/dft.py:_fft_plan`; at n_fft 8, M = 4, the
   mixed-radix kernel), in turns (radix 8, loop, loop, radix 8), their
   outputs compared; then both on the filtered chain's power stage (768 x
   480000, n_fft 512).
3. Kernel A-tc's wgmma groups (`kernels/csrc/framed_dft_tc.cu`): the
   source compiled again with a whole weight stage per group
   (kGroupSteps = 0) against the built one (one k-step per group),
   each checked bitwise against the other (the same products in the same
   order per accumulator) and timed at the bench chain at 'high' and
   'default', in turns, two rounds.
4. Kernel D's tile and ring (`kernels/csrc/shared_dft.cu`): the source
   compiled again with its `NX_D_*` macros set to other warps along the
   blocks, blocks per CTA, rows per ring stage, stages and CTAs per SM of
   its launch bounds (hence registers per thread), each checked bitwise against
   the built kernel (every P element sums the same 32-row chunks in the
   same order whatever the tile or ring); two cuts timed only (chunk sums
   of 128 rows; stage A alone, stages B and C cut); kernel A at 'highest'
   on the same chain. All at the bench chain (768 x 480000, 255 taps, hann
   512, hop 128, n_fft 512), medians of 7 CUDA-event timings, in turns, two
   rounds; then the SM clock, power draw and temperature (nvidia-smi)
   during 3 s of back-to-back calls of D and of A.
5. Kernel B-fft's mixed-radix table (`kernels/csrc/framed_fft.cu`): the
   source compiled again with NX_FFT_L2_TABLE_POINTS set to 0 (every CTA
   reads the plan's table from global memory, through L2) and to 2^30
   (the table staged in shared memory wherever it fits) beside the built
   one (staged up to 2048 points), each checked bitwise against the built
   one (the same arithmetic), at 64 x 480000 with a hann frame of n_fft at
   hop n_fft / 4, on 13-smooth lengths and Bluestein's on its 13-smooth M
   from 600 to 4095,
   medians of 7 CUDA-event timings, in turns (built, L2, staged, staged,
   L2, built).
6. Kernel B-fft past 1024 points against an earlier version of it: with
   --parent DIR, the framed_fft.cu of the checkout in DIR (say the parent
   commit, unpacked with `git archive`) built alone with nvcc beside this
   one, at 64 x 480000, hann frame n_fft, hop n_fft / 4, at n_fft 1031,
   2048, 4093, 4094 and 4096 (the lengths both take), each version on the
   plan it was written for (this one's `_device_fft_plan`; for the earlier
   one the radix-8 kernel, plan 0, at a power of two and Bluestein on the
   smallest 13-smooth M), torch.stft(center=False) beside, in turns (this,
   earlier, torch.stft, then back), their outputs compared. Then
   Bluestein's M at lengths whose power of two P >= 2L - 1 exceeds the
   smallest 13-smooth S >= 2L - 1 by 1.0 to 2.0 times: P (the loop kernel
   to 8192 points, 4096 for odd n_fft; the mixed-radix kernel past that)
   against S (the mixed-radix kernel), in turns, their outputs compared;
   `kernels/dft.py:_bluestein_points`'s ratio follows these times.

7. Kernel B-ifft alone at the round trip's shape (64 x 2 646 000, hann
   512, hop 128, n_fft 512: a (64, 20 669, 257) complex64 spectrum from
   B-fft), against what it replaced on istft's route (the concatenation of
   [Re z | Im z] and the exact-f32 product with the dense weights, the
   weights built ahead; and the whole old route with its numpy weights,
   `kernels/dft.py:_framed_idft_torch`) and against torch.fft.irfft times
   the window, the library yardstick, in turns, medians of 7 CUDA-event
   timings; the outputs compared, and the bound (bytes of z read and frames
   written at 3.35 TB/s).

8. Kernel M (`kernels/csrc/log_mel.cu`) alone at the Whisper cell's shape
   (512 clips of 30 s at 16 kHz: a (512, 3001, 201) complex64 spectrum
   from B-fft, 128 mels), against the plain version on the card, the torch
   operations it replaced on WhisperLogMel's route (|z|^2 through torch's
   complex abs, the exact-f32 product with the dense filterbank, clamp,
   log10, each clip's max, the floor and the scaling), in turns, medians of
   7 CUDA-event timings; the outputs compared; M's device time split by
   the profiler (the fill, the kernel); and its bounds (bytes at 3.35 TB/s:
   z read and the log-mel written once, and with the floor's read and
   write of the log-mel).

    python3 scripts/torch_kernel_variants.py 5   # section 5 alone (or 2, 7 or 8)
    python3 scripts/torch_kernel_variants.py 6 --parent DIR   # section 6

Prints the card's name and power limit first. Imports nothing of JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nx_signal_tpu_torch.kernels import cuda_dft  # noqa: E402
from nx_signal_tpu_torch.kernels.cuda_dft import _device_fft_plan, _pack_plan  # noqa: E402
from nx_signal_tpu_torch.kernels._build import _CSRC, _NVCC_FLAGS, _nvcc, load_library  # noqa: E402
from nx_signal_tpu_torch.kernels.dft import (  # noqa: E402
    _bluestein_plan, _bluestein_points, _fft_plan, _fft_twiddles, _smooth_points,
    _transform_length, fir_dft_fold_weights, shared_fold_weights, shared_twiddles)
from nx_signal_tpu_torch.ops.filters import firwin  # noqa: E402
from nx_signal_tpu_torch.ops.windows import hann  # noqa: E402

_RING_VARIANTS = ((16, 3), (16, 2), (8, 4))   # (rows per chunk, stages) beside the built one
# kernel D beside its built (64 blocks per CTA on 12 warps, 4 blocks x 4
# columns per lane, a ring of 16 rows x 2 stages, 2 CTAs per SM): the
# macros of shared_dft.cu each variant sets
_D_VARIANTS = {
    "6 warps, 8 blocks x 4 columns per lane": {"NX_D_WARPS_M": 2},
    "32 blocks per CTA on 6 warps, 3 CTAs/SM": {"NX_D_WARPS_M": 2, "NX_D_BLOCKS": 32,
                                                "NX_D_MIN_CTAS": 3},
    "8 rows x 4 stages": {"NX_D_CHUNK": 8, "NX_D_STAGES": 4},
    "32 rows x 2 stages, 1 CTA/SM": {"NX_D_CHUNK": 32, "NX_D_MIN_CTAS": 1},
}
# and two cuts that only time a part of it (their results differ): chunk
# sums of 128 rows (a quarter of the flushes into P), and stage A alone
_D_PROBES = {
    "chunk sums of 128 rows (timing only)": {"NX_D_SUM_ROWS": 128},
    "stage A alone (timing only)": {"NX_D_STAGE_A_ONLY": 1},
}


def _median_ms(fn, n=7):
    fn()
    torch.cuda.synchronize()
    return sorted(chip_smoke._time_ms(fn) for _ in range(n))[n // 2]


def _ring_variant(tmp, chunk, stages):
    """framed_dft.cu with `chunk` rows per stage and `stages` stages, built
    into its own library."""
    text = (_CSRC / "framed_dft.cu").read_text()
    for name, value in (("kChunk", chunk), ("kStages", stages)):
        line = next(ln for ln in text.splitlines() if ln.startswith(f"constexpr int {name} = "))
        text = text.replace(line, f"constexpr int {name} = {value};")
    src = os.path.join(tmp, f"a_{chunk}_{stages}.cu")
    lib = os.path.join(tmp, f"a_{chunk}_{stages}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", lib, src], check=True)
    variant = ctypes.CDLL(lib)
    variant.nx_framed_dft_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [
        ctypes.c_void_p]
    variant.nx_framed_dft_f32.restype = ctypes.c_int
    return variant


def _ring(dev, gen, tmp):
    x = torch.randn((768, 480000), generator=gen, device=dev)
    num_taps, frame, hop, n_fft = 255, 512, 128, 512
    frames = (x.shape[-1] - frame) // hop + 1
    pad_left = (num_taps - 1) - (num_taps - 1) // 2
    taps = firwin(num_taps, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    w = fir_dft_fold_weights(taps, hann(frame, device="cpu").numpy(), n_fft, True, device=dev)
    want = cuda_dft.fir_framed_dft_power_cuda(x, w, stride=hop, pad_left=pad_left,
                                              num_frames=frames, bins=257)
    out = torch.empty_like(want)

    def call(lib, laid, packed):
        def run():
            err = lib.nx_framed_dft_f32(
                x.data_ptr(), laid.data_ptr(), out.data_ptr(), x.shape[0], x.shape[-1], hop,
                laid.shape[1], pad_left, frames, 257, int(packed), 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"framed_dft variant failed ({err})")
        return run

    laid, packed = cuda_dft._a_weights(w, 257)
    runs = {f"built {cuda_dft._A_CHUNK} rows": call(load_library(), laid, packed)}
    for chunk, stages in _RING_VARIANTS:
        rows = -(-w.shape[0] // chunk) * chunk
        layout = torch.nn.functional.pad(laid[:, :w.shape[0]], (0, 0, 0, rows - w.shape[0]))
        run = call(_ring_variant(tmp, chunk, stages), layout.contiguous(), packed)
        run()
        torch.cuda.synchronize()
        print(f"kernel A, {chunk} rows x {stages} stages: bitwise equal to the built kernel = "
              f"{torch.equal(out, want)}", flush=True)
        runs[f"{chunk} rows x {stages} stages"] = run
    for _ in range(2):
        print("  kernel A at 768 x 480000: " + ", ".join(
            f"{name} {_median_ms(run):.3f} ms" for name, run in runs.items()), flush=True)


def _tc_groups(dev, gen, tmp):
    x = torch.randn((768, 480000), generator=gen, device=dev)
    num_taps, frame, hop, n_fft = 255, 512, 128, 512
    frames = (x.shape[-1] - frame) // hop + 1
    pad_left = (num_taps - 1) - (num_taps - 1) // 2
    taps = firwin(num_taps, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    w = fir_dft_fold_weights(taps, hann(frame, device="cpu").numpy(), n_fft, True, device=dev)
    text = (_CSRC / "framed_dft_tc.cu").read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith("constexpr int kGroupSteps = "))
    src, lib = os.path.join(tmp, "tc_stage_group.cu"), os.path.join(tmp, "tc_stage_group.so")
    with open(src, "w") as f:
        f.write(text.replace(line, "constexpr int kGroupSteps = 0;"))
    subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", lib, src], check=True)
    variant = ctypes.CDLL(lib)
    variant.nx_framed_dft_tc_power_f32.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64] * 9 + [ctypes.c_void_p]
    variant.nx_framed_dft_tc_power_f32.restype = ctypes.c_int

    for precision, passes in (("high", 3), ("default", 1)):
        laid, packed = cuda_dft._tc_weights(w, 257, passes)
        outs = {}

        def call(lib, name):
            out = outs.setdefault(name, torch.empty((768, frames, 257), device=dev))

            def run():
                err = lib.nx_framed_dft_tc_power_f32(
                    x.data_ptr(), laid.data_ptr(), out.data_ptr(), x.shape[0], x.shape[-1],
                    hop, cuda_dft._tc_krows_pad(w.shape[0]), pad_left, frames, 257,
                    int(packed), passes, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"framed_dft_tc ({name}) failed ({err})")
            return run

        runs = {"a k-step per group (built)": call(load_library(), "built"),
                "a stage per group": call(variant, "stage")}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        print(f"kernel A-tc '{precision}': the two groupings bitwise equal = "
              f"{torch.equal(outs['built'], outs['stage'])}", flush=True)
        for _ in range(2):
            print(f"  kernel A-tc '{precision}' at 768 x 480000: " + ", ".join(
                f"{name} {_median_ms(run):.3f} ms" for name, run in runs.items()), flush=True)


def _shared_variant(tmp, defines):
    """shared_dft.cu built with the macros of `defines` into its own
    library."""
    tag = "_".join(f"{k[5:].lower()}{v}" for k, v in defines.items())
    lib = os.path.join(tmp, f"d_{tag}.so")
    build = subprocess.run([_nvcc(), *_NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
                            "-shared", "-o", lib, str(_CSRC / "shared_dft.cu")], check=True,
                           capture_output=True, text=True)
    uses = chip_smoke._ptxas_registers(build.stdout + build.stderr)["shared_dft_power_kernel"]
    print(f"kernel D {defines}: registers " + ", ".join(f"<{a}> {n}" for a, n in uses),
          flush=True)
    variant = ctypes.CDLL(lib)
    variant.nx_shared_dft_power_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 9 + [
        ctypes.c_void_p]
    variant.nx_shared_dft_power_f32.restype = ctypes.c_int
    return variant


def _shared_tiles(dev, gen, tmp):
    x = torch.randn((768, 480000), generator=gen, device=dev)
    num_taps, hop, n_fft, bins = 255, 128, 512, 257
    frames = (x.shape[-1] - n_fft) // hop + 1
    pad_left = (num_taps - 1) - (num_taps - 1) // 2
    taps = firwin(num_taps, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    coeffs = (0.5, -0.5)
    w = shared_fold_weights(taps, hop, n_fft, device=dev)
    tw = shared_twiddles(hop, n_fft, device=dev)
    laid, laid_tw = cuda_dft._d_weights(w, bins, 1), cuda_dft._d_twiddles(tw, bins, 1)
    wc = torch.tensor([0.5, -0.25], device=dev)
    want = cuda_dft.fir_framed_dft_power_shared_cuda(x, w, tw, coeffs, stride=hop,
                                                     pad_left=pad_left, num_frames=frames,
                                                     bins=bins)
    out = torch.empty_like(want)

    def call(lib, name):
        def run():
            err = lib.nx_shared_dft_power_f32(
                x.data_ptr(), laid.data_ptr(), laid_tw.data_ptr(), wc.data_ptr(),
                out.data_ptr(), x.shape[0], x.shape[-1], hop, laid.shape[1], pad_left, frames,
                bins, n_fft // hop, len(coeffs), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"shared_dft ({name}) failed ({err})")
        return run

    runs = {"built": call(load_library(), "built")}
    for name, defines in _D_VARIANTS.items():
        run = call(_shared_variant(tmp, defines), name)
        run()
        torch.cuda.synchronize()
        print(f"kernel D, {name}: bitwise equal to the built kernel = "
              f"{torch.equal(out, want)}", flush=True)
        runs[name] = run
    for name, defines in _D_PROBES.items():
        runs[name] = call(_shared_variant(tmp, defines), name)
    hann64 = hann(n_fft, dtype=torch.float64, device="cpu").numpy()
    wa = fir_dft_fold_weights(taps, hann64, n_fft, True, device=dev)
    runs["kernel A 'highest' (same chain)"] = lambda: cuda_dft.fir_framed_dft_power_cuda(
        x, wa, stride=hop, pad_left=pad_left, num_frames=frames, bins=bins)
    for _ in range(2):
        print("  kernel D at 768 x 480000: " + ", ".join(
            f"{name} {_median_ms(run):.3f} ms" for name, run in runs.items()), flush=True)
    for name in ("built", "kernel A 'highest' (same chain)"):
        print(f"  {name} under a 3 s load: clocks.sm, power.draw, temperature = "
              f"{_clock_under_load(runs[name])}", flush=True)


def _clock_under_load(fn, seconds=3.0):
    """nvidia-smi's SM clock, power draw and temperature, read three times
    from the second second of `seconds` of back-to-back calls of fn."""
    samples = []

    def read():
        time.sleep(1.0)
        for _ in range(3):
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
            time.sleep(0.3)

    reader = threading.Thread(target=read)
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    reader.join()
    return samples


def _fft_kernels(dev, gen):
    lib = load_library()

    def kernel(n_fft, planned, x, hop, power):
        if planned:   # the host plan: the loop kernel (the mixed one at n_fft 8)
            plan = _fft_plan(n_fft)
            packed, points = _pack_plan(plan), plan.points
            table = torch.as_tensor(plan.table.astype(np.float32), device=dev)
        else:
            packed, points, table = 0, 0, _fft_twiddles(n_fft, device=dev)
        return _fft_call(lib, x, n_fft, hop, table, packed, points, power)

    x = torch.randn((64, 480000), generator=gen, device=dev)
    for n_fft in (8, 16, 32, 64, 128, 256, 512, 1024):
        (radix8, a), (mixed, b) = (kernel(n_fft, m, x, n_fft // 4, False) for m in (False, True))
        radix8(), mixed()
        torch.cuda.synchronize()
        diff = float((a - b).abs().max() / a.abs().max())
        t = [_median_ms(f) for f in (radix8, mixed, mixed, radix8)]
        print(f"  B-fft n_fft {n_fft} hop {n_fft // 4}: radix 8 {t[0]:.3f} / {t[3]:.3f} ms, "
              f"{'mixed radix' if n_fft == 8 else 'loop kernel'} {t[1]:.3f} / {t[2]:.3f} ms, "
              f"max|d| / max {diff:.2g}", flush=True)
    del x
    y = torch.randn((768, 480000), generator=gen, device=dev)
    (radix8, _), (mixed, _) = (kernel(512, m, y, 128, True) for m in (False, True))
    t = [_median_ms(f) for f in (radix8, mixed, mixed, radix8)]
    print(f"  B-fft power at 768 x 480000, n_fft 512: radix 8 {t[0]:.3f} / {t[3]:.3f} ms, "
          f"loop kernel {t[1]:.3f} / {t[2]:.3f} ms", flush=True)


def _fft_variants(tmp, variants, source=_CSRC / "framed_fft.cu"):
    """A framed_fft.cu (this one by default) built once per {name: {macro:
    value}}, all at once, each into its own library; returns {name:
    library}."""
    libs, procs = {}, []
    for name, defines in variants.items():
        lib = os.path.join(tmp, f"fft_{len(procs)}.so")
        flags = [f"-D{k}={v}" for k, v in defines.items()]
        procs.append((name, lib, subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, *flags, "-shared", "-o", lib, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = load_library()   # while they compile
    for name, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].nx_framed_fft_f32.argtypes = built.nx_framed_fft_f32.argtypes
        libs[name].nx_framed_fft_f32.restype = ctypes.c_int
    return libs


def _fft_call(lib, x, n_fft, hop, table, packed, points, power=False):
    """(run, out): one launch of nx_framed_fft_f32 from `lib` at a hann
    frame of n_fft and hop `hop`, onesided, into `out`."""
    win = hann(n_fft, device=x.device)
    frames = (x.shape[-1] - n_fft) // hop + 1
    out = torch.empty((x.shape[0], frames, n_fft // 2 + 1),
                      dtype=torch.float32 if power else torch.complex64, device=x.device)

    def run():
        err = lib.nx_framed_fft_f32(
            x.data_ptr(), win.data_ptr(), table.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[-1], hop, n_fft, n_fft, frames, n_fft // 2 + 1, packed, points, int(power),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"framed_fft failed ({err}) at n_fft {n_fft}")
    return run, out


# Section 6's Bluestein lengths: n_fft whose P / S (the power of two and the
# smallest 13-smooth M >= 2L - 1) runs from 1.0 to 2.0, even and odd, on
# either side of 1024 points
_M_SWEEP = (997, 4093, 4094, 802, 787, 3079, 6151, 1367, 2731, 683, 662, 603, 541, 526, 514,
            1031, 2053, 8209)


def _timed_in_turns(runs):
    """{name: (ms, ms)}: each run's median of 7 in turns, forth and back."""
    order = list(runs)
    t = {n: [] for n in order}
    for n in order + order[::-1]:
        t[n].append(_median_ms(runs[n]))
    return t


def _rel_diff(got, want):
    got, want = torch.view_as_real(got), torch.view_as_real(want)
    return float((got - want).abs().max() / want.abs().max())


def _against_parent(dev, gen, tmp, parent):
    x = torch.randn((64, 480000), generator=gen, device=dev)
    if parent is not None:
        source = os.path.join(parent, "nx_signal_tpu_torch", "kernels", "csrc", "framed_fft.cu")
        earlier = _fft_variants(tmp, {"earlier": {}}, source)["earlier"]
        for n_fft in (1031, 2048, 4093, 4094, 4096):
            hop = n_fft // 4
            table, packed, points = _device_fft_plan(n_fft, dev)
            runs, outs = {}, {}
            runs["this"], outs["this"] = _fft_call(load_library(), x, n_fft, hop, table, packed,
                                                   points)
            if n_fft & (n_fft - 1) == 0:   # the earlier radix-8 kernel, plan 0
                plan_e = (_fft_twiddles(n_fft, device=dev), 0, 0)
            else:
                plan = _bluestein_plan(n_fft, _smooth_points(_transform_length(n_fft)))
                plan_e = (torch.as_tensor(plan.table.astype(np.float32), device=dev),
                          _pack_plan(plan), plan.points)
            runs["earlier"], outs["earlier"] = _fft_call(earlier, x, n_fft, hop, *plan_e)
            win = hann(n_fft, device=dev)
            runs["torch.stft"] = lambda: torch.stft(
                x, n_fft, hop_length=hop, window=win, center=False, onesided=True,
                return_complex=True)
            for run in runs.values():
                run()
            torch.cuda.synchronize()
            t = _timed_in_turns(runs)
            length = _transform_length(n_fft)
            print(f"  B-fft n_fft {n_fft} (M {points or length} here, {plan_e[2] or length} "
                  f"earlier) hop {hop}: " + ", ".join(f"{n} {a:.3f} / {b:.3f} ms"
                                                       for n, (a, b) in t.items())
                  + f", max|d| / max {_rel_diff(outs['this'], outs['earlier']):.2g}",
                  flush=True)
            del runs, outs
    # Bluestein's M: the power of two against the smallest 13-smooth M
    for n_fft in _M_SWEEP:
        hop, length = n_fft // 4, _transform_length(n_fft)
        ms = (1 << (2 * length - 2).bit_length(), _smooth_points(length))
        runs, outs = {}, {}
        for m in ms:
            plan = _bluestein_plan(n_fft, m)
            table = torch.as_tensor(plan.table.astype(np.float32), device=dev)
            runs[m], outs[m] = _fft_call(load_library(), x, n_fft, hop, table, _pack_plan(plan),
                                         m)
            runs[m]()
        torch.cuda.synchronize()
        t = _timed_in_turns(runs)
        print(f"  Bluestein n_fft {n_fft} (L {length}) hop {hop}: "
              + ", ".join(f"M {m} {a:.3f} / {b:.3f} ms" for m, (a, b) in t.items())
              + f", P / S {ms[0] / ms[1]:.3f}, the rule's M {_bluestein_points(length)}, "
              f"max|d| / max {_rel_diff(outs[ms[1]], outs[ms[0]]):.2g}", flush=True)
        del runs, outs


def _fft_table_in_l2(dev, gen, tmp):
    libs = {"built": load_library()}
    libs.update(_fft_variants(tmp, {"L2": {"NX_FFT_L2_TABLE_POINTS": 0},
                                    "staged": {"NX_FFT_L2_TABLE_POINTS": 1 << 30}}))
    x = torch.randn((64, 480000), generator=gen, device=dev)
    # 13-smooth: 600, 3000, 4095; Bluestein on the 13-smooth M: 1031 (M
    # 2079), 2047 (M 4095), 4094 (M 4095)
    for n_fft in (600, 3000, 4095, 1031, 2047, 4094):
        hop = n_fft // 4
        # the mixed-radix kernel's plan: Bluestein on the 13-smooth M
        plan = (_fft_plan(n_fft) if cuda_dft._thirteen_smooth(n_fft) else
                _bluestein_plan(n_fft, _smooth_points(_transform_length(n_fft))))
        table = torch.as_tensor(plan.table.astype(np.float32), device=dev)
        packed, points = _pack_plan(plan), plan.points
        outs, runs = {}, {}
        for name, variant in libs.items():
            runs[name], outs[name] = _fft_call(variant, x, n_fft, hop, table, packed, points)
            runs[name]()
        torch.cuda.synchronize()
        same = all(torch.equal(torch.view_as_real(outs["built"]), torch.view_as_real(outs[n]))
                   for n in ("L2", "staged"))
        t = [_median_ms(runs[n]) for n in ("built", "L2", "staged", "staged", "L2", "built")]
        print(f"  B-fft n_fft {n_fft} (M {points or n_fft}) hop {hop}: built {t[0]:.3f} / "
              f"{t[5]:.3f} ms, table in L2 {t[1]:.3f} / {t[4]:.3f} ms, staged where it fits "
              f"{t[2]:.3f} / {t[3]:.3f} ms, bitwise equal {same}", flush=True)
        if not same:
            raise AssertionError(f"n_fft {n_fft}: where the table lives changed the result")


def _ifft_alone(dev, gen):
    """Section 7: kernel B-ifft at the round trip's shape against the old
    product, the old route and torch.fft.irfft x window, in turns."""
    from nx_signal_tpu_torch.kernels.dft import _exact_f32, _framed_idft_torch, _idft_weights

    rows, length, n_fft, hop = 64, 2646000, 512, 128
    frames, bins = (length - n_fft) // hop + 1, n_fft // 2 + 1
    window = hann(n_fft, device=dev)
    x = torch.randn(rows, length, generator=gen, device=dev)
    z = cuda_dft.framed_fft_cuda(x, window, stride=hop, n_fft=n_fft, onesided=True)
    del x
    weights = torch.as_tensor(_idft_weights(window.double().cpu().numpy(), n_fft, n_fft, True,
                                            np.float32), device=dev)

    def product():
        with _exact_f32():
            return torch.matmul(torch.cat([z.real, z.imag], dim=-1), weights)

    runs = {
        "B-ifft": lambda: cuda_dft.framed_ifft_cuda(z, window, n_fft=n_fft),
        "concatenation + exact-f32 product (weights ahead)": product,
        "the old route (numpy weights each call)":
            lambda: _framed_idft_torch(z, window, n_fft=n_fft, onesided=True),
        "torch.fft.irfft x window": lambda: torch.fft.irfft(z, n=n_fft) * window,
    }
    got, want = runs["B-ifft"](), product()
    lib = runs["torch.fft.irfft x window"]()
    top = float(want.abs().max())
    print(f"section 7: B-ifft at {rows} x {length}, n_fft {n_fft}, hop {hop} ({frames} frames a "
          f"row): max|d| / max against the product {float((got - want).abs().max()) / top:.3g}, "
          f"against irfft x window {float((got - lib).abs().max()) / top:.3g}", flush=True)
    del got, want, lib
    t = _timed_in_turns(runs)
    bound = rows * frames * (8.0 * bins + 4.0 * n_fft) / 3.35e12 * 1e3
    for name, (a, b) in t.items():
        print(f"  {name}: {a:.3f} / {b:.3f} ms", flush=True)
    print(f"  bound (bytes: z read, frames written, at 3.35 TB/s): {bound:.3f} ms", flush=True)


def _log_mel_alone(dev, gen):
    """Section 8: kernel M at the Whisper cell's shape against the torch
    operations it replaced, in turns, and its launches by the profiler."""
    from nx_signal_tpu_torch.kernels.cuda_mel import log_mel_clips_cuda
    from nx_signal_tpu_torch.models.pipeline import WhisperLogMel
    from nx_signal_tpu_torch.spectral.mel import _log_mel
    from nx_signal_tpu_torch.spectral.stft import stft

    clips, length, mels = 512, 480000, 128
    frontend = WhisperLogMel(mels, device=dev)
    x = torch.randn(clips, length, generator=gen, device=dev)
    x *= torch.pow(10.0, -2.0 * torch.rand(clips, 1, generator=gen, device=dev))
    z = stft(x, frontend.window, sampling_rate=frontend.sampling_rate,
             fft_length=frontend.n_fft, overlap_length=frontend.n_fft - frontend.hop_length,
             onesided=True, window_padding="reflect").z
    del x
    bins = frontend.filters.shape[-1]
    runs = {
        "M": lambda: log_mel_clips_cuda(z, frontend.bands, frontend.band_weights),
        "torch: |z|^2, exact-f32 product, tail": lambda: _log_mel(
            z[..., :-1, :].abs() ** 2, frontend.filters, bins, clips=True),
    }
    got, want = (run() for run in runs.values())
    print(f"section 8: M at {tuple(z.shape)} complex64, {mels} mels: max|d| against the torch "
          f"operations {float((got - want).abs().max()):.3g}, bitwise equal on a second run "
          f"{bool(torch.equal(got, runs['M']()))}", flush=True)
    del got, want
    t = _timed_in_turns(runs)
    for name, (a, b) in t.items():
        print(f"  {name}: {a:.3f} / {b:.3f} ms", flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            runs["M"]()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"  M's {e.key}: {e.device_time_total / e.count * 1e-3:.3f} ms a call",
                  flush=True)
    frames = z.shape[-2] - 1
    once = clips * frames * (8.0 * bins + 4.0 * mels)
    floored = once + 8.0 * clips * frames * mels
    print(f"  bound (bytes at 3.35 TB/s): z read and the log-mel written once "
          f"{once / 1e9:.3f} GB, {once / 3.35e12 * 1e3:.3f} ms; with the floor's read and "
          f"write {floored / 1e9:.3f} GB, {floored / 3.35e12 * 1e3:.3f} ms", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description="Design probe of the port's kernels.")
    parser.add_argument("section", nargs="?", choices=("2", "5", "6", "7", "8"),
                        help="run this section alone")
    parser.add_argument("--parent", help="section 6: a checkout whose framed_fft.cu to time "
                                         "beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._gpu_name_and_power_limit(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        if args.section == "5":
            _fft_table_in_l2(dev, gen, tmp)
            return 0
        if args.section == "6":
            _against_parent(dev, gen, tmp, args.parent)
            return 0
        if args.section == "2":
            _fft_kernels(dev, gen)
            return 0
        if args.section == "7":
            _ifft_alone(dev, gen)
            return 0
        if args.section == "8":
            _log_mel_alone(dev, gen)
            return 0
        _ring(dev, gen, tmp)
        _tc_groups(dev, gen, tmp)
        _shared_tiles(dev, gen, tmp)
        _fft_table_in_l2(dev, gen, tmp)
        _against_parent(dev, gen, tmp, args.parent)
    _fft_kernels(dev, gen)
    _ifft_alone(dev, gen)
    _log_mel_alone(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
