"""Rank programs of the sharded port's tests: each runs in a process of its
own, spawned by tests/test_torch_sharded.py and
tests/test_torch_sharded_estimation.py (one gloo group of CPU ranks per test
process, `cpu_results`), tests/test_torch_multihost.py (CPU ranks started
through parallel.multihost) or tests/test_torch_cuda.py (ranks on the card:
sharing one, or one card each). This module
imports no JAX: the spawned ranks must start without it.

Each case makes its inputs with numpy from a seed (`signal`), so the
parent process rebuilds the same inputs for the JAX package.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4

MESHES = [(1, 4), (2, 2), (4, 1)]
CONV_SHAPES = [(4096, 255), (4096, 256), (1000, 31), (4099, 17)]  # tests/test_sharded.py:44
CONV_CASES = [(mesh, length, k, method) for mesh in MESHES for length, k in CONV_SHAPES
              for method in ("conv", "direct")]
# channels, length, taps, frame, hop, n_fft: the bench chain cut to size
# (block 2048, a multiple of the hop), a ragged one, and a hop of 4096 past
# the frame (no right halo)
CHAIN_CASES = [((1, 4), (4, 8192, 255, 512, 128, 512)), ((2, 2), (4, 8192, 255, 512, 128, 512)),
               ((2, 2), (2, 6000, 100, 400, 150, 512)), ((1, 4), (2, 65536, 255, 1024, 4096, 1024))]
# mesh, channels, length, frame, overlap, onesided (61 frames: padded to 64
# on 4 blocks; 4099 samples: a padded block)
STFT_CASES = [((1, 4), 4, 4096, 256, 192, True), ((2, 2), 4, 4096, 256, 192, False),
              ((1, 4), 2, 4099, 256, 128, True)]
OA_CASES = [((1, 4), 4096, 255), ((2, 2), 4099, 64)]
# the sharded Welch family: (mesh, function, channels, length, options); 4099
# samples pad the last block, overlap 192 of 256 needs a 3-hop halo
EST_CASES = [
    ((1, 4), "welch", 4, 4096, dict(segment_length=256, overlap_length=128)),
    ((2, 2), "welch", 4, 4099, dict(segment_length=256, overlap_length=192, detrend="linear",
                                    average="median")),
    ((1, 4), "welch", 2, 4096, dict(segment_length=128, detrend=False, scaling="spectrum",
                                    average="median", window=("kaiser", 6.0))),
    ((4, 1), "welch", 4, 3000, dict(segment_length=200, overlap_length=50, fft_length=256)),
    ((1, 4), "csd", 2, 4096, dict(segment_length=256, fft_length=300, detrend="linear")),
    ((2, 2), "csd", 2, 4099, dict(segment_length=128, onesided=False, complex_input=True)),
    ((2, 2), "coherence", 4, 4096, dict(segment_length=256, overlap_length=192)),
]
HALO_PADS = [(5, 3), (1, 0), (0, 4), (16, 16), (0, 0)]  # on 16-sample blocks
# sharded_sosfilt (tests/test_sharded.py:267-296): mesh, design, channels,
# length (1-D when channels is None; 5001 and 4099 pad the last block)
SOS_DESIGNS = {"butter6": (6, 0.2), "ellip8": (8, 0.5, 60.0, 0.15), "butter4": (4, 0.3)}
SOS_CASES = [((1, 4), "butter4", None, 5001), ((2, 2), "butter4", 4, 4096),
             ((2, 2), "ellip8", 4, 4096), ((4, 1), "butter6", 4, 4099)]

# the polyphase functions (tests/test_sharded_resample.py, tests/test_sharded.py:221-242):
# mesh, channels (None: 1-D), length, and (up, down, taps) / (up, down) / (bands, tpc);
# 4099 and 50000 pad the last block, resample_poly's group delay makes halo_right > 0
UPFIRDN_CASES = [((1, 4), 8, 4096, (2, 3, 31)), ((2, 2), 4, 4099, (3, 2, 31)),
                 ((4, 1), 4, 4096, (1, 4, 31)), ((1, 4), None, 4096, (3, 2, 19))]
UPFIRDN_COMPLEX = ((2, 2), 4, 2050, (2, 3, 31))
RESAMPLE_CASES = [((1, 4), 8, 8820, (1, 3)), ((2, 2), 4, 4099, (2, 3)),
                  ((4, 1), 4, 3000, (3, 1)), ((1, 4), 2, 8820, (160, 441))]
PFB_SHARDED_CASES = [((2, 2), 2, 65536, (64, 8)), ((1, 4), None, 50000, (32, 4))]


def polyphase_signal(channels, length, complex_input=False):
    x = signal(40, (length,) if channels is None else (channels, length))
    if complex_input:
        x = (x + 1j * signal(41, x.shape)).astype(np.complex64)
    return x


def upfirdn_taps(k):
    return signal(42, k)


def sos_design(name):
    """The case's (sections, 6) f64 design (the port's, numpy, no JAX)."""
    from nx_signal_tpu_torch.ops import iir_design

    args = SOS_DESIGNS[name]
    if name.startswith("ellip"):
        return iir_design.ellip(*args, output="sos")
    return iir_design.butter(*args, output="sos")


def sos_signal(channels, length):
    return signal(30, (length,) if channels is None else (channels, length))


def signal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def est_signals(channels, length, complex_input=False):
    """x and a delayed, noisy copy y of it for the Welch-family cases."""
    x = signal(20, (channels, length), np.float64) + np.sin(0.2 * np.arange(length))
    y = np.roll(x, 5, axis=-1) * 0.5 + signal(21, (channels, length), np.float64) * 0.2
    if complex_input:
        x, y = x + 1j * signal(22, (channels, length)), y + 1j * signal(23, (channels, length))
        return x.astype(np.complex64), y.astype(np.complex64)
    return x.astype(np.float32), y.astype(np.float32)


def _init(rank, world, store_path):
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _exit_rank():
    """End a CPU rank once the group's last barrier has passed: flush and
    leave with code 0 at once. The gloo teardown (destroy_process_group and
    the interpreter's exit) is skipped: under the load of the parallel test
    run a rank whose results were already gathered and written died there
    with SIGABRT ("terminate called without an active exception"), which
    failed the module's fixture."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _error(fn):
    """The message of the ValueError `fn` raises (None if it returns)."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


def cpu_cases(rank, store_path, out_path):
    """Every case of tests/test_torch_sharded.py on a gloo group of WORLD CPU
    ranks; rank 0 pickles the gathered results to `out_path`."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.kernels.dft import framed_idft
    from nx_signal_tpu_torch.ops.convolution import _direct_convolve
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel import sharded as ts
    from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh, mesh_coordinate
    from nx_signal_tpu_torch.spectral.framing import _ola_fold

    # WORLD ranks share the cores (the parallel test run shares them further)
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORLD))
    _init(rank, WORLD, store_path)
    meshes = {shape: make_dsp_mesh(*shape, device_type="cpu") for shape in MESHES}
    out = {}

    def gather(local, mesh, length, axis=-1):
        return ts.gather_blocks(local, mesh=mesh, length=length, axis=axis).numpy()

    for mesh_shape, length, k, method in CONV_CASES:
        mesh = meshes[mesh_shape]
        x, taps = signal(1, (8, length)), signal(2, k)
        y = ts.sharded_convolve_same(torch.from_numpy(x), torch.from_numpy(taps), mesh=mesh,
                                     method=method)
        out["conv", mesh_shape, length, k, method] = gather(y, mesh, length)
        if method == "conv":
            out["conv_single", length, k] = _direct_convolve(
                torch.from_numpy(x), torch.from_numpy(taps)[None], "same",
                use_matmul=False).numpy()
    mesh = meshes[(1, 4)]
    x1, taps1 = signal(3, 2048), signal(4, 33)
    out["conv_1d"] = gather(ts.sharded_convolve_same(x1, taps1, mesh=mesh), mesh, 2048)

    # the plain halo against the concat of the global signal's slices
    x = torch.from_numpy(signal(5, (2, 64)))
    _, b = mesh_coordinate(mesh)
    blk = x[:, 16 * b:16 * (b + 1)]
    halo_ok = []
    for pl, pr in HALO_PADS:
        left = x[:, 16 * b - pl:16 * b] if b > 0 else torch.zeros(2, pl)
        right = x[:, 16 * (b + 1):16 * (b + 1) + pr] if b < 3 else torch.zeros(2, pr)
        want = torch.cat([left, blk, right], dim=-1)
        before = cuda_halo.halo_extend_cuda.launches
        got = _halo_extend_torch(blk, pl, pr, mesh=mesh)
        got_e = cuda_halo.halo_extend_cuda(blk, pl, pr, mesh=mesh)
        halo_ok.append(bool(torch.equal(got, want) and torch.equal(got_e, want)
                            and cuda_halo.halo_extend_cuda.launches == before
                            and ((pl, pr) != (0, 0) or got is blk)))
    per_rank = {("halo_ok", rank): halo_ok}

    for mesh_shape, (channels, length, k, frame, hop, n_fft) in CHAIN_CASES:
        mesh = meshes[mesh_shape]
        x = signal(6, (channels, length))
        taps = firwin(k, [2000.0], sampling_rate=48000.0, device="cpu")
        window = hann(frame, device="cpu")
        before = cuda_dft.fir_framed_dft_power_cuda.launches
        p = ts.sharded_fir_framed_dft_power(torch.from_numpy(x), taps, window, mesh=mesh,
                                            stride=hop, n_fft=n_fft)
        per_rank["chain_launches", mesh_shape, length, rank] = (
            cuda_dft.fir_framed_dft_power_cuda.launches - before)
        out["chain", mesh_shape, length] = gather(p, mesh, (length - frame) // hop + 1, -2)

    for mesh_shape, channels, length, frame, overlap, onesided in STFT_CASES:
        mesh = meshes[mesh_shape]
        x = signal(7, (channels, length))
        window = hann(frame, device="cpu")
        kw = dict(fft_length=frame, overlap_length=overlap, sampling_rate=8000.0,
                  onesided=onesided)
        z, times, freqs = ts.sharded_stft(torch.from_numpy(x), window, mesh=mesh, **kw)
        key = mesh_shape, length, onesided
        num_frames = times.shape[0]
        out["stft", key] = (gather(z, mesh, num_frames, -2), times.numpy(), freqs.numpy())
        # istft of the gathered spectrum, every rank passing the global one
        z_global = ts.gather_blocks(z, mesh=mesh, length=num_frames, axis=-2)
        y = ts.sharded_istft(z_global, window, mesh=mesh, **kw)
        stride = frame - overlap
        out_length = num_frames * stride + overlap
        out["istft", key] = gather(y, mesh, out_length)
        # the seeded fold against the single-device fold, on the same frames
        frames = framed_idft(z_global, window, n_fft=frame, onesided=onesided)
        frames = frames if onesided else frames.real.contiguous()
        fpb = -(-num_frames // mesh_shape[1])
        shard = ts._local_shard(frames, mesh, fpb, 1, frames.device)
        own = fpb * stride
        folded = ts._sharded_fold(shard, stride, own, overlap, mesh)
        _, b = mesh_coordinate(mesh)
        mine = folded if b == mesh_shape[1] - 1 else folded[..., :own]
        out["fold", key] = (gather(mine, mesh, out_length),
                            _ola_fold(frames, stride, out_length).numpy())

    for mesh_shape, length, k in OA_CASES:
        mesh = meshes[mesh_shape]
        x, taps = signal(8, (4, length)), signal(9, k)
        y = ts.sharded_oaconvolve_same(torch.from_numpy(x), torch.from_numpy(taps), mesh=mesh)
        out["oa", mesh_shape, length, k] = gather(y, mesh, length)

    from nx_signal_tpu_torch.parallel import estimation as te

    for i, (mesh_shape, fn, channels, length, kw) in enumerate(EST_CASES):
        mesh = meshes[mesh_shape]
        kw = dict(kw)
        x, y = est_signals(channels, length, kw.pop("complex_input", False))
        before = cuda_halo.halo_extend_cuda.launches
        if fn == "welch":
            f, p = te.sharded_welch(torch.from_numpy(x), mesh=mesh, sampling_rate=100.0, **kw)
        else:
            f, p = getattr(te, f"sharded_{fn}")(torch.from_numpy(x), torch.from_numpy(y),
                                                mesh=mesh, sampling_rate=100.0, **kw)
        per_rank["est", i, rank] = (mesh_coordinate(mesh), p.numpy(),
                                    cuda_halo.halo_extend_cuda.launches - before)
        out["est_freqs", i] = f.numpy()

    from nx_signal_tpu_torch.ops.iir import sosfilt

    for mesh_shape, design, channels, length in SOS_CASES:
        mesh = meshes[mesh_shape]
        sos, x = sos_design(design), sos_signal(channels, length)
        y = ts.sharded_sosfilt(sos, torch.from_numpy(x), mesh=mesh)
        y2d = y[None] if channels is None else y
        got = gather(y2d, mesh, length)
        out["sos", mesh_shape, design, length] = got[0] if channels is None else got
        out["sos_single", mesh_shape, design, length] = sosfilt(sos, torch.from_numpy(x)).numpy()

    from nx_signal_tpu_torch.ops import resample as tr

    for mesh_shape, channels, length, (up, down, k) in UPFIRDN_CASES + [UPFIRDN_COMPLEX]:
        mesh = meshes[mesh_shape]
        complex_input = (mesh_shape, channels, length, (up, down, k)) == UPFIRDN_COMPLEX
        x = torch.from_numpy(polyphase_signal(channels, length, complex_input))
        h = torch.from_numpy(upfirdn_taps(k))
        y = ts.sharded_upfirdn(h, x, up, down, mesh=mesh)
        n_out = tr._upfirdn_out_len(length, k, up, down)
        got = gather(y[None] if channels is None else y, mesh, n_out)
        key = mesh_shape, length, up, down, complex_input
        out["upfirdn", key] = got[0] if channels is None else got
        out["upfirdn_single", key] = tr.upfirdn(h, x, up, down).numpy()
    for mesh_shape, channels, length, (up, down) in RESAMPLE_CASES:
        mesh = meshes[mesh_shape]
        x = torch.from_numpy(polyphase_signal(channels, length))
        y = ts.sharded_resample_poly(x, up, down, mesh=mesh)
        out["resample_poly", mesh_shape, length, up, down] = gather(y, mesh,
                                                                    -(-length * up // down))
        out["resample_poly_single", mesh_shape, length, up, down] = tr.resample_poly(
            x, up, down).numpy()
    for mesh_shape, channels, length, (m, tpc) in PFB_SHARDED_CASES:
        mesh = meshes[mesh_shape]
        x = torch.from_numpy(polyphase_signal(channels, length))
        p = ts.sharded_pfb_analyze(x, m, mesh=mesh, taps_per_channel=tpc)
        frames = (length - m * tpc) // m + 1
        got = gather(p[None] if channels is None else p, mesh, frames, -2)
        out["pfb", mesh_shape, length, m] = got[0] if channels is None else got
        out["pfb_single", mesh_shape, length, m] = tr.pfb_analyze(
            x, m, taps_per_channel=tpc).numpy()

    mesh = meshes[(1, 4)]
    out["errors"] = {
        "polyphase_halo": _error(lambda: ts.sharded_upfirdn(
            torch.ones(600), torch.zeros(1, 512), 1, 1, mesh=mesh)),
        "pfb_halo": _error(lambda: ts.sharded_pfb_analyze(
            torch.zeros(1, 1024), 64, mesh=mesh, taps_per_channel=8)),
        "pfb_taps": _error(lambda: ts.sharded_pfb_analyze(
            torch.zeros(1, 4096), 16, mesh=mesh, taps=np.ones(100))),
        "halo": _error(lambda: ts.sharded_convolve_same(
            torch.zeros(1, 32), torch.zeros(33), mesh=mesh, method="conv")),
        "chain_halo": _error(lambda: ts.sharded_fir_framed_dft_power(
            torch.zeros(1, 2048), torch.zeros(301), hann(512, device="cpu"), mesh=mesh, stride=128,
            n_fft=512)),
        "channels": _error(lambda: ts.sharded_convolve_same(
            torch.zeros(3, 4096), torch.zeros(5), mesh=meshes[(2, 2)])),
        "kernel_halo": _error(lambda: cuda_halo.halo_extend_cuda(
            torch.zeros(2, 16), 17, 0, mesh=mesh)),
        "frame_halo": _error(lambda: ts.sharded_stft(
            torch.zeros(1, 1024), hann(512, device="cpu"), mesh=mesh, overlap_length=448)),
        "mesh": _error(lambda: make_dsp_mesh(3, device_type="cpu")),
        "est_detrend": _error(lambda: te.sharded_welch(
            torch.zeros(4, 4096), mesh=mesh, detrend=lambda f: f)),
        "est_channels": _error(lambda: te.sharded_welch(
            torch.zeros(3, 4096), mesh=meshes[(2, 2)])),
        "sos_shape": _error(lambda: ts.sharded_sosfilt(
            np.zeros((2, 5)), torch.zeros(4, 4096), mesh=mesh)),
        "sos_channels": _error(lambda: ts.sharded_sosfilt(
            sos_design("butter4"), torch.zeros(3, 4096), mesh=meshes[(2, 2)])),
    }
    every = [None] * WORLD
    dist.all_gather_object(every, per_rank)
    if rank == 0:
        for entries in every:
            out.update(entries)
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    _exit_rank()


FUZZ_WORLD = 8
FUZZ_MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def fuzz_sharded_case(seed):
    """The draw of tests/test_fuzz_parity.py:test_sharded_geometry_random
    for `seed`: (mesh shape, signal, taps)."""
    rng = np.random.default_rng(900 + seed)
    c, b = FUZZ_MESHES[int(rng.integers(0, 4))]
    length = int(rng.integers(600, 5000))
    k = int(rng.integers(3, min(120, length // b)))
    channels = c * int(rng.integers(1, 3))
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    return (c, b), x, taps


def fuzz_sharded_cases(rank, store_path, out_path):
    """The four seeds of the sharded parity sweep on a gloo group of
    FUZZ_WORLD CPU ranks: rank 0 pickles {seed: (sharded_convolve_same
    gathered, the single-device direct convolve)}."""
    from nx_signal_tpu_torch.ops.convolution import _direct_convolve
    from nx_signal_tpu_torch.parallel import sharded as ts
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh

    torch.set_num_threads(1)
    _init(rank, FUZZ_WORLD, store_path)
    out = {}
    for seed in range(4):
        mesh_shape, x, taps = fuzz_sharded_case(seed)
        mesh = make_dsp_mesh(*mesh_shape, device_type="cpu")
        y = ts.sharded_convolve_same(torch.from_numpy(x), torch.from_numpy(taps), mesh=mesh,
                                     method="conv")
        got = ts.gather_blocks(y, mesh=mesh, length=x.shape[-1]).numpy()
        if rank == 0:
            want = _direct_convolve(torch.from_numpy(x), torch.from_numpy(taps)[None, :],
                                    "same", use_matmul=False).numpy()
            out[seed] = (got, want)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    _exit_rank()


def cuda_halo_case(rank, store_path, out_path):
    """Two ranks on cuda:0: kernel E against the plain halo, bitwise, and
    kernel C with a seed against the plain fold, bitwise; rank 0 pickles
    the verdicts."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.kernels.cuda_dft import _ola_fold_torch
    from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh

    _init(rank, 2, store_path)
    mesh = make_dsp_mesh(1, 2)
    dev = torch.device("cuda", 0)
    verdicts = []
    for dtype, (c, n, pl, pr) in [(torch.float32, (3, 1000, 128, 127)),
                                  (torch.float32, (2, 64, 1, 0)),
                                  (torch.float64, (2, 77, 5, 9)),
                                  (torch.complex64, (2, 300, 30, 31))]:
        x = torch.from_numpy(signal(10, (c, 2 * n), np.float64)).to(dtype)
        if dtype.is_complex:  # 8-byte elements: E moves the two parts together
            x = x + 1j * torch.from_numpy(signal(14, (c, 2 * n), np.float64)).to(dtype)
        blk = x[:, rank * n:(rank + 1) * n].to(dev)
        before = cuda_halo.halo_extend_cuda.launches
        got = cuda_halo.halo_extend_cuda(blk, pl, pr, mesh=mesh)
        want = _halo_extend_torch(blk, pl, pr, mesh=mesh)
        verdicts.append(bool(torch.equal(got.cpu(), want.cpu()))
                        and cuda_halo.halo_extend_cuda.launches == before + 1)
    frames = torch.from_numpy(signal(11, (2, 40, 400))).to(dev)
    init = torch.from_numpy(signal(12, (2, 900))).to(dev)
    init[:, ::5] = -0.0
    got = cuda_dft.overlap_add_cuda(frames, stride=150, out_length=6250, init=init)
    want = _ola_fold_torch(frames.cpu(), 150, 6250, init=init.cpu())
    verdicts.append(got.cpu().numpy().tobytes() == want.numpy().tobytes())
    cuda_halo.close_halo_buffers()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(verdicts, f)
    dist.barrier()
    dist.destroy_process_group()


def cuda_welch_case(rank, store_path, out_path):
    """Two ranks on cuda:0: sharded_welch launches B-fft once and kernel E
    twice on each rank, and each rank's PSD is within 1e-5 x max of the
    single-device welch; rank 0 pickles the verdicts."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.parallel.estimation import sharded_welch
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    from nx_signal_tpu_torch.spectral.estimation import welch

    _init(rank, 2, store_path)
    mesh = make_dsp_mesh(1, 2)
    x = torch.from_numpy(signal(13, (4, 48000))).to("cuda:0")
    kw = dict(sampling_rate=48000.0, segment_length=512, overlap_length=256)
    before = (cuda_dft.framed_fft_cuda.launches, cuda_halo.halo_extend_cuda.launches)
    _, p = sharded_welch(x, mesh=mesh, **kw)
    counts = (cuda_dft.framed_fft_cuda.launches - before[0],
              cuda_halo.halo_extend_cuda.launches - before[1])
    _, want = welch(x, **kw)
    err = float((p - want).abs().max())
    verdict = counts == (1, 2) and err <= 1e-5 * float(want.abs().max())
    cuda_halo.close_halo_buffers()
    every = [None] * 2
    dist.all_gather_object(every, verdict)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


def cuda_istft_case(rank, store_path, out_path):
    """Two ranks on cuda:0: sharded_istft of a one-sided spectrum (hann 512,
    hop 128, an odd frame count, so the last block is padded) launches
    kernel B-ifft once on each rank, and each rank's shard is bitwise the
    single-device istft's samples; rank 0 pickles the verdicts."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh, mesh_coordinate
    from nx_signal_tpu_torch.parallel.sharded import sharded_istft
    from nx_signal_tpu_torch.spectral.stft import istft, stft

    _init(rank, 2, store_path)
    mesh = make_dsp_mesh(1, 2)
    x = torch.from_numpy(signal(17, (4, 30000))).to("cuda:0")
    window = hann(512, device="cuda:0")
    kw = dict(fft_length=512, overlap_length=384, onesided=True)
    z = stft(x, window, **kw).z
    before = cuda_dft.framed_ifft_cuda.launches
    shard = sharded_istft(z, window, mesh=mesh, **kw)
    count = cuda_dft.framed_ifft_cuda.launches - before
    single = istft(z, window, **kw)
    _, b = mesh_coordinate(mesh)
    own = -(-z.shape[-2] // 2) * 128
    ref = single[..., b * own:b * own + shard.shape[-1]]
    verdict = (count == 1 and z.shape[-2] % 2 == 1 and ref.shape[-1] > 0
               and torch.equal(shard[..., :ref.shape[-1]], ref))
    cuda_halo.close_halo_buffers()
    every = [None] * 2
    dist.all_gather_object(every, verdict)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


def cuda_long_hop_chain_case(rank, store_path, out_path):
    """Two ranks on cuda:0: sharded_fir_framed_dft_power at hop 4096 past
    the frame (hann 1024, 255 taps: kernel A streams x) launches A and E
    once each and is bitwise the single-device chain's frames; rank 0
    pickles the verdicts."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.kernels.dft import fir_framed_dft
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh, mesh_coordinate
    from nx_signal_tpu_torch.parallel.sharded import sharded_fir_framed_dft_power

    _init(rank, 2, store_path)
    mesh = make_dsp_mesh(1, 2)
    x = torch.from_numpy(signal(15, (3, 65536 + 1000))).to("cuda:0")
    taps = firwin(255, [2000.0], sampling_rate=48000.0, device="cpu")
    window = hann(1024, device="cpu")
    kw = dict(stride=4096, n_fft=1024)
    before = (cuda_dft.fir_framed_dft_power_cuda.launches, cuda_halo.halo_extend_cuda.launches)
    p = sharded_fir_framed_dft_power(x, taps, window, mesh=mesh, **kw)
    counts = (cuda_dft.fir_framed_dft_power_cuda.launches - before[0],
              cuda_halo.halo_extend_cuda.launches - before[1])
    single = fir_framed_dft(x, taps.numpy(), window.numpy(), onesided=True, output="power", **kw)
    _, b = mesh_coordinate(mesh)
    f0 = b * p.shape[1]
    f1 = min(f0 + p.shape[1], single.shape[1])
    verdict = counts == (1, 1) and f1 > f0 and torch.equal(p[:, :f1 - f0], single[:, f0:f1])
    cuda_halo.close_halo_buffers()
    every = [None] * 2
    dist.all_gather_object(every, verdict)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


# kernel E on 4 ranks of one card: (dtype, channels, block, pad_left,
# pad_right) of each call; the first sets the buffers' size, which every
# later one fits until GROWN
HALO_FIRST = (torch.float64, 3, 300, 130, 130)
HALO_CALLS = [(torch.float32, 3, 300, 127, 128), (torch.float64, 2, 77, 1, 0),
              (torch.float32, 3, 300, 0, 4), (torch.float64, 3, 300, 5, 9),
              (torch.float32, 1, 64, 64, 64)] * 3 + [(torch.float32, 2, 50, 7, 7)]
HALO_GROWN = (torch.float64, 4, 600, 300, 200)


def _raise(*_, **__):
    raise AssertionError("a steady-state call of kernel E synchronised or took a collective")


def cuda_halo_stream_case(rank, store_path, out_path):
    """Four ranks on cuda:0, meshes (1, 4) and (2, 2): after a first call
    (set-up), 16 calls of kernel E back to back, each on a fresh block, one
    rank delayed on its stream before two of them, with
    torch.distributed's barrier, all_gather and all_gather_object and every stream, event and
    device sync replaced by functions that raise; then a call on a side
    stream, a call that grows the buffers, and one after it. Every result
    is held bitwise against the plain halo, computed afterwards; rank 0
    pickles {check: verdict}."""
    from nx_signal_tpu_torch.kernels import cuda_halo
    from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh, mesh_coordinate

    _init(rank, WORLD, store_path)
    dev = torch.device("cuda", 0)
    verdicts = {}
    guarded = [(dist, "barrier"), (dist, "all_gather"), (dist, "all_gather_object"),
               (torch.cuda, "synchronize"),
               (torch.cuda.Stream, "synchronize"), (torch.cuda.Event, "synchronize")]
    for shape in ((1, 4), (2, 2)):
        mesh = make_dsp_mesh(*shape)
        _, b = mesh_coordinate(mesh)

        def block(seed, dtype, c, n):
            x = signal(seed, (c, shape[1] * n), np.float64)
            return torch.from_numpy(x[:, b * n:(b + 1) * n]).to(dtype).to(dev)

        calls = [HALO_FIRST, *HALO_CALLS]
        blocks = [block(30 + i, dtype, c, n) for i, (dtype, c, n, _, _) in enumerate(calls)]
        torch.cuda.synchronize()
        got = [cuda_halo.halo_extend_cuda(blocks[0], *HALO_FIRST[3:], mesh=mesh)]
        saved = [(owner, name, getattr(owner, name)) for owner, name in guarded]
        for owner, name in guarded:
            setattr(owner, name, _raise)
        try:
            for i, (_, _, _, pl, pr) in enumerate(HALO_CALLS, 1):
                if rank == 1 and i in (1, 9):
                    torch.cuda._sleep(20_000_000)  # about 10 ms of this rank's stream
                got.append(cuda_halo.halo_extend_cuda(blocks[i], pl, pr, mesh=mesh))
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            blk = blocks[1]
            got.append(cuda_halo.halo_extend_cuda(blk, *HALO_CALLS[0][3:], mesh=mesh))
            blocks.append(blk)
            calls.append(HALO_CALLS[0])
        for i, call in enumerate((HALO_GROWN, HALO_CALLS[3])):
            dtype, c, n, pl, pr = call
            blocks.append(block(60 + i, dtype, c, n))
            got.append(cuda_halo.halo_extend_cuda(blocks[-1], pl, pr, mesh=mesh))
            calls.append(call)
        torch.cuda.synchronize()
        for i, (blk, out, (dtype, c, n, pl, pr)) in enumerate(zip(blocks, got, calls)):
            want = _halo_extend_torch(blk, pl, pr, mesh=mesh)
            verdicts[shape, i, str(dtype), pl, pr, rank] = (
                out.dtype == dtype and bool(torch.equal(out.cpu(), want.cpu())))
    cuda_halo.close_halo_buffers()
    every = [None] * WORLD
    dist.all_gather_object(every, verdicts)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({k: v for entries in every for k, v in entries.items()}, f)
    dist.barrier()
    dist.destroy_process_group()


# process_block_range's streams: divisible, ragged, and one whose last
# block starts past its end (3 samples on 2 blocks of 2, 5 on 4 of 2)
MULTIHOST_TOTALS = (480000, 48001, 3, 5)


def multihost_case(port, rank, store_path, out_path):
    """A rank started through `parallel.multihost`: initialize at
    127.0.0.1:port (rank 0 listens), make_pod_mesh(2) on the CPU, and this
    rank's process_block_range of each of MULTIHOST_TOTALS; rank 0
    pickles every rank's report."""
    torch.set_num_threads(1)
    from nx_signal_tpu_torch.parallel import multihost
    from nx_signal_tpu_torch.parallel.mesh import mesh_coordinate

    multihost.initialize(f"127.0.0.1:{port}", WORLD, rank, timeout=120.0)
    mesh = multihost.make_pod_mesh(2, device_type="cpu")
    report = {"rank": rank, "backend": dist.get_backend(), "world": dist.get_world_size(),
              "shape": tuple(mesh.shape), "coordinate": tuple(mesh_coordinate(mesh)),
              "ranges": [multihost.process_block_range(t, mesh) for t in MULTIHOST_TOTALS]}
    every = [None] * WORLD
    dist.all_gather_object(every, report)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    _exit_rank()


def cuda_multihost_case(port, rank, store_path, out_path):
    """Four ranks started through `multihost.initialize(127.0.0.1:port, 4,
    rank)` on the card: on one card they share it over gloo, on four each
    has its own and the group is NCCL with gloo beside it. On a (1, 4)
    pod mesh, kernel E against the plain halo, bitwise, for f32 and f64;
    sharded_welch (B-fft once, E twice on each rank) within 1e-5 x max of
    the single-device welch; and an all-reduce of a host tensor (the
    liveness probe's). Rank 0 pickles every rank's report."""
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.parallel import multihost
    from nx_signal_tpu_torch.parallel.estimation import sharded_welch
    from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
    from nx_signal_tpu_torch.spectral.estimation import welch

    multihost.initialize(f"127.0.0.1:{port}", WORLD, rank, timeout=120.0)
    mesh = multihost.make_pod_mesh(1)
    dev = torch.device("cuda", torch.cuda.current_device())
    verdicts = {}
    for dtype, (c, n, pl, pr) in [(torch.float32, (3, 1000, 128, 127)),
                                  (torch.float64, (2, 77, 5, 9))]:
        x = torch.from_numpy(signal(40, (c, WORLD * n), np.float64)).to(dtype)
        blk = x[:, rank * n:(rank + 1) * n].to(dev)
        before = cuda_halo.halo_extend_cuda.launches
        got = cuda_halo.halo_extend_cuda(blk, pl, pr, mesh=mesh)
        want = _halo_extend_torch(blk, pl, pr, mesh=mesh)
        verdicts["halo", str(dtype)] = (bool(torch.equal(got.cpu(), want.cpu()))
                                        and cuda_halo.halo_extend_cuda.launches == before + 1)
    x = torch.from_numpy(signal(13, (4, 48000))).to(dev)
    kw = dict(sampling_rate=48000.0, segment_length=512, overlap_length=256)
    before = (cuda_dft.framed_fft_cuda.launches, cuda_halo.halo_extend_cuda.launches)
    _, p = sharded_welch(x, mesh=mesh, **kw)
    counts = (cuda_dft.framed_fft_cuda.launches - before[0],
              cuda_halo.halo_extend_cuda.launches - before[1])
    _, want = welch(x, **kw)
    verdicts["welch"] = (counts == (1, 2)
                         and float((p - want).abs().max()) <= 1e-5 * float(want.abs().max()))
    ones = torch.ones(())
    dist.all_reduce(ones)
    verdicts["host all-reduce"] = float(ones) == WORLD
    cuda_halo.close_halo_buffers()
    report = {"rank": rank, "device": dev.index, "backend": str(dist.get_backend()),
              "verdicts": verdicts}
    every = [None] * WORLD
    dist.all_gather_object(every, report)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


_CPU_RESULTS = {}


def cpu_results(tmp_path_factory):
    """What `cpu_cases` returns, spawned once per test process (the files
    that hold these results share one group)."""
    if "out" not in _CPU_RESULTS:
        _CPU_RESULTS["out"] = spawn(cpu_cases, WORLD, tmp_path_factory.mktemp("sharded"))
    return _CPU_RESULTS["out"]


def spawn(fn, nprocs, tmp_dir, timeout=240):
    """Run `fn(rank, store_path, out_path)` in `nprocs` spawned processes,
    join them within `timeout` seconds (a rank that fails raises here), and
    return what rank 0 pickled."""
    import time

    import torch.multiprocessing as mp

    store_path, out_path = str(tmp_dir / "store"), str(tmp_dir / "out.pkl")
    ctx = mp.start_processes(fn, args=(store_path, out_path), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    with open(out_path, "rb") as f:
        return pickle.load(f)
