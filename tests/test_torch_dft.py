"""Parity of the PyTorch port's kernels/dft.py with the JAX package, on the
CPU, where every kernel wrapper runs its plain PyTorch version.

Tolerances:
* host weight functions (toeplitz_band, _dft_weights, _idft_weights,
  fir_dft_fold_weights): bitwise — the same numpy f64 operations, cast to
  f32 the same way.
* contractions (blocked_frame_matmul, framed_dft, framed_idft,
  fir_framed_dft): 1e-4 x max|reference|, the JAX package's own gate
  (pallas_dft.py:385) — both sides are f32 sums of up to ~800 products in
  different orders (conv1d vs XLA's conv or the Pallas dot).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels import dft as jd
from nx_signal_tpu.kernels.pallas_dft import fir_framed_dft_power_pallas, framed_dft_pallas
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels import dft as td


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes()


def assert_close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def hann_np(n):
    return np.array(jw.hann(n))


@pytest.mark.parametrize("num_taps", [1, 3, 100, 255])
@pytest.mark.parametrize("out_cols", [4, 64])
def test_toeplitz_band_bitwise(num_taps, out_cols, rng):
    taps = rng.normal(size=num_taps)
    assert_bitwise(td.toeplitz_band(taps, out_cols), jd.toeplitz_band(taps, out_cols, np))


@pytest.mark.parametrize("frame,n_fft,onesided", [
    (512, 512, True), (400, 512, True), (256, 256, False), (7, 8, True), (9, 9, False)])
def test_dft_and_idft_weights_bitwise(frame, n_fft, onesided):
    window = np.asarray(jw.hann(frame), np.float64)
    assert_bitwise(td._dft_weights(window, frame, n_fft, onesided, np.float32),
                   jd._dft_weights(window, frame, n_fft, onesided, np.float32))
    assert_bitwise(td._idft_weights(window, frame, n_fft, onesided, np.float32),
                   jd._idft_weights(window, frame, n_fft, onesided, np.float32))


@pytest.mark.parametrize("num_taps,frame,n_fft,onesided", [
    (255, 512, 512, True), (100, 400, 512, True), (4, 256, 256, False), (1, 64, 64, True)])
def test_fir_dft_fold_weights_bitwise(num_taps, frame, n_fft, onesided, rng):
    taps = rng.normal(size=num_taps).astype(np.float32)
    window = hann_np(frame)
    want = jd.fir_dft_fold_weights(taps, window, n_fft, onesided)
    got = td.fir_dft_fold_weights(taps, torch.from_numpy(window), n_fft, onesided)
    assert got.dtype == torch.float32
    assert_bitwise(got, want)


@pytest.mark.parametrize("strategy", ["conv", "materialize"])
@pytest.mark.parametrize("window,stride,length", [(300, 128, 3000), (256, 100, 2000),
                                                  (128, 128, 1000)])
def test_blocked_frame_matmul(strategy, window, stride, length, rng):
    x = rng.normal(size=(2, length)).astype(np.float32)
    w = rng.normal(size=(window, 10)).astype(np.float32)
    m = (length - window) // stride + 1
    want = jd.blocked_frame_matmul(jnp.asarray(x), jnp.asarray(w), window_length=window,
                                   stride=stride, num_frames=m)
    got = td.blocked_frame_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  window_length=window, stride=stride, num_frames=m,
                                  strategy=strategy)
    assert_close_to_max(got, want)


FRAMED_GEOMETRIES = [  # channels, length, frame, hop, n_fft
    (2, 4096, 512, 128, 512),
    (1, 3000, 400, 150, 512),   # hop does not divide the frame, n_fft > frame
    (3, 2048, 256, 256, 256),   # no overlap
    (2, 3000, 512, 128, 600),   # 7-smooth n_fft: the mixed-radix B-fft
    (2, 3000, 400, 160, 400),   # Whisper's frame, hop and n_fft
    (3, 3000, 441, 147, 441),   # odd n_fft: two frames per complex FFT
    (2, 3000, 500, 128, 1000),  # n_fft 2^3 * 5^3
    (2, 3000, 512, 128, 572),   # 2^2 * 11 * 13: the dense kernel B
    (2, 1000, 12, 5, 16),       # the FFT kernel's small sizes
    (1, 500, 5, 3, 8),
    (1, 5000, 1000, 300, 1024),  # its largest
]


@pytest.mark.parametrize("geometry", FRAMED_GEOMETRIES)
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("output", ["complex", "power"])
def test_framed_dft(geometry, onesided, output, rng):
    channels, length, frame, hop, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    window = hann_np(frame)
    want = jd.framed_dft(jnp.asarray(x), window, stride=hop, n_fft=n_fft,
                         onesided=onesided, output=output)
    got = td.framed_dft(torch.from_numpy(x), torch.from_numpy(window), stride=hop,
                        n_fft=n_fft, onesided=onesided, output=output)
    assert got.dtype == (torch.complex64 if output == "complex" else torch.float32)
    assert_close_to_max(got, np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("n_fft,kernel", [(8, "fft"), (16, "fft"), (512, "fft"), (1024, "fft"),
                                          (400, "fft"), (441, "fft"), (600, "fft"),
                                          (1000, "fft"), (4, "dense"), (572, "dense"),
                                          (1021, "dense"), (2048, "dense")])
def test_framed_dft_kernel_split(n_fft, kernel, rng):
    """framed_dft takes kernel B-fft for every n_fft from 8 to 1024 with no
    prime factor above 7 and the dense kernel B for any other; on a CPU
    tensor both wrappers are the same plain version, so their results are
    equal bitwise."""
    assert cuda_dft.fft_kernel_takes(n_fft) == (kernel == "fft")
    frame = min(n_fft, 400)
    x = torch.from_numpy(rng.normal(size=(2, 3 * frame + 7)).astype(np.float32))
    window = hann_np(frame)
    m = (x.shape[-1] - frame) // 3 + 1
    bins = n_fft // 2 + 1
    dense = cuda_dft.framed_dft_cuda(
        x, torch.as_tensor(td._dft_weights(window, frame, n_fft, True, np.float32)), stride=3,
        num_frames=m, bins=bins)
    assert torch.equal(cuda_dft.framed_fft_cuda(x, window, stride=3, n_fft=n_fft, onesided=True),
                       dense)
    assert torch.equal(td.framed_dft(x, window, stride=3, n_fft=n_fft, onesided=True), dense)


SEVEN_SMOOTH = [n for n in range(8, 1025) if cuda_dft._seven_smooth(n)]


def replay_fft_plan(n_fft, frames):
    """Kernel B-fft's mixed-radix transform in numpy f64, in the kernel's
    order and layout (framed_fft.cu:framed_fft_mixed_kernel): the Stockham
    passes of the plan through two padded buffers with the plan's twiddle
    table, then the split (even n_fft, one frame) or the separation (odd,
    two frames); returns the onesided spectrum of each frame."""
    plan = td._fft_plan(n_fft)
    size = plan.length
    table = plan.table[:, 0] + 1j * plan.table[:, 1]
    off = 0 if n_fft % 2 else size // 2 + 1
    z = frames[0][0::2] + 1j * frames[0][1::2] if n_fft % 2 == 0 else frames[0] + 1j * frames[1]
    src, in_group, in_pad, ns = None, 1, 0, 1
    for p, (r, c) in enumerate(zip(plan.radices, plan.pads)):
        span, group = size // r, ns * r
        j = np.arange(span)
        t = j[None, :] + np.arange(r)[:, None] * span
        v = z[t] if p == 0 else src[t + t // in_group * in_pad]
        jm, g = j % ns, j // ns
        if p > 0:
            v = v * table[off + np.arange(r)[:, None] * ns + jm]
            off += group
        dst = np.full(size + size // group * c, np.nan + 0j)
        dst[g * (group + c) + jm + np.arange(r)[:, None] * ns] = np.fft.fft(v, axis=0)
        src, in_group, in_pad, ns = dst, group, c, group
    assert off == table.shape[0] and src.shape[0] == size   # the last pass is unpadded
    k = np.arange(size // 2 + 1)
    a, b = src[k], np.conj(src[(size - k) % size])
    if n_fft % 2:
        return [(a + b) / 2, (a - b) / 2j]
    w = table[k]
    out = np.empty(size + 1, complex)
    out[size - k] = np.conj((a + b) / 2 + 1j * w * (a - b) / 2)   # X[L-k] as the kernel forms it
    out[k] = (a + b) / 2 - 1j * w * (a - b) / 2                   # X[k]
    return [out]


@pytest.mark.parametrize("n_fft", SEVEN_SMOOTH)
def test_fft_plan_replays_to_numpy(n_fft, rng):
    """The host plan of kernel B-fft (radices, paddings, per-pass twiddle
    tables) replayed as the kernel indexes it gives np.fft's spectrum, for
    every 7-smooth n_fft from 8 to 1024, even and odd, at 1e-12 of the
    max; no slot of a padded buffer is read unwritten, and the tables are
    used up exactly."""
    frames = rng.normal(size=(2, n_fft))
    got = replay_fft_plan(n_fft, frames)
    for spectrum, frame in zip(got, frames):
        want = np.fft.rfft(frame)
        assert np.isfinite(spectrum).all()
        np.testing.assert_allclose(spectrum, want, rtol=0, atol=1e-12 * np.abs(want).max())
    plan = td._fft_plan(n_fft)
    assert np.prod(plan.radices) == plan.length and plan.pads[-1] == 0
    assert all(0 <= c < 16 for c in plan.pads) and len(plan.radices) <= cuda_dft._FFT_MAX_PASSES


@pytest.mark.parametrize("num_taps,frame,n_fft,onesided", [
    (255, 512, 512, True),    # the bench chain: 257 bins packed into 256 slots, 4 tiles
    (100, 400, 600, True),    # 301 bins packed into 300 slots
    (4, 441, 441, True),      # odd n_fft, no Nyquist bin: not packed
    (1, 64, 64, False),       # the full spectrum: not packed
])
def test_a_weight_layout_round_trips(num_taps, frame, n_fft, onesided, rng):
    """Kernel A's laid-out weights (`_a_weights`, `_a_columns`) scatter back
    to the (krows, 2*bins) weights: every column once, but for the two
    columns packing drops (the DC bin's Im, exactly zero, and the Nyquist
    bin's Im, below f32 resolution of its Re); zeros elsewhere."""
    w = td.fir_dft_fold_weights(rng.normal(size=num_taps), hann_np(frame), n_fft, onesided)
    krows, bins = w.shape[0], w.shape[1] // 2
    laid, packed = cuda_dft._a_weights(w, bins)
    assert packed == (onesided and n_fft % 2 == 0)
    cols = cuda_dft._a_columns(bins, packed)
    assert laid.shape == (cols.shape[0], -(-krows // cuda_dft._A_CHUNK) * cuda_dft._A_CHUNK,
                          2 * cuda_dft._A_TILE_BINS)
    used = cols >= 0
    assert not laid[:, krows:].any() and not laid[torch.from_numpy(~used)[:, None, :]
                                                  .expand_as(laid)].any()
    index = cols[used]
    dropped = {bins, 2 * bins - 1} if packed else set()
    assert sorted(index.tolist()) == sorted(set(range(2 * bins)) - dropped)
    back = torch.zeros_like(w)
    back[:, torch.from_numpy(index)] = laid[:, :krows].permute(1, 0, 2)[:, torch.from_numpy(used)]
    keep = sorted(set(range(2 * bins)) - dropped)
    assert torch.equal(back[:, keep], w[:, keep])
    if packed:
        assert not w[:, bins].any()
        assert w[:, -1].abs().max() <= 2.0 ** -24 * w[:, bins - 1].abs().max()


@pytest.mark.parametrize("n_fft", [8, 512, 1024])
def test_fft_twiddles(n_fft):
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    got = td._fft_twiddles(n_fft).numpy()
    assert got.shape == (n_fft, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, rtol=0, atol=6e-8)
    assert got[n_fft // 4, 0] == 0.0 and got[n_fft // 4, 1] == -1.0


@pytest.mark.parametrize("onesided", [True, False])
def test_framed_dft_matches_pallas_interpret(onesided, rng):
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    window = hann_np(256)
    want = framed_dft_pallas(jnp.asarray(x), window, stride=128, n_fft=256,
                             onesided=onesided, interpret=True)
    got = td.framed_dft(torch.from_numpy(x), window, stride=128, n_fft=256,
                        onesided=onesided)
    assert_close_to_max(got, np.asarray(want).astype(np.complex64))


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("bins_delta", [0, -3, 2])   # exact, short (padded), long (cut)
def test_framed_idft(onesided, bins_delta, rng):
    n_fft, frame = 256, 256
    bins = (n_fft // 2 + 1 if onesided else n_fft) + bins_delta
    z = (rng.normal(size=(2, 7, bins)) + 1j * rng.normal(size=(2, 7, bins))).astype(
        np.complex64)
    window = hann_np(frame)
    want = jd.framed_idft(jnp.asarray(z), window, n_fft=n_fft, onesided=onesided)
    got = td.framed_idft(torch.from_numpy(z), window, n_fft=n_fft, onesided=onesided)
    assert got.dtype == (torch.float32 if onesided else torch.complex64)
    assert_close_to_max(got, np.asarray(want).astype(got.numpy().dtype))


FIR_GEOMETRIES = [  # channels, length, taps, frame, hop, n_fft
    (2, 5000, 255, 512, 128, 512),   # the bench chain's shape family
    (1, 3000, 100, 400, 150, 512),   # even taps, hop does not divide the frame
    (2, 2048, 4, 256, 64, 256),      # even taps, short filter
    (1, 2500, 63, 384, 128, 512),    # (frame + K - 1) % hop != 0
]


@pytest.mark.parametrize("geometry", FIR_GEOMETRIES)
def test_fir_framed_dft_power_matches_xla(geometry, rng):
    channels, length, k, frame, hop, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = hann_np(frame)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=hop, n_fft=n_fft,
                             onesided=True, output="power", kernel="xla")
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = td.fir_framed_dft(torch.from_numpy(x), torch.from_numpy(taps), window,
                            stride=hop, n_fft=n_fft, onesided=True, output="power")
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before  # CPU: plain version
    assert got.dtype == torch.float32
    assert_close_to_max(got, np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("channels,length,k,frame", [(2, 5000, 255, 512), (1, 3000, 100, 256)])
def test_fir_framed_dft_power_matches_pallas_interpret(channels, length, k, frame, rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = hann_np(frame)
    want = fir_framed_dft_power_pallas(jnp.asarray(x), taps, window, stride=128,
                                       n_fft=frame, interpret=True)
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=128, n_fft=frame,
                            onesided=True, output="power")
    assert_close_to_max(got, np.asarray(want))


@pytest.mark.parametrize("onesided", [True, False])
def test_fir_framed_dft_complex(onesided, rng):
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    taps = rng.normal(size=31).astype(np.float32)
    window = hann_np(256)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=100, n_fft=256,
                             onesided=onesided, output="complex", kernel="xla")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=100, n_fft=256,
                            onesided=onesided, output="complex")
    assert got.dtype == torch.complex64
    assert_close_to_max(got, np.asarray(want).astype(np.complex64))


@pytest.mark.parametrize("frame_chunks", [2, 3, "auto"])
def test_fir_framed_dft_frame_chunks(frame_chunks, rng):
    x = rng.normal(size=(2, 4000)).astype(np.float32)
    taps = rng.normal(size=101).astype(np.float32)
    window = hann_np(256)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=64, n_fft=256,
                             onesided=True, output="power", kernel="xla")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=64, n_fft=256,
                            onesided=True, output="power", frame_chunks=frame_chunks,
                            kernel="torch")
    assert_close_to_max(got, np.asarray(want).astype(np.float32))


def test_fir_framed_dft_kernel_routes(rng):
    x = torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32))
    taps, window = rng.normal(size=51), hann_np(256)
    kw = dict(stride=128, n_fft=256, onesided=True, output="power")
    plain = td.fir_framed_dft(x, taps, window, kernel="torch", **kw)
    # 'auto' and 'cuda' go through the kernel wrapper, which on a CPU tensor
    # is the plain version itself; frame_chunks never takes a call off it
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="auto", **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="cuda", **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, frame_chunks=3, **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="cuda", frame_chunks=3,
                                         **kw), plain)


def test_fir_framed_dft_errors(rng):
    x = torch.zeros(2, 1000)
    taps, window = np.ones(5), hann_np(128)
    kw = dict(stride=64, n_fft=128, onesided=True)
    with pytest.raises(ValueError, match="kernel"):
        td.fir_framed_dft(x, taps, window, output="power", kernel="pallas", **kw)
    with pytest.raises(ValueError, match="kernel='cuda' requires"):
        td.fir_framed_dft(x, taps, window, output="complex", kernel="cuda", **kw)
    with pytest.raises(ValueError, match="edge must be 'pad' or 'conv'"):
        td.fir_framed_dft(x, taps, window, output="power", edge="wrap", **kw)
    with pytest.raises(ValueError, match="exceeds signal length"):
        td.fir_framed_dft(torch.zeros(100), taps, window, output="power", **kw)
    with pytest.raises(ValueError, match="precision"):
        td.fir_framed_dft(x, taps, window, output="power", precision="fast", **kw)
    for bad in (0, 2.5, "many"):
        with pytest.raises(ValueError, match="frame_chunks"):
            td.fir_framed_dft(x, taps, window, output="power", frame_chunks=bad, **kw)


def test_framed_dft_errors():
    with pytest.raises(ValueError, match="exceeds signal length"):
        td.framed_dft(torch.zeros(100), hann_np(128), stride=64, n_fft=128)
    with pytest.raises(ValueError, match="real signal"):
        td.framed_dft(torch.zeros(300, dtype=torch.complex64), hann_np(128), stride=64,
                      n_fft=128)
    with pytest.raises(ValueError, match="output"):
        td.framed_dft(torch.zeros(300), hann_np(128), stride=64, n_fft=128, output="abs")


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 1025, 4096])
def test_good_matmul_fft_length(n_fft):
    assert td.good_matmul_fft_length(n_fft) == jd.good_matmul_fft_length(n_fft)


@pytest.mark.parametrize("name", ["nx_framed_dft_f32", "nx_framed_fft_f32",
                                  "nx_framed_dft_tc_frames", "nx_framed_dft_tc_power_f32",
                                  "nx_overlap_add_f32",
                                  "nx_shared_dft_power_f32", "nx_halo_alloc", "nx_halo_free",
                                  "nx_ipc_get_handle", "nx_ipc_open_handle",
                                  "nx_ipc_close_handle", "nx_stream_synchronize",
                                  "nx_halo_put", "nx_halo_assemble"])
def test_ctypes_signatures_match_the_sources(name):
    """The argtypes declared for each C entry point match its prototype in
    kernels/csrc (ctypes cannot check this, and the card is not here)."""
    import ctypes
    import re
    from pathlib import Path

    from nx_signal_tpu_torch.kernels import _build

    src = "".join(Path(_build._CSRC, f).read_text() for f in _build._SOURCES)
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int64 for p in params]
    assert list(_build._SIGNATURES[name]) == kinds


@pytest.mark.parametrize("source,constants", [
    ("framed_fft.cu", {"kMinFft": "_FFT_MIN", "kMaxFft": "_FFT_MAX",
                       "kMaxPasses": "_FFT_MAX_PASSES"}),
    ("framed_dft.cu", {"kTileBins": "_A_TILE_BINS", "kChunk": "_A_CHUNK"}),
    ("framed_dft_tc.cu", {"kTileBins": "_TC_TILE_BINS", "kChunk": "_TC_CHUNK"}),
])
def test_kernel_constants_match_the_sources(source, constants):
    """The wrappers' copies of each kernel's limits and weight layout equal
    the constants the CUDA source declares."""
    import re
    from pathlib import Path

    from nx_signal_tpu_torch.kernels import _build

    text = Path(_build._CSRC, source).read_text()
    for c_name, py_name in constants.items():
        value = re.search(rf"constexpr int {c_name} = (\d+);", text).group(1)
        assert int(value) == getattr(cuda_dft, py_name), c_name
