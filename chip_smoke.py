#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nx_signal_tpu_torch`) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version, drives the port's main path through its public entry points and
times the kernels.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure raises, and the exit code is not 0):
  0. the card's name and power limit (nvidia-smi); no CUDA device is a failure.
  1. build the kernels of nx_signal_tpu_torch/kernels/csrc with nvcc (sm_90a),
     one nvcc process per source, all at once; ptxas's report: every kernel
     compiled without spills, the most registers a kernel uses, any ptxas
     performance warning (C75xx, e.g. serialised wgmma), and the registers
     of each kernel's instantiations (their template arguments) printed.
  2. each kernel against its plain version on the same device tensors,
     each bin within 1e-4 x that bin's max|plain| (a per-bin gate, so the
     low-pass chain's small stopband bins are held as tightly as its
     passband) unless said otherwise: A (fused FIR + framed DFT + power,
     exact f32) at 768 x 480000 with the bench chain (firwin 255 taps @ 48
     kHz, hann 512, hop 128, n_fft 512), and on 64 channels at hann 4096,
     hop 4096 (16 frames' window of x does not fit beside its weight ring:
     it streams x); A-tc ('high' 3xTF32 and 'default'
     one TF32 pass) on the same chain against its plain version (the same
     TF32 products summed in f64, 192 channels at a time) and, on two
     channels, against an f64 numpy reference (convolve, frame, window,
     rfft, |.|^2) at 1e-4 ('high') and 1e-2 ('default'); B-fft (an FFT per
     frame) at 64 x 480000, complex and power, at n_fft 512 (its radix-8
     kernel), 600 and 572 (= 2^2 * 11 * 13; its mixed-radix kernel) and
     1021 and 1018 (= 2 * 509; Bluestein's chirp-z transform on the
     persistent loop kernel's radix-8 passes, M = 2048 and 1024), then
     with a hann frame of n_fft at hop n_fft / 4 at 1031, 4093, 8191 and
     12289 (Bluestein on the mixed kernel, M = 2079 and 8192, and over a
     cluster of 2 CTAs, M = 16384 and 24640), 4094 and 16382
     (Bluestein, M = 4096 on the loop kernel and 16384), 2048, 4096, 8192
     and 16384 (radix 8 on the loop kernel), 12000, 3375 and 6561 (the
     mixed-radix kernel, the frames read from global memory) and 15625 (the
     same over a cluster of 2 CTAs), and on frames of 2 x n_fft (folded
     modulo n_fft) at 512 and, on 8 channels, 4096, 4093 and 8192 (the
     plain version's weights past 1024 built ahead on 4 host threads); past
     16384 at 16400, 19683 (= 3^9, radix 9), 20000, 32749 (a prime, M =
     65536 over a cluster of 8 CTAs), 32768 and 65536 (radix 8 over
     clusters of 2 and 4) and 65535 (M = 131072 over a cluster of 16), hop
     n_fft / 4, against the plain version at a hann frame of 512
     zero-padded and at a hann frame of n_fft against the f64 torch.fft of
     the same frames; the dense B at 4 (64 channels, B-fft's range starts
     at 8) and, called directly, at 16400 (8 channels, hop 4100, where it
     streams x); B-ifft (framed_idft on the card) on the (64, 3747, 257)
     spectrum against its plain version (the dense weights product) at
     1e-5 of the max; C (overlap-add) on the
     (64, 3747, 512) frames of framed_idft, bitwise, and on complex64
     frames with a complex seed through spectral.framing._ola_fold (C once
     per part: two launches), bitwise the plain per-part fold; B-fft, complex and
     power, on the full spectrum at 64 x 480000, n_fft 16, 8 (frame 5) and
     1024, and the mixed-radix kernel at n_fft 400 (hop 160), 441 (odd: two
     frames per FFT; full spectrum, and frame 300), 480, 960, 1000, 9, 10,
     1001 and 143 (radices 11 and 13), 997, 17 and 34 (Bluestein), frames
     longer than n_fft at 1031 and 2000, and 4094 with a shorter frame, with
     hops that do not divide the frame; then two ragged
     geometries (even taps, hop not dividing the frame, length not a
     multiple of the hop, frame 400 with n_fft 512, a hop whose window
     needs the small frame tile and where A-tc's window does not fit, so
     'high' runs kernel A) for A, A-tc, B, B-fft and C, and
     stft_fir_chain(precision='high', frame_chunks=4), which must launch
     kernel A-tc once. D (the shared hop-block chain) at 768 x 480000 with
     the bench chain against its plain version and against A given the
     window D applies (the periodic hann in f64); then D on the geometries
     of the JAX package's shared-kernel tests (Blackman with 63 taps on a
     (3, 2) batch, Hamming with hop 256 and no taps, n_fft 1024 with 129
     taps) and on a length that is not a multiple of the hop with even
     taps, a hop of 50, a hop of 1000 (whose window needs the 16-block
     tile), n_fft 374 at hop 34 (188 bins: the last 96-column tile ends on
     its edge) and Blackman at n_fft 1024, with random taps as those tests
     use.
  3. the fused chain, models.pipeline.stft_fir_chain(return_filtered=False,
     precision='high') on 768 x 480000 (kernel A-tc), then the same chain
     as the module StftFirChain(precision='high') (A-tc exactly once, A
     never; whether its power is bitwise the function's is printed) and
     StftFirChain, exact f32 (kernel A), each held on two channels against
     the f64 numpy reference, per bin.
  4. stft -> istft (onesided, hann 512, overlap 384) on 64 x 480000 through
     the public functions (B-fft, B-ifft, C); interior reconstruction error <= 1e-5
     x max|x|; then istft(onesided=False) of the two-sided spectrum (C
     exactly three times: the real and imaginary parts of the complex64
     frames and the envelope), the same gate, and its fold bitwise the plain
     per-part fold; then stft at fft_length 600 and 572 on the same signal
     (B-fft's mixed-radix kernel) and at the prime 1021 (B-fft's Bluestein
     transform), each B-fft and not the dense B; stft at fft_length 2048,
     4093 and 4096 (hann n_fft, hop n_fft / 4), B-fft where the card's cut
     takes it (kernels/cuda_dft.py:_auto_takes_kernel) and torch.fft past
     it (4093, past Bluestein's cut: both branches must run); framed_dft at
     n_fft 1031, 2048, 4093, 4096, 3375, 6561, 8191, 8192, 12000, 12289,
     15625, 16381 (M = 32768 over a cluster of 4 CTAs), 16382, 16384, 16400,
     19683, 20000, 32749, 32768, 65535 and 65536 and at a frame of 1500
     (folded) through B-fft, not the dense B, and at n_fft 4 through the
     dense B, not B-fft; each held on two channels
     against the f64 numpy rfft per bin; stft(method='matmul') at
     fft_length 32768 (hann 32768, hop 8192: B-fft, not the dense B), held
     the same way; then LogMelFrontend(frame_length=400,
     hop_length=160, fft_length=400) on the same 64 x 480000 (30 s at 16
     kHz; B-fft, not B), held on two channels against an f64 numpy log-mel
     (reflect padding, rfft, |.|^2, the mel filters, log10, floor) within
     1e-5 of its max; then WhisperLogMel(128) on 512 x 480000 (30 s clips at
     16 kHz, gains -40..0 dB, the benchmark's logmel16k.whisper call: B-fft,
     then kernel M exactly once, not the dense B), held against its plain
     version (the power and spectral.mel._log_mel(clips=True) on the card)
     on the same spectrum within 2e-6.
  5. the shared path: fir_framed_dft(kernel='cuda_shared') and
     fir_framed_dft_shared(output='power', onesided=True) on 768 x 480000,
     each held on two channels against the f64 numpy reference with the
     periodic f64 hann, per bin.
  6. the filtered chain: stft_fir_chain(return_filtered=True) on 768 x
     480000 (the direct FIR, then B-fft), on two channels: the filtered
     signal against np.convolve 'same', the power against the f64 DFT of
     that filtered signal and end to end against the f64 numpy reference,
     each within 1e-4 x max and per bin within 5e-3 of the bin's max (an
     f32 filtered signal has no digits for a per-bin 1e-4 at its deepest
     stopband bins); then FIRFilterChain on the same signal against
     np.convolve 'same' (within 1e-4 x max).
     Phases 3-6 and 9 drive the main paths through their public entry points:
     the launch counters are zeroed just before each and read just after,
     and each must have launched the kernels of its path.
  7. median of 5 CUDA-event timings of each kernel, its plain version and
     the one PyTorch call that computes the same function (`library_ms`,
     never called by the port: F.conv1d of the folded weights for A and D,
     exact f32, and for A-tc in TF32 beside the exact one;
     torch.stft(center=False) for B-fft at n_fft 512, 600, 572, 1021 and
     1018 and for the dense B at 16400 on 8 channels (hop 4100); F.fold as a 1-D
     overlap-add for C), taken in turns, at the phase-2 shapes, A-tc at
     'high' and 'default', A also at hann 4096, hop 4096 on 64 channels,
     each function warmed by two calls (the second
     while the first one's result is alive, so the caching allocator holds
     its blocks); the card's FFT cuts at n_fft 1024, 1031, 2048, 3375, 4093,
     4094, 4096, 6561, 8191, 8192, 12000, 12289, 15625, 16382, 16384, 19683,
     20000, 32749, 32768, 65535 and 65536
     (hann frame n_fft, hop n_fft / 4, 64 x 480000): B-fft through
     framed_dft, torch.stft(center=False), then the public stft with method
     'matmul' (B-fft) and 'fft' (torch.fft), and B-fft's plain version at
     1024-4096, 8192 and 16384; the cut those times put within each length
     class (the largest timed n_fft of the class up to which B-fft is no
     slower than torch.stft at every timed length of the class: powers of
     two, other 13-smooth lengths, Bluestein's) beside the port's
     _CARD_FFT_CUT, _CARD_SMOOTH_CUT and _CARD_BLUESTEIN_CUT; then of
     the filtered chain's two stages (the direct FIR and B-fft) at 768 x
     480000; the fused chain's own cut at n_fft 2048 (64 channels): the
     fold at 'high' (A-tc, or A where A-tc's window does not fit) against
     the FIR then B-fft's power; frame_chunks='auto' on the plain power
     path of the bench chain at 768 x 480000: the plan at the card's
     budget (must be 1) and its peak memory above its inputs beside the
     plan's model, then the plan at a third of the model (must be > 1),
     its peak, and its output per bin at 1e-4 of the unchunked one; then
     welch at 768 x 480000 (hann 512, hop 256, detrend
     'constant', average 'mean') end to end and by stage (B-fft through
     stft, the detrend coefficients' exact-f32 contraction, the in-place z
     - coefs @ wk update, the power and the mean) beside torch.stft(center=
     False) with |z|^2 and the mean: where the time of phase 9's path goes
     (printed lines, not a kernel row). Each kernel's bound is computed from this run's shapes, for
     the least work its function needs (not the dense-matrix DFT the
     contraction kernels run): the larger of the operations of an FFT route
     (the FIR as an FFT overlap-save convolution, a real FFT per frame, 2.5
     n log2 n each) over the 67 TFLOP/s f32 peak and its bytes (inputs read
     once, outputs written once) over the card's data-sheet rate
     (utils/profiling.py:device_hbm_bandwidth, 3.35 TB/s on the H100 SXM); A-tc's own route at the 495 TFLOP/s TF32 peak is printed beside,
     and D's (stage A, each hop block's partial DFT once) at the f32 peak,
     with the CTAs of D an SM holds at the bench chain (the occupancy
     calculator; fewer than 2 fails) and the shared path's set-up per call
     on the host clock (the f64 fold and twiddle table copied to the card,
     then D's layout of both).
  8. the sharded layer: 4 ranks, each a fresh interpreter running this
     script with --phase8-rank (subprocess; never fork, which CUDA forbids),
     each starting its process group through parallel.multihost.initialize(
     coordinator_address="127.0.0.1:<free port>", num_processes=4,
     process_id=rank) (one gloo group: the ranks share the card) and making
     its meshes (1, 4) and (2, 2) with make_pod_mesh, on cuda:(rank %
     device_count), so with one card all four share it and kernel E's
     stores and signals go through CUDA IPC. Each rank reports its
     process_block_range(480000) on mesh (1, 4), and the parent fails
     unless the four ranges tile [0, 480000) in block order. The ranks load
     the library phase 1 built. Kernel E against its plain version (send/recv +
     concat), bitwise, on mesh (1, 4) for 768 x 120320 blocks (the bench
     FIR's 'direct' block rounding of 480000 / 4) with hl = hr = 127, K =
     256 (128, 127) and K = 2 (1, 0); then, each path with the counters
     zeroed before it (every sharded halo is kernel E):
     sharded_convolve_same with the bench FIR at 768 x 480000 on (1, 4)
     and 64 x 480000 on (2, 2), each rank's shard within 1e-5 of its max
     against the single-device convolve(mode='same'), E launched once per
     rank; sharded_fir_framed_dft_power at the bench chain on (1, 4) at
     precision 'highest' (kernel A), 'high' and 'default' (A-tc), each
     rank's frames
     bitwise equal to the single-device stft_fir_chain at the same
     precision, the kernel and E launched once per rank, and at hann 1024,
     hop 4096 (no right halo; kernel A streams x) bitwise equal to the
     single-device fir_framed_dft; sharded_stft ->
     sharded_istft at 64 x 480000 on (1, 4), B-fft, B-ifft, C and E launched, the
     interior within 1e-5 x
     max|x|, and the seeded sharded overlap-add bitwise equal to the
     single-device fold; sharded_welch at 64 x 480000 on (1, 4) (hann 512,
     hop 256), B-fft once and E twice per rank (the frame halo and the
     detrend coefficients' right halo), each rank's PSD within 1e-5 of its
     max against the single-device welch. Then 16 calls of kernel E back to back on fresh
     64 x 120320 blocks, pads (127, 127), (128, 127), (1, 0), (0, 4) in
     turn, no host sync between them and rank 1's stream delayed (about 50
     ms) before the first and the ninth, each result bitwise equal to the
     plain version computed afterwards. Last, at the bench geometry (all
     ranks together, host clock; median of 5, the largest rank reported):
     one exchange through kernel E and a sync (`ms`), 16 back to back and
     one sync, per call (`ms_back_to_back`), issuing one call without a
     sync (`host_ms`), the plain send/recv halo and the bare send/recv; and
     E's put, interior and edges alone, without the waits and signals,
     rank by rank, by CUDA events (`device_ms`). The parent waits
     for every rank with a timeout; a rank that fails or hangs fails the
     run, and the ranks still running are killed. Ranks prefix their lines
     with their rank.
  9. spectral estimation on the card, each path with the counters zeroed
     before it: welch (hann 512, hop 256, detrend 'constant') at 768 x
     480000 with average 'mean' and 'median' (1874 segments: the median of
     an even count), B-fft launched and the dense B not; csd and coherence
     of 64 x 480000 and a filtered (3 taps), delayed (7 samples), noisy
     copy; spectrogram (hann 512, hop 128) at 64 x 480000; each held on
     two channels against f64 scipy.signal (welch, csd, coherence,
     spectrogram with detrend=False) within 1e-4 of the max, the gate of
     the CPU parity tests. Then ShortTimeFFT(hann 512, hop 128, fs 48000):
     stft then istft at 64 x 480000, B-fft and C launched, the interior
     reconstruction within 1e-5 x max|x|, the spectrum per bin within
     1e-4 against the f64 torch.fft route on the CPU (two channels), and C
     on istft's own frames bitwise equal to its plain fold.
 10. IIR filtering on the card (plain PyTorch: no TPU kernel lies on this
     path, and none of the kernels may launch), on 768 x 480000 f32 from
     the seed: sosfilt with butter(8, 0.1) and ellip(8, 0.5, 60, 0.15) as
     sos (4 biquads each, the chunked order-2 form), lfilter with butter(2,
     0.1) (order 2, chunked) and butter(8, 0.1) as ba (order 8, one f64
     step per sample), then sosfiltfilt and filtfilt once each; each held
     per row within 1e-4 of the row's max against f64 scipy.signal on 8
     channels, timed as the median of 5 CUDA-event timings (filtfilt and
     sosfiltfilt: their one checked call, host clock), with its peak memory
     above the input (torch.cuda.max_memory_allocated) beside the card's
     name and power limit. Phase 8 also holds sharded_sosfilt (no halo:
     kernel E must not launch) on its ranks against the single-device
     sosfilt at 1e-5 of the max, and the polyphase functions at 64 x 480000
     on (1, 4), each launching kernel E once per rank, each rank's shard
     against the single-device call at the JAX package's gates:
     sharded_upfirdn (31 taps, up 2, down 3; float32, and complex64, whose
     8-byte elements E moves whole) at rtol 2e-5, atol 2e-5 x max;
     sharded_resample_poly (1/3: a left and a right halo) at rtol = atol =
     1e-5; sharded_pfb_analyze (64 bands, tpc 8: a right halo of 448) at
     rtol = atol = 1e-6 x max (each rank prints the error it reads).
 11. resampling, the polyphase filterbank and mixing on the card (plain
     PyTorch: no TPU kernel lies on these paths, and none of A-D may
     launch), from the seed in f32, each held on 4 rows against an f64
     oracle per row at 1e-5 of the row's max (decimate 'sos' and 'iir' at
     1e-4 against scipy.signal.decimate), timed as the median of 5
     CUDA-event timings, with its peak memory above the input and the
     card's name and power limit: the config-4 chain
     resample_poly(mix_down(x, 8000, 48000).real, 1, 3) at 64 x 2880000
     (60 s at 48 kHz; the oracle mixes with the port's f32 phase argument
     in f64, then scipy's resample_poly); upfirdn (31 taps, up 2, down 3)
     on float32 and complex64 input ('materialize': frames of 2 hop
     blocks), and with 2047 taps at 8 x 2880000 ('conv': 17 blocks;
     against scipy's f64 fftconvolve);
     demodulate_channel(x, 12000, 48000, bandwidth=4000, decimation=6);
     resample (the Fourier method) to a third; decimate(q=3) 'fir' and
     'sos', all at 64 x 2880000, and 'iir' at 8 x 48000 (order 8 one f64
     step per sample: the checked call on the host clock); pfb_analyze at
     8 x 4194304 with 64 and 1024 bands ('auto': 'factored') and 16 bands
     ('matmul'), and 1024 bands on one stream of 100 000 000 samples, each
     against an f64 numpy einsum and FFT, its peak beside
     pfb_footprint_bytes; last, resample_poly(x, 1, 3) at 64 x 28800000 (10
     min at 48 kHz), its reckoned peak printed first.
 12. the streaming slice on the card (parallel/streaming.py, models/
     pipeline.py, io/, parallel/failure.py), each path with the counters
     zeroed before it: StreamingFIR (firwin 255 taps) and StreamingIIR
     (butter(8, 0.1) as 4 sections) at 768 x 480000 in chunks of 48000, per
     row at 1e-5 of the row's max against convolve(x, taps, 'full')[..., :n]
     and sosfilt of the whole rows; StreamingSTFT (hann 512, hop 128, the
     full spectrum; B-fft exactly once a chunk) at 64 x 480000 in chunks of
     48000, per bin at 1e-4 against stft of the signal with 384 zeros
     prepended, and StreamingISTFT of its spectra (C exactly twice a chunk)
     within 1e-5 x max|x| of the delayed signal past the first 512 samples;
     StreamingPFB (1024 bands, tpc 8) at 8 x 4194304 in chunks of 2^20
     against pfb_analyze after lead_frames at 1e-5 of the max;
     StreamingResamplePoly 1/3 at 64 x 2880000 in chunks of 288000 against
     resample_poly after lead_out, per row at 1e-5. Each processor then
     runs half its chunks, save_state, load_state and the other half: the
     tail bitwise the uninterrupted run's. Each is timed (ms per chunk of
     one streaming run, the batch call beside it; medians of 3, CUDA
     events). Then BASELINE.json config 5 from a capture: a seeded i16
     capture of 8 blocks of 2^24 frames (the JAX script's 24 cut to 8 for
     the time limit) written with write_raw, read by
     PrefetchingRawReader(depth_blocks=4) through channelize_power_stream
     (1024 bands, tpc 8), its power within 1e-4 of the max of the batch
     pfb_analyze of the zero-prepended stream, end-to-end Msamples/s (host
     clock) and compute-only ms per block (CUDA events); WidebandReceiver
     (1024 bands, tpc 8, frame 128, hop 64) on 1 x 2^26 samples, 4 bands
     within 1e-4 of each band's max against an f64 numpy evaluation with
     scipy's prototype (firwin) and periodic Hann window; 60 s
     of stereo 44.1 kHz PCM16 written, read whole, streamed and read by
     PrefetchingWavReader, all bitwise equal, in MB/s, failing unless the
     native library is the one loaded; heartbeat on the card within its
     deadline; the phase's seconds.
 13. the signal-facing long tail of ops/ on the card (plain PyTorch: no TPU
     kernel lies on these paths, and none of A-D may launch), each path
     with the counters zeroed before it, each against an f64 oracle and
     timed (median of 3 CUDA-event timings) beside the card's name and
     power limit: chirp (linear, logarithmic), sawtooth and square at 28 800
     000 samples (10 min at 48 kHz) against an f64 evaluation of the same
     float32 argument (numpy's float32 ops in the port's order) at 1e-5, the
     logarithmic chirp with 8 ulps of its float32 power (the card's powf
     and the host's differ there) and of its argument added to the gate,
     each chirp's drift from scipy's f64 chirp printed; argrelmax order 5 at
     64 x 480000, scipy's indices; cwt (ricker, widths 1-128) on 480000
     samples, 8 widths per row at 1e-4 against scipy's f64 convolve 'same'
     with the conjugated reversed wavelet; find_peaks on a 2^22-sample
     random walk plus noise (height, distance 50, prominence, width):
     scipy's indices, the x-valued properties at 1e-5 of max|x|, the
     positions at float32 resolution, the distance filter's rounds printed;
     find_peaks_cwt (host f64) at 2^14, widths 1-16, scipy's indices;
     zoom_fft at 64 x 480000 (1-2 kHz at 48 kHz, m 8192: Bluestein) and czt
     at 768 x 1024, m 1024 on each route, 4 rows each at 1e-4 of scipy's,
     then both CZT routes timed at n = m, n*m from 2^18 to 2^23, 768 rows;
     lambert_w on 2^22 complex128 points, branches 0 and -1, at atol
     1e-13, rtol 1e-10 against scipy.special.lambertw; cspline1d and
     symiirorder2 at 768 x 480000 (4 rows), cspline2d, qspline2d and
     spline_filter at 2048 x 2048, sepfir2d (7 taps) at 4096 x 4096, each per
     row at 1e-4 of scipy's f64 (the smoothing boundary sums at precision
     1e-14, where scipy's truncated sums meet the full ones).
 14. the state-space simulation and the utils on the card (plain PyTorch:
     no TPU kernel lies on these paths, and none of A-E may launch), each
     path with the counters zeroed before it, timed (median of 3 CUDA-event
     timings, with the cost of a step) beside the card's name and power
     limit: dlsim of tf2ss(butter(8, 0.1)) (8 states) with x0 set on 48 000
     f64 samples given as numpy, y and x against scipy.signal.dlsim at 1e-9
     of their max; dlsim of a MIMO system (4 states, 2 inputs, 2 outputs)
     on a (100 000, 2) float32 CUDA tensor, y at 1e-5; lsim of the analog
     butter(4, 2 pi 1000) over linspace(0, 1, 48 001) with a random input,
     interp True and False, y and x against scipy.signal.lsim at 1e-9;
     impulse, step, dimpulse and dstep at their defaults and the outputs of
     lti, dlti and StateSpace, each at 1e-8 of scipy's. Then the utils on
     x * 2.0 over 2^28 float32 (1 GiB in, 1 GiB out): benchmark (host
     clock) and timed_median (CUDA events), each reading 105% or less of
     device_hbm_bandwidth(); slope_rate between 2^27 and 2^28; trace writes
     a Chrome trace holding at least one CUDA kernel event; count_nonfinite
     of a 2^28 tensor with 3 infs gives 3, and assert_all_finite raises.
 15. the device rule (utils/devices.py) on the card: every entry point given
     no tensor (the windows, firwin, firwin_2d, savgol_coeffs, the frequency
     responses, max_len_seq, firwin2, firls, remez, minimum_phase,
     mel_filters, fft_frequencies, unit_impulse, the wavelets, the chirp-z
     points, the fold weights and twiddles, FIRFilterChain.design), called
     with no device=, returns CUDA tensors equal to its device='cpu' build:
     bit for bit where the values are built on the host and moved, within
     1e-6 of the max for float32 / complex64 values computed on the card
     (mel_filters 1e-5, its gate against the JAX package) and 1e-12 for
     f64 / complex128 ones, every miss listed; the port's internal host paths
     on an 8 x 48000 CUDA signal against the same calls on its CPU copy
     (ShortTimeFFT.from_window('hann') within 1e-4 of the max, check_COLA
     of a named window, resample_poly and decimate with their default taps,
     demodulate_channel and StreamingPFB with its default prototype, within
     1e-5); then the count and bytes of the host-to-device copies of the
     second call (torch.profiler's trace of the card) of stft(x, hann(512)),
     LogMelFrontend()(x) and FIRFilterChain()(x) on 8 x 480000, each beside
     the same work with its window, filterbank or taps built on the CPU,
     which it must not exceed.
Last of all, a process this script started that is still running is
killed and fails the run.
The line before the last is one JSON object describing the kernels A,
A-tc, B-fft, B, C, D, E and M (the launch counts add up every path's, phase
8's over all ranks, and phases 9's and 12's; phases 13 and 14 launch
none; A's at the bench chain, with the same keys and `_hop_4096` at hann
4096, hop 4096 beside; A-tc's `ms`, `plain_ms` and `max_abs_err` are at
'high', with `ms_default`, `max_abs_err_default` and the exact conv1d's
`library_exact_ms` beside; B-fft's at n_fft 512, with the mixed-radix
kernel's `ms_600`, `plain_ms_600`, `library_ms_600`, `bound_ms_600`,
`bound_by_600` and `max_abs_err_600` at 600 beside, and the same keys
with `_572`, `_1021` and `_1018` and each timed n_fft of the cuts (past
16384 `max_abs_err_<n>` against the f64 torch.fft, and
`max_abs_err_<n>_frame_512` against the plain version); B's at its
`n_fft` 16400, `channels` 8 and `hop` 4100; D's with the
shared path's set-up, `fold_ms` and `layout_ms`; E's `ms`,
`ms_back_to_back`, `host_ms`, `plain_ms` and `library_ms` are host-clock
times of all ranks at once, `device_ms` its kernels alone, and its bound
counts the bytes
of all the ranks sharing the card; M's at WhisperLogMel's call, 512 clips
of 3001 x 201 bins and 128 mels, beside the plain version and
openai/whisper's own torch lines, its bound one read of the frames of z it
needs and one write of the log-mel); the last is the device line {"ok":
true, "device": {...}}.
"""

import concurrent.futures
import ctypes
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

# H100 SXM f32 peak outside the tensor cores (NVIDIA's data sheet); the
# device-memory rate comes from the port's table (_peak_bytes)
_PEAK_F32_FLOPS = 67e12
_PHASE8_RANKS = 4
_PHASE8_TIMEOUT_S = 600
# the n_fft at which phase 7 times B-fft against torch.stft for the card's
# cuts (kernels/cuda_dft.py:_card_takes_kernel), and those at which it also
# times B-fft's plain version
_CUT_LENGTHS = (1024, 1031, 2048, 3375, 4093, 4094, 4096, 6561, 8191, 8192, 12000, 12289,
                15625, 16382, 16384, 19683, 20000, 32749, 32768, 65535, 65536)
_PLAIN_CUT_LENGTHS = (1024, 1031, 2048, 4093, 4094, 4096, 8192, 16384)
# B-fft past 16384 (phase 2 holds each against its plain version at a frame
# of 512 and against an f64 torch.fft at a hann frame of n_fft; phase 4
# drives each through framed_dft): 16400 (past 16384), 19683 = 3^9
# and 20000 (13-smooth), the prime 32749 (Bluestein, M = 65536), 32768 and
# 65536 (radix 8 over clusters of 2 and 4 CTAs) and 65535 = 3 * 5 * 17 * 257
# (Bluestein, M = 131072 over a cluster of 16)
_LONG_LENGTHS = (16400, 19683, 20000, 32749, 32768, 65535, 65536)


def _gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _ptxas_summary(log):
    """(kernels, most registers, spill bytes, C75xx performance warnings) in
    the ptxas -v report of a build."""
    import re

    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in
                 re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    warnings = [ln.strip() for ln in log.splitlines() if re.search(r"\(C75\d\d\)", ln)]
    return log.count("Compiling entry function"), max(regs, default=0), spills, warnings


def _ptxas_registers(log):
    """{kernel: [(template arguments, registers), ...]} of every entry
    function in the ptxas -v report, named as its mangled name spells it."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            continue
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            kernel = re.search(r"([a-z_]+_kernel)(I(?:L[a-z]\d+E)+E)?", name)
            args = ",".join(re.findall(r"L[a-z](\d+)E", kernel.group(2) or ""))
            found.setdefault(kernel.group(1), []).append((args, int(used.group(1))))
            name = None
    return found


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _per_bin(name, got, want):
    """(max|got - want|, max|want|) of each bin (last axis)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    dims = tuple(range(want.ndim - 1))
    return (got - want).abs().amax(dim=dims), want.abs().amax(dim=dims)


def _gate_bins(name, err_bin, scale_bin, rel) -> float:
    """Gate each bin at rel x that bin's own max|want|; returns the max abs
    error over all bins."""
    rel_bin = err_bin / scale_bin
    worst = int(rel_bin.argmax())
    err, worst_rel = float(err_bin.max()), float(rel_bin[worst])
    print(f"  {name}: max|d| = {err:.6g}, max|plain| = {float(scale_bin.max()):.6g}, "
          f"largest per-bin rel = {worst_rel:.3g} at bin {worst} of {err_bin.shape[0]} "
          f"(gate {rel:g})", flush=True)
    if not worst_rel <= rel:
        raise AssertionError(f"{name}: bin {worst} max|d| {float(err_bin[worst])} > "
                             f"{rel} x {float(scale_bin[worst])}")
    return err


def _check_close(name, got, want, rel=1e-4) -> float:
    """Gate each bin (last axis) at rel x that bin's own max|want|; returns
    the max abs error over all bins."""
    return _gate_bins(name, *_per_bin(name, got, want), rel)


def _check_close_rows(name, got, plain, rows, rel=1e-4) -> float:
    """_check_close of got against plain(leading-axis slice), `rows` rows at
    a time (a plain version with f64 sums of every row at once would hold
    tens of GB)."""
    import torch

    pairs = [_per_bin(name, got[r:r + rows], plain(slice(r, r + rows)))
             for r in range(0, got.shape[0], rows)]
    return _gate_bins(name, torch.stack([e for e, _ in pairs]).amax(dim=0),
                      torch.stack([s for _, s in pairs]).amax(dim=0), rel)


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


def _peak_bytes() -> float:
    """The card's device-memory rate in bytes/s, from NVIDIA's data sheet
    (`utils.profiling.device_hbm_bandwidth`, which phase 14 reads too)."""
    from nx_signal_tpu_torch.utils.profiling import device_hbm_bandwidth

    return device_hbm_bandwidth()


def _bound(flops, nbytes):
    """(least ms, what bounds it) for `flops` f32 operations and `nbytes`
    of device-memory traffic at the card's published peaks."""
    ops_ms, bytes_ms = flops / _PEAK_F32_FLOPS * 1e3, nbytes / _peak_bytes() * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _rfft_flops(n) -> float:
    """Operations of one real-input FFT of length n (2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def _fft_route_flops(rows, length, num_taps, frame, num_frames, n_fft, bins) -> float:
    """Operations of the least-work route of the FIR + framed DFT power
    chain on `rows` signals: the FIR (none for num_taps 0) as an FFT
    overlap-save convolution of length 2 x the power of two >= K (a forward
    and an inverse real FFT and a complex product per block of n - K + 1
    outputs), then per frame the window, one real FFT and |.|^2 (3 per
    bin; 0 for a complex output)."""
    fir = 0.0
    if num_taps:
        n = 2 * (1 << (num_taps - 1).bit_length())
        blocks = -(-length // (n - num_taps + 1))
        fir = blocks * (2 * _rfft_flops(n) + 6.0 * (n // 2 + 1))
    return rows * (fir + num_frames * (frame + _rfft_flops(n_fft) + 3.0 * bins))


def _run_path(name, kernels, expect, fn, avoid=()):
    """Zero every launch counter, run one main path, and fail unless each
    kernel of `expect` was launched on it and none of `avoid`; returns the
    counts."""
    for kernel in kernels:
        kernel.launches = 0
    fn()
    counts = {k.__name__: k.launches for k in kernels}
    print(f"  launches on {name}: {counts}", flush=True)
    for kernel in expect:
        if counts[kernel.__name__] < 1:
            raise AssertionError(f"{kernel.__name__} was not launched on {name}")
    for kernel in avoid:
        if counts[kernel.__name__]:
            raise AssertionError(f"{kernel.__name__} was launched on {name}")
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase8(world, device_type, sizes):
    """Start `world` ranks, each a fresh interpreter running this script's
    `_phase8_rank` and starting its process group through
    `parallel.multihost.initialize` at 127.0.0.1 on a free port, wait for
    them within _PHASE8_TIMEOUT_S, check that their process_block_range
    tiles the stream in block order, and return every rank's report. A
    rank that fails or hangs fails the run; every rank still running is
    then killed, and each is reaped before this returns. The ranks are
    plain subprocesses, not multiprocessing's, whose 'spawn' leaves its
    resource-tracker process running until the interpreter exits."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--phase8-rank"]
        address = f"127.0.0.1:{_free_port()}"
        procs = []
        try:
            for rank in range(world):
                procs.append(subprocess.Popen(
                    [*cmd, str(rank), str(world), tmp, device_type, json.dumps(sizes),
                     address]))
            deadline = time.monotonic() + _PHASE8_TIMEOUT_S
            while True:
                codes = [proc.poll() for proc in procs]
                for rank, code in enumerate(codes):
                    if code not in (None, 0):
                        raise RuntimeError(f"phase 8: rank {rank} exited with {code}")
                if all(code == 0 for code in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"phase 8: ranks still running after "
                                       f"{_PHASE8_TIMEOUT_S} s")
                time.sleep(0.2)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        with open(os.path.join(tmp, "phase8.json")) as f:
            reports = json.load(f)
    spans = [tuple(r["block_range"]) for r in sorted(reports, key=lambda r: r["block"])]
    print(f"  phase 8: the ranks started through multihost.initialize({address!r}, {world}, "
          f"rank); process_block_range({sizes['length']}) in block order: {spans}", flush=True)
    if spans[0][0] != 0 or spans[-1][1] != sizes["length"] or any(
            a[1] != b[0] for a, b in zip(spans, spans[1:])):
        raise AssertionError(f"phase 8: the ranks' block ranges {spans} do not tile "
                             f"[0, {sizes['length']})")
    return reports


def _live_children():
    """(pid, command line) of every process whose parent is this one."""
    found = []
    for stat in os.listdir("/proc"):
        if not stat.isdigit():
            continue
        try:
            with open(f"/proc/{stat}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == os.getpid():
                with open(f"/proc/{stat}/cmdline", "rb") as f:
                    found.append((int(stat), f.read().replace(b"\0", b" ").decode().strip()))
        except (OSError, IndexError, ValueError):
            continue  # gone while we looked
    return found


def _phase8_rank(rank, world, tmp, device_type, sizes, address):
    """One rank of phase 8 (see the module docstring), its process group
    started by `parallel.multihost.initialize` at `address` (rank 0
    listens there) and its meshes made by `make_pod_mesh`. `device_type`
    'cpu' runs the same program on the CPU at a small `sizes`, with the
    plain versions and without the launch gates and timings."""
    import numpy as np
    import torch
    import torch.distributed as dist

    def say(msg):
        print(f"[rank {rank}] {msg}", flush=True)

    from nx_signal_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=address, num_processes=world, process_id=rank)
    from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
    from nx_signal_tpu_torch.kernels._build import load_library
    from nx_signal_tpu_torch.kernels.dft import fir_framed_dft, framed_idft
    from nx_signal_tpu_torch.models.pipeline import stft_fir_chain
    from nx_signal_tpu_torch.ops.convolution import convolve
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel.halo import (
        _halo_extend_torch, _shift_from_left, _shift_from_right)
    from nx_signal_tpu_torch.parallel.mesh import block_row, mesh_coordinate, mesh_device
    from nx_signal_tpu_torch.ops.iir import sosfilt
    from nx_signal_tpu_torch.ops.iir_design import butter
    from nx_signal_tpu_torch.parallel.estimation import sharded_welch
    from nx_signal_tpu_torch.ops.resample import pfb_analyze, resample_poly, upfirdn
    from nx_signal_tpu_torch.parallel.sharded import (
        _local_shard, _sharded_fold, gather_blocks, sharded_convolve_same,
        sharded_fir_framed_dft_power, sharded_istft, sharded_pfb_analyze,
        sharded_resample_poly, sharded_sosfilt, sharded_stft, sharded_upfirdn)
    from nx_signal_tpu_torch.spectral.estimation import welch

    mesh14 = multihost.make_pod_mesh(1, device_type=device_type)
    mesh22 = multihost.make_pod_mesh(2, device_type=device_type)
    dev = mesh_device(mesh14)
    on_card = dev.type == "cuda"
    say(f"on {dev}, {dist.get_backend()} group of {dist.get_world_size()}")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    A, A_tc = cuda_dft.fir_framed_dft_power_cuda, cuda_dft.fir_framed_dft_power_tc_cuda
    B_fft, B = cuda_dft.framed_fft_cuda, cuda_dft.framed_dft_cuda
    B_ifft = cuda_dft.framed_ifft_cuda
    C, E = cuda_dft.overlap_add_cuda, cuda_halo.halo_extend_cuda
    kernels = (A, A_tc, B_fft, B_ifft, B, C, E)
    report = {"rank": rank, "launches": {k.__name__: 0 for k in kernels},
              "block": mesh_coordinate(mesh14)[1],
              "block_range": multihost.process_block_range(sizes["length"], mesh14)}
    out = {}

    def run_path(name, expect, fn):
        for kernel in kernels:
            kernel.launches = 0
        fn()
        sync()
        counts = {k.__name__: k.launches for k in kernels}
        say(f"launches on {name}: {counts}")
        for kernel, n in expect.items():
            if on_card and counts[kernel.__name__] != n:
                raise AssertionError(f"rank {rank}: {kernel.__name__} launched "
                                     f"{counts[kernel.__name__]} times on {name}, not {n}")
        for kname, n in counts.items():
            report["launches"][kname] += n

    def bitwise(name, got, want):
        """Fail unless bitwise equal; returns max|got - want|."""
        same = got.shape == want.shape and torch.equal(got.contiguous().view(torch.int32),
                                                       want.contiguous().view(torch.int32))
        say(f"{name}: bitwise equal = {same}")
        if not same:
            raise AssertionError(f"rank {rank}: {name} not bitwise equal")
        return float((got - want).abs().max())

    channels, length, block = sizes["channels"], sizes["length"], sizes["block"]
    small = sizes["small_channels"]
    rate, num_taps, frame, hop, n_fft = 48000.0, 255, 512, 128, 512
    _, b = mesh_coordinate(mesh14)

    # kernel E against its plain version on each rank's own block
    report["e_max_abs_err"] = 0.0
    for k in (num_taps, 256, 2):
        hr = (k - 1) // 2
        hl = k - 1 - hr
        gen = torch.Generator(device=dev).manual_seed(100 + rank)
        x_blk = torch.randn((channels, block), generator=gen, device=dev)
        err = bitwise(f"E {channels}x{block} hl={hl} hr={hr} vs send/recv + concat",
                      E(x_blk, hl, hr, mesh=mesh14),
                      _halo_extend_torch(x_blk, hl, hr, mesh=mesh14))
        report["e_max_abs_err"] = max(report["e_max_abs_err"], err)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((channels, length), generator=gen, device=dev)  # the same on every rank
    x_small = x[:small]
    taps = firwin(num_taps, [2000.0], sampling_rate=rate, device=dev)
    for mesh, sig, tag in ((mesh14, x, "(1, 4)"), (mesh22, x_small, "(2, 2)")):
        name = f"sharded_convolve_same {tag} {tuple(sig.shape)}"
        run_path(name, {E: 1}, lambda: out.update(
            y=sharded_convolve_same(sig, taps, mesh=mesh)))
        y = out.pop("y")
        c, bb = mesh_coordinate(mesh)
        rows = sig.shape[0] // mesh.size(0)
        start = bb * y.shape[-1]
        stop = min(start + y.shape[-1], length)
        ref = convolve(sig[c * rows:(c + 1) * rows], taps.to(dev)[None],
                       mode="same")[:, start:stop]
        got = y[:, :stop - start]
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        say(f"{name} vs single-device convolve 'same': max|d| = {err:.6g}, max = {scale:.6g}, "
            f"bitwise = {torch.equal(got, ref)} (gate 1e-5 x max)")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"rank {rank}: {name} off the single-device call by {err}")
        del y, ref, got

    window = hann(frame, device=dev)
    num_frames = (length - frame) // hop + 1
    for precision, kernel in (("highest", A), ("high", A_tc), ("default", A_tc)):
        name = f"sharded_fir_framed_dft_power (1, 4) {channels}x{length} precision={precision}"
        run_path(name, {kernel: 1, E: 1}, lambda: out.update(p=sharded_fir_framed_dft_power(
            x, taps, window, mesh=mesh14, stride=hop, n_fft=n_fft, precision=precision)))
        p = out.pop("p")
        f0 = b * p.shape[1]
        f1 = min(f0 + p.shape[1], num_frames)
        single = stft_fir_chain(x, taps, window, fft_length=n_fft, overlap_length=frame - hop,
                                sampling_rate=rate, return_filtered=False, precision=precision)
        got, want = p[:, :f1 - f0], single[:, f0:f1]
        _check_close(f"[rank {rank}] {name} frames {f0}:{f1} vs single-device stft_fir_chain",
                     got, want)
        if on_card:  # each frame sums the same way whatever its tile
            bitwise(f"{name} vs the single-device chain", got, want)
        del p, single, got, want
    # a hop of 4096 past a hann frame of 1024 (no right halo): kernel A
    # streams x on every rank and in the single-device chain
    win_l, hop_l, n_l = hann(1024, device=dev), 4096, 1024
    name = f"sharded_fir_framed_dft_power (1, 4) {channels}x{length} hann 1024 hop {hop_l}"
    run_path(name, {A: 1, E: 1}, lambda: out.update(p=sharded_fir_framed_dft_power(
        x, taps, win_l, mesh=mesh14, stride=hop_l, n_fft=n_l)))
    p = out.pop("p")
    single = fir_framed_dft(x, taps, win_l, stride=hop_l, n_fft=n_l, onesided=True,
                            output="power")
    f0 = b * p.shape[1]
    f1 = min(f0 + p.shape[1], single.shape[1])
    got, want = p[:, :f1 - f0], single[:, f0:f1]
    _check_close(f"[rank {rank}] {name} frames {f0}:{f1} vs single-device fir_framed_dft",
                 got, want)
    if on_card:
        bitwise(f"{name} vs the single-device chain", got, want)
    del p, single, got, want

    win_t = hann(frame, device=dev)
    kw = dict(fft_length=n_fft, overlap_length=frame - hop, sampling_rate=rate, onesided=True)

    def round_trip():
        z = sharded_stft(x_small, win_t, mesh=mesh14, **kw).z
        out["z"] = gather_blocks(z, mesh=mesh14, length=num_frames, axis=-2)
        out["y"] = sharded_istft(out["z"], win_t, mesh=mesh14, **kw)

    run_path(f"sharded_stft -> sharded_istft (1, 4) {small}x{length}",
             {B_fft: 1, B_ifft: 1, C: 4, E: 1}, round_trip)
    z, y = out.pop("z"), out.pop("y")
    overlap = frame - hop
    own = -(-num_frames // world) * hop
    out_length = num_frames * hop + overlap
    lo, hi = max(b * own, frame), min(b * own + y.shape[-1], out_length - frame)
    err = float((y[:, lo - b * own:hi - b * own] - x_small[:, lo:hi]).abs().max())
    scale = float(x_small.abs().max())
    say(f"round trip samples {lo}:{hi}: max|d| = {err:.6g} (gate 1e-5 x {scale:.6g})")
    if not (bool(torch.isfinite(y).all()) and err <= 1e-5 * scale):
        raise AssertionError(f"rank {rank}: round trip error {err} > 1e-5 x {scale}")
    frames = framed_idft(z, win_t, n_fft=n_fft, onesided=True)
    fpb = own // hop
    folded = _sharded_fold(_local_shard(frames, mesh14, fpb, 1, dev), hop, own, overlap, mesh14)
    mine = folded if b == world - 1 else folded[..., :own]
    ref = C(frames, stride=hop, out_length=out_length)[:, b * own:b * own + mine.shape[-1]]
    bitwise("seeded sharded overlap-add vs the single-device fold", mine[..., :ref.shape[-1]],
            ref)
    del z, y, frames, folded, mine, ref

    # sharded_welch: B-fft for the segment spectra and E twice (the frame
    # halo and the detrend coefficients' halo), against the single-device
    # welch on the same card
    welch_kw = dict(sampling_rate=rate, window="hann", segment_length=frame,
                    overlap_length=frame // 2)
    name = f"sharded_welch (1, 4) {small}x{length}"
    run_path(name, {B_fft: 1, E: 2}, lambda: out.update(
        p=sharded_welch(x_small, mesh=mesh14, **welch_kw)[1]))
    p, single = out.pop("p"), welch(x_small, **welch_kw)[1]
    if tuple(p.shape) != tuple(single.shape) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"rank {rank}: {name} output {tuple(p.shape)} not finite or "
                             "wrong shape")
    report["welch_max_abs_err"] = _check_close(
        f"[rank {rank}] {name} vs single-device welch, all bins (gate 1e-5 x max)",
        p.reshape(-1, 1), single.reshape(-1, 1), rel=1e-5)
    del p, single

    # sharded_sosfilt: no halo (E must not launch), one all-gather of the
    # blocks' final states; against the single-device sosfilt on the same
    # card at 1e-5 of the max (tests/test_sharded.py:276-277)
    sos = butter(8, 0.1, output="sos")
    name = f"sharded_sosfilt (1, 4) {small}x{length} butter(8, 0.1) sos"
    run_path(name, {E: 0}, lambda: out.update(y=sharded_sosfilt(sos, x_small, mesh=mesh14)))
    y = out.pop("y")
    start = b * y.shape[-1]
    stop = min(start + y.shape[-1], length)
    single = sosfilt(sos, x_small)[:, start:stop]
    got = y[:, :stop - start]
    err, scale = float((got - single).abs().max()), float(single.abs().max())
    say(f"{name} samples {start}:{stop} vs single-device sosfilt: max|d| = {err:.6g}, "
        f"max = {scale:.6g} (gate 1e-5 x max)")
    if not (bool(torch.isfinite(y).all()) and err <= 1e-5 * scale):
        raise AssertionError(f"rank {rank}: {name} off the single-device sosfilt by {err}")
    report["sos_max_abs_err"] = err
    del y, single, got

    # the polyphase functions, every halo through kernel E (resample_poly's
    # group delay gives a right halo too; a complex64 shard goes through E
    # whole): each rank's shard against the single-device call on the same
    # card at the JAX package's gates (tests/test_sharded_resample.py:43-44,
    # :72-73; tests/test_sharded.py:221-242), as (rtol, atol, atol relative
    # to the single-device max)
    h31 = torch.randn(31, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    x_c = torch.complex(x_small, x_small.flip(-1))
    report["polyphase_rel_err"] = {}
    polyphase = [
        ("sharded_upfirdn 2/3 31 taps", -1, (2e-5, 2e-5, True),
         lambda: sharded_upfirdn(h31.float(), x_small, 2, 3, mesh=mesh14),
         lambda: upfirdn(h31.float(), x_small, 2, 3)),
        ("sharded_upfirdn 2/3 31 taps complex64", -1, (2e-5, 2e-5, True),
         lambda: sharded_upfirdn(h31.float(), x_c, 2, 3, mesh=mesh14),
         lambda: upfirdn(h31.float(), x_c, 2, 3)),
        ("sharded_resample_poly 1/3", -1, (1e-5, 1e-5, False),
         lambda: sharded_resample_poly(x_small, 1, 3, mesh=mesh14),
         lambda: resample_poly(x_small, 1, 3)),
        ("sharded_pfb_analyze 64 bands tpc 8", -2, (1e-6, 1e-6, True),
         lambda: sharded_pfb_analyze(x_small, 64, mesh=mesh14, taps_per_channel=8),
         lambda: pfb_analyze(x_small, 64, taps_per_channel=8)),
    ]
    for label, axis, (rtol, atol, of_max), sharded_fn, single_fn in polyphase:
        name = f"{label} (1, 4) {small}x{length}"
        run_path(name, {E: 1}, lambda: out.update(y=sharded_fn()))
        y, single = out.pop("y"), single_fn()
        start = b * y.shape[axis]
        stop = min(start + y.shape[axis], single.shape[axis])
        got, want = y.narrow(axis, 0, stop - start), single.narrow(axis, start, stop - start)
        scale = float(single.abs().max())
        limit = (atol * scale if of_max else atol) + rtol * want.abs()
        worst = float(((got - want).abs() / limit).max())
        err = float((got - want).abs().max())
        say(f"{name} vs the single-device call, {'frames' if axis == -2 else 'samples'} "
            f"{start}:{stop}: max|d| = {err:.6g}, max|d| / max = {err / scale:.3g}, dtype "
            f"{y.dtype}; largest |d| / (atol + rtol |want|) = {worst:.3g} (gate 1: rtol "
            f"{rtol:g}, atol {atol:g}{' x max' if of_max else ''})")
        if not (y.dtype == single.dtype and bool(torch.isfinite(y).all()) and worst <= 1):
            raise AssertionError(f"rank {rank}: {name} off the single-device call: "
                                 f"max|d| {err} (max {scale}), {worst} of its gate")
        report["polyphase_rel_err"][label] = err / scale
        del y, single, got, want, limit

    if on_card:  # kernel E, 16 calls back to back with a delayed rank
        rows, pads = small, [(127, 127), (128, 127), (1, 0), (0, 4)]
        gen = torch.Generator(device=dev).manual_seed(200 + rank)
        blocks = [torch.randn((rows, block), generator=gen, device=dev) for _ in range(16)]
        sync()
        dist.barrier()
        got = []
        for i, x_blk in enumerate(blocks):  # no host sync between the calls
            if rank == 1 and i in (0, 8):
                torch.cuda._sleep(100_000_000)  # about 50 ms of rank 1's stream
            got.append(E(x_blk, *pads[i % len(pads)], mesh=mesh14))
        sync()
        for i, (x_blk, ext) in enumerate(zip(blocks, got)):
            hl, hr = pads[i % len(pads)]
            err = bitwise(f"E back to back, call {i}, {rows}x{block} hl={hl} hr={hr}, rank 1 "
                          "delayed, vs send/recv + concat",
                          ext, _halo_extend_torch(x_blk, hl, hr, mesh=mesh14))
            report["e_max_abs_err"] = max(report["e_max_abs_err"], err)
        del blocks, got

    if on_card:  # kernel E's times at the bench geometry
        hl = hr = (num_taps - 1) // 2
        gen = torch.Generator(device=dev).manual_seed(100 + rank)
        x_blk = torch.randn((channels, block), generator=gen, device=dev)
        report["e_geometry"] = dict(c=channels, n=block, hl=hl, hr=hr)
        E(x_blk, hl, hr, mesh=mesh14)
        lib = load_library()
        group, row, bi = block_row(mesh14)
        bufs = cuda_halo._peer_buffers(lib, group, row, bi, channels * hl * 4,
                                       channels * hr * 4, dev)
        ext = torch.empty((channels, hl + block + hr), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        last = bi + 1 == len(row)
        right_left = None if last else bufs.slot(bi + 1, "left", 0)
        left_right = None if bi == 0 else bufs.slot(bi - 1, "right", 0)
        recv_left = None if bi == 0 else bufs.slot(bi, "left", 0)
        recv_right = None if last else bufs.slot(bi, "right", 0)

        def device_part():  # put, interior and edges without the waits and signals
            cuda_halo._put(lib, x_blk, right_left, left_right, hl, hr, stream)
            cuda_halo._interior(lib, x_blk, ext, hl, hr, bi == 0, last, stream)
            cuda_halo._edges(lib, x_blk, ext, recv_left, recv_right, hl, hr, stream)

        sync()
        for turn in range(world):  # one rank at a time on the card
            dist.barrier()
            if turn == rank:
                device_part()
                sync()
                report["e_kernel_ms"] = sorted(_time_ms(device_part) for _ in range(5))[2]
        dist.barrier()

        def together(fn, calls=1, wait=True):
            """Median of 5 of `calls` runs of fn after a barrier, then a sync
            (inside the time where `wait`), per run, host clock."""
            times = []
            for _ in range(5):
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                if wait:
                    sync()
                times.append((time.perf_counter() - t0) * 1e3 / calls)
                sync()
            return sorted(times)[2]

        def exchange():
            return E(x_blk, hl, hr, mesh=mesh14)

        report["e_exchange_ms"] = together(exchange)
        report["e_back_to_back_ms"] = together(exchange, calls=16)
        report["e_host_ms"] = together(exchange, wait=False)
        report["e_plain_ms"] = together(lambda: _halo_extend_torch(x_blk, hl, hr, mesh=mesh14))
        report["e_library_ms"] = together(lambda: (_shift_from_left(x_blk[:, -hl:], mesh14),
                                                   _shift_from_right(x_blk[:, :hr], mesh14)))
        say(f"E put + interior + edges {report['e_kernel_ms']:.3f} ms, exchange "
            f"{report['e_exchange_ms']:.3f} ms, back to back "
            f"{report['e_back_to_back_ms']:.3f} ms, issue {report['e_host_ms']:.3f} ms, "
            f"plain {report['e_plain_ms']:.3f} ms, send/recv {report['e_library_ms']:.3f} ms")
        cuda_halo.close_halo_buffers()

    reports = [None] * world
    dist.all_gather_object(reports, report)
    if rank == 0:
        with open(os.path.join(tmp, "phase8.json"), "w") as f:
            json.dump(reports, f)
    dist.barrier()
    # leave without the gloo teardown: a CPU rank whose work was done died
    # there with SIGABRT under load (tests/torch_sharded_ranks.py:_exit_rank)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _phase9(kernels, launches, dev, channels, length, rate):
    """Phase 9 (see the module docstring); returns the launch counts with
    this phase's paths added."""
    import numpy as np
    import scipy.signal as ss
    import torch

    from nx_signal_tpu_torch.kernels import cuda_dft
    from nx_signal_tpu_torch.ops.convolution import convolve
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.kernels.cuda_dft import _ola_fold_torch
    from nx_signal_tpu_torch.spectral.estimation import coherence, csd, welch
    from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
    from nx_signal_tpu_torch.spectral.spectrogram import spectrogram

    B_fft, B, C = cuda_dft.framed_fft_cuda, cuda_dft.framed_dft_cuda, cuda_dft.overlap_add_cuda
    seg, out = 512, {}

    def add(counts):
        merged = dict(launches)  # phase 8 added kernel E's counts
        for name, n in counts.items():
            merged[name] = merged.get(name, 0) + n
        return merged

    def close_all(name, got, want, rel=1e-4):
        """Gate every value at rel x the global max|want| (one 'bin')."""
        return _check_close(name, got.reshape(-1, 1), want.reshape(-1, 1), rel=rel)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((channels, length), generator=gen, device=dev)
    xh = x[:2].double().cpu().numpy()
    welch_kw = dict(sampling_rate=rate, window="hann", segment_length=seg,
                    overlap_length=seg // 2, detrend="constant")
    scipy_kw = dict(fs=rate, window="hann", nperseg=seg, noverlap=seg // 2, detrend="constant")
    for average in ("mean", "median"):
        def welch_path():
            out["p"] = welch(x, average=average, **welch_kw)[1]
            torch.cuda.synchronize()

        launches = add(_run_path(f"welch average={average!r} {channels}x{length}", kernels,
                                 (B_fft,), welch_path, avoid=(B,)))
        p = out.pop("p")
        if tuple(p.shape) != (channels, seg // 2 + 1) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"welch output {tuple(p.shape)} not finite or wrong shape")
        _, want = ss.welch(xh, average=average, **scipy_kw)
        close_all(f"welch average={average!r} vs f64 scipy.signal.welch (2 channels)",
                  p[:2].double().cpu(), torch.as_tensor(want))
        del p

    # csd and coherence of 64 channels and a filtered (3 taps), delayed (7
    # samples), noisy copy, held against scipy on two channels
    x64 = x[:64]
    gen_y = torch.Generator(device=dev).manual_seed(1)
    y64 = torch.roll(convolve(x64, torch.tensor([[0.5, 0.3, 0.2]], device=dev), mode="same"),
                     7, dims=-1) + 0.5 * torch.randn(x64.shape, generator=gen_y, device=dev)
    yh = y64[:2].double().cpu().numpy()
    pair_kw = {k: v for k, v in welch_kw.items()}

    def csd_coherence():
        out["pxy"] = csd(x64, y64, **pair_kw)[1]
        out["coh"] = coherence(x64, y64, **pair_kw)[1]
        torch.cuda.synchronize()

    launches = add(_run_path(f"csd and coherence 64x{length}", kernels, (B_fft,),
                             csd_coherence, avoid=(B,)))
    pxy, coh = out.pop("pxy"), out.pop("coh")
    for name, got in (("csd", pxy), ("coherence", coh)):
        if tuple(got.shape) != (x64.shape[0], seg // 2 + 1) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} output {tuple(got.shape)} not finite or wrong shape")
    close_all("csd vs f64 scipy.signal.csd (2 channels)", pxy[:2].cpu().to(torch.complex128),
              torch.as_tensor(ss.csd(xh, yh, **scipy_kw)[1]))
    close_all("coherence vs f64 scipy.signal.coherence (2 channels)", coh[:2].double().cpu(),
              torch.as_tensor(ss.coherence(xh, yh, **scipy_kw)[1]))
    del pxy, coh, y64

    xh64 = x64[:2].double().cpu().numpy()

    def spectrogram_path():
        out["s"] = spectrogram(x64, rate, window="hann", window_length=seg,
                               overlap_length=seg - 128)[2]
        torch.cuda.synchronize()

    launches = add(_run_path(f"spectrogram 64x{length}", kernels, (B_fft,), spectrogram_path,
                             avoid=(B,)))
    sxx = out.pop("s")
    n_frames = (length - seg) // 128 + 1
    if tuple(sxx.shape) != (x64.shape[0], seg // 2 + 1, n_frames) or not bool(torch.isfinite(sxx).all()):
        raise AssertionError(f"spectrogram output {tuple(sxx.shape)} not finite or wrong shape")
    _, _, want = ss.spectrogram(xh64, fs=rate, window="hann", nperseg=seg,
                                noverlap=seg - 128, detrend=False)
    close_all("spectrogram vs f64 scipy.signal.spectrogram (2 channels)",
              sxx[:2].double().cpu(), torch.as_tensor(want))
    del sxx

    # ShortTimeFFT: stft (B-fft) then istft (kernel C); the interior of the
    # reconstruction within 1e-5 x max|x|, the spectrum per bin against the
    # f64 torch.fft route on the CPU, and the fold bitwise against C's plain
    # version on the same frames
    hop = 128
    sft = ShortTimeFFT(hann(seg, dtype=torch.float64, device="cpu").numpy(), hop, rate)

    def sft_round_trip():
        out["z"] = sft.stft(x64)
        out["y"] = sft.istft(out["z"], k1=length)
        torch.cuda.synchronize()

    launches = add(_run_path(f"ShortTimeFFT stft -> istft 64x{length}", kernels, (B_fft, C),
                             sft_round_trip, avoid=(B,)))
    z, y = out.pop("z"), out.pop("y")
    if tuple(y.shape) != (x64.shape[0], length) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"ShortTimeFFT.istft output {tuple(y.shape)} not finite or "
                             "wrong shape")
    err = _max_err(y[:, seg:-seg], x64[:, seg:-seg])
    scale = float(x64.abs().max())
    print(f"  ShortTimeFFT interior reconstruction max|d| = {err:.6g} (gate 1e-5 x "
          f"{scale:.6g})", flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"ShortTimeFFT round trip error {err} > 1e-5 x {scale}")
    want_z = sft.stft(x64[:2].double().cpu())
    _check_close("ShortTimeFFT.stft vs the f64 torch.fft route (2 channels)",
                 z[:2].cpu().to(torch.complex128).transpose(-1, -2), want_z.transpose(-1, -2))
    frames = sft._synthesis_frames(z).contiguous()
    full_len = (z.shape[-1] - 1) * hop + seg
    _check_bitwise(f"C on ShortTimeFFT's frames {tuple(frames.shape)}",
                   C(frames, stride=hop, out_length=full_len),
                   _ola_fold_torch(frames, hop, full_len))
    del z, y, frames, x, x64
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


def _phase10(kernels, dev, channels, length):
    """Phase 10 (see the module docstring): the IIR filters on the card,
    each against f64 scipy.signal on 8 channels, timed, with its peak
    memory."""
    import numpy as np
    import scipy.signal as ss
    import torch

    from nx_signal_tpu_torch.ops.iir import filtfilt, lfilter, sosfilt, sosfiltfilt
    from nx_signal_tpu_torch.ops.iir_design import butter, ellip

    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((channels, length), generator=gen, device=dev)
    xh = x[:8].double().cpu().numpy()
    sos_b, sos_e = butter(8, 0.1, output="sos"), ellip(8, 0.5, 60.0, 0.15, output="sos")
    ba2, ba8 = butter(2, 0.1), butter(8, 0.1)
    paths = [  # (name, the port's call, scipy's f64 call on 8 rows, timed)
        ("sosfilt butter(8, 0.1) sos (4 biquads)", lambda: sosfilt(sos_b, x),
         lambda: ss.sosfilt(sos_b, xh), True),
        ("sosfilt ellip(8, 0.5, 60, 0.15) sos (4 biquads)", lambda: sosfilt(sos_e, x),
         lambda: ss.sosfilt(sos_e, xh), True),
        ("lfilter butter(2, 0.1) ba (order 2: chunked)", lambda: lfilter(*ba2, x),
         lambda: ss.lfilter(*ba2, xh), True),
        ("lfilter butter(8, 0.1) ba (order 8: per sample, f64)", lambda: lfilter(*ba8, x),
         lambda: ss.lfilter(*ba8, xh), True),
        ("sosfiltfilt butter(8, 0.1) sos", lambda: sosfiltfilt(sos_b, x),
         lambda: ss.sosfiltfilt(sos_b, xh), False),
        ("filtfilt butter(2, 0.1) ba", lambda: filtfilt(*ba2, x),
         lambda: ss.filtfilt(*ba2, xh), False),
    ]
    card = _gpu_name_and_power_limit()
    bytes_ms = 2 * 4 * channels * length / _peak_bytes() * 1e3
    results = {}
    for name, fn, ref, timed in paths:
        out = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _run_path(f"{name} {channels}x{length}", kernels, (),
                  lambda: out.update(y=fn()) or torch.cuda.synchronize())
        first_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        y = out.pop("y")
        if tuple(y.shape) != (channels, length) or y.dtype != torch.float32 \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: output {tuple(y.shape)} {y.dtype} not finite, not "
                                 "float32 or of the wrong shape")
        got, want = y[:8].double().cpu(), torch.as_tensor(np.ascontiguousarray(ref()))
        err_row = (got - want).abs().amax(dim=-1)
        scale_row = want.abs().amax(dim=-1)
        worst = float((err_row / scale_row).max())
        print(f"  {name}: largest per-row max|d| / max|scipy f64| = {worst:.3g} over 8 rows "
              f"(gate 1e-4)", flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f"{name}: a row is off f64 scipy by {worst} of its max")
        del y, got
        ms = sorted(_time_ms(fn) for _ in range(5))[2] if timed else None
        results[name] = dict(ms=ms, first_s=first_s, peak_gib=peak, rel_err=worst)
        timing = f"{ms:.3f} ms (median of 5, CUDA events)" if timed else \
            f"{first_s * 1e3:.1f} ms once (host clock, with a sync)"
        print(f"  {name} at {channels}x{length} f32: {timing}, peak memory {peak:.3f} GiB "
              f"above the input (torch.cuda.max_memory_allocated); bytes bound of reading x "
              f"and writing y once {bytes_ms:.3f} ms; {card}", flush=True)
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def _phase11(kernels, dev):
    """Phase 11 (see the module docstring): resampling, the polyphase
    filterbank and mixing on the card, each against an f64 oracle on 4
    rows, timed, with its peak memory above the input."""
    import numpy as np
    import scipy.signal as ss
    import torch

    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.mixing import demodulate_channel, mix_down
    from nx_signal_tpu_torch.ops.resample import (
        decimate, pfb_analyze, pfb_footprint_bytes, resample, resample_poly, upfirdn)

    card = _gpu_name_and_power_limit()
    rate, rows = 48000.0, 4

    def randn(seed, shape):
        return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    def host(t):
        return t[:rows].cpu().numpy().astype(np.complex128 if t.is_complex() else np.float64)

    def lo_f64(n, fc):
        """The port's oscillator: its float32 argument (the f32 product of
        the f32 scalar -2 pi fc/fs and an f32 index), exp taken in f64."""
        arg = np.float32(-2.0 * math.pi * (fc / rate)) * np.arange(n, dtype=np.float32)
        return np.exp(1j * arg.astype(np.float64))

    def pfb_f64(xh, m, tpc, proto):
        frames = np.lib.stride_tricks.sliding_window_view(xh, m * tpc, axis=-1)[..., ::m, :]
        blocks = frames.reshape(*frames.shape[:-1], tpc, m)
        return np.fft.fft(np.einsum("...jc,jc->...c", blocks, proto.reshape(tpc, m)), axis=-1)

    def bound_text(flops, nbytes):
        ms, by = _bound(flops, nbytes)
        return f"bound {ms:.3f} ms ({by})"

    results = {}

    def run(label, fn, oracle, *, rel, timed=True, bound=(0.0, 0.0), model=None, note=""):
        """Drive `fn` once (counters zeroed, no kernel may launch), hold its
        first 4 rows per row within rel x the row's max against `oracle()`
        (f64, rows flattened), then time it (median of 5 CUDA-event
        timings, or the checked call on the host clock) and print its peak
        memory above the input."""
        out = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _run_path(label, kernels, (), lambda: out.update(y=fn()) or torch.cuda.synchronize(),
                  avoid=kernels)
        first_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        y = out.pop("y")
        if not bool(torch.isfinite(y.abs()).all()):
            raise AssertionError(f"{label}: output {tuple(y.shape)} not finite")
        got = host(y).reshape(min(rows, y.shape[0]), -1)
        want = np.asarray(oracle()).reshape(got.shape[0], -1)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {got.shape} != the oracle's {want.shape}")
        worst = float((np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max())
        print(f"  {label}: largest per-row max|d| / max|oracle| = {worst:.3g} over "
              f"{got.shape[0]} rows (gate {rel:g}); output {tuple(y.shape)} {y.dtype}",
              flush=True)
        if not worst <= rel:
            raise AssertionError(f"{label}: a row is off its f64 oracle by {worst} of its max")
        del y, got
        ms = sorted(_time_ms(fn) for _ in range(5))[2] if timed else None
        timing = (f"{ms:.3f} ms (median of 5, CUDA events)" if timed else
                  f"{first_s * 1e3:.1f} ms once (host clock, the checked call){note}")
        extra = f", model (pfb_footprint_bytes) {model / 2**30:.3f} GiB" if model else ""
        print(f"  {label}: {timing}, peak memory {peak:.3f} GiB above the input "
              f"(torch.cuda.max_memory_allocated){extra}; {bound_text(*bound)}; {card}",
              flush=True)
        results[label] = dict(ms=ms, first_s=first_s, peak_gib=peak, rel_err=worst)

    # BASELINE.json config 4 at 60 s (scripts/configs_bench.py:74-84): the
    # mixdown and the 48 kHz -> 16 kHz polyphase resample on 64 channels
    n60 = 2_880_000
    x = randn(11, (64, n60))
    xh = host(x)
    out_len = n60 // 3
    run(f"config-4 chain resample_poly(mix_down(x, 8000, 48000).real, 1, 3) 64x{n60}",
        lambda: resample_poly(mix_down(x, 8000.0, rate).real, 1, 3),
        lambda: ss.resample_poly((xh * lo_f64(n60, 8000.0)).real, 1, 3, axis=-1), rel=1e-5,
        bound=(64 * out_len * 61 * 2.0, 4.0 * 64 * (n60 + out_len)))
    h31 = torch.from_numpy(np.random.default_rng(31).normal(size=31).astype(np.float32))
    n_up = -(-((n60 - 1) * 2 + 31) // 3)
    run(f"upfirdn 31 taps, up 2, down 3, float32 64x{n60} ('materialize', C = 2)",
        lambda: upfirdn(h31, x, 2, 3),
        lambda: ss.upfirdn(h31.double().numpy(), xh, 2, 3), rel=1e-5,
        bound=(64 * n_up * 16 * 2.0, 4.0 * 64 * (n60 + n_up)))
    xc = torch.complex(x, x.flip(-1))
    xch = host(xc)
    run(f"upfirdn 31 taps, up 2, down 3, complex64 64x{n60} ('materialize')",
        lambda: upfirdn(h31, xc, 2, 3),
        lambda: ss.upfirdn(h31.double().numpy(), xch, 2, 3), rel=1e-5,
        bound=(64 * n_up * 16 * 4.0, 8.0 * 64 * (n60 + n_up)))
    del xc, xch
    # a frame of more hop blocks than _MATERIALIZE_MAX_BLOCKS: the banded 'conv'
    h2047 = torch.from_numpy(np.random.default_rng(2047).normal(size=2047).astype(np.float32))
    x8 = x[:8]
    run(f"upfirdn 2047 taps, up 1, down 1, float32 8x{n60} ('conv', C = 17)",
        lambda: upfirdn(h2047, x8, 1, 1),
        lambda: ss.fftconvolve(xh, h2047.double().numpy()[None], axes=-1), rel=1e-5,
        bound=(8 * (n60 + 2046) * 2047 * 2.0, 4.0 * 8 * (2 * n60 + 2046)))
    del x8
    taps = firwin(129, [2000.0], sampling_rate=rate, device="cpu").double().numpy()
    run(f"demodulate_channel(x, 12000, 48000, bandwidth=4000, decimation=6) 64x{n60}",
        lambda: demodulate_channel(x, 12000.0, rate, bandwidth=4000.0, decimation=6),
        lambda: ss.resample_poly(xh * lo_f64(n60, 12000.0), 1, 6, window=taps, axis=-1),
        rel=1e-5, bound=(64 * (n60 // 6) * 129 * 4.0, 4.0 * 64 * n60 + 8.0 * 64 * n60 // 6))
    run(f"resample (Fourier) to a third, 64x{n60}", lambda: resample(x, out_len),
        lambda: ss.resample(xh, out_len, axis=-1), rel=1e-5,
        bound=(64 * (5.0 * n60 * math.log2(n60) + 5.0 * out_len * math.log2(out_len)),
               4.0 * 64 * (n60 + out_len)))
    run(f"decimate(x, 3, ftype='fir') 64x{n60}", lambda: decimate(x, 3, ftype="fir"),
        lambda: ss.decimate(xh, 3, ftype="fir", axis=-1), rel=1e-5,
        bound=(64 * out_len * 61 * 2.0, 4.0 * 64 * (n60 + out_len)))
    run(f"decimate(x, 3, ftype='sos') 64x{n60} (cheby1(8) as 4 biquads, sosfiltfilt)",
        lambda: decimate(x, 3, ftype="sos"), lambda: ss.decimate(xh, 3, axis=-1), rel=1e-4,
        bound=(0.0, 4.0 * 64 * (n60 + out_len)))
    del x, xh
    xi = randn(12, (8, 48000))
    run("decimate(x, 3, ftype='iir') 8x48000 (cheby1(8) 'ba' through filtfilt)",
        lambda: decimate(xi, 3), lambda: ss.decimate(host(xi), 3, axis=-1), rel=1e-4,
        timed=False, bound=(0.0, 4.0 * 8 * (48000 + 16000)),
        note="; the port runs order 8 one f64 step per sample, host-bound")
    del xi

    # BASELINE.json config 5 (scripts/configs_bench.py:87-93): the PFB at
    # 8 x 4 194 304, and 1 s of its 100 Msample/s stream at 1024 bands
    n5 = 4_194_304
    xp = randn(13, (8, n5))
    xph = host(xp)
    for m, tpc, strategy, used in ((64, 8, "auto", "factored"), (1024, 8, "auto", "factored"),
                                   (16, 8, "matmul", "matmul")):
        proto = firwin(m * tpc, [1.0 / m], window=("kaiser", 5.0), device="cpu").double().numpy()
        frames = (n5 - m * tpc) // m + 1
        run(f"pfb_analyze {m} bands, tpc {tpc}, strategy={strategy!r} ('{used}') 8x{n5}",
            lambda: pfb_analyze(xp, m, taps_per_channel=tpc, strategy=strategy),
            lambda: pfb_f64(xph, m, tpc, proto), rel=1e-5,
            model=pfb_footprint_bytes(used, 8, n5, m, tpc),
            bound=(8 * frames * (2.0 * m * tpc + 5.0 * m * math.log2(m)),
                   4.0 * 8 * n5 + 8.0 * 8 * frames * m))
    del xp, xph
    n_stream = 100_000_000
    xs = randn(14, (1, n_stream))
    proto = firwin(8192, [1.0 / 1024], window=("kaiser", 5.0), device="cpu").double().numpy()
    frames = (n_stream - 8192) // 1024 + 1
    run(f"pfb_analyze 1024 bands, tpc 8 ('factored') on one stream of {n_stream} samples",
        lambda: pfb_analyze(xs, 1024), lambda: pfb_f64(host(xs), 1024, 8, proto), rel=1e-5,
        model=pfb_footprint_bytes("factored", 1, n_stream, 1024, 8),
        bound=(frames * (2.0 * 8192 + 5.0 * 1024 * 10), 4.0 * n_stream + 8.0 * frames * 1024))
    del xs

    # resample_poly alone at config 4's full size: 10 min at 48 kHz on 64
    # channels (7.4 GB in, 2.5 GB out), its peak reckoned first
    n10 = 28_800_000
    s_in = 4.0 * 64 * n10
    reckoned = (2 + 442 / 384 + 1 / 3) * s_in
    print(f"  resample_poly 1/3 at 64x{n10}: reckoned peak above the input "
          f"{reckoned / 2**30:.1f} GiB (F.pad's extended copy and blocked_frame_matmul's padded "
          f"copy, S = {s_in / 2**30:.2f} GiB each; the frames of 442 samples at stride 384, "
          "442/384 S; the output, S / 3)", flush=True)
    xl = randn(15, (64, n10))
    run(f"resample_poly(x, 1, 3) 64x{n10} (10 min at 48 kHz)", lambda: resample_poly(xl, 1, 3),
        lambda: ss.resample_poly(host(xl), 1, 3, axis=-1), rel=1e-5,
        bound=(64 * (n10 // 3) * 61 * 2.0, 4.0 * 64 * (n10 + n10 // 3)))
    del xl
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def _bits(t):
    """The bit pattern of a float32 or complex64 tensor, as int32."""
    import torch

    t = t.contiguous()
    return (torch.view_as_real(t) if t.is_complex() else t).view(torch.int32)


def _same_bits(name, got, want):
    """Fail unless every chunk of `got` is bitwise the chunk of `want`."""
    import torch

    same = len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
        for g, w in zip(got, want))
    print(f"  {name}: bitwise equal = {same}", flush=True)
    if not same:
        raise AssertionError(f"{name}: not bitwise equal to the uninterrupted run")


def _gate_rows(name, got, want, rel):
    """Gate each row (all leading axes) at rel x that row's max|want|."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs().flatten(0, -2).amax(dim=-1)
    scale = want.abs().flatten(0, -2).amax(dim=-1)
    worst = float((err / scale).max())
    print(f"  {name}: largest per-row max|d| / max|batch| = {worst:.3g} over "
          f"{err.shape[0]} rows (gate {rel:g})", flush=True)
    if not worst <= rel:
        raise AssertionError(f"{name}: a row is off by {worst} of its max")


def _phase12(kernels, dev):
    """Phase 12 (see the module docstring): the streaming processors, the
    wideband receiver, config 5 from a raw capture, the native IO and the
    heartbeat on the card. Returns the launch counts of its paths."""
    import numpy as np
    import scipy.signal as ss
    import torch

    from nx_signal_tpu_torch.io import checkpoint, raw, wav
    from nx_signal_tpu_torch.kernels import cuda_dft
    from nx_signal_tpu_torch.models.pipeline import WidebandReceiver, channelize_power_stream
    from nx_signal_tpu_torch.ops.convolution import convolve
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.iir import sosfilt
    from nx_signal_tpu_torch.ops.iir_design import butter
    from nx_signal_tpu_torch.ops.resample import pfb_analyze, resample_poly
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel import streaming
    from nx_signal_tpu_torch.parallel.failure import heartbeat
    from nx_signal_tpu_torch.spectral.stft import istft, stft

    t_phase = time.perf_counter()
    B_fft, C = cuda_dft.framed_fft_cuda, cuda_dft.overlap_add_cuda
    card = _gpu_name_and_power_limit()
    launches = {k.__name__: 0 for k in kernels}
    out = {}

    def randn(seed, shape):
        return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    def run(proc, state, chunks):
        outs = []
        for c in chunks:
            state, y = proc.process(state, c)
            outs.append(y)
        return state, outs

    def stream_ms(proc, state, chunks):
        """ms per chunk of one streaming run (CUDA events), median of 3."""
        return sorted(_time_ms(lambda: run(proc, state, chunks)) for _ in range(3))[1] / len(
            chunks)

    def main_path(name, proc, state, chunks, expect=(), exact=None):
        """The uninterrupted run, the launch counters zeroed before it and
        read after; returns its chunk outputs."""
        def path():
            out["ys"] = run(proc, state, chunks)[1]
            torch.cuda.synchronize()

        counts = _run_path(name, kernels, expect, path)
        for kernel, n in (exact or {}).items():
            if counts[kernel.__name__] != n:
                raise AssertionError(f"{name}: {kernel.__name__} launched "
                                     f"{counts[kernel.__name__]} times, not {n}")
        for k, n in counts.items():
            launches[k] += n
        return out.pop("ys")

    def resume(name, proc, state, chunks, full, tmp):
        """Half the chunks, save_state, load_state (numpy leaves), the other
        half: the tail bitwise the uninterrupted run's."""
        half = len(chunks) // 2
        mid, _ = run(proc, state, chunks[:half])
        path = os.path.join(tmp, f"{name}.npz")
        checkpoint.save_state(path, mid, meta={"chunk": half})
        restored, meta = checkpoint.load_state(path)
        if meta != {"chunk": half} or not isinstance(restored, np.ndarray):
            raise AssertionError(f"{name}: checkpoint read back {type(restored)}, {meta}")
        _, tail = run(proc, restored, chunks[half:])
        _same_bits(f"{name} resumed from a checkpoint after {half} of {len(chunks)} chunks",
                   tail, full[half:])

    def report(name, proc, state, chunks, batch):
        ms = stream_ms(proc, state, chunks)
        batch_ms = sorted(_time_ms(batch) for _ in range(3))[1]
        print(f"  {name}: {ms:.3f} ms per chunk of {tuple(chunks[0].shape)} ({len(chunks)} "
              f"chunks, {ms * len(chunks):.3f} ms in all), the batch call {batch_ms:.3f} ms "
              f"(medians of 3, CUDA events); {card}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # StreamingFIR and StreamingIIR at 768 x 480000, chunks of 48000
        x = randn(12, (768, 480000))
        chunks = list(x.split(48000, dim=-1))
        taps = firwin(255, [2000.0], sampling_rate=48000.0, device="cpu")
        fir = streaming.StreamingFIR(taps)
        full = main_path("StreamingFIR 768x480000", fir, fir.init_state((768,)), chunks)
        want = convolve(x, taps.to(dev).reshape(1, -1), mode="full")[..., :480000]
        _gate_rows("StreamingFIR vs convolve(x, taps, 'full')[..., :n]", torch.cat(full, -1),
                   want, 1e-5)
        del want
        resume("StreamingFIR", fir, fir.init_state((768,)), chunks, full, tmp)
        del full
        report(
            "StreamingFIR, firwin 255 taps", fir, fir.init_state((768,)), chunks,
            lambda: convolve(x, taps.to(dev).reshape(1, -1), mode="full"))

        sos = butter(8, 0.1, output="sos")
        iir = streaming.StreamingIIR(sos)
        full = main_path("StreamingIIR 768x480000", iir, iir.init_state((768,)), chunks)
        want = sosfilt(sos, x)
        _gate_rows("StreamingIIR vs sosfilt of the whole rows", torch.cat(full, -1), want, 1e-5)
        del want
        resume("StreamingIIR", iir, iir.init_state((768,)), chunks, full, tmp)
        del full
        report("StreamingIIR, butter(8, 0.1) as 4 sections", iir,
                                         iir.init_state((768,)), chunks,
                                         lambda: sosfilt(sos, x))
        del x, chunks

        # StreamingSTFT -> StreamingISTFT at 64 x 480000, chunks of 48000,
        # hann 512, hop 128, the full spectrum
        x = randn(13, (64, 480000))
        chunks = list(x.split(48000, dim=-1))
        w, hop, lead = hann(512, device="cpu"), 128, 512 - 128
        enc, dec = streaming.StreamingSTFT(w, hop=hop), streaming.StreamingISTFT(w, hop=hop)
        zs = main_path("StreamingSTFT 64x480000", enc, enc.init_state((64,)), chunks, (B_fft,),
                       exact={B_fft: len(chunks)})
        xp = torch.nn.functional.pad(x, (lead, 0))
        _check_close("StreamingSTFT vs stft of the zero-prepended signal (per bin)",
                     torch.cat(zs, -2), stft(xp, w.to(dev), fft_length=512, overlap_length=lead,
                                             onesided=False).z)
        resume("StreamingSTFT", enc, enc.init_state((64,)), chunks, zs, tmp)
        ys = main_path("StreamingISTFT 64x480000", dec, dec.init_state((64,)), zs, (C,),
                       exact={C: 2 * len(zs)})
        y = torch.cat(ys, -1)
        err = _max_err(y[:, 512:], xp[:, 512:480000])
        scale = float(x.abs().max())
        print(f"  StreamingISTFT interior reconstruction max|d| = {err:.6g} (gate 1e-5 x "
              f"{scale:.6g})", flush=True)
        if tuple(y.shape) != (64, 480000) or not err <= 1e-5 * scale:
            raise AssertionError(f"StreamingISTFT {tuple(y.shape)}: error {err} > 1e-5 x "
                                 f"{scale}")
        resume("StreamingISTFT", dec, dec.init_state((64,)), zs, ys, tmp)
        del y, ys
        report(
            "StreamingSTFT, hann 512, hop 128 (B-fft once a chunk)", enc, enc.init_state((64,)),
            chunks, lambda: stft(xp, w.to(dev), fft_length=512, overlap_length=lead,
                                 onesided=False))
        z_batch = torch.cat(zs, -2)
        report(
            "StreamingISTFT (C twice a chunk)", dec, dec.init_state((64,)), zs,
            lambda: istft(z_batch, w.to(dev), fft_length=512, overlap_length=lead,
                          onesided=False))
        del x, xp, zs, z_batch, chunks

        # StreamingPFB at 8 x 4194304, chunks of 2^20, 1024 bands, tpc 8
        x = randn(14, (8, 4194304))
        chunks = list(x.split(1 << 20, dim=-1))
        pfb = streaming.StreamingPFB(1024, taps_per_channel=8)
        full = main_path("StreamingPFB 8x4194304", pfb, pfb.init_state((8,)), chunks)
        got = torch.cat(full, -2)[:, pfb.lead_frames:]
        want = pfb_analyze(x, 1024, taps_per_channel=8)
        err, top = _max_err(got, want), float(want.abs().max())
        print(f"  StreamingPFB vs batch pfb_analyze after {pfb.lead_frames} lead frames: max|d| "
              f"= {err:.6g} (gate 1e-5 x {top:.6g})", flush=True)
        if got.shape != want.shape or not err <= 1e-5 * top:
            raise AssertionError(f"StreamingPFB {tuple(got.shape)}: error {err} > 1e-5 x {top}")
        del got, want
        resume("StreamingPFB", pfb, pfb.init_state((8,)), chunks, full, tmp)
        del full
        report(
            "StreamingPFB, 1024 bands, tpc 8", pfb, pfb.init_state((8,)), chunks,
            lambda: pfb_analyze(x, 1024, taps_per_channel=8))
        del x, chunks

        # StreamingResamplePoly 1/3 at 64 x 2880000, chunks of 288000
        x = randn(15, (64, 2880000))
        chunks = list(x.split(288000, dim=-1))
        srp = streaming.StreamingResamplePoly(1, 3)
        full = main_path("StreamingResamplePoly 64x2880000", srp, srp.init_state((64,)), chunks)
        got = torch.cat(full, -1)[:, srp.lead_out:]
        want = resample_poly(x, 1, 3)[:, :got.shape[-1]]
        _gate_rows(f"StreamingResamplePoly vs resample_poly after {srp.lead_out} lead samples",
                   got, want, 1e-5)
        del got, want
        resume("StreamingResamplePoly", srp, srp.init_state((64,)), chunks, full, tmp)
        del full
        report(
            "StreamingResamplePoly 1/3", srp, srp.init_state((64,)), chunks,
            lambda: resample_poly(x, 1, 3))
        del x, chunks
        torch.cuda.empty_cache()

        # BASELINE.json config 5 end to end from a raw capture: a seeded i16
        # capture written with write_raw, read through the native
        # prefetching reader, channelized by channelize_power_stream. Its
        # depth is cut from 24 blocks (scripts/config5_pipeline_r5.py) to 8
        # of 2^24 frames to fit the time limit.
        m, tpc, blocks, block = 1024, 8, 8, 1 << 24
        rng = np.random.default_rng(16)
        cap = rng.uniform(-0.9, 0.9, size=(1, blocks * block)).astype(np.float32)
        path = os.path.join(tmp, "capture.i16")
        raw.write_raw(path, cap, dtype="i16")
        del cap
        if raw._load() is None or wav._native_failed:
            raise AssertionError("the native IO library is not the one loaded")

        def config5():
            with raw.PrefetchingRawReader(path, dtype="i16", channels=1, block_frames=block,
                                          depth_blocks=4) as pf:
                out["p"] = channelize_power_stream(pf, m, taps_per_channel=tpc)
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        _run_path(f"channelize_power_stream, {blocks} blocks of 2^24 i16 frames", kernels, (),
                  config5)
        seconds = time.perf_counter() - t0
        power, frames = out.pop("p")
        decoded = torch.from_numpy(raw.read_raw(path, dtype="i16", channels=1)).to(dev)
        ref = pfb_analyze(torch.nn.functional.pad(decoded, ((tpc - 1) * m, 0)), m,
                          taps_per_channel=tpc)
        ref_p = (ref.real.double() ** 2 + ref.imag.double() ** 2).sum(dim=-2)
        del ref
        err, top = _max_err(power.double(), ref_p), float(ref_p.max())
        print(f"  config 5 power vs batch pfb_analyze of the zero-prepended stream: max|d| = "
              f"{err:.6g} (gate 1e-4 x {top:.6g}), {frames} frames", flush=True)
        if frames != blocks * block // m or not err <= 1e-4 * top:
            raise AssertionError(f"config 5: {frames} frames, error {err} > 1e-4 x {top}")
        proc = streaming.StreamingPFB(m, taps_per_channel=tpc)
        dev_blocks = list(decoded.split(block, dim=-1))

        def compute_only():
            state = proc.init_state((1,))
            acc = torch.zeros((1, m), dtype=torch.float64, device=dev)
            for b in dev_blocks:
                state, z = proc.process(state, b)
                acc += torch.sum(z.real ** 2 + z.imag ** 2, dim=-2, dtype=torch.float64)

        compute_ms = sorted(_time_ms(compute_only) for _ in range(3))[1] / blocks
        t0 = time.perf_counter()
        with raw.PrefetchingRawReader(path, dtype="i16", channels=1, block_frames=block,
                                      depth_blocks=4) as pf:
            read = sum(b.shape[1] for b in pf)
        read_s = time.perf_counter() - t0
        msps = blocks * block / seconds / 1e6
        print(f"  config 5 (depth cut from 24 to {blocks} blocks of 2^24 frames): end to end "
              f"{msps:.1f} Msamples/s ({seconds:.3f} s, host clock, native decode + copy + "
              f"PFB + power); the reader alone {read / read_s / 1e6:.1f} Msamples/s "
              f"({read_s:.3f} s); compute only {compute_ms:.3f} ms per block (median of 3, "
              f"CUDA events, blocks already on the card); {card}", flush=True)
        del decoded, dev_blocks, ref_p

        # WidebandReceiver: 1024 bands, tpc 8, frame 128, hop 64 on 1 x 2^26
        # samples, 4 bands against an f64 numpy evaluation with scipy's
        # prototype and window (a wrong design on the card fails the gate)
        x = randn(17, (1, 1 << 26))
        rx = WidebandReceiver(n_channels=1024, taps_per_channel=8, frame_length=128, hop=64)
        p_rx = rx(x)
        torch.cuda.synchronize()
        rx_ms = sorted(_time_ms(lambda: rx(x)) for _ in range(3))[1]
        xh = x[0].double().cpu().numpy()
        proto = ss.firwin(8192, 1 / 1024, window=("kaiser", 5.0))
        hop_blocks = xh.reshape(-1, 1024)
        nf = hop_blocks.shape[0] - 8 + 1
        summed = sum(proto[j * 1024:(j + 1) * 1024] * hop_blocks[j:j + nf] for j in range(8))
        win = ss.get_window("hann", 128)
        bands = (0, 1, 333, 1023)
        worst = 0.0
        for k in bands:
            sub = summed @ np.exp(-2j * np.pi * k * np.arange(1024) / 1024)
            fr = np.lib.stride_tricks.sliding_window_view(sub, 128)[::64]
            want = np.abs(np.fft.fft(fr * win, axis=-1)) ** 2
            got = p_rx[0, k].double().cpu().numpy()
            if got.shape != want.shape:
                raise AssertionError(f"WidebandReceiver band {k}: {got.shape} != {want.shape}")
            worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
        print(f"  WidebandReceiver 1x2^26, 1024 bands: output {tuple(p_rx.shape)}; bands "
              f"{bands} vs f64 numpy (polyphase sum, DFT, Hann STFT): largest max|d| / band max "
              f"= {worst:.3g} (gate 1e-4); {rx_ms:.3f} ms a call (median of 3, CUDA events); "
              f"{card}", flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f"WidebandReceiver: a band is off by {worst} of its max")
        del x, p_rx, summed, hop_blocks

        # the native IO: 60 s of stereo 44.1 kHz PCM16 (config 3's audio)
        pcm = np.round(rng.uniform(-0.9, 0.9, size=(2, 60 * 44100)) * 32767) / 32767
        pcm = pcm.astype(np.float32)
        wpath = os.path.join(tmp, "audio.wav")
        t0 = time.perf_counter()
        wav.write_wav(wpath, pcm, 44100)
        io_s = {"write": time.perf_counter() - t0}
        t0 = time.perf_counter()
        whole, rate = wav.read_wav(wpath)
        io_s["read"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = np.concatenate(list(wav.stream_wav(wpath, 1 << 16)), axis=1)
        io_s["stream"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with wav.PrefetchingWavReader(wpath, block_frames=1 << 16, depth_blocks=4) as pf:
            prefetched = np.concatenate(list(pf), axis=1)
        io_s["prefetch"] = time.perf_counter() - t0
        if rate != 44100 or not (np.array_equal(whole, streamed)
                                 and np.array_equal(whole, prefetched)):
            raise AssertionError("the WAV reads are not bitwise equal")
        if wav._load() is None or wav._native_failed:
            raise AssertionError("the native IO library is not the one loaded")
        mb = os.path.getsize(wpath) / 1e6
        print("  native IO, 60 s stereo 44.1 kHz PCM16 (" + f"{mb:.1f} MB): " + ", ".join(
            f"{k} {mb / s:.1f} MB/s" for k, s in io_s.items()) + " (host clock); reads "
            f"bitwise equal; library {wav.library_path().name}; {card}", flush=True)

    hb = heartbeat(timeout=30.0)
    print(f"  heartbeat on the card: {hb * 1e3:.3f} ms (deadline 30 s); {card}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"  phase 12: {seconds:.1f} s; {card}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


_PHASE13_SIZES = dict(wave=28_800_000, rows=64, length=480_000, cwt_n=480_000, cwt_widths=128,
                      peaks_n=1 << 22, cwt_peaks_n=1 << 14, czt_rows=768, czt_n=1024,
                      lw_n=1 << 22, spline_rows=768, image=2048, sep_image=4096,
                      route_rows=768, route_log2=(18, 23), check_rows=4)


def _find_peaks_f64(x, *, height, distance, prominence, width):
    """scipy.signal.find_peaks(x, height=, distance=, prominence=, width=)
    in f64 in scipy's order of conditions, its distance filter in plain
    numpy with the JAX package's order among equal heights (the larger
    index first) where scipy's follows its unstable sort; returns (peaks,
    properties) as scipy does."""
    import numpy as np
    import scipy.signal as ss

    peaks, props = ss.find_peaks(x, height=height)
    heights = props["peak_heights"]
    reach = math.ceil(float(np.float32(distance))) - 1
    lo = np.searchsorted(peaks, peaks - reach, side="left")
    hi = np.searchsorted(peaks, peaks + reach, side="right")
    keep = np.ones(peaks.size, dtype=bool)
    for i in np.argsort(heights, kind="stable")[::-1]:
        if keep[i]:
            keep[lo[i]:i] = False
            keep[i + 1:hi[i]] = False
    peaks, props = peaks[keep], {"peak_heights": heights[keep]}
    prom, lb, rb = ss.peak_prominences(x, peaks)
    sel = prom >= prominence
    peaks, props = peaks[sel], {k: v[sel] for k, v in props.items()}
    props.update(prominences=prom[sel], left_bases=lb[sel], right_bases=rb[sel])
    w, wh, lip, rip = ss.peak_widths(x, peaks, rel_height=0.5, prominence_data=(
        props["prominences"], props["left_bases"], props["right_bases"]))
    sel = w >= width
    peaks, props = peaks[sel], {k: v[sel] for k, v in props.items()}
    props.update(widths=w[sel], width_heights=wh[sel], left_ips=lip[sel], right_ips=rip[sel])
    return peaks, props


def _phase13(kernels, dev, sizes=_PHASE13_SIZES):
    """Phase 13 (see the module docstring): waveforms, relative extrema,
    cwt, find_peaks, czt / zoom_fft, lambert_w and the splines on the card,
    each against its f64 oracle, timed by CUDA events (median of 3), and
    the CZT routes timed against each other. No kernel may launch. Returns
    {label: ms} and the CZT route times."""
    import numpy as np
    import scipy.signal as ss
    import scipy.special as ssp
    import torch

    import nx_signal_tpu_torch.ops.czt as czt_mod
    import nx_signal_tpu_torch.ops.find_peaks as fp_mod
    from nx_signal_tpu_torch.ops import splines, waveforms
    from nx_signal_tpu_torch.ops.lambert_w import lambert_w
    from nx_signal_tpu_torch.ops.peak_finding import argrelmax
    from nx_signal_tpu_torch.ops.wavelets import _ricker_np, cwt, ricker

    t_phase = time.perf_counter()
    card = _gpu_name_and_power_limit()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sz = dict(sizes)
    rows = sz["check_rows"]
    times = {}

    def randn(seed, shape, dtype=torch.float32):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def drive(label, fn, timed=True):
        """Drive fn once with the launch counters zeroed (no kernel of A-E
        may launch), then time it: the median of 3 CUDA-event timings."""
        out = {}
        _run_path(label, kernels, (), lambda: out.update(y=fn()) or sync(), avoid=kernels)
        if timed:
            times[label] = sorted(_time_ms(fn) for _ in range(3))[1]
        return out.pop("y")

    def gate_rows(label, got, want, rel):
        """Each row (last axis) within rel x that row's max|want|."""
        got, want = np.atleast_2d(got), np.atleast_2d(want)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {got.shape} != the oracle's {want.shape}")
        worst = float((np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max())
        print(f"  {label}: largest per-row max|d| / max|f64| = {worst:.3g} over "
              f"{got.shape[0]} rows (gate {rel:g}); {times.get(label, float('nan')):.3f} ms "
              f"(median of 3, CUDA events); {card}", flush=True)
        if not worst <= rel:
            raise AssertionError(f"{label}: a row is off its f64 oracle by {worst} of its max")

    def host(t, r=None):
        t = t if r is None else t[:r]
        return t.cpu().numpy().astype(np.complex128 if t.is_complex() else np.float64)

    # ------------------------------------------------------- waveforms
    n = sz["wave"]
    t = torch.arange(n, dtype=torch.float32, device=dev) / 48000.0
    # the oracles start from the card's float32 times and redo the port's
    # float32 ops in numpy in its order; torch divides by a scalar on the
    # card as a product with the scalar's float32 reciprocal
    th = t.cpu().numpy()
    seconds = n / 48000.0
    f0, f1 = 100.0, 8000.0
    y = drive(f"chirp linear {n}", lambda: waveforms.chirp(t, f0, seconds, f1))
    beta = (f1 - f0) / seconds
    arg = np.float32(2.0 * math.pi) * (np.float32(f0) * th + np.float32(0.5 * beta) * th * th)
    gate_rows(f"chirp linear {n}", host(y), np.cos(arg.astype(np.float64)), 1e-5)
    drift = float(np.abs(host(y) - ss.chirp(np.arange(n) / 48000.0, f0, seconds, f1)).max())
    print(f"  chirp linear {n}: drift from the f64 chirp (scipy.signal.chirp of f64 times) "
          f"{drift:.4g} (the f32 phase, kept)", flush=True)
    del arg

    y = drive(f"chirp logarithmic {n}",
              lambda: waveforms.chirp(t, f0, seconds, f1, method="logarithmic"))
    beta = seconds / math.log(f1 / f0)
    scale = np.float32(2.0 * math.pi * beta * f0)
    power = np.power(np.float32(f1 / f0),
                     th * (np.float32(1.0) / np.float32(seconds)) if dev.type == "cuda"
                     else th / np.float32(seconds))
    arg = scale * (power - np.float32(1.0))
    # the card's powf and the host's differ by a few ulps of the power, which
    # the scale carries into the argument: the gate adds 8 ulps of each
    slack = 8.0 * (float(scale) * np.spacing(power).astype(np.float64)
                   + np.spacing(np.abs(arg)).astype(np.float64))
    d = np.abs(host(y) - np.cos(arg.astype(np.float64)))
    worst = float((d / (1e-5 + slack)).max())
    drift = float(np.abs(host(y) - ss.chirp(np.arange(n) / 48000.0, f0, seconds, f1,
                                             method="logarithmic")).max())
    print(f"  chirp logarithmic {n}: max|d| {float(d.max()):.4g}, largest |d| / (1e-5 + 8 ulps "
          f"of the power x scale + 8 ulps of the argument) = {worst:.3g} (gate 1), "
          f"{int((d > 1e-5).sum())} samples past 1e-5; drift from the f64 chirp {drift:.4g}; "
          f"{times[f'chirp logarithmic {n}']:.3f} ms (median of 3, CUDA events); {card}",
          flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"chirp logarithmic: off the f32 argument by {worst} x its slack")
    del arg, power, slack, d

    wt = (2.0 * math.pi * 440.0) * t
    wth = wt.cpu().numpy()
    tmod = np.remainder(wth, np.float32(2.0 * math.pi)).astype(np.float64)
    y = drive(f"sawtooth width 0.3 {n}", lambda: waveforms.sawtooth(wt, width=0.3))
    want = np.where(tmod < 2.0 * math.pi * 0.3, tmod / (math.pi * 0.3) - 1.0,
                    (math.pi * 1.3 - tmod) / (math.pi * 0.7))
    gate_rows(f"sawtooth width 0.3 {n}", host(y), want, 1e-5)
    y = drive(f"square duty 0.3 {n}", lambda: waveforms.square(wt, duty=0.3))
    want = np.where(tmod < 2.0 * math.pi * 0.3, 1, -1)
    edge = tmod == float(np.float32(2.0 * math.pi * 0.3))  # the f32 threshold itself
    wrong = int(((y.cpu().numpy() != want) & ~edge).sum())
    print(f"  square duty 0.3 {n}: {wrong} samples differ from the f64 comparison off the "
          f"f32 threshold ({int(edge.sum())} on it); {times[f'square duty 0.3 {n}']:.3f} ms "
          f"(median of 3, CUDA events); {card}", flush=True)
    if wrong:
        raise AssertionError(f"square: {wrong} samples differ from the f64 comparison")
    del t, wt, y, th, wth, tmod, want, edge

    # ------------------------------------------- relative extrema, cwt
    x = randn(131, (sz["rows"], sz["length"]))
    ext = drive(f"argrelmax order 5 {tuple(x.shape)}", lambda: argrelmax(x, axis=1, order=5))
    count = int(ext.valid_indices)
    found = ext.indices[:count].cpu().numpy()
    want = np.stack(ss.argrelmax(host(x), axis=1, order=5), axis=1)
    same = found.shape == want.shape and bool((found == want).all())
    print(f"  argrelmax order 5 {tuple(x.shape)}: {count} maxima, indices equal to scipy's = "
          f"{same}; {times[f'argrelmax order 5 {tuple(x.shape)}']:.3f} ms (median of 3, CUDA "
          f"events); {card}", flush=True)
    if not same:
        raise AssertionError("argrelmax: not scipy's indices")
    del x, ext

    x = randn(132, (sz["cwt_n"],))
    widths = np.arange(1, sz["cwt_widths"] + 1, dtype=np.float64)
    y = drive(f"cwt ricker widths 1-{widths.size} {sz['cwt_n']}", lambda: cwt(x, ricker, widths))
    xh = host(x)
    check = np.linspace(0, widths.size - 1, 8).astype(int)
    want = np.stack([ss.convolve(xh, np.conj(_ricker_np(min(10 * w, xh.size), w)[::-1]),
                                 mode="same") for w in widths[check]])
    gate_rows(f"cwt ricker widths 1-{widths.size} {sz['cwt_n']}", host(y[check]), want, 1e-4)
    del x, y

    # ------------------------------------------------------ find_peaks
    n = sz["peaks_n"]
    x = torch.cumsum(randn(133, (n,)), 0) + 2.0 * randn(134, (n,))
    xh = host(x)
    kwargs = dict(height=float(np.median(xh)), distance=50, prominence=1.0, width=1.0)
    rounds = []
    build = fp_mod._range_max_tables
    fp_mod._range_max_tables = lambda r: rounds.append(1) or build(r)
    try:
        pk = drive(f"find_peaks {n}", lambda: fp_mod.find_peaks(x, **kwargs), timed=False)
    finally:
        fp_mod._range_max_tables = build
    times[f"find_peaks {n}"] = sorted(_time_ms(lambda: fp_mod.find_peaks(x, **kwargs))
                                      for _ in range(3))[1]
    want, props = _find_peaks_f64(xh, **kwargs)
    scipys = ss.find_peaks(xh, **kwargs)[0]
    count = int(pk.valid_count)
    got = pk.indices[:count].cpu().numpy()
    if got.shape != want.shape or not (got == want).all():
        raise AssertionError(f"find_peaks: {count} peaks, the f64 oracle {want.size}; not its "
                             f"indices ({np.setxor1d(got, want)[:8]})")
    amax, errs = float(np.abs(xh).max()), {}
    for key, w in props.items():
        g = pk.properties[key][:count].cpu().numpy().astype(np.float64)
        if key in ("widths", "left_ips", "right_ips"):  # positions, float32
            errs[key] = float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max())
            bad = errs[key] > 2.0 ** -23
        elif key in ("left_bases", "right_bases"):
            errs[key] = float(np.abs(g - w).max())
            bad = errs[key] != 0
        else:
            errs[key] = float(np.abs(g - w).max()) / amax
            bad = errs[key] > 1e-5
        if bad:
            raise AssertionError(f"find_peaks: {key} off scipy by {errs[key]}")
    print(f"  find_peaks {n} (height, distance 50, prominence, width): {count} peaks, indices "
          f"equal to the f64 oracle's (scipy's own find_peaks breaks equal heights by its "
          f"unstable sort: {np.setxor1d(scipys, want).size} indices differ from it); "
          f"properties off the oracle by " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()) + " (x-valued / max|x|, gate 1e-5; "
          f"positions relative, gate 2^-23; bases exact); distance filter {len(rounds)} "
          f"rounds; {times[f'find_peaks {n}']:.3f} ms (median of 3, CUDA events, its syncs "
          f"included); {card}", flush=True)
    del x, pk

    m = sz["cwt_peaks_n"]
    xs = torch.sin(2 * math.pi * torch.arange(m, device=dev) / 200.0) + 0.3 * randn(135, (m,))
    t0 = time.perf_counter()
    got = fp_mod.find_peaks_cwt(xs, np.arange(1, 17))
    cwt_s = time.perf_counter() - t0
    want = ss.find_peaks_cwt(host(xs), np.arange(1, 17))
    if not np.array_equal(got, want):
        raise AssertionError("find_peaks_cwt: not scipy's indices")
    print(f"  find_peaks_cwt {m}, widths 1-16 (host f64, from a tensor on the card): "
          f"{got.size} peaks, equal to scipy's; {cwt_s * 1e3:.1f} ms once (host clock); {card}",
          flush=True)

    # -------------------------------------------------- czt, zoom_fft
    x = randn(136, (sz["rows"], sz["length"]))
    y = drive(f"zoom_fft {tuple(x.shape)} 1-2 kHz m 8192",
              lambda: czt_mod.zoom_fft(x, [1000.0, 2000.0], 8192, fs=48000.0))
    want = ss.zoom_fft(host(x, rows), [1000.0, 2000.0], 8192, fs=48000.0)
    gate_rows(f"zoom_fft {tuple(x.shape)} 1-2 kHz m 8192", host(y, rows), want, 1e-4)
    # the function builds its host f64 chirp tables on every call; the
    # object keeps them, and its device copies
    plan = czt_mod.ZoomFFT(x.shape[-1], [1000.0, 2000.0], 8192, fs=48000.0)
    y = drive(f"ZoomFFT {tuple(x.shape)} 1-2 kHz m 8192 (tables built once)", lambda: plan(x))
    gate_rows(f"ZoomFFT {tuple(x.shape)} 1-2 kHz m 8192 (tables built once)", host(y, rows),
              want, 1e-4)
    del x, y, plan

    x = randn(137, (sz["czt_rows"], sz["czt_n"]))
    saved = czt_mod._MAX_MATMUL_NM
    try:
        for route, cut in (("matmul", 1 << 62), ("bluestein", 0)):
            czt_mod._MAX_MATMUL_NM = cut
            label = f"czt {tuple(x.shape)} m {sz['czt_n']} ({route}, tables built per call)"
            y = drive(label, lambda: czt_mod.czt(x, sz["czt_n"]))
            gate_rows(label, host(y, rows), ss.czt(host(x, rows), sz["czt_n"]), 1e-4)
        route_ms = {}
        for log2 in range(sz["route_log2"][0], sz["route_log2"][1] + 1):
            side = round(2.0 ** (log2 / 2.0))
            xr = randn(138, (sz["route_rows"], side))
            for route, cut in (("matmul", 1 << 62), ("bluestein", 0)):
                czt_mod._MAX_MATMUL_NM = cut
                plan = czt_mod.CZT(side, side)
                plan(xr)
                route_ms[(side, route)] = sorted(_time_ms(lambda: plan(xr)) for _ in range(5))[2]
            print(f"  czt route at n = m = {side} (n*m ~ 2^{log2}), {sz['route_rows']} rows: "
                  f"matmul {route_ms[(side, 'matmul')]:.3f} ms, Bluestein "
                  f"{route_ms[(side, 'bluestein')]:.3f} ms (median of 5, CUDA events); {card}",
                  flush=True)
    finally:
        czt_mod._MAX_MATMUL_NM = saved
    print(f"  czt's cut _MAX_MATMUL_NM = {saved} (2^{int(math.log2(saved))}): czt "
          f"{sz['czt_rows']} x {sz['czt_n']}, m {sz['czt_n']} takes the "
          f"{'matmul' if sz['czt_n'] ** 2 <= saved else 'Bluestein'} route", flush=True)
    del x, y

    # ------------------------------------------------------- lambert_w
    z = torch.complex(3.0 * randn(139, (sz["lw_n"],), torch.float64),
                      3.0 * randn(140, (sz["lw_n"],), torch.float64))
    zh = host(z)
    for k in (0, -1):
        label = f"lambert_w k={k} {sz['lw_n']}"
        y = drive(label, lambda: lambert_w(z, k))
        want = ssp.lambertw(zh, k)
        d = np.abs(host(y) - want)
        worst = float((d / (1e-13 + 1e-10 * np.abs(want))).max())
        print(f"  {label} complex128: max|d| {float(d.max()):.3g}, largest |d| / (1e-13 + "
              f"1e-10 |scipy|) = {worst:.3g} (gate 1); {times[label]:.3f} ms (median of 3, "
              f"CUDA events); {card}", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"lambert_w k={k}: off scipy.special.lambertw")
    del z, y

    # --------------------------------------------------------- splines
    x = randn(141, (sz["spline_rows"], sz["length"]))
    r, omega = 0.5, 0.3
    for label, fn, oracle in (
            ("cspline1d", lambda: splines.cspline1d(x), lambda row: ss.cspline1d(row)),
            ("symiirorder2 r 0.5 omega 0.3", lambda: splines.symiirorder2(x, r, omega),
             lambda row: ss.symiirorder2(row, r, omega, precision=1e-14))):
        label = f"{label} {tuple(x.shape)}"
        y = drive(label, fn)
        gate_rows(label, host(y, rows), np.stack([oracle(row) for row in host(x, rows)]), 1e-4)
    del x, y
    img = randn(142, (sz["image"], sz["image"]))
    imh = host(img)
    hcol = np.array([1.0, 4.0, 1.0]) / 6.0
    for label, fn, oracle in (
            ("cspline2d", lambda: splines.cspline2d(img),
             lambda: ss.cspline2d(imh, 0.0, precision=1e-14)),
            ("qspline2d", lambda: splines.qspline2d(img),
             lambda: ss.qspline2d(imh, 0.0, precision=1e-14)),
            ("spline_filter lmbda 5", lambda: splines.spline_filter(img),
             lambda: ss.sepfir2d(ss.cspline2d(imh, 5.0, precision=1e-14), hcol, hcol))):
        label = f"{label} {tuple(img.shape)}"
        y = drive(label, fn)
        gate_rows(label, host(y), oracle(), 1e-4)
    del img, y
    img = randn(143, (sz["sep_image"], sz["sep_image"]))
    taps = np.array([1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0]) / 16.0
    label = f"sepfir2d 7 taps {tuple(img.shape)}"
    y = drive(label, lambda: splines.sepfir2d(img, taps, taps))
    gate_rows(label, host(y), ss.sepfir2d(host(img), taps, taps), 1e-4)
    del img, y
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return times, route_ms


_PHASE14_SIZES = dict(dlsim_n=48_000, mimo_n=100_000, lsim_n=48_001, big_log2=28)


def _phase14(kernels, dev, sizes=_PHASE14_SIZES):
    """Phase 14 (see the module docstring): the state-space simulation and
    the LTI classes' responses on the card, each against scipy.signal in
    f64, then the utils (benchmark, timed_median, slope_rate, trace,
    count_nonfinite, assert_all_finite). No kernel of A-E may launch.
    Returns {label: ms}."""
    import shutil

    import numpy as np
    import scipy.signal as ss
    import torch

    from nx_signal_tpu_torch.ops import ltisys
    from nx_signal_tpu_torch.ops.iir_design import butter
    from nx_signal_tpu_torch.utils import checks, profiling

    t_phase = time.perf_counter()
    card = _gpu_name_and_power_limit()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # a numpy signal goes to the card; the CPU rehearsal passes CPU tensors
    # and asks for the CPU where a call has no signal
    signal = (lambda v: v) if on_card else torch.from_numpy
    where = {} if on_card else {"device": "cpu"}
    sz = dict(sizes)
    rng = np.random.default_rng(14)
    times = {}

    def drive(label, fn):
        """Drive fn once with the launch counters zeroed (no kernel of A-E
        may launch), then time it: the median of 3 CUDA-event timings."""
        out = {}
        _run_path(label, kernels, (), lambda: out.update(y=fn()) or sync(), avoid=kernels)
        times[label] = sorted(_time_ms(fn) for _ in range(3))[1]
        return out.pop("y")

    def gate(label, parts, rel, steps=None):
        """Each (name, got, want) of `parts` within rel x max|want|."""
        for name, got, want in parts:
            if got.device.type != dev.type:
                raise AssertionError(f"{label}: {name} on {got.device}, not on {dev}")
            got = got.cpu().numpy().astype(np.float64)
            want = np.asarray(want, dtype=np.float64)
            if got.shape != want.shape:
                raise AssertionError(f"{label}: {name} {got.shape} != scipy's {want.shape}")
            worst = float(np.abs(got - want).max() / np.abs(want).max())
            step = (f", {times[label] / steps * 1e3:.2f} us a step" if steps else "")
            print(f"  {label}: {name} max|d| / max|scipy| = {worst:.3g} (gate {rel:g}); "
                  f"{times[label]:.3f} ms (median of 3, CUDA events){step}; {card}", flush=True)
            if not worst <= rel:
                raise AssertionError(f"{label}: {name} off scipy.signal by {worst} of its max")

    # ---------------------------------------------------------- dlsim
    b8, a8 = butter(8, 0.1)
    sys8 = (*ltisys.tf2ss(b8, a8), 1.0)
    n = sz["dlsim_n"]
    u = rng.standard_normal(n)
    x0 = rng.standard_normal(8)
    label = f"dlsim tf2ss(butter(8, 0.1)), x0 set, {n} f64 samples"
    _, y, x = drive(label, lambda: ltisys.dlsim(sys8, signal(u), x0=x0))
    _, yw, xw = ss.dlsim(sys8, u, x0=x0)
    gate(label, [("y", y, yw), ("x", x, xw)], 1e-9, steps=n)

    m = sz["mimo_n"]
    a4 = rng.standard_normal((4, 4))
    a4 *= 0.95 / np.abs(np.linalg.eigvals(a4)).max()
    mimo = (a4, rng.standard_normal((4, 2)), rng.standard_normal((2, 4)),
            rng.standard_normal((2, 2)), 1.0)
    u2 = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)).to(dev)
    label = f"dlsim MIMO (4 states, 2 in, 2 out), {m} x 2 float32 tensor"
    y = drive(label, lambda: ltisys.dlsim(mimo, u2))[1]
    if y.dtype != torch.float32:
        raise AssertionError(f"{label}: y is {y.dtype}, not float32")
    gate(label, [("y", y, ss.dlsim(mimo, u2.cpu().numpy().astype(np.float64))[1])], 1e-5,
         steps=m)

    # ---------------------------------------------------------- lsim
    bc, ac = butter(4, 2.0 * math.pi * 1000.0, analog=True)
    t = np.linspace(0.0, 1.0, sz["lsim_n"])
    uc = rng.standard_normal(t.shape[0])
    for interp in (True, False):
        label = (f"lsim butter(4, 2 pi 1000, analog=True), interp={interp}, "
                 f"{t.shape[0]} f64 samples")
        _, y, x = drive(label, lambda: ltisys.lsim((bc, ac), signal(uc), t, interp=interp))
        _, yw, xw = ss.lsim((bc, ac), uc, t, interp=interp)
        gate(label, [("y", y, yw), ("x", x, xw)], 1e-9, steps=t.shape[0] - 1)

    # ---------------------------- the responses at their defaults, the classes
    k = t.shape[0] - 1
    for label, fn, oracle in (
            ("impulse butter(4, 2 pi 1000, analog=True), defaults",
             lambda: ltisys.impulse((bc, ac), **where)[1], lambda: ss.impulse((bc, ac))[1]),
            ("step butter(4, 2 pi 1000, analog=True), defaults",
             lambda: ltisys.step((bc, ac), **where)[1], lambda: ss.step((bc, ac))[1]),
            ("dimpulse butter(8, 0.1), defaults",
             lambda: ltisys.dimpulse((b8, a8, 1.0), **where)[1][0],
             lambda: ss.dimpulse((b8, a8, 1.0))[1][0]),
            ("dstep butter(8, 0.1), defaults",
             lambda: ltisys.dstep((b8, a8, 1.0), **where)[1][0],
             lambda: ss.dstep((b8, a8, 1.0))[1][0]),
            (f"lti(butter(4, 2 pi 1000, analog=True)).output, {k} steps",
             lambda: ltisys.lti(bc, ac).output(signal(uc), t)[1],
             lambda: ss.lsim((bc, ac), uc, t)[1]),
            (f"dlti(butter(8, 0.1)).output, {n} steps",
             lambda: ltisys.dlti(b8, a8, dt=1.0).output(signal(u))[1],
             lambda: ss.dlsim((b8, a8, 1.0), u)[1]),
            (f"StateSpace(tf2ss(butter(4, 2 pi 1000, analog=True))).output, {k} steps",
             lambda: ltisys.StateSpace(*ltisys.tf2ss(bc, ac)).output(signal(uc), t)[1],
             lambda: ss.lsim(ss.StateSpace(*ss.tf2ss(bc, ac)), uc, t)[1])):
        gate(label, [("y", drive(label, fn), oracle())], 1e-8)

    # ---------------------------------------------------------- the utils
    bw = profiling.device_hbm_bandwidth(dev)
    big = 1 << sz["big_log2"]
    x = torch.ones(big, device=dev)
    label = f"x * 2.0 on 2^{sz['big_log2']} float32"
    res = {}

    def utils_path():
        res["bench"] = profiling.benchmark(lambda v: v * 2.0, x, iters=10,
                                           samples_per_call=big, min_bytes_per_sample=8.0)
        res["large"] = profiling.timed_median(lambda v: v * 2.0, x)
        res["small"] = profiling.timed_median(lambda v: v * 2.0, x[:big // 2])

    _run_path(label, kernels, (), utils_path, avoid=kernels)
    bench, large, small = res["bench"], res["large"], res["small"]
    tm_fraction = 8.0 * big / large / bw
    rate = profiling.slope_rate(8.0 * (big - big // 2), small, large)
    print(f"  {label}: benchmark {bench} (host clock, 10 calls); timed_median "
          f"{large * 1e3:.4f} ms, {tm_fraction * 100:.1f}% of {bw / 1e12:.2f} TB/s "
          f"(device_hbm_bandwidth); at 2^{sz['big_log2'] - 1} {small * 1e3:.4f} ms; slope_rate "
          f"{rate / 1e12:.3f} TB/s ({rate / bw * 100:.1f}%); {card}", flush=True)
    for name, fraction in (("benchmark", bench.hbm_fraction), ("timed_median", tm_fraction)):
        if not 0.0 < fraction <= 1.05:
            raise AssertionError(f"{label}: {name} reads {fraction * 100:.1f}% of the card's "
                                 "device-memory bandwidth")

    path = tempfile.mkdtemp()
    try:
        with profiling.trace(path):
            x[:1 << 20] * 2.0
            sync()
        with open(os.path.join(path, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(path, ignore_errors=True)
    device_events = [e for e in events if e.get("cat") == "kernel"]
    print(f"  trace: {len(events)} events in the Chrome trace, {len(device_events)} CUDA kernel "
          f"events ({sorted({e['name'] for e in device_events})[:3]})", flush=True)
    if on_card and not device_events:
        raise AssertionError("trace: the Chrome trace holds no CUDA kernel event")

    z = torch.zeros(big, device=dev)
    z[[5, big // 2, big - 1]] = float("inf")
    label = f"count_nonfinite 2^{sz['big_log2']} float32, 3 infs"
    count = drive(label, lambda: checks.count_nonfinite(z))
    print(f"  {label}: {int(count)} ({count.dtype} on {count.device}); {times[label]:.3f} ms "
          f"(median of 3, CUDA events); {card}", flush=True)
    if int(count) != 3 or count.device.type != dev.type or count.dtype != torch.int64:
        raise AssertionError(f"{label}: {count!r}, not 3")
    try:
        checks.assert_all_finite(z, "phase 14")
    except FloatingPointError as exc:
        print(f"  assert_all_finite raised: {exc}", flush=True)
    else:
        raise AssertionError("assert_all_finite did not raise on 3 infs")
    del x, z
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    if on_card:
        torch.cuda.empty_cache()
    return times


def _h2d_copies(fn):
    """(count, bytes) of the host-to-device copies of the second of two
    calls of fn, read from a torch.profiler trace of the card (bytes None
    where the trace gives none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies = [e for e in events if "HtoD" in e.get("name", "")]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    return len(copies), (None if None in sizes else int(sum(sizes)))


def _phase15(kernels, dev):
    """Phase 15 (see the module docstring): the device rule on the card.
    Every entry point given no tensor, called with no device=, builds on
    the card and equals its device='cpu' build; the port's internal host
    paths run on a CUDA signal; the host-to-device copies of three paths'
    second call, with the window or taps built on the CPU and by default.
    Returns {path: (count, bytes)}."""
    import numpy as np
    import torch

    from nx_signal_tpu_torch.kernels import dft
    from nx_signal_tpu_torch.models.pipeline import FIRFilterChain, LogMelFrontend
    from nx_signal_tpu_torch.ops import czt, filters, fir_design, waveforms, wavelets, windows
    from nx_signal_tpu_torch.ops.convolution import oaconvolve
    from nx_signal_tpu_torch.ops.iir_design import butter
    from nx_signal_tpu_torch.ops.mixing import demodulate_channel
    from nx_signal_tpu_torch.ops.resample import decimate, resample_poly
    from nx_signal_tpu_torch.parallel.streaming import StreamingPFB
    from nx_signal_tpu_torch.spectral.mel import _log_mel, mel_filters
    from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
    from nx_signal_tpu_torch.spectral.stft import check_COLA, fft_frequencies, stft

    t_phase = time.perf_counter()
    card = _gpu_name_and_power_limit()
    for kernel in kernels:
        kernel.launches = 0
    rate = 48000.0
    taps = filters.firwin(255, [2000.0], sampling_rate=rate, device="cpu").numpy()
    window = windows.hann(512, device="cpu").numpy()
    ba = butter(4, 0.2)
    sos = butter(8, 0.1, output="sos")
    zpk = butter(4, 0.2, output="zpk")
    w_czt, a_czt = np.exp(-0.002j), np.exp(0.1j)
    # (name, build(**device), gate): 0 is bit for bit (built on the host and
    # moved), else the largest |default - cpu| over max|cpu| (computed on
    # the device: 1e-6 for float32 / complex64, 1e-12 for f64 / complex128;
    # mel_filters 1e-5, its gate against the JAX package, for its float32
    # exp differs by ulps between libraries and its triangles' edges are
    # differences of nearly equal frequencies)
    host, f32, f64 = 0.0, 1e-6, 1e-12
    cases = [
        *[(name, lambda n=name, **kw: getattr(windows, n)(512, **kw), f32)
          for name in ("hann", "hamming", "blackman", "bartlett", "triangular", "triang")],
        *[(name, lambda n=name, **kw: getattr(windows, n)(512, **kw), host)
          for name in ("rectangular", "boxcar", "kaiser", "blackmanharris", "nuttall",
                       "flattop", "bohman", "cosine", "barthann", "parzen", "lanczos", "tukey",
                       "exponential", "taylor", "chebwin")],
        ("general_cosine", lambda **kw: windows.general_cosine(512, [0.5, 0.3, 0.2], **kw),
         host),
        ("general_hamming", lambda **kw: windows.general_hamming(512, 0.6, **kw), host),
        ("gaussian", lambda **kw: windows.gaussian(512, 60.0, **kw), host),
        ("general_gaussian", lambda **kw: windows.general_gaussian(512, 1.5, 60.0, **kw), host),
        ("dpss", lambda **kw: windows.dpss(512, 3.0, 4, **kw), host),
        ("kaiser_bessel_derived", lambda **kw: windows.kaiser_bessel_derived(512, 4.0, **kw),
         host),
        ("get_window hann", lambda **kw: windows.get_window("hann", 512, periodic=True, **kw),
         f32),
        ("get_window kaiser", lambda **kw: windows.get_window(("kaiser", 8.0), 512, **kw),
         host),
        ("firwin", lambda **kw: filters.firwin(255, [2000.0], sampling_rate=rate, **kw), f32),
        ("firwin_2d", lambda **kw: filters.firwin_2d((31, 63), ("hamming", "hann"), fc=0.4,
                                                     **kw), f32),
        ("firwin_2d circular", lambda **kw: filters.firwin_2d((63, 31), "hamming", fc=0.3,
                                                              circular=True, **kw), f32),
        ("savgol_coeffs", lambda **kw: filters.savgol_coeffs(31, 3, **kw), host),
        ("freqz", lambda **kw: filters.freqz(taps, n_freqs=8192, **kw), f64),
        ("freqz iir", lambda **kw: filters.freqz(*ba, n_freqs=8192, whole=True, **kw), f64),
        ("sosfreqz", lambda **kw: filters.sosfreqz(sos, n_freqs=8192, **kw), f64),
        ("freqz_sos", lambda **kw: filters.freqz_sos(sos, n_freqs=8192, **kw), f64),
        ("freqz_zpk", lambda **kw: filters.freqz_zpk(*zpk, n_freqs=8192, **kw), f64),
        ("freqs", lambda **kw: filters.freqs([1.0], [1.0, 2.0, 5.0], 2000, **kw), f64),
        ("freqs_zpk", lambda **kw: filters.freqs_zpk([-0.5], [-1.0 + 2.0j, -1.0 - 2.0j], 3.0,
                                                     2000, **kw), f64),
        ("group_delay", lambda **kw: filters.group_delay([1.0, 0.5], [1.0, -0.4, 0.2],
                                                         n_freqs=8192, **kw), f64),
        ("max_len_seq", lambda **kw: filters.max_len_seq(16, **kw)[0], host),
        ("firwin2", lambda **kw: fir_design.firwin2(255, [0.0, 0.1, 0.2, 1.0],
                                                    [1.0, 1.0, 0.0, 0.0], **kw), host),
        ("firls", lambda **kw: fir_design.firls(255, [0.0, 0.1, 0.2, 1.0],
                                                [1.0, 1.0, 0.0, 0.0], **kw), host),
        ("remez", lambda **kw: fir_design.remez(255, [0.0, 0.04, 0.05, 0.5], [1.0, 0.0],
                                                sampling_rate=1.0, **kw), host),
        ("minimum_phase", lambda **kw: fir_design.minimum_phase(taps, **kw), host),
        ("mel_filters", lambda **kw: mel_filters(512, 80, 16000.0, **kw), 1e-5),
        ("fft_frequencies", lambda **kw: fft_frequencies(16000.0, fft_length=512, **kw), f32),
        ("unit_impulse", lambda **kw: waveforms.unit_impulse((64, 64), index="midpoint", **kw),
         host),
        ("ricker", lambda **kw: wavelets.ricker(1024, 8.0, **kw), host),
        ("morlet", lambda **kw: wavelets.morlet(1024, 6.0, 1.0, **kw), host),
        ("morlet2", lambda **kw: wavelets.morlet2(1024, 8.0, **kw), host),
        ("qmf", lambda **kw: wavelets.qmf(taps, **kw), host),
        ("czt_points", lambda **kw: czt.czt_points(4096, w_czt, a_czt, **kw), host),
        ("CZT.points", lambda **kw: czt.CZT(4096, 1024, w_czt, a_czt).points(**kw), host),
        ("ZoomFFT.points", lambda **kw: czt.ZoomFFT(4096, [0.1, 0.2], 1024).points(**kw),
         host),
        ("_CztPlan.points", lambda **kw: czt._CztPlan(4096, 1024).points(**kw), host),
        ("fir_dft_fold_weights", lambda **kw: dft.fir_dft_fold_weights(taps, window, 512, True,
                                                                        **kw), host),
        ("shared_fold_weights", lambda **kw: dft.shared_fold_weights(taps, 128, 512, **kw),
         host),
        ("shared_twiddles", lambda **kw: dft.shared_twiddles(128, 512, **kw), host),
        ("FIRFilterChain.design", lambda **kw: FIRFilterChain().design(**kw), f32),
    ]
    worst, failed = {}, []
    for name, build, gate in cases:
        got, want = build(), build(device="cpu")
        got = [t for t in (got if isinstance(got, tuple) else (got,))]
        want = [t for t in (want if isinstance(want, tuple) else (want,))]
        for g, w in zip(got, want):
            if g.device.type != "cuda" or w.device.type != "cpu":
                failed.append(f"{name} built on {g.device}, its device='cpu' build on "
                              f"{w.device}")
                continue
            g = g.cpu()
            same = g.dtype == w.dtype and torch.equal(g, w)
            rel = 0.0 if same else float(
                (g.to(torch.complex128) - w.to(torch.complex128)).abs().max()
                / w.to(torch.complex128).abs().max())
            worst[name] = max(worst.get(name, 0.0), rel)
            if not (same if gate == host else rel <= gate):
                failed.append(f"{name} off its device='cpu' build by {rel:.3g} of the max "
                              f"(gate {'bit for bit' if gate == host else gate})")
    print(f"  {len(cases)} entry points given no tensor built on the card, each against its "
          f"device='cpu' build ({sum(1 for _, _, g in cases if g == host)} held bit for bit); "
          f"largest |d| / max per case: "
          + ", ".join(f"{n} {r:.3g}" for n, r in worst.items()), flush=True)

    # the port's internal host paths, on a CUDA signal against a CPU one
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((8, 48000), generator=gen, device=dev)
    xc = x.cpu()

    def hold(name, got, want, rel=1e-5):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        print(f"  {name} on {got.device} vs the CPU: max|d| = {err:.6g}, max = {scale:.6g} "
              f"(gate {rel:g} x max)", flush=True)
        if got.device.type != "cuda" or not err <= rel * scale:
            failed.append(f"{name} on {got.device}: off the CPU by {err}")

    sft = ShortTimeFFT.from_window("hann", rate, 512, 384)
    hold("ShortTimeFFT.from_window('hann').stft", sft.stft(x), sft.stft(xc), 1e-4)
    if not (check_COLA("hann", 512, 384) and check_COLA(("kaiser", 8.0), 512, 256)
            == check_COLA(windows.kaiser(512, beta=8.0, dtype=torch.float64,
                                         device="cpu").numpy(), 512, 256)):
        failed.append("check_COLA of a named window")
    hold("resample_poly(x, 1, 3), default taps", resample_poly(x, 1, 3), resample_poly(xc, 1, 3))
    hold("decimate(x, 3, 'fir')", decimate(x, 3, ftype="fir"), decimate(xc, 3, ftype="fir"))
    demod = dict(bandwidth=4000.0, decimation=6)
    hold("demodulate_channel", demodulate_channel(x, 12000.0, rate, **demod),
         demodulate_channel(xc, 12000.0, rate, **demod))
    pfb = StreamingPFB(1024, taps_per_channel=8)
    chunk = torch.randn((8, 1 << 17), generator=gen, device=dev)
    hold("StreamingPFB(1024), default prototype",
         pfb.process(pfb.init_state((8,)), chunk)[1],
         pfb.process(pfb.init_state((8,), device="cpu"), chunk.cpu())[1])
    del xc

    # host-to-device copies of each path's second call: the window or taps
    # built on the CPU, then by default (on the card)
    x = torch.randn((8, 480000), generator=gen, device=dev)
    kw = dict(sampling_rate=rate, fft_length=512, overlap_length=384)
    logmel = LogMelFrontend()
    mel_kw = dict(sampling_rate=16000.0, fft_length=512, overlap_length=240,
                  window_padding="reflect")
    paths = {
        "stft(x, hann(512, device='cpu'))": lambda: stft(x, windows.hann(512, device="cpu"),
                                                          **kw),
        "stft(x, hann(512))": lambda: stft(x, windows.hann(512), **kw),
        "log-mel, hann(400) and mel_filters on the CPU": lambda: _log_mel(
            stft(x, windows.hann(400, device="cpu"), **mel_kw).z.abs() ** 2,
            mel_filters(512, 80, 16000.0, device="cpu").to(dev), 256),
        "LogMelFrontend()(x)": lambda: logmel(x),
        "oaconvolve(x, firwin taps built on the CPU)": lambda: oaconvolve(
            x, FIRFilterChain().design(device="cpu").to(dev).reshape(1, -1), mode="same"),
        "FIRFilterChain()(x)": lambda: FIRFilterChain()(x),
    }
    copies = {}
    for label, fn in paths.items():
        copies[label] = _h2d_copies(fn)
        print(f"  host-to-device copies on the second call of {label}, 8 x 480000: "
              f"{copies[label][0]}, {copies[label][1]} bytes", flush=True)
    del x, chunk
    labels = list(copies)
    for cpu_built, default in zip(labels[::2], labels[1::2]):
        if copies[default][0] > copies[cpu_built][0]:
            failed.append(f"{default} made more host-to-device copies than {cpu_built}: "
                          f"{copies[default]} against {copies[cpu_built]}")
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    torch.cuda.empty_cache()
    return copies


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
    from nx_signal_tpu_torch.kernels._build import library_path, load_library, ptxas_log_path
    from nx_signal_tpu_torch.kernels.cuda_dft import _ola_fold_torch
    from nx_signal_tpu_torch.kernels.cuda_halo import halo_extend_cuda
    from nx_signal_tpu_torch.kernels.cuda_mel import log_mel_clips_cuda
    from nx_signal_tpu_torch.kernels.dft import (
        _dft_weights, _framed_idft_torch, _framed_matmul_tf32_torch, _framed_matmul_torch,
        _same_pad_left,
        _shared_power_torch, fir_dft_fold_weights, fir_framed_dft, fir_framed_dft_shared,
        framed_dft, framed_idft, recognize_cosine_window, shared_fold_weights, shared_twiddles)
    from nx_signal_tpu_torch.models.pipeline import (
        FIRFilterChain, LogMelFrontend, StftFirChain, WhisperLogMel, stft_fir_chain)
    from nx_signal_tpu_torch.ops import windows
    from nx_signal_tpu_torch.ops.filters import firwin
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.spectral.framing import _ola_fold
    from nx_signal_tpu_torch.spectral.mel import _log_mel, mel_filters
    from nx_signal_tpu_torch.spectral.stft import istft, stft

    A = cuda_dft.fir_framed_dft_power_cuda
    A_tc = cuda_dft.fir_framed_dft_power_tc_cuda
    B_fft = cuda_dft.framed_fft_cuda
    B_ifft = cuda_dft.framed_ifft_cuda
    B = cuda_dft.framed_dft_cuda
    C = cuda_dft.overlap_add_cuda
    D = cuda_dft.fir_framed_dft_power_shared_cuda
    M = log_mel_clips_cuda
    kernels = (A, A_tc, B_fft, B_ifft, B, C, D, M)

    # ---------------------------------------------------------------- 1
    t_build = time.perf_counter()

    def _header(text):
        """A phase's first line, with the seconds since the build began."""
        print(f"{text} [{time.perf_counter() - t_build:.0f} s]", flush=True)

    load_library()
    print(f"phase 1: built {library_path().name} in {time.perf_counter() - t_build:.1f} s",
          flush=True)
    kernels_built, regs, spills, warnings = _ptxas_summary(ptxas_log_path().read_text())
    print(f"  ptxas: {kernels_built} kernels, at most {regs} registers, {spills} bytes of "
          f"spills, {len(warnings)} performance warnings", flush=True)
    for line in warnings:
        print(f"  {line}", flush=True)
    for kernel, uses in sorted(_ptxas_registers(ptxas_log_path().read_text()).items()):
        print(f"  registers of {kernel}: " + ", ".join(
            f"<{args}> {n}" if args else str(n) for args, n in uses), flush=True)
    if spills or not kernels_built:
        raise AssertionError(f"ptxas reports {spills} bytes of spills")

    # ---------------------------------------------------------------- 2
    channels, length, rate = 768, 480000, 48000.0
    num_taps, frame, hop, n_fft = 255, 512, 128, 512
    bins = n_fft // 2 + 1
    num_frames = (length - frame) // hop + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((channels, length), generator=gen, device=dev)
    taps = firwin(num_taps, [2000.0], sampling_rate=rate, device="cpu").numpy()
    window = hann(frame, device="cpu").numpy()
    pad_left = (num_taps - 1) - (num_taps - 1) // 2

    _header("phase 2: kernels against their plain versions")
    w_fold = fir_dft_fold_weights(taps, window, n_fft, True, device=dev)
    args_a = dict(stride=hop, pad_left=pad_left, num_frames=num_frames, bins=bins)
    got = A(x, w_fold, **args_a)
    want = _framed_matmul_torch(x, w_fold, power=True, **args_a)
    err_a = _check_close(f"A {channels}x{length}", got, want)
    del got, want
    # A where 16 frames' window of x does not fit beside its weight ring: a
    # hann frame of 4096 at hop 4096 with the bench taps (311 568 B of 232
    # 448), 64 channels; the kernel streams x through the ring
    frame_l = hop_l = 4096
    frames_l, bins_l = (length - frame_l) // hop_l + 1, frame_l // 2 + 1
    w_fold_l = fir_dft_fold_weights(taps, hann(frame_l, device="cpu").numpy(), frame_l, True,
                                    device=dev)
    args_al = dict(stride=hop_l, pad_left=pad_left, num_frames=frames_l, bins=bins_l)
    err_a_hop = _check_close(f"A 64x{length} frame {frame_l} hop {hop_l} (x streamed)",
                             A(x[:64], w_fold_l, **args_al),
                             _framed_matmul_torch(x[:64], w_fold_l, power=True, **args_al))

    # A-tc ('high': 3xTF32, 'default': one TF32 pass) on the same chain:
    # against its plain version (the same TF32 products summed in f64), 192
    # channels at a time, per bin at 1e-4; on two channels against the f64
    # numpy reference (convolve, frame, window, rfft, |.|^2) per bin, at
    # 1e-4 for 'high' and 1e-2 for 'default' (TF32 keeps ~3 digits)
    xh = x[:2].double().cpu().numpy()
    ref_kw = dict(hop=hop, num_frames=num_frames, n_fft=n_fft)
    ref_y = _numpy_filter(xh, taps.astype(np.float64))
    ref = torch.as_tensor(_numpy_power(ref_y, window.astype(np.float64), **ref_kw))
    ref_y = torch.as_tensor(ref_y)
    err_atc = {}
    for precision, passes, gate in (("high", 3, 1e-4), ("default", 1, 1e-2)):
        got = A_tc(x, w_fold, precision=precision, **args_a)
        err_atc[precision] = _check_close_rows(
            f"A-tc {precision} {channels}x{length} vs its plain version", got,
            lambda rows: _framed_matmul_tf32_torch(x[rows], w_fold, passes=passes, **args_a),
            192)
        _check_close(f"A-tc {precision} vs f64 numpy reference (2 channels)",
                     got[:2].double().cpu(), ref, rel=gate)
        del got

    # B-fft (an FFT per frame: the radix-8 kernel at n_fft 512, the
    # mixed-radix one at 600 and at 572 = 2^2 * 11 * 13, Bluestein's at the
    # prime 1021 and at 1018 = 2 * 509), then past 1024 with a hann frame of
    # n_fft at hop n_fft / 4 and a frame longer than n_fft, and the dense B
    # at the n_fft B-fft does not take (4, and 16400 past its 16384), each
    # against the plain version, complex and power
    x64 = x[:64]

    # the plain version's weights past 1024 (kernels/dft.py:_dft_weights,
    # host f64 numpy, seconds each past 8192) built ahead on host threads
    weight_pool = concurrent.futures.ThreadPoolExecutor(4)
    weight_jobs = {}

    def weights_ahead(wr, fl, nf):
        weight_jobs[(fl, nf)] = weight_pool.submit(_dft_weights, wr, fl, nf, True, np.float32)

    def plain_dft(xr, wr, fl, hp, nf, onesided):
        """The plain framed DFT: its weights and (complex, power)."""
        nb = nf // 2 + 1 if onesided else nf
        job = weight_jobs.pop((fl, nf), None) if onesided else None
        wd = torch.as_tensor(job.result() if job is not None else
                             _dft_weights(wr, fl, nf, onesided, np.float32), device=dev)
        acc = _framed_matmul_torch(xr, wd, stride=hp, pad_left=0,
                                   num_frames=(xr.shape[-1] - fl) // hp + 1, bins=nb, power=False)
        re, im = acc[..., :nb], acc[..., nb:]
        return wd, torch.complex(re, im), re ** 2 + im ** 2

    args_b = dict(stride=hop, num_frames=num_frames, bins=bins)
    fft_kw = dict(stride=hop, n_fft=n_fft, onesided=True)
    w_dft, z_plain, p_plain = plain_dft(x64, window, frame, hop, n_fft, True)
    err_bfft = _check_close(f"B-fft 64x{length} complex", B_fft(x64, window, **fft_kw), z_plain)
    _check_close(f"B-fft 64x{length} power", B_fft(x64, window, output="power", **fft_kw),
                 p_plain)
    del p_plain
    n_mixed = 600
    bins_mixed = n_mixed // 2 + 1
    mixed_kw = dict(stride=hop, n_fft=n_mixed, onesided=True)
    w_mixed, want_z, want_p = plain_dft(x64, window, frame, hop, n_mixed, True)
    err_bfft_600 = _check_close(f"B-fft 64x{length} n_fft={n_mixed} complex",
                                B_fft(x64, window, **mixed_kw), want_z)
    _check_close(f"B-fft 64x{length} n_fft={n_mixed} power",
                 B_fft(x64, window, output="power", **mixed_kw), want_p)
    err_bfft_more = {}
    for nf in (572, 1021, 1018):
        w_nf, want_z, want_p = plain_dft(x64, window, frame, hop, nf, True)
        kw_nf = dict(stride=hop, n_fft=nf, onesided=True)
        err_bfft_more[nf] = _check_close(f"B-fft 64x{length} n_fft={nf} complex",
                                         B_fft(x64, window, **kw_nf), want_z)
        _check_close(f"B-fft 64x{length} n_fft={nf} power",
                     B_fft(x64, window, output="power", **kw_nf), want_p)
        del w_nf, want_z, want_p
    # past 1024: Bluestein at the primes 1031, 4093, 8191 and 12289 (M = 2079
    # and 8192 on the mixed kernel, 16384 and 24640 on it over a cluster of 2
    # CTAs) and at 4094 = 2 * 23 * 89 and 16382 = 2 * 8191 (M = 4096 on the
    # loop kernel, 16384), radix 8 at 2048, 4096, 8192 and 16384 (the
    # loop kernel), the mixed-radix kernel at 12000, at the odd 3375 and 6561
    # and over a cluster of 2 CTAs at 15625; then frames of 2 x n_fft, folded
    # modulo n_fft. The dense B's weights at n_fft 16400 are built ahead too.
    past_1024 = ((1031, 1031, 64), (2048, 2048, 64), (4093, 4093, 64), (4094, 4094, 64),
                 (4096, 4096, 64), (3375, 3375, 64), (6561, 6561, 64), (8191, 8191, 64),
                 (8192, 8192, 64), (12000, 12000, 64), (12289, 12289, 64), (15625, 15625, 64),
                 (16382, 16382, 64), (16384, 16384, 64),
                 (512, 1024, 64), (4096, 8192, 8), (4093, 8186, 8), (8192, 16384, 8))
    for nf, fl, _ in past_1024:
        weights_ahead(hann(fl, device="cpu").numpy(), fl, nf)
    weights_ahead(hann(16400, device="cpu").numpy(), 16400, 16400)
    for nf in _LONG_LENGTHS:
        weights_ahead(window, frame, nf)
    # the plain version's weights that phase 7 times, kept on the card
    plain_weights = {}
    for nf, fl, ch in past_1024:
        xr, wr, hp = x[:ch], hann(fl, device="cpu").numpy(), nf // 4
        w_nf, want_z, want_p = plain_dft(xr, wr, fl, hp, nf, True)
        if fl == nf and nf in _PLAIN_CUT_LENGTHS:
            plain_weights[nf] = w_nf
        del w_nf
        kw_nf = dict(stride=hp, n_fft=nf, onesided=True)
        tag = f"B-fft {ch}x{length} n_fft={nf} frame={fl} hop={hp}"
        err_bfft_more[nf if fl == nf else (nf, fl)] = _check_close(
            f"{tag} complex", B_fft(xr, wr, **kw_nf), want_z)
        _check_close(f"{tag} power", B_fft(xr, wr, output="power", **kw_nf), want_p)
        del want_z, want_p
    # past 16384 (hop n_fft / 4): against the plain version at the hann
    # frame of 512 zero-padded to n_fft, then at a hann frame of n_fft (the
    # plain weights pass 17 GB at 65536) against the f64 torch.fft of the
    # same f32 frames times the same f32 window samples, complex and power
    for nf in _LONG_LENGTHS:
        hp, nb = nf // 4, nf // 2 + 1
        kw_nf = dict(stride=hp, n_fft=nf, onesided=True)
        _, want_z, want_p = plain_dft(x64, window, frame, hp, nf, True)
        tag = f"B-fft 64x{length} n_fft={nf} frame={frame} hop={hp}"
        err_bfft_more[(nf, frame)] = _check_close(f"{tag} complex", B_fft(x64, window, **kw_nf),
                                                  want_z)
        _check_close(f"{tag} power", B_fft(x64, window, output="power", **kw_nf), want_p)
        del want_z, want_p
        wr = hann(nf, device="cpu").numpy()
        want_z = torch.fft.rfft(x64.double().unfold(-1, nf, hp)
                                * torch.as_tensor(wr, dtype=torch.float64, device=dev), n=nf)
        tag = f"B-fft 64x{length} n_fft={nf} frame={nf} hop={hp} vs f64 torch.fft"
        err_bfft_more[nf] = _check_close(f"{tag} complex", B_fft(x64, wr, **kw_nf), want_z)
        _check_close(f"{tag} power", B_fft(x64, wr, output="power", **kw_nf),
                     want_z.real ** 2 + want_z.imag ** 2)
        if want_z.shape[-1] != nb:
            raise AssertionError(f"{tag}: {want_z.shape[-1]} bins, not {nb}")
        del want_z
    # the dense B keeps only what B-fft does not take (an n_fft below 8 or
    # above 65536): n_fft 4 (frame 4, hop 4) on 64 channels; and, called
    # directly, at 16400 (hann frame 16400) on 8 channels at hop 4100 =
    # n_fft / 4, where 16 frames' window of x (360 768 B) does not fit beside
    # its weight stages (232 448 B a CTA): the kernel streams x
    x8 = x[:8]
    n_dense, ch_dense = 16400, 8
    bins_dense, hop_dense = n_dense // 2 + 1, n_dense // 4
    frames_dense = (length - n_dense) // hop_dense + 1
    win_dense = hann(n_dense, device="cpu").numpy()
    args_dense = dict(stride=hop_dense, num_frames=frames_dense, bins=bins_dense)
    w_dense, want_z, want_p = plain_dft(x8, win_dense, n_dense, hop_dense, n_dense, True)
    err_b = _check_close(f"B (dense) {ch_dense}x{length} n_fft={n_dense} complex",
                         B(x8, w_dense, **args_dense), want_z)
    _check_close(f"B (dense) {ch_dense}x{length} n_fft={n_dense} power",
                 B(x8, w_dense, output="power", **args_dense), want_p)
    w4, want_z, want_p = plain_dft(x64, hann(4, device="cpu").numpy(), 4, 4, 4, True)
    args4 = dict(stride=4, num_frames=(length - 4) // 4 + 1, bins=3)
    _check_close(f"B (dense) 64x{length} n_fft=4 complex", B(x64, w4, **args4), want_z)
    _check_close(f"B (dense) 64x{length} n_fft=4 power", B(x64, w4, output="power", **args4),
                 want_p)
    del want_z, want_p, w4
    weight_pool.shutdown()
    fft_ragged = [  # channels, length, frame, hop, n_fft, onesided
        (64, length, frame, hop, n_fft, False),   # the full spectrum
        (2, 20000, 16, 7, 16, True),
        (2, 20001, 12, 5, 16, False),
        (2, 20001, 5, 3, 8, True),
        (3, 30001, 1024, 256, 1024, True),
        # the mixed-radix kernel: Whisper's 400 / 160, odd n_fft (two frames
        # per FFT) with a ragged last pair, hops that do not divide the frame
        (3, 30001, 400, 160, 400, True),
        (3, 30001, 441, 100, 441, False),
        (2, 30002, 300, 147, 441, True),
        (3, 30001, 480, 130, 480, True),
        (2, 30001, 960, 333, 960, False),
        (2, 30001, 1000, 250, 1000, True),
        (2, 20001, 9, 4, 9, True),
        (2, 20001, 10, 3, 10, False),
        # radices 11 and 13, and Bluestein's chirp-z transform: odd (two
        # frames per FFT, M = 2000) and even, short and ragged lengths
        (2, 30001, 900, 333, 997, False),
        (2, 30001, 1500, 300, 1031, True),    # a frame longer than n_fft, odd
        (2, 40001, 3000, 777, 2000, False),   # a frame longer than n_fft, 13-smooth
        (2, 40001, 2047, 500, 4094, True),    # frame < n_fft on Bluestein's M = 4095
        (2, 30001, 1000, 250, 1001, True),
        (3, 20001, 143, 50, 143, True),
        (2, 20001, 17, 5, 17, False),
        (2, 20001, 30, 7, 34, True),
    ]
    for ch, n, fl, hp, nf, onesided in fft_ragged:
        xr = x[:ch, :n]
        wr = hann(fl, device="cpu").numpy()
        _, want_z, want_p = plain_dft(xr, wr, fl, hp, nf, onesided)
        tag = f"B-fft {ch}x{n} frame={fl} hop={hp} n_fft={nf} onesided={onesided}"
        _check_close(tag, B_fft(xr, wr, stride=hp, n_fft=nf, onesided=onesided), want_z)
        _check_close(f"{tag} power", B_fft(xr, wr, stride=hp, n_fft=nf, onesided=onesided,
                                           output="power"), want_p)
        del want_z, want_p

    # framed_idft on the card: kernel B-ifft, against its plain version (the
    # dense weights product) at 1e-5 of the frames' max
    frames = framed_idft(z_plain, window, n_fft=n_fft, onesided=True)
    want_frames = _framed_idft_torch(z_plain, window, n_fft=n_fft, onesided=True)
    err_ifft = _max_err(frames, want_frames)
    top = float(want_frames.abs().max())
    print(f"  B-ifft {tuple(frames.shape)}: max|d| = {err_ifft:.6g} (gate 1e-5 x {top:.6g})",
          flush=True)
    if not err_ifft <= 1e-5 * top:
        raise AssertionError(f"B-ifft error {err_ifft} > 1e-5 x {top}")
    del want_frames
    out_length = num_frames * hop + (frame - hop)
    err_c = _check_bitwise(f"C {tuple(frames.shape)}",
                           C(frames, stride=hop, out_length=out_length),
                           _ola_fold_torch(frames, hop, out_length))
    # complex64 frames: C once per part (spectral.framing._ola_fold), with
    # a complex seed whose real parts hold -0.0, bitwise the plain per-part
    # fold (signed zeros included)
    cframes = torch.complex(frames, frames.flip(-2)).contiguous()
    seed_re = -frames[..., 0, :].abs().repeat(1, out_length // frame + 1)
    seed_re[..., ::7] = -0.0
    cseed = torch.complex(seed_re, frames[..., 1, :].repeat(1, out_length // frame + 1))
    before = C.launches
    got_c = _ola_fold(cframes, hop, out_length, init=cseed)
    if C.launches != before + 2:
        raise AssertionError(f"complex fold launched C {C.launches - before} times, not 2")
    want_c = _ola_fold_torch(cframes, hop, out_length, init=cseed)
    _check_bitwise(f"C on complex64 frames {tuple(cframes.shape)}, seeded (two launches)",
                   torch.view_as_real(got_c), torch.view_as_real(want_c))
    del z_plain, cframes, cseed, got_c, want_c

    ragged = [  # channels, length, taps, frame, hop, n_fft, B onesided
        (4, 48037, 100, 400, 150, 512, True),
        (3, 50001, 64, 1024, 1000, 1024, False),
    ]
    for ch, n, k, fl, hp, nf, onesided in ragged:
        xr = torch.randn((ch, n), generator=gen, device=dev)
        tr = firwin(k, [3000.0], sampling_rate=rate, device="cpu").numpy()
        wr = hann(fl, device="cpu").numpy()
        m = (n - fl) // hp + 1
        tag = f"{ch}x{n} K={k} frame={fl} hop={hp} n_fft={nf}"
        wf = fir_dft_fold_weights(tr, wr, nf, True, device=dev)
        args = dict(stride=hp, pad_left=(k - 1) - (k - 1) // 2, num_frames=m,
                    bins=nf // 2 + 1)
        _check_close(f"A {tag}", A(xr, wf, **args),
                     _framed_matmul_torch(xr, wf, power=True, **args))
        # A-tc where its staged window fits in shared memory; elsewhere
        # 'high' runs the exact kernel A
        if cuda_dft._tc_takes(hp, wf.shape[0]):
            _check_close(f"A-tc high {tag}", A_tc(xr, wf, precision="high", **args),
                         _framed_matmul_tf32_torch(xr, wf, passes=3, **args))
        else:
            before = A.launches
            A(xr, wf, precision="high", **args)
            if A.launches != before + 1:
                raise AssertionError(f"'high' at {tag} did not run kernel A")
            print(f"  A 'high' {tag}: A-tc's window does not fit; kernel A ran", flush=True)
        nb = nf // 2 + 1 if onesided else nf
        wd = torch.as_tensor(_dft_weights(wr, fl, nf, onesided, np.float32), device=dev)
        acc = _framed_matmul_torch(xr, wd, stride=hp, pad_left=0, num_frames=m, bins=nb,
                                   power=False)
        z_want = torch.complex(acc[..., :nb], acc[..., nb:])
        _check_close(f"B {tag} onesided={onesided}",
                     B(xr, wd, stride=hp, num_frames=m, bins=nb), z_want)
        _check_close(f"B-fft {tag} onesided={onesided}",
                     B_fft(xr, wr, stride=hp, n_fft=nf, onesided=onesided), z_want)
        fr = torch.randn((ch, m, fl), generator=gen, device=dev)
        ol = m * hp + (fl - hp)
        _check_bitwise(f"C {tuple(fr.shape)} hop={hp}", C(fr, stride=hp, out_length=ol),
                       _ola_fold_torch(fr, hp, ol))

    # frame_chunks shapes only the plain path: the chain still runs kernel A-tc
    chain_args = dict(fft_length=n_fft, overlap_length=frame - hop, sampling_rate=rate,
                      onesided=True, return_filtered=False, precision="high",
                      frame_chunks=4)
    xs = x[:4, :48000]
    before = A_tc.launches
    got = stft_fir_chain(xs, taps, window, **chain_args)
    if A_tc.launches != before + 1:
        raise AssertionError(f"stft_fir_chain(frame_chunks=4) launched kernel A-tc "
                             f"{A_tc.launches - before} times, not once")
    want = fir_framed_dft(xs, taps, window, stride=hop, n_fft=n_fft, onesided=True,
                          output="power", frame_chunks=4, kernel="torch")
    _check_close("A-tc via stft_fir_chain(frame_chunks=4) vs chunked plain", got, want)
    del got, want

    # D applies the window as its exact cosine sum: A is given the same
    # window, the periodic hann in f64 (the f32 samples of hann(512) differ
    # from it by up to 6e-8, which the low-pass chain's stopband bins see)
    window64 = hann(frame, dtype=torch.float64, device="cpu").numpy()
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
        ((1,), 20000, 17, 34, 374, "hann"),      # 188 bins: the last tile ends on its edge
        ((2,), 20000, 129, 128, 1024, "blackman"),  # 2 neighbour bins, J = 8
    ]
    for batch, n, k, hp, nf, wname in shared_ragged:
        xr = torch.randn((*batch, n), generator=gen, device=dev)
        tr = None if k is None else rng.normal(size=k)
        wr = getattr(windows, wname)(nf, dtype=torch.float64, device="cpu").numpy()
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
    _header("phase 3: stft_fir_chain(return_filtered=False, precision='high')")
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

    launches = _run_path("the fused chain", kernels, (A_tc,), fused_chain)
    power_high = out.pop("power")
    if tuple(power_high.shape) != (channels, num_frames, bins):
        raise AssertionError(f"chain output shape {tuple(power_high.shape)}")
    if not bool(torch.isfinite(power_high).all()):
        raise AssertionError("chain output is not finite")
    _check_close("chain vs f64 numpy reference (2 channels)", power_high[:2].double().cpu(), ref)

    # the chain as a module at 'high': kernel A-tc, once
    def chain_module_high():
        out["power"] = StftFirChain.from_numpy(taps, window, stride=hop, n_fft=n_fft,
                                               precision="high")(x)
        torch.cuda.synchronize()

    counts = _run_path("StftFirChain(precision='high')", kernels, (A_tc,), chain_module_high,
                       avoid=(A,))
    if counts[A_tc.__name__] != 1:
        raise AssertionError(f"StftFirChain(precision='high') launched A-tc "
                             f"{counts[A_tc.__name__]} times, not once")
    launches = {name: launches[name] + counts[name] for name in launches}
    power = out.pop("power")
    _check_close("StftFirChain(precision='high') vs f64 numpy reference (2 channels)",
                 power[:2].double().cpu(), ref)
    print(f"  StftFirChain(precision='high') bitwise the fused chain's 'high' power: "
          f"{torch.equal(power, power_high)}", flush=True)
    del power, power_high

    # the chain as a module keeps exact f32: kernel A
    def chain_module():
        out["power"] = StftFirChain.from_numpy(taps, window, stride=hop, n_fft=n_fft)(x)
        torch.cuda.synchronize()

    counts = _run_path("StftFirChain", kernels, (A,), chain_module)
    launches = {name: launches[name] + counts[name] for name in launches}
    power = out.pop("power")
    if tuple(power.shape) != (channels, num_frames, bins) or not bool(
            torch.isfinite(power).all()):
        raise AssertionError(f"StftFirChain output {tuple(power.shape)} not finite or wrong shape")
    _check_close("StftFirChain vs f64 numpy reference (2 channels)", power[:2].double().cpu(),
                 ref)
    del power

    _header("phase 4: stft -> istft round trip, 64 x 480000")
    win_t = hann(frame, device=dev)

    def round_trip():
        z = stft(x64, win_t, sampling_rate=rate, fft_length=n_fft,
                 overlap_length=frame - hop, onesided=True).z
        out["y"] = istft(z, win_t, fft_length=n_fft, overlap_length=frame - hop,
                         onesided=True, sampling_rate=rate)
        torch.cuda.synchronize()

    counts = _run_path("the round trip", kernels, (B_fft, B_ifft, C), round_trip)
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

    # the two-sided round trip: istft(onesided=False) folds its complex64
    # frames through C once per part and the envelope once (three
    # launches); its fold bitwise the plain per-part fold
    z2 = stft(x64, win_t, sampling_rate=rate, fft_length=n_fft, overlap_length=frame - hop,
              onesided=False).z

    def two_sided():
        out["y"] = istft(z2, win_t, fft_length=n_fft, overlap_length=frame - hop,
                         onesided=False, sampling_rate=rate)
        torch.cuda.synchronize()

    counts = _run_path("istft(onesided=False)", kernels, (C,), two_sided)
    if counts[C.__name__] != 3:
        raise AssertionError(f"istft(onesided=False) launched C {counts[C.__name__]} times, "
                             "not 3 (real part, imaginary part, envelope)")
    launches = {name: launches[name] + counts[name] for name in launches}
    y = out.pop("y")
    if tuple(y.shape) != (64, out_length) or not y.is_complex() or not bool(
            torch.isfinite(torch.view_as_real(y)).all()):
        raise AssertionError(f"two-sided istft output {tuple(y.shape)} {y.dtype} not finite, "
                             "not complex or of the wrong shape")
    err = _max_err(y[:, frame:-frame], x64[:, frame:out_length - frame])
    print(f"  two-sided interior reconstruction max|d| = {err:.6g} (gate 1e-5 x {scale:.6g})",
          flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"two-sided round trip error {err} > 1e-5 x {scale}")
    frames2 = framed_idft(z2, win_t, n_fft=n_fft, onesided=False)
    _check_bitwise(f"the two-sided fold of {tuple(frames2.shape)} complex64 frames",
                   torch.view_as_real(_ola_fold(frames2, hop, out_length)),
                   torch.view_as_real(_ola_fold_torch(frames2, hop, out_length)))
    del y, z2, frames2

    # fft_length 600 = 2^3 * 3 * 5^2: the mixed-radix kernel B-fft, not the
    # dense B
    def stft_600():
        out["z"] = stft(x64, win_t, sampling_rate=rate, fft_length=n_mixed,
                        overlap_length=frame - hop, onesided=True).z
        torch.cuda.synchronize()

    counts = _run_path(f"stft at fft_length {n_mixed}", kernels, (B_fft,), stft_600, avoid=(B,))
    launches = {name: launches[name] + counts[name] for name in launches}
    z = out.pop("z")
    if tuple(z.shape) != (64, num_frames, bins_mixed) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"stft output {tuple(z.shape)} not finite or wrong shape")
    fr = np.lib.stride_tricks.sliding_window_view(xh, frame, axis=-1)[:, ::hop][:, :num_frames]
    _check_close(f"stft at fft_length {n_mixed} vs f64 numpy rfft (2 channels)",
                 z[:2].cpu().to(torch.complex128),
                 torch.as_tensor(np.fft.rfft(fr * window.astype(np.float64), n=n_mixed)))
    del z, fr

    # fft_length 572 = 2^2 * 11 * 13 (B-fft's radices 2, 13, 11) and the
    # prime 1021 (its Bluestein transform): B-fft, not the dense B
    for nf in (572, 1021):
        def stft_nf():
            out["z"] = stft(x64, win_t, sampling_rate=rate, fft_length=nf,
                            overlap_length=frame - hop, onesided=True).z
            torch.cuda.synchronize()

        counts = _run_path(f"stft at fft_length {nf}", kernels, (B_fft,), stft_nf, avoid=(B,))
        launches = {name: launches[name] + counts[name] for name in launches}
        z = out.pop("z")
        if tuple(z.shape) != (64, num_frames, nf // 2 + 1) or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"stft output {tuple(z.shape)} not finite or wrong shape")
        fr = np.lib.stride_tricks.sliding_window_view(xh, frame, axis=-1)[:, ::hop][:, :num_frames]
        _check_close(f"stft at fft_length {nf} vs f64 numpy rfft (2 channels)",
                     z[:2].cpu().to(torch.complex128),
                     torch.as_tensor(np.fft.rfft(fr * window.astype(np.float64), n=nf)))
        del z, fr

    # stft past 1024 through the public function (hann frame of n_fft, hop
    # n_fft / 4): B-fft where the card's cut takes it, torch.fft past it
    # (cuda_dft._auto_takes_kernel; 4093, Bluestein's, is past its class's
    # cut); held on two channels against the f64 numpy rfft; both branches
    # of the route must run
    routes = set()
    for nf in (2048, 4093, 4096):
        win_nf = hann(nf, device=dev)
        on_kernel = cuda_dft._auto_takes_kernel(x64, nf)
        routes.add(on_kernel)

        def stft_past_1024():
            out["z"] = stft(x64, win_nf, sampling_rate=rate, fft_length=nf,
                            overlap_length=nf - nf // 4, onesided=True).z
            torch.cuda.synchronize()

        counts = _run_path(f"stft at fft_length {nf} ({'B-fft' if on_kernel else 'torch.fft'})",
                           kernels, (B_fft,) if on_kernel else (),
                           stft_past_1024, avoid=(B,) if on_kernel else (B, B_fft))
        launches = {name: launches[name] + counts[name] for name in launches}
        z = out.pop("z")
        m_nf = (length - nf) // (nf // 4) + 1
        if tuple(z.shape) != (64, m_nf, nf // 2 + 1) or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"stft output {tuple(z.shape)} not finite or wrong shape")
        fr = np.lib.stride_tricks.sliding_window_view(xh, nf, axis=-1)[:, ::nf // 4][:, :m_nf]
        _check_close(f"stft at fft_length {nf} vs f64 numpy rfft (2 channels)",
                     z[:2].cpu().to(torch.complex128),
                     torch.as_tensor(np.fft.rfft(
                         fr * hann(nf, device="cpu").double().numpy(), n=nf)))
        del z, fr
    if routes != {True, False}:
        raise AssertionError("stft at 2048, 4093 and 4096 drove only one branch of "
                             f"method='auto' (B-fft: {routes})")

    # framed_dft at n_fft 1031 (a prime, once the dense B's), 2048, 4093,
    # 4096, 3375, 6561, 8191, 8192, 12000, 12289, 15625, 16381, 16382 and
    # 16384, past it at 16400, 19683, 20000, 32749,
    # 32768, 65535 and 65536, and at a frame of 1500 > n_fft 1031 (folded
    # modulo n_fft): B-fft, not the dense B; below B-fft's 8 (n_fft 4, frame
    # 4, hop 4): the dense B, not B-fft
    for nf, fl, xr, expect, avoid in ((1031, frame, x64, B_fft, B), (1031, 1500, x64, B_fft, B),
                                      (2048, 2048, x64, B_fft, B), (4093, 4093, x64, B_fft, B),
                                      (4096, 4096, x64, B_fft, B),
                                      *((nf, nf, x64, B_fft, B)
                                        for nf in (3375, 6561, 8191, 8192, 12000, 12289,
                                                   15625, 16381, 16382, 16384, *_LONG_LENGTHS)),
                                      (4, 4, x64, B, B_fft)):
        wr = hann(fl, device="cpu").numpy()
        hp = max(1, nf // 4) if fl == nf else hop
        hp = 4 if nf == 4 else hp

        def framed_path():
            out["z"] = framed_dft(xr, wr, stride=hp, n_fft=nf, onesided=True)
            torch.cuda.synchronize()

        counts = _run_path(f"framed_dft at n_fft {nf}, frame {fl}", kernels, (expect,),
                           framed_path, avoid=(avoid,))
        launches = {name: launches[name] + counts[name] for name in launches}
        z = out.pop("z")
        m_nf = (length - fl) // hp + 1
        if tuple(z.shape) != (xr.shape[0], m_nf, nf // 2 + 1) or not bool(
                torch.isfinite(z).all()):
            raise AssertionError(f"framed_dft output {tuple(z.shape)} not finite or wrong shape")
        fr = np.lib.stride_tricks.sliding_window_view(xh, fl, axis=-1)[:, ::hp][:, :m_nf]
        fr = fr * wr.astype(np.float64)
        if fl > nf:   # the fold modulo n_fft, in f64
            fr = np.pad(fr, ((0, 0), (0, 0), (0, -fl % nf))).reshape(2, m_nf, -1, nf).sum(-2)
        _check_close(f"framed_dft at n_fft {nf}, frame {fl} vs f64 numpy rfft (2 channels)",
                     z[:2].cpu().to(torch.complex128), torch.as_tensor(np.fft.rfft(fr, n=nf)))
        del z, fr

    # stft(method='matmul') past 16384: n_fft 32768 (hann 32768, hop 8192),
    # kernel B-fft (radix 8 over a cluster of 2 CTAs), not the dense B; on
    # two channels against the f64 numpy rfft
    n_long, hop_long = 32768, 8192
    win_long = hann(n_long, device=dev)

    def stft_matmul_long():
        out["z"] = stft(x64, win_long, sampling_rate=rate, fft_length=n_long,
                        overlap_length=n_long - hop_long, onesided=True, method="matmul").z
        torch.cuda.synchronize()

    counts = _run_path(f"stft(method='matmul') at fft_length {n_long}", kernels, (B_fft,),
                       stft_matmul_long, avoid=(B,))
    launches = {name: launches[name] + counts[name] for name in launches}
    z = out.pop("z")
    fr = np.lib.stride_tricks.sliding_window_view(xh, n_long, axis=-1)[:, ::hop_long]
    if tuple(z.shape) != (64, fr.shape[1], n_long // 2 + 1) or not bool(
            torch.isfinite(z).all()):
        raise AssertionError(f"stft output {tuple(z.shape)} not finite or wrong shape")
    _check_close(f"stft(method='matmul') at fft_length {n_long} vs f64 numpy rfft (2 channels)",
                 z[:2].cpu().to(torch.complex128), torch.as_tensor(np.fft.rfft(
                     fr * hann(n_long, device="cpu").double().numpy(), n=n_long)))
    del z, fr

    # Whisper's log-mel front end (frame 400, hop 160, n_fft 400 = 2^4 5^2)
    # on 64 x 30 s at 16 kHz: kernel B-fft, not the dense B
    mel_front = LogMelFrontend(frame_length=400, hop_length=160, fft_length=400)

    def log_mel():
        out["mel"] = mel_front(x64)
        torch.cuda.synchronize()

    counts = _run_path("LogMelFrontend(fft_length=400)", kernels, (B_fft,), log_mel, avoid=(B,))
    launches = {name: launches[name] + counts[name] for name in launches}
    mel = out.pop("mel")
    mel_frames = length // 160 + 1   # reflect padding of 200 on each side
    if tuple(mel.shape) != (64, mel_frames, 80) or not bool(torch.isfinite(mel).all()):
        raise AssertionError(f"log-mel output {tuple(mel.shape)} not finite or wrong shape")
    # the f64 reference on two channels: reflect padding, the frontend's hann
    # samples, rfft, |.|^2, its mel filters, log10 with the 1e-10 clip, the
    # floor max - 8 (white noise stays far above it), (x + 4) / 4; within
    # 1e-5 of the max, the JAX package's own gate for the front end
    frm = np.lib.stride_tricks.sliding_window_view(
        np.pad(xh, ((0, 0), (200, 200)), mode="reflect"), 400, axis=-1)[:, ::160]
    mel_power = np.abs(np.fft.rfft(frm * hann(400, device="cpu").double().numpy(), n=400)) ** 2
    filters = mel_filters(400, 80, 16000.0, device="cpu").double().numpy()
    log_ref = np.log10(np.maximum(mel_power[..., :200] @ filters[:, :200].T, 1e-10))
    log_ref = (np.maximum(log_ref, log_ref.max() - 8.0) + 4.0) / 4.0
    _check_close("LogMelFrontend(fft_length=400) vs f64 numpy log-mel (2 channels)",
                 mel[:2].double().cpu().reshape(-1, 1), torch.as_tensor(log_ref).reshape(-1, 1),
                 rel=1e-5)
    del mel, frm, mel_power

    # Whisper large-v3's front end at the benchmark's call (logmel16k.whisper):
    # WhisperLogMel(128) on 512 clips of 30 s at 16 kHz, gains -40..0 dB;
    # kernel B-fft, then kernel M once, not the dense B. Held against the
    # plain version (the CPU route's power and _log_mel, run on the card) on
    # the same spectrum within 2e-6 of the normalised values (the tests'
    # CARD_TOL: the power's fmaf, the band sum's order, log10's ulps)
    whisper, clips_w = WhisperLogMel(128, device=dev), 512
    x_w = torch.randn((clips_w, length), generator=gen, device=dev)
    x_w *= torch.pow(10.0, -2.0 * torch.rand((clips_w, 1), generator=gen, device=dev))

    def whisper_path():
        out["whisper"] = whisper(x_w)
        torch.cuda.synchronize()

    counts = _run_path(f"WhisperLogMel(128) {clips_w}x{length}", kernels, (B_fft, M),
                       whisper_path, avoid=(B,))
    if counts[M.__name__] != 1:
        raise AssertionError(f"kernel M launched {counts[M.__name__]} times on WhisperLogMel, "
                             "not once")
    launches = {name: launches[name] + counts[name] for name in launches}
    got = out.pop("whisper")
    z_w = stft(x_w, whisper.window, sampling_rate=whisper.sampling_rate,
               fft_length=whisper.n_fft, overlap_length=whisper.n_fft - whisper.hop_length,
               onesided=True, window_padding="reflect").z
    del x_w

    def plain_m(z):
        return _log_mel(z[..., :-1, :].abs() ** 2, whisper.filters, whisper.filters.shape[-1],
                        clips=True)

    want = plain_m(z_w)
    frames_w = z_w.shape[-2] - 1
    if tuple(got.shape) != (clips_w, 128, frames_w) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"WhisperLogMel output {tuple(got.shape)} not finite or wrong shape")
    err_m = _max_err(got, want)
    print(f"  WhisperLogMel(128) {clips_w}x{length} vs the plain version on the same spectrum: "
          f"max|d| = {err_m:.6g} (gate 2e-06); M on that spectrum bitwise the module's = "
          f"{torch.equal(M(z_w, whisper.bands, whisper.band_weights), got)}", flush=True)
    if not err_m <= 2e-6:
        raise AssertionError(f"WhisperLogMel: max|d| {err_m} > 2e-6 against the plain version")
    del got, want

    # ---------------------------------------------------------------- 5
    _header("phase 5: the shared path, fir_framed_dft(kernel='cuda_shared') and "
            "fir_framed_dft_shared")
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
    _header("phase 6: the filtered chain, stft_fir_chain(return_filtered=True), and "
            "FIRFilterChain")
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

    counts = _run_path("the filtered chain", kernels, (B_fft, C), filtered_chain)
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
    fir_taps = fir_chain.design(device="cpu").double().numpy()
    fir_ref = np.stack([np.convolve(c, fir_taps)[(fir_taps.size - 1) // 2:][:length]
                        for c in xh])
    _check_close("FIRFilterChain vs np.convolve 'same' (2 channels)",
                 fir[:2].double().cpu().reshape(-1, 1), torch.as_tensor(fir_ref).reshape(-1, 1))
    del y, power, fir

    # ---------------------------------------------------------------- 7
    _header("phase 7: median of 5 CUDA-event timings, kernel vs plain vs library call")
    import torch.nn.functional as F

    from nx_signal_tpu_torch.kernels.dft import _CHUNK_MEMORY_SHARE as _CHUNK_SHARE
    from nx_signal_tpu_torch.kernels.dft import _exact_f32

    # the library calls (timed here, never called by the port): the conv1d of
    # the folded weights over the hop blocks, as the plain path runs it
    # without its power epilogue (A, and D whose chain it computes)
    def folded_conv(xr, w, hp, frames_r):
        """(cuDNN's conv1d of the folded weights w over the hop-hp blocks of
        xr, exact f32 or TF32; its inputs, kept for `del`)."""
        c_blk = -(-w.shape[0] // hp)
        needed = (frames_r + c_blk - 1) * hp
        blk = F.pad(xr, (pad_left, max(0, needed - pad_left - xr.shape[-1])))[..., :needed]
        blk = blk.reshape(xr.shape[0], -1, hp).transpose(1, 2)
        cw = F.pad(w, (0, 0, 0, c_blk * hp - w.shape[0])).reshape(
            c_blk, hp, w.shape[1]).permute(2, 1, 0).contiguous()

        def conv(tf32=False):
            saved = torch.backends.cudnn.allow_tf32
            try:
                with _exact_f32():
                    torch.backends.cudnn.allow_tf32 = tf32
                    return F.conv1d(blk, cw)
            finally:
                torch.backends.cudnn.allow_tf32 = saved

        return conv, (blk, cw)

    def whisper_torch():
        """openai/whisper's own torch lines (audio.py:log_mel_spectrogram),
        the floor per clip, on the card's spectrum z_w."""
        magnitudes = z_w[..., :-1, :].abs() ** 2
        log_spec = torch.clamp(whisper.filters @ magnitudes.transpose(-1, -2), min=1e-10).log10()
        log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
        return (log_spec + 4.0) / 4.0

    rows_a = w_fold.shape[0]
    conv1d_folded, conv_in = folded_conv(x, w_fold, hop, num_frames)
    conv1d_folded_l, conv_in_l = folded_conv(x[:64], w_fold_l, hop_l, frames_l)

    stft_window = hann(frame, device=dev)
    dense_window = hann(n_dense, device=dev)
    mixed_window = F.pad(stft_window, (0, n_mixed - frame))
    args_mixed = dict(stride=hop, num_frames=num_frames, bins=bins_mixed)

    def fft_case(nf):
        """B-fft at n_fft nf on the phase-2 shape: (bound, [(label, fn)])."""
        nb = nf // 2 + 1
        win_nf = F.pad(stft_window, (0, nf - frame))
        w_nf = torch.as_tensor(_dft_weights(window, frame, nf, True, np.float32), device=dev)
        fns = [("kernel", lambda: B_fft(x64, window, stride=hop, n_fft=nf, onesided=True)),
               ("plain", lambda: torch.complex(*_framed_matmul_torch(
                   x64, w_nf, stride=hop, pad_left=0, num_frames=num_frames, bins=nb,
                   power=False).split(nb, dim=-1)))]
        fns.append(("library", lambda: torch.stft(x64, nf, hop_length=hop, window=win_nf,
                                                  center=False, onesided=True,
                                                  return_complex=True)))
        return (_bound(_fft_route_flops(64, length, 0, frame, num_frames, nf, 0),
                       4.0 * (x64.numel() + frame) + 8.0 * 64 * num_frames * nb), fns)

    def cut_case(nf):
        """At n_fft nf (hann frame nf, hop nf / 4, 64 x 480000): B-fft through
        framed_dft, its plain version, torch.stft(center=False), then the
        public stft with method='matmul' (B-fft) and 'fft' (torch.fft)."""
        nb, hp, win_nf = nf // 2 + 1, nf // 4, hann(nf, device=dev)
        m_nf = (length - nf) // hp + 1
        stft_kw = dict(sampling_rate=rate, fft_length=nf, overlap_length=nf - hp, onesided=True)
        fns = [("kernel", lambda: framed_dft(x64, win_nf, stride=hp, n_fft=nf, onesided=True)),
               ("library", lambda: torch.stft(x64, nf, hop_length=hp, window=win_nf,
                                              center=False, onesided=True, return_complex=True)),
               ("stft matmul", lambda: stft(x64, win_nf, method="matmul", **stft_kw)),
               ("stft fft", lambda: stft(x64, win_nf, method="fft", **stft_kw))]
        if nf in _PLAIN_CUT_LENGTHS:
            w_nf = plain_weights.pop(nf, None)
            if w_nf is None:
                w_nf = torch.as_tensor(_dft_weights(hann(nf, device="cpu").numpy(), nf, nf, True,
                                                    np.float32), device=dev)
            fns.insert(1, ("plain", lambda: torch.complex(*_framed_matmul_torch(
                x64, w_nf, stride=hp, pad_left=0, num_frames=m_nf, bins=nb,
                power=False).split(nb, dim=-1))))
        return (_bound(_fft_route_flops(64, length, 0, nf, m_nf, nf, 0),
                       4.0 * (x64.numel() + nf) + 8.0 * 64 * m_nf * nb), fns)

    fold_in = frames.transpose(1, 2).contiguous()
    # A, A-tc and D compute the same function (the FIR + framed DFT power
    # chain): one bound, for the least work it needs, taps and window read once
    bound_chain = _bound(_fft_route_flops(channels, length, num_taps, frame, num_frames, n_fft,
                                          bins),
                         4.0 * (x.numel() + num_taps + frame + channels * num_frames * bins))
    cases = [  # tag, samples, bound, (label, fn) in turns: kernel, plain, library, more
        ("A", channels * length, bound_chain, [
            ("kernel", lambda: A(x, w_fold, **args_a)),
            ("plain", lambda: _framed_matmul_torch(x, w_fold, power=True, **args_a)),
            ("library", conv1d_folded)]),
        ("A hop 4096", 64 * length,   # x streamed through the weight ring
         _bound(_fft_route_flops(64, length, num_taps, frame_l, frames_l, frame_l, bins_l),
                4.0 * (64 * length + num_taps + frame_l + 64 * frames_l * bins_l)), [
            ("kernel", lambda: A(x[:64], w_fold_l, **args_al)),
            ("plain", lambda: _framed_matmul_torch(x[:64], w_fold_l, power=True, **args_al)),
            ("library", conv1d_folded_l)]),
        ("A-tc", channels * length, bound_chain, [
            ("kernel", lambda: A_tc(x, w_fold, precision="high", **args_a)),
            ("plain", lambda: _framed_matmul_tf32_torch(x, w_fold, passes=3, **args_a)),
            ("library", lambda: conv1d_folded(tf32=True)),
            ("kernel 'default'", lambda: A_tc(x, w_fold, precision="default", **args_a)),
            ("exact library", conv1d_folded)]),
        ("B-fft", 64 * length,
         # the window and a real FFT per frame, a complex64 output
         _bound(_fft_route_flops(64, length, 0, frame, num_frames, n_fft, 0),
                4.0 * (x64.numel() + frame) + 8.0 * 64 * num_frames * bins), [
            ("kernel", lambda: B_fft(x64, window, **fft_kw)),
            ("plain", lambda: torch.complex(*_framed_matmul_torch(
                x64, w_dft, pad_left=0, power=False, **args_b).split(bins, dim=-1))),
            ("library", lambda: torch.stft(x64, n_fft, hop_length=hop, win_length=frame,
                                           window=stft_window, center=False, onesided=True,
                                           return_complex=True))]),
        ("B-fft 600", 64 * length,   # the mixed-radix kernel
         _bound(_fft_route_flops(64, length, 0, frame, num_frames, n_mixed, 0),
                4.0 * (x64.numel() + frame) + 8.0 * 64 * num_frames * bins_mixed), [
            ("kernel", lambda: B_fft(x64, window, **mixed_kw)),
            ("plain", lambda: torch.complex(*_framed_matmul_torch(
                x64, w_mixed, pad_left=0, power=False, **args_mixed).split(bins_mixed, dim=-1))),
            ("library", lambda: torch.stft(x64, n_mixed, hop_length=hop, window=mixed_window,
                                           center=False, onesided=True, return_complex=True))]),
        ("B-fft 572", 64 * length, *fft_case(572)),    # radices 2, 13, 11
        ("B-fft 1021", 64 * length, *fft_case(1021)),  # Bluestein, M = 2048
        ("B-fft 1018", 64 * length, *fft_case(1018)),  # Bluestein, M = 1024
        # the card's FFT cut: a hann frame of n_fft at hop n_fft / 4
        *((f"cut {nf}", 64 * length, *cut_case(nf)) for nf in _CUT_LENGTHS),
        ("B", ch_dense * length,   # called directly at 16400, hop 4100: x streamed
         _bound(_fft_route_flops(ch_dense, length, 0, n_dense, frames_dense, n_dense, 0),
                4.0 * (x8.numel() + n_dense) + 8.0 * ch_dense * frames_dense * bins_dense), [
            ("kernel", lambda: B(x8, w_dense, **args_dense)),
            ("plain", lambda: torch.complex(*_framed_matmul_torch(
                x8, w_dense, pad_left=0, power=False, **args_dense).split(bins_dense, dim=-1))),
            ("library", lambda: torch.stft(x8, n_dense, hop_length=hop_dense,
                                           window=dense_window, center=False, onesided=True,
                                           return_complex=True))]),
        ("C", 64 * out_length,
         _bound(1.0 * frames.numel(), 4.0 * (frames.numel() + 64 * out_length)), [
            ("kernel", lambda: C(frames, stride=hop, out_length=out_length)),
            ("plain", lambda: _ola_fold_torch(frames, hop, out_length)),
            ("library", lambda: F.fold(fold_in, output_size=(1, out_length),
                                       kernel_size=(1, frame), stride=(1, hop)))]),
        ("D", channels * length, bound_chain, [
            ("kernel", lambda: D(x, w_shared, tw_shared, coeffs, **args_d)),
            ("plain", lambda: _shared_power_torch(x, w_shared, tw_shared, coeffs, **args_d)),
            ("library", conv1d_folded)]),
        # M at the Whisper call: its bound reads the frames of z it needs and
        # writes the log-mel once each (its floor's second pass over the
        # log-mel is its design's, not the function's); operations: the
        # power (3 a bin), the band sums (2 a nonzero), log10, the floor and
        # the scaling (4 a value)
        ("M", clips_w * length,
         _bound(clips_w * frames_w * (3.0 * z_w.shape[-1] + 2.0 * whisper.band_weights.numel()
                                      + 4.0 * 128),
                8.0 * clips_w * frames_w * z_w.shape[-1] + 4.0 * clips_w * 128 * frames_w), [
            ("kernel", lambda: M(z_w, whisper.bands, whisper.band_weights)),
            ("plain", lambda: plain_m(z_w)),
            ("library", whisper_torch)]),
    ]
    timings = {}
    for tag, samples, bound, fns in cases:
        for _, fn in fns:  # warm up, the caching allocator too: a second
            kept = fn()    # call while the first one's result is alive
            fn()
            del kept
        torch.cuda.synchronize()
        times = {label: [] for label, _ in fns}
        for _ in range(5):  # in turns: kernel, plain, library, ..., kernel, ...
            for label, fn in fns:
                times[label].append(_time_ms(fn))
        timings[tag] = {label: sorted(t)[2] for label, t in times.items()}
        timings[tag].update(bound_ms=bound[0], bound_by=bound[1])
        k_ms = timings[tag]["kernel"]
        print(f"  {tag}: kernel {k_ms:.3f} ms ({samples / k_ms / 1e3:.1f} Msamples/s), "
              + ", ".join(f"{label} {timings[tag][label]:.3f} ms" for label, _ in fns[1:])
              + f", bound {bound[0]:.3f} ms ({bound[1]})", flush=True)
    # the card's FFT cut: the largest timed n_fft up to which B-fft (through
    # framed_dft, and stft's 'matmul' route) is no slower than torch.stft
    # (and stft's 'fft' route) at every timed length, over every timed
    # length and within each length class (the kernels each runs: powers of
    # two, other 13-smooth lengths, Bluestein's), the port's cuts
    # (cuda_dft._card_takes_kernel) beside
    def cut_of(lengths):
        for i, nf in enumerate(lengths):
            t = timings[f"cut {nf}"]
            if t["kernel"] > t["library"]:
                return max([1024, *lengths[:i]])
        return max([1024, *lengths])

    for nf in _CUT_LENGTHS:
        t = timings[f"cut {nf}"]
        print(f"  cut at n_fft {nf}: B-fft / torch.stft = {t['kernel'] / t['library']:.3f}, "
              f"stft 'matmul' / 'fft' = {t['stft matmul'] / t['stft fft']:.3f}", flush=True)
    pow2 = [nf for nf in _CUT_LENGTHS if nf & (nf - 1) == 0]
    smooth = [nf for nf in _CUT_LENGTHS if cuda_dft._thirteen_smooth(nf) and nf not in pow2]
    blue = [nf for nf in _CUT_LENGTHS if not cuda_dft._thirteen_smooth(nf)]
    print(f"  the cut these times put: n_fft <= {cut_of(_CUT_LENGTHS)} over every timed length; "
          f"by class, a power of two <= {cut_of(pow2)} (the port's _CARD_FFT_CUT is "
          f"{cuda_dft._CARD_FFT_CUT}), another 13-smooth n_fft <= {cut_of(smooth)} (the port's "
          f"_CARD_SMOOTH_CUT is {cuda_dft._CARD_SMOOTH_CUT}), Bluestein's <= {cut_of(blue)} "
          f"(the port's _CARD_BLUESTEIN_CUT is {cuda_dft._CARD_BLUESTEIN_CUT})", flush=True)
    # A-tc's own floor: the dense route's TF32 products at the 495 TFLOP/s peak
    tc_flops = 2.0 * channels * num_frames * rows_a * 2 * bins
    print(f"  A-tc's route at the TF32 peak: 'high' {3 * tc_flops / 495e9:.3f} ms, "
          f"'default' {tc_flops / 495e9:.3f} ms", flush=True)
    # D's own floor: stage A (each hop block's partial DFT once) at the f32
    # peak; the CTAs an SM holds at this geometry (the occupancy calculator)
    rows_d, j_d = w_shared.shape[0], n_fft // hop
    d_route_ms = (2.0 * channels * (num_frames + j_d - 1) * rows_d * 2 * bins
                  / _PEAK_F32_FLOPS * 1e3)
    ctas = ctypes.c_int64(0)
    cuda_dft._check(load_library(), load_library().nx_shared_dft_ctas_per_sm(
        hop, -(-rows_d // cuda_dft._D_SUM_ROWS) * cuda_dft._D_SUM_ROWS, j_d,
        ctypes.byref(ctas)), "shared_dft occupancy query")
    print(f"  D's route (stage A) at the f32 peak: {d_route_ms:.3f} ms; D holds "
          f"{ctas.value} CTAs per SM at this geometry", flush=True)
    if ctas.value < 2:
        raise AssertionError(f"kernel D holds {ctas.value} CTAs per SM at the bench chain, "
                             "not 2")

    # the shared path's set-up on its own (host clock, synchronised): the
    # host fold of the weights and the twiddle table (numpy f64, copied to
    # the card), then kernel D's layout of both (two gathers on the card)
    def shared_fold():
        out["fold"] = (shared_fold_weights(taps, hop, n_fft, device=dev),
                       shared_twiddles(hop, n_fft, device=dev))
        torch.cuda.synchronize()

    def shared_layout():
        cuda_dft._d_weights(out["fold"][0], bins, len(coeffs) - 1)
        cuda_dft._d_twiddles(out["fold"][1], bins, len(coeffs) - 1)
        torch.cuda.synchronize()

    setup_ms = {}
    for name, fn in (("fold", shared_fold), ("layout", shared_layout)):
        fn()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        setup_ms[name] = sorted(times)[2]
    out.pop("fold")
    print(f"  the shared path's set-up per call (host clock): fold + twiddles "
          f"{setup_ms['fold']:.3f} ms, D's layout {setup_ms['layout']:.3f} ms", flush=True)
    del conv_in, conv_in_l, fold_in

    # where the filtered chain's time goes: the direct FIR, then kernel B-fft
    from nx_signal_tpu_torch.ops.convolution import convolve

    taps_t = torch.as_tensor(taps, device=dev).reshape(1, -1)
    y = convolve(x, taps_t, mode="same")
    stages = [("FIR (convolve 'same', cuDNN conv1d)", lambda: convolve(x, taps_t, mode="same")),
              ("framed_dft power (kernel B-fft)",
               lambda: framed_dft(y, window, stride=hop, n_fft=n_fft, onesided=True,
                                  output="power"))]
    for name, fn in stages:
        fn()
        torch.cuda.synchronize()
        print(f"  filtered chain at {channels}x{length}, {name}: "
              f"{sorted(_time_ms(fn) for _ in range(5))[2]:.3f} ms", flush=True)
    del y

    # the fused chain's own cut: at n_fft 2048 (hann 2048, hop 512, the bench
    # chain's 255 taps, 64 channels) the fold at 'high' (A-tc, or A where
    # A-tc's window does not fit) against the FIR then B-fft's power, in turns
    win_2048 = hann(2048, device="cpu").numpy()
    chain_fns = [
        ("the fold at 'high'", lambda: fir_framed_dft(
            x64, taps, win_2048, stride=512, n_fft=2048, onesided=True, output="power",
            precision="high")),
        ("FIR then framed_dft power", lambda: framed_dft(
            convolve(x64, taps_t, mode="same"), win_2048, stride=512, n_fft=2048,
            onesided=True, output="power"))]
    counts = _run_path("the fold at n_fft 2048", kernels, (), chain_fns[0][1])
    fold_kernel = "A-tc" if counts[A_tc.__name__] else "A"
    for _, fn in chain_fns:
        fn()
    torch.cuda.synchronize()
    chain_times = {name: [] for name, _ in chain_fns}
    for _ in range(5):
        for name, fn in chain_fns:
            chain_times[name].append(_time_ms(fn))
    for name, t in chain_times.items():
        print(f"  fused chain's cut, 64x{length} n_fft 2048: {name} {sorted(t)[2]:.3f} ms"
              + (f" (kernel {fold_kernel})" if name.startswith("the fold") else ""), flush=True)

    # frame_chunks='auto' on the plain power path (kernel='torch') of the
    # bench chain at 768 x 480000: the plan at the card's budget, its peak
    # memory above what was allocated before the call; then a budget a
    # third of the plan's unchunked model, forcing k > 1, held per bin at
    # 1e-4 against the unchunked output
    from nx_signal_tpu_torch.kernels.dft import _auto_frame_chunks, _memory_budget

    plan_args = (channels, num_frames, 2 * bins, x.numel())
    plan_cols = 2 * bins   # the plan's model of the unchunked path (kernels/dft.py)
    model = (8.0 * x.numel() + 4.0 * channels * num_frames * (plan_cols // 2 + 1)
             + 1.15 * 4.0 * channels * num_frames * plan_cols)
    budget = _memory_budget(dev)
    k_card = _auto_frame_chunks(*plan_args, budget)
    k_small = _auto_frame_chunks(*plan_args, model / 3)
    chunk_kw = dict(stride=hop, n_fft=n_fft, onesided=True, output="power", kernel="torch")
    peaks = {}
    for k in ("auto", k_small):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out[k] = fir_framed_dft(x, taps, window, frame_chunks=k, **chunk_kw)
        torch.cuda.synchronize()
        peaks[k] = torch.cuda.max_memory_allocated(dev) - base
    print(f"  frame_chunks='auto' at {channels}x{length}: budget {budget / 2 ** 30:.2f} GiB "
          f"(free x {_CHUNK_SHARE}), plan {k_card}, the plan's unchunked model "
          f"{model / 2 ** 30:.2f} GiB, peak above the inputs {peaks['auto'] / 2 ** 30:.2f} GiB "
          f"({peaks['auto'] / model:.2f} x the model)", flush=True)
    if k_card != 1 or k_small < 2:
        raise AssertionError(f"chunk plans {k_card} at the card's budget, {k_small} at a third "
                             "of the model (want 1 and > 1)")
    print(f"  frame_chunks={k_small} (the plan at {model / 3 / 2 ** 30:.2f} GiB): peak above the "
          f"inputs {peaks[k_small] / 2 ** 30:.2f} GiB", flush=True)
    _check_close(f"frame_chunks={k_small} vs unchunked", out.pop(k_small), out.pop("auto"))

    # where welch's time goes at 768 x 480000 (hann 512, hop 256, detrend
    # 'constant', average 'mean'): end to end, its stages, and torch.stft
    # with |z|^2 and the mean as the comparison; median of 5, in turns
    from nx_signal_tpu_torch.kernels.dft import blocked_frame_matmul
    from nx_signal_tpu_torch.spectral import estimation as est

    seg = 512
    n_seg = (length - seg) // (seg // 2) + 1
    w_seg = hann(seg, device=dev)
    cols = torch.as_tensor(est._detrend_columns(seg, "constant"), dtype=torch.float32,
                           device=dev)
    wk = torch.as_tensor(est._detrend_basis_spectra(w_seg, seg, True, "constant"), device=dev)
    seg_kw = dict(sampling_rate=1.0, fft_length=seg, overlap_length=seg // 2, onesided=True)
    z_seg = stft(x, w_seg, **seg_kw).z
    coefs = blocked_frame_matmul(x, cols, window_length=seg, stride=seg // 2, num_frames=n_seg)

    def torch_stft_power_mean():
        z = torch.stft(x, seg, hop_length=seg // 2, window=w_seg, center=False, onesided=True,
                       return_complex=True)
        return torch.view_as_real(z).square().sum(-1).mean(-1)

    welch_stages = [
        ("welch end to end", lambda: est.welch(x, sampling_rate=rate, window="hann",
                                               segment_length=seg, overlap_length=seg // 2)),
        ("B-fft (stft, 'valid')", lambda: stft(x, w_seg, **seg_kw)),
        ("detrend coefficients (blocked_frame_matmul, exact f32)",
         lambda: blocked_frame_matmul(x, cols, window_length=seg, stride=seg // 2,
                                      num_frames=n_seg)),
        ("z - coefs @ wk (in place)", lambda: est._subtract_trend(z_seg, coefs, wk)),
        ("power and mean", lambda: est._segment_average(z_seg, z_seg, "mean")),
        ("power and mean without the finite check (one reduction, no sync)",
         lambda: torch.linalg.vector_norm(z_seg, dim=-2) ** 2 / n_seg),
        ("torch.stft(center=False) + |z|^2 + mean", torch_stft_power_mean),
    ]
    for _, fn in welch_stages:
        fn()
    torch.cuda.synchronize()
    stage_times = {name: [] for name, _ in welch_stages}
    for _ in range(5):
        for name, fn in welch_stages:
            stage_times[name].append(_time_ms(fn))
    welch_ms = {name: sorted(t)[2] for name, t in stage_times.items()}
    for name, ms in welch_ms.items():
        print(f"  welch at {channels}x{length} ({n_seg} segments of {seg}), {name}: "
              f"{ms:.3f} ms", flush=True)
    del z_seg, coefs

    # ---------------------------------------------------------------- 8
    del x, x64, x8, xs, frames, w_fold, w_fold64, w_fold_l, w_shared, w_dense, w_mixed, z_w
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _header(f"phase 8: the sharded layer on {_PHASE8_RANKS} ranks sharing the card (gloo, "
            "CUDA IPC)")
    reports = _phase8(_PHASE8_RANKS, "cuda", dict(channels=channels, length=length,
                                                   small_channels=64, block=120320))
    for report in reports:
        for name, n in report["launches"].items():
            launches[name] = launches.get(name, 0) + n
    # E's ms, plain_ms and library_ms: host-clock exchanges of all ranks at
    # once; its bound: every rank reads its block once and writes its ext
    # once, all on the cards the ranks share
    geo = reports[0]["e_geometry"]
    timings["E"] = dict(zip(("kernel", "plain", "library", "back_to_back", "host"),
                            (max(r[key] for r in reports)
                             for key in ("e_exchange_ms", "e_plain_ms", "e_library_ms",
                                         "e_back_to_back_ms", "e_host_ms"))))
    timings["E"].update(zip(("bound_ms", "bound_by"), _bound(
        0.0, 4.0 * geo["c"] * (2 * geo["n"] + geo["hl"] + geo["hr"]) * _PHASE8_RANKS
        / torch.cuda.device_count())))
    e_device_ms = max(r["e_kernel_ms"] for r in reports)
    err_e = max(r["e_max_abs_err"] for r in reports)
    e = timings["E"]
    print(f"  E: one exchange {e['kernel']:.3f} ms, 16 back to back {e['back_to_back']:.3f} "
          f"ms each, issuing one {e['host']:.3f} ms, plain send/recv + concat "
          f"{e['plain']:.3f} ms, bare send/recv {e['library']:.3f} ms (largest rank, host "
          f"clock, all ranks at once), bound {e['bound_ms']:.3f} ms ({e['bound_by']}, "
          f"{_PHASE8_RANKS} ranks); put + interior + edges alone {e_device_ms:.3f} ms "
          f"(largest rank, CUDA events, one rank at a time)", flush=True)

    # ---------------------------------------------------------------- 9
    _header("phase 9: spectral estimation on the card (welch, csd, coherence, spectrogram, "
            "ShortTimeFFT)")
    launches = _phase9(kernels, launches, dev, channels, length, rate)

    # ---------------------------------------------------------------- 10
    _header("phase 10: IIR filtering on the card (sosfilt, lfilter, sosfiltfilt, filtfilt)")
    _phase10(kernels, dev, channels, length)

    # ---------------------------------------------------------------- 11
    _header("phase 11: resampling, the polyphase filterbank and mixing on the card "
            "(upfirdn, resample_poly, resample, decimate, pfb_analyze, mix_down, "
            "demodulate_channel)")
    _phase11(kernels, dev)

    # ---------------------------------------------------------------- 12
    _header("phase 12: streaming, the wideband receiver and config 5 from a raw capture, native "
            "IO, checkpoints and the heartbeat on the card")
    counts = _phase12(kernels, dev)
    launches = {name: n + counts.get(name, 0) for name, n in launches.items()}

    # ---------------------------------------------------------------- 13
    _header("phase 13: waveforms, relative extrema, cwt, find_peaks, czt / zoom_fft, lambert_w "
            "and the splines on the card")
    _phase13(kernels, dev)

    # ---------------------------------------------------------------- 14
    _header("phase 14: the state-space simulation (dlsim, lsim, their responses, the LTI "
            "classes) and the utils on the card")
    _phase14((*kernels, halo_extend_cuda), dev)

    # ---------------------------------------------------------------- 15
    _header("phase 15: the device rule on the card (entry points given no tensor, the internal "
            "host paths, host-to-device copies)")
    _phase15((*kernels, halo_extend_cuda), dev)

    rows = [
        (A, "framed_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:342", err_a, "A"),
        (A_tc, "framed_dft_tc.cu", "nx_signal_tpu/kernels/pallas_dft.py:342", err_atc["high"],
         "A-tc"),
        (B_fft, "framed_fft.cu", "nx_signal_tpu/kernels/pallas_dft.py:127", err_bfft, "B-fft"),
        (B, "framed_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:127", err_b, "B"),
        (C, "overlap_add.cu", "nx_signal_tpu/kernels/pallas_dft.py:924", err_c, "C"),
        (D, "shared_dft.cu", "nx_signal_tpu/kernels/pallas_dft.py:687", err_d, "D"),
        (halo_extend_cuda, "halo.cu", "nx_signal_tpu/kernels/pallas_halo.py:89", err_e, "E"),
        (M, "log_mel.cu", None, err_m, "M"),   # replaces no TPU kernel
    ]
    entries = [
        {"name": k.__name__, "route": "cuda",
         "source": f"nx_signal_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
         "launches": launches[k.__name__], "max_abs_err": err,
         "ms": timings[tag]["kernel"], "plain_ms": timings[tag]["plain"],
         "bound_ms": timings[tag]["bound_ms"], "bound_by": timings[tag]["bound_by"],
         "library_ms": timings[tag]["library"]}
        for k, src, replaces, err, tag in rows]
    # A-tc: 'high' above; its 'default' time, its 'default' error against
    # the plain version, and the exact conv1d beside the TF32 one
    # A: the bench chain above; at hop 4096 (hann 4096, 64 channels), where
    # it streams x, beside
    a_l = timings["A hop 4096"]
    entries[0].update(ms_hop_4096=a_l["kernel"], plain_ms_hop_4096=a_l["plain"],
                      library_ms_hop_4096=a_l["library"], bound_ms_hop_4096=a_l["bound_ms"],
                      bound_by_hop_4096=a_l["bound_by"], max_abs_err_hop_4096=err_a_hop)
    entries[1].update(ms_default=timings["A-tc"]["kernel 'default'"],
                      max_abs_err_default=err_atc["default"],
                      library_exact_ms=timings["A-tc"]["exact library"])
    # B-fft: n_fft 512 above (the radix-8 kernel); the mixed-radix kernel at
    # n_fft 600 beside torch.stft there. B: n_fft 1031 above
    b600 = timings["B-fft 600"]
    entries[2].update(ms_600=b600["kernel"], plain_ms_600=b600["plain"],
                      library_ms_600=b600["library"], bound_ms_600=b600["bound_ms"],
                      bound_by_600=b600["bound_by"], max_abs_err_600=err_bfft_600)
    for nf in (572, 1021, 1018):   # B-fft's radix-13/11 and Bluestein lengths
        t_nf = timings[f"B-fft {nf}"]
        entries[2].update({f"ms_{nf}": t_nf["kernel"], f"plain_ms_{nf}": t_nf["plain"],
                           f"library_ms_{nf}": t_nf["library"],
                           f"bound_ms_{nf}": t_nf["bound_ms"], f"bound_by_{nf}": t_nf["bound_by"],
                           f"max_abs_err_{nf}": err_bfft_more[nf]})
    # past 1024 (hann frame n_fft, hop n_fft / 4): through framed_dft, beside
    # its plain version and torch.stft, and the frames of 2 x n_fft
    for nf in _CUT_LENGTHS[1:]:
        t_nf = timings[f"cut {nf}"]
        entries[2].update({f"ms_{nf}": t_nf["kernel"], f"plain_ms_{nf}": t_nf.get("plain"),
                           f"library_ms_{nf}": t_nf["library"],
                           f"bound_ms_{nf}": t_nf["bound_ms"], f"bound_by_{nf}": t_nf["bound_by"],
                           f"max_abs_err_{nf}": err_bfft_more[nf]})
    entries[2].update(max_abs_err_frame_1024_n_fft_512=err_bfft_more[(512, 1024)],
                      max_abs_err_frame_8192_n_fft_4096=err_bfft_more[(4096, 8192)],
                      max_abs_err_frame_16384_n_fft_8192=err_bfft_more[(8192, 16384)])
    # past 16384 the errors above are against the f64 torch.fft (frame n_fft);
    # against the plain version at a frame of 512 here
    entries[2].update({f"max_abs_err_{nf}_frame_{frame}": err_bfft_more[(nf, frame)]
                       for nf in _LONG_LENGTHS})
    # the dense B: called directly at n_fft 16400 on 8 channels, hop 4100
    entries[3].update(n_fft=n_dense, channels=ch_dense, hop=hop_dense)
    # D: the shared path's set-up per call
    entries[5].update(fold_ms=setup_ms["fold"], layout_ms=setup_ms["layout"])
    entries[6].update(ms_back_to_back=e["back_to_back"], host_ms=e["host"],
                      device_ms=e_device_ms)
    # M: at the Whisper call, 512 clips of 3001 x 201 bins, 128 mels
    entries[7].update(clips=clips_w, frames=frames_w, mels=128)

    # every process this run started has ended: stop any that has not, and fail
    left = _live_children()
    for pid, _ in left:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    if left:
        raise AssertionError(f"processes still running at the end, killed: {left}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase8-rank"]:  # one rank of phase 8, started by _phase8
        rank, world, tmp, device_type, sizes, address = sys.argv[2:]
        _phase8_rank(int(rank), int(world), tmp, device_type, json.loads(sizes), address)
        sys.exit(0)
    sys.exit(main())
