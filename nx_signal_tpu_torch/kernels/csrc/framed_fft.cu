// Hopper kernel B-fft: the windowed framed DFT as one FFT per frame in
// shared memory (of one CTA, or of a thread-block cluster of 2 to 16 CTAs),
// for every n_fft from 8 to 65536 and any frame length; and its inverse for
// a power-of-two n_fft to 1024, kernel B-ifft (described below).
//
// Replaces (TPU kernel of the JAX package):
//   nx_signal_tpu/kernels/pallas_dft.py:framed_dft_pallas
// for those n_fft; an n_fft below 8 or above 65536 keeps the dense
// contraction of framed_dft.cu.
//
// For channel c and frame m (0 <= m < num_frames), with
//   xw[i] = sum_q x[c, m*stride + i + q*n_fft] * win[i + q*n_fft] for i < n_fft
//           (the terms with i + q*n_fft < frame_length: a frame no longer
//           than n_fft is zero-padded, a longer one folded modulo n_fft, since
//           exp(-2 pi i k t / n_fft) has period n_fft in t),
//   X[k] = sum_i xw[i] exp(-2 pi i k i / n_fft),
// out[c, m, k] is X[k] (complex64 as interleaved float2) or, with POWER,
// re^2 + im^2 (f32), for the bins = n_fft/2 + 1 (onesided) or n_fft bins.
//
// A real frame of even n_fft is one complex FFT of L = n_fft/2 points,
// z[j] = xw[2j] + i xw[2j+1] (the window multiply and the fold fused into
// the load), and the split post-pass
//   X[k] = (Z[k] + conj Z[L-k]) / 2 - i W^k (Z[k] - conj Z[L-k]) / 2,
//   W = exp(-2 pi i / n_fft), k = 0..L (indices mod L), X[n-k] = conj X[k],
// which forms X[k] and X[L-k] from the same two values and one twiddle. Two
// real frames of odd n_fft share one complex FFT of L = n_fft points, z =
// xw_m + i xw_{m+1}, separated after it as
//   X_m[k] = (Z[k] + conj Z[n-k]) / 2,  X_{m+1}[k] = (Z[k] - conj Z[n-k]) / (2i).
// The FFT runs Stockham autosort passes (butterflies in registers); an L
// with a prime factor above 13 (1021, 1031, 4093, 8191, 1018 = 2 * 509)
// runs as Bluestein's chirp-z transform (kernels/dft.py:_bluestein_plan),
//   Z[k] = w_k sum_j (z_j w_j) conj(w_{k-j}),  w_j = exp(-pi i j^2 / L),
// through two FFTs of M >= 2L - 1 points: the first pass loads z_t w_t
// (zeros past L), the second FFT's first pass conj(A[t] S[t]) with S the
// host's FFT of the conjugate chirp over M, and the post-pass reads Z[k] =
// w_k conj(.) of its output (conj, FFT, conj is the inverse; S carries the
// 1/M). Three kernels run the FFTs:
//   * framed_fft_kernel, a power-of-two n_fft up to 1024: radix-8 passes
//     (a last 4 or 2) over a padded buffer per frame (index i at i + i/8),
//     one CTA per (channel, tile of frames). Each CTA copies the (n_fft)
//     float2 table exp(-2 pi i t / n_fft) the host builds in f64: its first
//     n_fft/4 + 1 entries (the post-pass's), and for each pass after the
//     first the entries exp(-2 pi i jm r / (Ns R)) at r*Ns + jm, so that a
//     warp's twiddle loads hit consecutive addresses.
//   * framed_fft_loop_kernel, every M that is a power of two from 8 to 8192
//     (4096 for odd n_fft): the power-of-two n_fft past 1024 (M = L) and
//     Bluestein's M, the power of two >= 2L - 1 by the host's rule
//     (kernels/dft.py:_bluestein_points). Persistent CTAs, as many as the
//     SMs hold (the occupancy calculator), each walking over (channel, tile
//     of frames) items. An FFT of M points takes M / 8 threads, each holding
//     one radix-8 butterfly (two of radix 4, four of radix 2) in registers;
//     every pass reads the FFT's one exchange buffer, waits for every read,
//     and writes it back (no ping-pong pair). CTAs of 512 threads (up to 128
//     registers each) run M up to 2048 and odd n_fft; CTAs of 1024 (64
//     registers) M = 4096 and 8192, one FFT of 8192 points on 1024 threads,
//     which two CTAs of 512 holding two butterflies a thread would spill.
//     Where the next item's window of x, the window and two slots
//     fit the budget (kLoopBudget), the next item is staged with cp.async
//     into the second slot while the current one's FFTs run; where they do
//     not (n_fft past about 4096), the frames and the window are read from
//     global memory, each frame's samples from device memory about once
//     (overlapping frames hit L2). The host lays out its table as the mixed
//     kernel's (post-pass twiddles, [chirp, filter spectrum], each later
//     pass's twiddles at r*Ns + jm, kernels/dft.py:_passes), with each pass's
//     output padding c_p of the plan; every CTA reads the twiddles, the
//     chirp and S through L2.
//   * framed_fft_mixed_kernel, every other M (13-smooth and not a power of
//     two, and a power of two past the loop kernel's range), following the
//     host's plan (kernels/dft.py:_fft_plan, _bluestein_plan): Stockham
//     passes of radix 8 and a 4 or 2, then 13, 11, 9, 7, 5, 3, of M points.
//     Each pass reads one buffer and writes the other (a ping-pong pair per
//     FFT), each thread looping over its share of the M/R butterflies, so
//     one sync per pass. The plan stores pass p's output index i at i + (i /
//     (Ns R)) c_p, which sends the stores of a half-warp to distinct banks
//     for the radix-3, -5 and -7 strides as for the even ones (past 2048
//     points only where c_p adds at most 1/8 to the buffer). Its f64 table
//     (post-pass twiddles, then each later pass's twiddles in the order the
//     pass reads them) is cast to f32 on the host. Up to 2048 points the CTA
//     stages the table in shared memory where it fits beside one FFT's
//     buffers and its frames; past 2048 points every CTA reads it from
//     global memory, where all CTAs share it through L2 (measured faster
//     there, NX_FFT_L2_TABLE_POINTS). An FFT past 2048 points takes the
//     CTA's kThreads threads; where staging its frames and the window beside
//     its buffers would take more than half an SM's shared memory (L past
//     about 3500), they are read from global memory. It runs Bluestein's
//     power-of-two M past the loop kernel's range: 8192 for odd n_fft (whose
//     loop shapes spill at the registers they leave), 16384 to 131072 (one
//     CTA of the loop kernel would hold 4 or more butterflies a thread,
//     which spills; spread over a cluster it ran about 2x slower than this),
//     and the power-of-two n_fft past 16384 (L 16384 and 32768). Where one
//     FFT's buffer pair does not fit a CTA (an L or Bluestein's M past about
//     14000 points), a cluster of C = 2, 4, 8 or 16 CTAs shares it (16, for
//     Bluestein's M past about 116000 points of an odd n_fft past 58000, is
//     past the portable 8 and asks for the non-portable size): each CTA
//     holds a part of both buffers, index i in CTA (i / 32) mod C (runs of
//     32 points, so that a warp's 32 consecutive points lie in one CTA), the
//     cluster's threads run the FFT's butterflies through distributed shared
//     memory, and the cluster's barrier ends each pass.
//
// What bounds it on the H100: bytes. Per input sample it moves 4 B in and
// 8 * bins / stride B out (complex64), against about 2.5 n log2 n / stride
// FLOP (~90 at n = 512, hop 128), far below the card's ratio. So:
//   * Each sample is read from device memory about once, not once per
//     frame: a CTA stages its tile's window of x with 16-byte cp.async
//     where the alignment allows, or (the long transforms) reads frames
//     that overlap through L2.
//   * A frame's threads run its passes in registers and shared memory,
//     several frames per CTA at once where they fit; they sync with
//     __syncwarp where an FFT's threads lie in one warp, else on a named
//     barrier of their own (the mixed and loop kernels), the CTA's, or the
//     cluster's.
//   * The output is written straight into the complex64 tensor, consecutive
//     threads on consecutive bins (no stacked [Re | Im] and no copy).
//
// Kernel B-ifft (framed_ifft_kernel), the inverse of framed_fft_kernel's
// path: the windowed frames of a one-sided spectrum, irfft(z[f], n_fft)[t]
// * win[t] for t < frame_length <= n_fft, n_fft a power of two from 8 to
// 1024, which the caller (spectral/stft.py:istft) overlap-adds with kernel
// C. It replaces no TPU kernel: the JAX package's
// nx_signal_tpu/kernels/dft.py:framed_idft is one XLA product against dense
// inverse-DFT weights, as the port's route off this kernel still is
// (kernels/dft.py:_framed_idft_torch: weights built in numpy each call, an
// exact-f32 GEMM of 0.70 TFLOP where this FFT needs about 17 GFLOP at 64 x
// 2 646 000, hop 128). Per frame it reads z's
// interleaved complex64 bins once (no split, no concatenation), forms the
// half-length spectrum with the mirror of the split post-pass,
//   Z[k] = (X[k] + conj X[h-k]) + i W^-k (X[k] - conj X[h-k]),  h = n_fft/2,
// runs one h-point inverse FFT as conj, the forward radix-8 passes, conj
// (the same passes, padded buffer and twiddle table), scales by 1/n_fft,
// and writes samples 2j and 2j + 1 from the real and imaginary parts of
// point j, times the window. Bounded by bytes like B-fft: 8 B a bin in and
// 4 B a sample out. Each frame's arithmetic depends on its own bins alone,
// in one fixed order, so the output does not depend on the tiling, the
// batch or the row count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinFft = 8;
constexpr int kMaxFft = 65536;
constexpr int kMaxSmallFft = 1024;             // framed_fft_kernel's largest n_fft
constexpr int kTileTarget = 32;                 // frames per CTA where they fit
constexpr size_t kSmemBudget = 96 * 1024;       // keeps two or more CTAs per SM
constexpr int64_t kMaxGridY = 65535;
// Past this many points the mixed kernel reads its table from global
// memory (L2) even where it would fit in shared memory: there a CTA holds
// one FFT, and the shared memory the table frees lets more CTAs share an
// SM. scripts/torch_kernel_variants.py section 5 times the choice (on an
// H100 at 700 W, L2 against staged: 0.80 / 1.13 ms at n_fft 4095, 2.56 /
// 3.59 at 4094, 2.20 / 2.42 at 1031; but 1.92 / 1.72 at 1021, M = 2048).
#ifndef NX_FFT_L2_TABLE_POINTS
#define NX_FFT_L2_TABLE_POINTS kLargeFft
#endif

__host__ __device__ inline int pad_index(int i) { return i + (i >> 3); }
__host__ __device__ inline int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

// threads per frame (each holds min(h, 8) values) and the padded h
__host__ __device__ inline int threads_per_frame(int h) { return h >= 8 ? h >> 3 : 1; }
__host__ __device__ inline int padded_len(int h) { return h + (h >> 3); }
// float2 of the post-pass twiddles a CTA keeps: W^k for k = 0..n_fft/4, an
// even count so that what follows stays 16-byte aligned
__host__ __device__ inline int post_len(int n_fft) { return (n_fft / 4 + 2) / 2 * 2; }

// Shared memory of a CTA: the post-pass twiddles, the passes' twiddle
// tables (n_fft float2 hold them), the FFT buffers of `group` frames (an
// even count of float2), the window, and the staged x window of `tile`
// frames (+3 for the alignment offset).
inline size_t smem_bytes(int n_fft, int frame_length, int64_t stride, int group, int tile) {
  const int64_t bufs = ((int64_t)group * padded_len(n_fft / 2) + 1) / 2 * 2;
  return (size_t)(8 * ((int64_t)post_len(n_fft) + n_fft) + 8 * bufs +
                  4 * round4(frame_length) +
                  4 * round4((int64_t)(tile - 1) * stride + frame_length + 3));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// -i * a
__device__ __forceinline__ float2 cmul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register forward DFT of R = 2, 4 or 8 points, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
  const float2 s13 = cadd(v[1], v[3]), d13 = cmul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(s02, s13);
  v[1] = cadd(d02, d13);
  v[2] = csub(s02, s13);
  v[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float c = 0.70710678118654752440f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));     // * W8
  o[2] = cmul_neg_i(o[2]);                                              // * W8^2
  o[3] = make_float2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));    // * W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// cos and sin of 2 pi m / R, R = 3, 5, 7, 9, 11 or 13, 0 <= m <= (R - 1) / 2
// (R and m are compile-time constants where the butterflies call these)
__device__ __forceinline__ float root_cos(int R, int m) {
  if (m == 0) return 1.0f;
  if (R == 3) return -0.5f;
  if (R == 5) return m == 1 ? 0.30901699437494745f : -0.8090169943749473f;
  if (R == 7) {
    return m == 1 ? 0.6234898018587336f : (m == 2 ? -0.22252093395631434f : -0.900968867902419f);
  }
  if (R == 9) {
    return m == 1 ? 0.76604444311897804f
         : m == 2 ? 0.17364817766693035f
         : m == 3 ? -0.5f
                  : -0.93969262078590838f;
  }
  if (R == 11) {
    return m == 1 ? 0.84125353283118117f
         : m == 2 ? 0.41541501300188643f
         : m == 3 ? -0.14231483827328514f
         : m == 4 ? -0.65486073394528506f
                  : -0.95949297361449738f;
  }
  return m == 1 ? 0.88545602565320990f
       : m == 2 ? 0.56806474673115580f
       : m == 3 ? 0.12053668025532305f
       : m == 4 ? -0.35460488704253562f
       : m == 5 ? -0.74851074817110109f
                : -0.97094181742605202f;
}
__device__ __forceinline__ float root_sin(int R, int m) {
  if (m == 0) return 0.0f;
  if (R == 3) return 0.8660254037844387f;
  if (R == 5) return m == 1 ? 0.9510565162951535f : 0.5877852522924732f;
  if (R == 7) {
    return m == 1 ? 0.7818314824680298f : (m == 2 ? 0.9749279121818236f : 0.43388373911755823f);
  }
  if (R == 9) {
    return m == 1 ? 0.64278760968653933f
         : m == 2 ? 0.98480775301220806f
         : m == 3 ? 0.8660254037844387f
                  : 0.34202014332566866f;
  }
  if (R == 11) {
    return m == 1 ? 0.54064081745559758f
         : m == 2 ? 0.90963199535451837f
         : m == 3 ? 0.98982144188093273f
         : m == 4 ? 0.75574957435425828f
                  : 0.28173255684142970f;
  }
  return m == 1 ? 0.46472317204376855f
       : m == 2 ? 0.82298386589365639f
       : m == 3 ? 0.99270887409805399f
       : m == 4 ? 0.93501624268541482f
       : m == 5 ? 0.66312265824079520f
                : 0.23931566428755777f;
}

// In-register forward DFT of an odd R points from the symmetric pairs
// a_n = v[n] + v[R-n], b_n = v[n] - v[R-n]:
//   X[k] = v[0] + sum_n a_n cos(2 pi n k / R) - i sum_n b_n sin(2 pi n k / R),
// and X[R-k] the same with + i (any odd R: at R = 9, n k = 9 is the angle 0).
template <int R>
__device__ __forceinline__ void dft_odd(float2* v) {
  constexpr int H = (R - 1) / 2;
  float2 a[H], b[H];
  float2 x0 = v[0];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    a[n - 1] = cadd(v[n], v[R - n]);
    b[n - 1] = csub(v[n], v[R - n]);
    x0 = cadd(x0, a[n - 1]);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 s = v[0], t = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int q = n * k % R;  // the angle 2 pi q / R, folded into 1..H
      const float c = root_cos(R, q <= H ? q : R - q);
      const float sn = q <= H ? root_sin(R, q) : -root_sin(R, R - q);
      s = make_float2(fmaf(c, a[n - 1].x, s.x), fmaf(c, a[n - 1].y, s.y));
      t = make_float2(fmaf(sn, b[n - 1].x, t.x), fmaf(sn, b[n - 1].y, t.y));
    }
    v[k] = make_float2(s.x + t.y, s.y - t.x);      // s - i t
    v[R - k] = make_float2(s.x - t.y, s.y + t.x);  // s + i t
  }
  v[0] = x0;
}

template <>
__device__ __forceinline__ void dft<3>(float2* v) { dft_odd<3>(v); }
template <>
__device__ __forceinline__ void dft<5>(float2* v) { dft_odd<5>(v); }
template <>
__device__ __forceinline__ void dft<7>(float2* v) { dft_odd<7>(v); }
template <>
__device__ __forceinline__ void dft<9>(float2* v) { dft_odd<9>(v); }
template <>
__device__ __forceinline__ void dft<11>(float2* v) { dft_odd<11>(v); }
template <>
__device__ __forceinline__ void dft<13>(float2* v) { dft_odd<13>(v); }

// Stages x[s0 - mis, s_end) of one channel into xs with 16-byte cp.async
// from the 16-byte boundary at or below s0 (zeros outside the signal) and
// commits the copies as one group; returns mis, the offset of s0 in xs.
__device__ __forceinline__ int stage_window(float* xs, const float* xc, int64_t length,
                                            int64_t s0, int64_t s_end, int tid, int nthr) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(xc + s0) >> 2) & 3);
  const int64_t a0 = s0 - mis;
  const int chunks = (int)((s_end - a0 + 3) >> 2);
  for (int c = tid; c < chunks; c += nthr) {
    const int64_t g = a0 + 4 * (int64_t)c;
    float* dst = xs + 4 * c;
    if (g >= 0 && g + 3 < length) {
      cp_async16(dst, xc + g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (g + e >= 0 && g + e < length) ? xc[g + e] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return mis;
}

// Bin k of a frame's output row (complex64 or its power) and, where
// `mirror`, bin n_fft - k as its conjugate (the full spectrum).
template <bool POWER>
__device__ __forceinline__ void put_bin(void* out, int64_t row, int k, float re, float im,
                                        bool mirror, int n_fft) {
  if constexpr (POWER) {
    const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    static_cast<float*>(out)[row + k] = p;
    if (mirror) static_cast<float*>(out)[row + n_fft - k] = p;
  } else {
    static_cast<float2*>(out)[row + k] = make_float2(re, im);
    if (mirror) static_cast<float2*>(out)[row + n_fft - k] = make_float2(re, -im);
  }
}

// Waits for the threads of this frame: its warp where a frame's threads lie
// in one warp (n_fft <= 512), else the CTA.
template <bool WARP_SYNC>
__device__ __forceinline__ void frame_sync() {
  if constexpr (WARP_SYNC) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Where a pass of framed_fft_kernel or framed_ifft_kernel takes its points:
// B-fft's first pass from the windowed frame in the staged x, B-ifft's first
// pass from the buffer as its pre-pass filled it (Ns = 1, no twiddles), and
// every later pass from the buffer times the pass's twiddles.
enum PassSource { kFromFrame, kFromBuffer, kFromPass };

// One Stockham pass of radix R over this frame's h-point buffer, after Ns
// points have been combined: thread j0 takes butterflies j = j0 + it*G.
// A first pass (Ns = 1) takes no twiddles; a later one takes them from the
// pass's table `twp` (entry r*Ns + j mod Ns). A pass that reads the buffer
// reads it, waits for every read, then writes.
template <int R, int ITERS, int SRC, bool WARP_SYNC>
__device__ __forceinline__ void fft_pass(float2* fbuf, const float2* twp, const float* xf,
                                         const float* wins, int frame_length, int h, int Ns,
                                         int G, int j0) {
  float2 v[ITERS][R];
  const int span = h / R;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = j0 + it * G;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * span;
      if constexpr (SRC == kFromFrame) {
        // (x, window) pairs as 8-byte loads where the frame starts 8-byte
        // aligned in the staged window (the window itself is); a frame
        // longer than n_fft = 2h folded modulo n_fft
        float re = 0.0f, im = 0.0f;
        if (xf != nullptr) {
          const bool aligned = (reinterpret_cast<uintptr_t>(xf) & 7) == 0;
          for (int i = 2 * n; i < frame_length; i += 2 * h) {
            if (i + 1 < frame_length && aligned) {
              const float2 xv = *reinterpret_cast<const float2*>(xf + i);
              const float2 wv = *reinterpret_cast<const float2*>(wins + i);
              re += xv.x * wv.x;
              im += xv.y * wv.y;
            } else {
              re += xf[i] * wins[i];
              if (i + 1 < frame_length) im += xf[i + 1] * wins[i + 1];
            }
          }
        }
        v[it][r] = make_float2(re, im);
      } else {
        v[it][r] = fbuf[pad_index(n)];
      }
    }
    if constexpr (SRC == kFromPass) {
      const int jm = j & (Ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[it][r] = cmul(v[it][r], twp[r * Ns + jm]);
    }
    dft<R>(v[it]);
  }
  if constexpr (SRC != kFromFrame) frame_sync<WARP_SYNC>();  // every read of this pass is done
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = j0 + it * G;
    const int jm = j & (Ns - 1);
    const int base = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) fbuf[pad_index(base + r * Ns)] = v[it][r];
  }
}

template <int SRC, bool WARP_SYNC>
__device__ __forceinline__ void run_pass(int R, float2* fbuf, const float2* twp, const float* xf,
                                         const float* wins, int frame_length, int h, int Ns,
                                         int G, int j0) {
  if (R == 8) {
    fft_pass<8, 1, SRC, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
  } else if (R == 4) {
    if (h >= 8) {
      fft_pass<4, 2, SRC, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
    } else {
      fft_pass<4, 1, SRC, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
    }
  } else {
    fft_pass<2, 4, SRC, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
  }
}

// Copies a CTA's twiddles from the (n_fft) float2 table exp(-2 pi i t /
// n_fft): the post-pass's W^k, k = 0..n_fft/4, into tws, and for each pass
// after the first its entries exp(-2 pi i jm r / (Ns R)) at r*Ns + jm, one
// pass's table after another, into twp.
__device__ __forceinline__ void stage_tables(float2* tws, float2* twp, const float2* tw,
                                             int n_fft, int tid, int nthr) {
  const int h = n_fft >> 1;
  for (int i = tid; i <= n_fft / 4; i += nthr) tws[i] = tw[i];
  for (int Ns = h < 8 ? h : 8, off = 0; Ns < h;) {
    const int R = h / Ns < 8 ? h / Ns : 8;
    for (int i = tid; i < Ns * R; i += nthr) {
      const int r = i / Ns, jm = i - r * Ns;
      twp[off + i] = tw[2 * jm * r * (h / (Ns * R))];
    }
    off += Ns * R;
    Ns *= R;
  }
}

// One frame's FFT of h points in its padded buffer: radix-8 passes (a last
// 4 or 2), the first taking its points from SRC (kFromFrame: the windowed
// frame xf; kFromBuffer: the buffer as filled), the later ones the tables
// of stage_tables; the last pass's writes are visible to the frame's
// threads on return.
template <int SRC, bool WARP_SYNC>
__device__ __forceinline__ void small_fft(float2* fbuf, const float2* twp, const float* xf,
                                          const float* wins, int frame_length, int h, int G,
                                          int j0) {
  const int r1 = h < 8 ? h : 8;
  run_pass<SRC, WARP_SYNC>(r1, fbuf, nullptr, xf, wins, frame_length, h, 1, G, j0);
  for (int Ns = r1, off = 0; Ns < h;) {
    frame_sync<WARP_SYNC>();  // the previous pass's writes are visible
    const int R = h / Ns < 8 ? h / Ns : 8;
    run_pass<kFromPass, WARP_SYNC>(R, fbuf, twp + off, nullptr, wins, frame_length, h, Ns, G, j0);
    off += Ns * R;
    Ns *= R;
  }
  frame_sync<WARP_SYNC>();
}

template <bool POWER, bool WARP_SYNC>
__global__ void __launch_bounds__(kThreads)
framed_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float2* __restrict__ tw, void* __restrict__ out, int64_t length,
                  int stride, int frame_length, int n_fft, int num_frames, int bins, int tile,
                  int group) {
  extern __shared__ __align__(16) float smem[];
  const int h = n_fft >> 1;
  const int G = threads_per_frame(h);
  const int hp = padded_len(h);
  float2* tws = reinterpret_cast<float2*>(smem);
  float2* twp = tws + post_len(n_fft);  // the passes' tables, one after another
  float2* bufs = twp + n_fft;
  float* wins = reinterpret_cast<float*>(bufs + ((int64_t)group * hp + 1) / 2 * 2);
  float* xs = wins + round4(frame_length);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int64_t ch = blockIdx.y;
  const int m0 = blockIdx.x * tile;
  const int m_end = min(num_frames, m0 + tile);

  // the tile's window of x: samples [m0*stride, (m_end-1)*stride + frame)
  const int mis = stage_window(xs, x + ch * length, length, (int64_t)m0 * stride,
                               (int64_t)(m_end - 1) * stride + frame_length, tid, nthr);
  stage_tables(tws, twp, tw, n_fft, tid, nthr);
  for (int i = tid; i < frame_length; i += nthr) wins[i] = win[i];
  asm volatile("cp.async.wait_group 0;\n" ::);

  __syncthreads();  // x staged

  // each frame's G threads run its FFT and write its bins on their own,
  // frames slot, slot + group, ... of the tile
  const int slot = tid / G;
  const int j0 = tid - slot * G;
  float2* fbuf = bufs + slot * hp;
  for (int mg = m0; mg < m_end; mg += group) {
    const int m = mg + slot;
    const float* xf = m < m_end ? xs + mis + (m - m0) * stride : nullptr;
    small_fft<kFromFrame, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, G, j0);

    // the split post-pass, X[k] and X[h-k] from the same Z[k], Z[h-k] and
    // W^k (W^(h-k) = -conj W^k), k = 0..h/2; the full spectrum adds
    // X[n-k] = conj X[k]. Consecutive threads write consecutive bins.
    if (m < m_end) {
      const int64_t row = (ch * num_frames + m) * (int64_t)bins;
      const bool full = bins == n_fft;
      for (int k = j0; k <= (h >> 1); k += G) {
        const float2 a = fbuf[pad_index(k & (h - 1))];        // Z[k]
        const float2 b = fbuf[pad_index((h - k) & (h - 1))];  // Z[h-k]
        const float sr = a.x + b.x, si = a.y - b.y;           // Z[k] + conj Z[h-k]
        const float dr = a.x - b.x, di = a.y + b.y;           // Z[k] - conj Z[h-k]
        const float2 w = tws[k];
        const float pr = w.x * dr - w.y * di, pi = w.x * di + w.y * dr;
        put_bin<POWER>(out, row, k, 0.5f * (sr + pi), 0.5f * (si - pr), full && k >= 1, n_fft);
        if (h - k != k) {
          put_bin<POWER>(out, row, h - k, 0.5f * (sr - pi), -0.5f * (si + pr), full && k >= 1,
                         n_fft);
        }
      }
    }
    frame_sync<WARP_SYNC>();  // the buffer is read before the next frame fills it
  }
}

// ---- kernel B-ifft: the inverse of framed_fft_kernel, one frame of a
// one-sided spectrum per FFT (see the top of the file)

// Frames of a CTA: `group` at once (kThreads / threads_per_frame), this many
// rounds of them, so that a CTA's twiddle tables serve many frames
constexpr int kIfftRounds = 8;

// Shared memory of a framed_ifft_kernel CTA: the post-pass twiddles, the
// passes' tables, the buffers of `group` frames and the window.
inline size_t ifft_smem_bytes(int n_fft, int frame_length, int group) {
  const int64_t bufs = ((int64_t)group * padded_len(n_fft / 2) + 1) / 2 * 2;
  return (size_t)(8 * ((int64_t)post_len(n_fft) + n_fft) + 8 * bufs + 4 * round4(frame_length));
}

// Frame f of z (frames, zbins) complex64, with X[k] = z[f, k] for k <
// zbins and 0 past it, to out[f, t] = irfft(X, n_fft)[t] * win[t], t <
// frame_length <= n_fft, the imaginary parts of X[0] and X[h] ignored
// (h = n_fft / 2); scale is 1 / n_fft (a power of two: exact), given by
// the host, whose division keeps the kernel free of the device's division
// routine and its stack frame. Frames slot, slot + group, ... of the CTA's
// tile; each frame's G threads run its FFT on their own, as in
// framed_fft_kernel.
template <bool WARP_SYNC>
__global__ void __launch_bounds__(kThreads)
framed_ifft_kernel(const float2* __restrict__ z, const float* __restrict__ win,
                   const float2* __restrict__ tw, float* __restrict__ out, int64_t frames,
                   float scale, int zbins, int frame_length, int n_fft, int tile,
                   int group) {
  extern __shared__ __align__(16) float smem[];
  const int h = n_fft >> 1;
  const int G = threads_per_frame(h);
  const int hp = padded_len(h);
  float2* tws = reinterpret_cast<float2*>(smem);
  float2* twp = tws + post_len(n_fft);
  float2* bufs = twp + n_fft;
  float* wins = reinterpret_cast<float*>(bufs + ((int64_t)group * hp + 1) / 2 * 2);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int64_t f0 = (int64_t)blockIdx.x * tile;
  const int64_t f_end = frames < f0 + tile ? frames : f0 + tile;
  stage_tables(tws, twp, tw, n_fft, tid, nthr);
  for (int i = tid; i < frame_length; i += nthr) wins[i] = win[i];
  __syncthreads();  // the tables and the window staged

  const int slot = tid / G;
  const int j0 = tid - slot * G;
  float2* fbuf = bufs + slot * hp;
  const int nz = zbins < h + 1 ? zbins : h + 1;  // bins read; those past them are zeros
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int64_t fg = f0; fg < f_end; fg += group) {
    const int64_t f = fg + slot;
    const bool live = f < f_end;
    // the pre-pass, the mirror of framed_fft_kernel's split post-pass: from
    // a = X[k] and b = X[h-k] (X[h] at k = 0), s = a + conj b, d = a - conj
    // b and p = W^-k d (W^-k = conj of the table's W^k), the half-length
    // spectrum Z[k] = s + i p and Z[h-k] = conj(s - i p), stored conjugated
    // (the inverse runs as conj, forward passes, conj). Consecutive threads
    // read consecutive bins from both ends.
    if (live) {
      const float2* zf = z + f * zbins;
      for (int k = j0; k <= (h >> 1); k += G) {
        float2 a = k < nz ? zf[k] : zero;
        float2 b = h - k < nz ? zf[h - k] : zero;
        if (k == 0) a.y = b.y = 0.0f;                 // DC and Nyquist
        const float sr = a.x + b.x, si = a.y - b.y;   // s
        const float dr = a.x - b.x, di = a.y + b.y;   // d
        const float2 w = tws[k];
        const float pr = w.x * dr + w.y * di, pi = w.x * di - w.y * dr;  // p
        fbuf[pad_index(k)] = make_float2(sr - pi, -(si + pr));            // conj Z[k]
        if (k != 0 && h - k != k) fbuf[pad_index(h - k)] = make_float2(sr + pi, si - pr);
      }
    }
    frame_sync<WARP_SYNC>();  // the pre-pass's writes are visible
    small_fft<kFromBuffer, WARP_SYNC>(fbuf, twp, nullptr, wins, frame_length, h, G, j0);

    // the output: point j of the FFT, conjugated and scaled, is samples 2j
    // (real part) and 2j + 1 (imaginary part), each times the window;
    // consecutive threads write consecutive pairs
    if (live) {
      float* of = out + f * frame_length;
      const bool paired = (frame_length & 1) == 0;  // every row starts 8-byte aligned
      for (int j = j0; 2 * j < frame_length; j += G) {
        const float2 v = fbuf[pad_index(j)];
        const float y0 = v.x * scale * wins[2 * j];
        if (2 * j + 1 == frame_length) {
          of[2 * j] = y0;
        } else {
          const float y1 = -v.y * scale * wins[2 * j + 1];
          if (paired) {
            *reinterpret_cast<float2*>(of + 2 * j) = make_float2(y0, y1);
          } else {
            of[2 * j] = y0;
            of[2 * j + 1] = y1;
          }
        }
      }
    }
    frame_sync<WARP_SYNC>();  // the buffer is read before the next frame fills it
  }
}

// ---- the mixed-radix kernel (every other n_fft: 13-smooth ones directly,
// the rest through Bluestein's chirp-z transform)

// A plan packs pass p into byte p: its radix (2, 3, 4, 5, 7, 8, 9, 11 or 13)
// in the low four bits, its output padding c (0..15) in the high four
constexpr int kMaxPasses = 8;
constexpr int kMaxPoints = 131072;  // Bluestein's M at the longest L (65535, odd n_fft)
// A cluster's CTAs hold an FFT buffer in runs of 1 << kRunLog points
constexpr int kRunLog = 5;
constexpr int kMaxCluster = 16;
// Past this many points a CTA holds one FFT of the mixed kernel (its two
// buffers fill the shared memory), which then takes kThreads threads; the
// host's plans pad such FFTs' passes sparingly (kernels/dft.py:_FULL_PAD_POINTS)
constexpr int kLargeFft = 2048;
__host__ __device__ inline int plan_radix(uint64_t plan, int p) {
  return (int)((plan >> (8 * p)) & 15);
}
__host__ __device__ inline int plan_pad(uint64_t plan, int p) {
  return (int)((plan >> (8 * p + 4)) & 15);
}

// threads per FFT of M points: one warp, or fewer for short FFTs (a power of
// two, so the FFTs of a warp never straddle two warps); Bluestein's FFTs
// and every FFT of more than 1024 points take up to two warps, which
// doubles the warps an SM holds where their buffers fill its shared
// memory, and an FFT of more than 2048 points, whose buffers leave room for
// one FFT per CTA, takes the CTA's kThreads
inline int mixed_threads(int M, bool blue) {
  const int cap = M > kLargeFft ? kThreads : (blue || M > 1024 ? 64 : 32);
  int g = 1;
  while (g < cap && 8 * g < M) g *= 2;
  return g;
}

// Waits for the G threads of this FFT slot: its warp, or its two warps on
// named barrier 1 + slot
__device__ __forceinline__ void slot_sync(int slot, int G) {
  if (G <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "r"(G) : "memory");
  }
}

// An FFT buffer of the mixed kernel: CL false, in this CTA's shared memory
// from `base`; CL true, spread over the C = 1 << log_c CTAs of a
// thread-block cluster, run r = i >> kRunLog of index i in CTA r mod C, at
// run r / C of the part from `base` there (the same offset in every CTA),
// read and written through distributed shared memory.
template <bool CL>
struct Buf {
  float2* base;
  int log_c;
  __device__ __forceinline__ float2& operator[](int i) const {
    if constexpr (CL) {
      const int run = i >> kRunLog;
      float2* local = base + ((run >> log_c) << kRunLog) + (i & ((1 << kRunLog) - 1));
      return *cg::this_cluster().map_shared_rank(local, run & ((1 << log_c) - 1));
    } else {
      return base[i];
    }
  }
};

// float2 of each buffer a CTA of a cluster of 1 << log_c holds: whole runs
inline int cluster_part(int buf_len, int log_c) {
  const int runs = (buf_len + (1 << kRunLog) - 1) >> kRunLog;
  return ((runs + (1 << log_c) - 1) >> log_c) << kRunLog;
}

// Waits for the threads of this FFT: slot_sync, or (CL) the cluster's,
// whose barrier also makes the CTAs' shared-memory writes visible to each
// other
template <bool CL>
__device__ __forceinline__ void fft_sync(int slot, int G) {
  if constexpr (CL) {
    cg::this_cluster().sync();
  } else {
    slot_sync(slot, G);
  }
}

// float2 per buffer: the largest padded output of any pass
inline int mixed_buf_len(uint64_t plan, int M) {
  int len = M;
  for (int p = 0, ns = 1; p < kMaxPasses && plan_radix(plan, p) != 0; ++p) {
    ns *= plan_radix(plan, p);
    len = M + M / ns * plan_pad(plan, p) > len ? M + M / ns * plan_pad(plan, p) : len;
  }
  return len;
}

// float2 of the plan's table: post-pass twiddles (even n_fft), Bluestein's
// chirp (L) and filter spectrum (M) where M != L, then Ns R per pass after
// the first
inline int mixed_table_len(uint64_t plan, int L, int M, bool odd) {
  int len = (odd ? 0 : L / 2 + 1) + (M != L ? L + M : 0);
  for (int p = 0, ns = 1; p < kMaxPasses && plan_radix(plan, p) != 0; ++p) {
    ns *= plan_radix(plan, p);
    if (p > 0) len += ns;
  }
  return len;
}

// Shared memory of a CTA: the table where it is staged (table_len float2,
// 0 where it stays in global memory; an even count, so what follows stays
// 16-byte aligned), two buffers per FFT, and where x is staged the window
// and the staged x window of `tile` frames (+3 for the alignment offset).
inline size_t mixed_smem_bytes(int table_len, int buf_len, int frame_length, int64_t stride,
                               int group, int tile, bool stage_x) {
  return (size_t)(8 * (((int64_t)table_len + 1) / 2 * 2) + 16 * (int64_t)group * buf_len +
                  (stage_x ? 4 * round4(frame_length) +
                                 4 * round4((int64_t)(tile - 1) * stride + frame_length + 3)
                           : 0));
}

// Point t of the FFT input, windowed and folded modulo n_fft: even n_fft
// xw[2t] + i xw[2t+1] of frame xa; odd n_fft xw_a[t] + i xw_b[t] of frames
// xa and xb (null: zeros). Zero for every t >= L (Bluestein's padding).
// The frame and the window lie in shared memory (staged) or global memory.
// The fold loops run once where the frame is no longer than n_fft; they are
// not unrolled, which keeps the loop kernel within its registers.
template <bool ODD>
__device__ __forceinline__ float2 load_point(int t, const float* xa, const float* xb,
                                             const float* wins, int frame_length, int L) {
  float re = 0.0f, im = 0.0f;
  if (t >= L) return make_float2(re, im);
  if constexpr (ODD) {
#pragma unroll 1
    for (int i = t; i < frame_length; i += L) {
      if (xa != nullptr) re += xa[i] * wins[i];
      if (xb != nullptr) im += xb[i] * wins[i];
    }
  } else if (xa != nullptr) {
    // (x, window) pairs as 8-byte loads where the frame starts 8-byte
    // aligned (the window does); the same products either way
    const bool aligned = ((reinterpret_cast<uintptr_t>(xa) | reinterpret_cast<uintptr_t>(wins)) &
                          7) == 0;
#pragma unroll 1
    for (int i = 2 * t; i < frame_length; i += 2 * L) {
      if (i + 1 < frame_length && aligned) {
        const float2 xv = *reinterpret_cast<const float2*>(xa + i);
        const float2 wv = *reinterpret_cast<const float2*>(wins + i);
        re += xv.x * wv.x;
        im += xv.y * wv.y;
      } else {
        re += xa[i] * wins[i];
        if (i + 1 < frame_length) im += xa[i + 1] * wins[i + 1];
      }
    }
  }
  return make_float2(re, im);
}

// Where a pass takes its points: a later pass from the previous pass's
// output (times its twiddles); a first pass from the staged signal (the
// windowed frames), from the signal times the chirp w_t for t < L
// (Bluestein's first FFT), or as conj(in[t] S[t]) from the unpadded output
// of the first FFT and the filter spectrum S (Bluestein's second FFT). `tbl`
// is the pass's twiddles, the chirp, or S.
enum Source { kBuffer, kSignal, kChirped, kFiltered };

// One Stockham pass of radix R over M points after Ns have been combined:
// this thread's butterflies j = j0, j0 + G, ... < M/R read points j + r M/R
// (the previous pass's output index i is stored at i + (i / Ns) in_pad),
// take twiddle tbl[r Ns + j mod Ns] (later passes), and write their DFT to
// (j / Ns) (Ns R + out_pad) + j mod Ns + r Ns of out. M/R is a multiple of
// Ns, so point j + r M/R lies in group j / Ns + r M/(R Ns); (j / Ns, j mod
// Ns) advance by (G / Ns, G mod Ns) with a carry, one division per pass.
template <int R, int SRC, bool ODD, bool CL>
__device__ __forceinline__ void mixed_pass(const Buf<CL>& in, int in_pad, const Buf<CL>& out,
                                           int out_pad, const float2* tbl, const float* xa,
                                           const float* xb, const float* wins, int frame_length,
                                           int L, int M, int Ns, int G, int j0) {
  const int span = M / R;
  const int span_groups = span / Ns;
  const int stride_g = Ns * R + out_pad;
  const int dq = G / Ns, dr = G - dq * Ns;
  int g = j0 / Ns, jm = j0 - g * Ns;
  for (int j = j0; j < span; j += G) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = j + r * span;
      if constexpr (SRC == kSignal || SRC == kChirped) {
        v[r] = load_point<ODD>(t, xa, xb, wins, frame_length, L);
        if (SRC == kChirped && t < L) v[r] = cmul(v[r], tbl[t]);
      } else if constexpr (SRC == kFiltered) {
        const float2 c = cmul(in[t], tbl[t]);
        v[r] = make_float2(c.x, -c.y);
      } else {
        v[r] = in[t + (g + r * span_groups) * in_pad];
      }
    }
    if constexpr (SRC == kBuffer) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tbl[r * Ns + jm]);
    }
    dft<R>(v);
    const int o = g * stride_g + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) out[o + r * Ns] = v[r];
    g += dq;
    jm += dr;
    if (jm >= Ns) jm -= Ns, ++g;
  }
}

template <int SRC, bool ODD, bool CL>
__device__ __forceinline__ void run_mixed_pass(int R, const Buf<CL>& in, int in_pad,
                                               const Buf<CL>& out, int out_pad, const float2* tbl,
                                               const float* xa, const float* xb,
                                               const float* wins, int frame_length, int L, int M,
                                               int Ns, int G, int j0) {
#define NX_MIXED_PASS(RADIX)                                                                     \
  mixed_pass<RADIX, SRC, ODD, CL>(in, in_pad, out, out_pad, tbl, xa, xb, wins, frame_length, L,  \
                                  M, Ns, G, j0)
  switch (R) {
    case 13: NX_MIXED_PASS(13); break;
    case 11: NX_MIXED_PASS(11); break;
    case 9: NX_MIXED_PASS(9); break;
    case 8: NX_MIXED_PASS(8); break;
    case 7: NX_MIXED_PASS(7); break;
    case 5: NX_MIXED_PASS(5); break;
    case 4: NX_MIXED_PASS(4); break;
    case 3: NX_MIXED_PASS(3); break;
    default: NX_MIXED_PASS(2); break;
  }
#undef NX_MIXED_PASS
}

// One FFT of M points of this slot through every pass of the plan: the
// first from SRC (`first`: its chirp or filter spectrum; `in`: the buffer
// it reads, if any) into `out`, the rest between `out` and `spare` with the
// twiddles twp; on return `out` holds the result, unpadded, in natural
// order, and `spare` the other buffer (passed and swapped by value, so no
// buffer is chosen by a runtime index into an array).
template <int SRC, bool ODD, bool CL>
__device__ __forceinline__ void run_fft(const Buf<CL>& in, Buf<CL>& out, Buf<CL>& spare,
                                        const float2* first, const float2* twp, uint64_t plan,
                                        const float* xa, const float* xb, const float* wins,
                                        int frame_length, int L, int M, int G, int j0,
                                        int slot) {
  run_mixed_pass<SRC, ODD, CL>(plan_radix(plan, 0), in, 0, out, plan_pad(plan, 0), first, xa, xb,
                               wins, frame_length, L, M, 1, G, j0);
  int ns = plan_radix(plan, 0);
  for (int p = 1; p < kMaxPasses && plan_radix(plan, p) != 0; ++p) {
    fft_sync<CL>(slot, G);  // the previous pass's writes are visible
    const int R = plan_radix(plan, p);
    run_mixed_pass<kBuffer, ODD, CL>(R, out, plan_pad(plan, p - 1), spare, plan_pad(plan, p), twp,
                                     nullptr, nullptr, wins, frame_length, L, M, ns, G, j0);
    twp += ns * R;
    ns *= R;
    const Buf<CL> done = spare;
    spare = out;
    out = done;
  }
}

// Z[k] of the L-point transform from the last FFT's output: the output
// itself, or with Bluestein w_k conj(out[k]) (the inverse FFT's last conj
// and the chirp; the filter spectrum carries the 1/M)
template <bool BLUE, class S>
__device__ __forceinline__ float2 spectrum_at(const S& src, const float2* chirp, int k) {
  const float2 c = src[k];
  if constexpr (BLUE) return cmul(chirp[k], make_float2(c.x, -c.y));
  return c;
}

// The bins of one FFT's frames from Z (the unpadded output `src`): odd
// n_fft the separation of frames m (row, where `first`) and m+1 (row +
// bins, where `second`), even n_fft the split post-pass with the twiddles
// post_tw of frame m (where `first`); this thread takes k = j0, j0 + G, ...,
// so consecutive threads write consecutive bins.
template <bool POWER, bool ODD, bool BLUE, class S>
__device__ __forceinline__ void write_spectrum(const S& src, const float2* chirp,
                                               const float2* post_tw, void* out, int64_t row,
                                               bool first, bool second, int bins, int n_fft,
                                               int L, int G, int j0) {
  const bool full = bins == n_fft;
  // bin k (and L - k, even n_fft)
  auto bin = [&](int k) {
    const float2 a = spectrum_at<BLUE>(src, chirp, k);
    const float2 b = spectrum_at<BLUE>(src, chirp, k == 0 ? 0 : L - k);
    const float sr = a.x + b.x, si = a.y - b.y;  // Z[k] + conj Z[L-k]
    const float dr = a.x - b.x, di = a.y + b.y;  // Z[k] - conj Z[L-k]
    if constexpr (ODD) {
      // X_m[k] = (Z[k] + conj Z[n-k]) / 2, X_{m+1}[k] = (Z[k] - conj Z[n-k]) / (2i)
      if (first) put_bin<POWER>(out, row, k, 0.5f * sr, 0.5f * si, full && k >= 1, n_fft);
      if (second) put_bin<POWER>(out, row + bins, k, 0.5f * di, -0.5f * dr, full && k >= 1, n_fft);
    } else {
      // the split post-pass, as in framed_fft_kernel
      const float2 w = post_tw[k];
      const float pr = w.x * dr - w.y * di, pi = w.x * di + w.y * dr;
      put_bin<POWER>(out, row, k, 0.5f * (sr + pi), 0.5f * (si - pr), full && k >= 1, n_fft);
      if (L - k != k) {
        put_bin<POWER>(out, row, L - k, 0.5f * (sr - pi), -0.5f * (si + pr), full && k >= 1,
                       n_fft);
      }
    }
  };
  if (!ODD && !first) return;
  const int end = ODD ? (L + 1) / 2 : L / 2 + 1;  // k = 0..(n-1)/2 (odd), 0..L/2 (even)
  for (int k = j0; k < end; k += G) bin(k);
}

// CL false: `group` FFTs a CTA, each of G threads over a buffer pair of
// buf_len float2. CL true (a cluster of C = 1 << log_c CTAs launched with
// cudaLaunchKernelEx, blockIdx.x / C the tile): one FFT over the cluster's
// G = C * blockDim.x threads, each CTA holding `part` float2 of each
// buffer (`Buf`); the table, the frames and the window read from global
// memory. (launch bounds: four CTAs an SM, 64 registers a thread, for one
// CTA; one for a cluster's CTAs, whose buffer parts fill an SM's shared
// memory)
template <bool POWER, bool ODD, bool BLUE, bool STAGED, bool CL>
__global__ void __launch_bounds__(kThreads, CL ? 1 : 4)
framed_fft_mixed_kernel(const float* __restrict__ x, const float* __restrict__ win,
                        const float2* __restrict__ table, void* __restrict__ out, int64_t length,
                        int stride, int frame_length, int n_fft, int num_frames, int bins,
                        int tile, int group, uint64_t plan, int G, int buf_len, int table_len,
                        int M, int stage_x, int part, int log_c) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPer = ODD ? 2 : 1;  // frames per FFT
  const int L = ODD ? n_fft : n_fft / 2;
  float2* staged = reinterpret_cast<float2*>(smem);  // the table, STAGED
  float2* bufs = STAGED ? staged + (table_len + 1) / 2 * 2 : staged;
  // the window and the tile's samples: staged (stage_x) or in global memory
  float* wins_s = reinterpret_cast<float*>(bufs + (int64_t)group * 2 * buf_len);
  float* xs = wins_s + round4(frame_length);
  const float* wins = stage_x ? wins_s : win;
  // the table, in shared memory or read from global memory (L2): post-pass
  // twiddles (even n_fft), [chirp, filter spectrum], the passes' twiddles
  const float2* tbl = STAGED ? staged : table;
  const float2* chirp = tbl + (ODD ? 0 : L / 2 + 1);
  const float2* filt = chirp + L;
  const float2* twp = BLUE ? filt + M : chirp;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int64_t ch = blockIdx.y;
  const int m0 = (blockIdx.x >> log_c) * tile;
  const int m_end = min(num_frames, m0 + tile);
  const float* xw = x + ch * length + (int64_t)m0 * stride;  // sample m0 * stride
  if (!CL && stage_x) {
    xw = xs + stage_window(xs, x + ch * length, length, (int64_t)m0 * stride,
                           (int64_t)(m_end - 1) * stride + frame_length, tid, nthr);
    for (int i = tid; i < frame_length; i += nthr) wins_s[i] = win[i];
  }
  if constexpr (STAGED) {
    for (int i = tid; i < table_len; i += nthr) staged[i] = table[i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // x staged

  // each FFT's G threads run it and write its bins on their own: FFT slot
  // takes frames mg + kPer*slot (and the next, odd n_fft) of the tile
  const int slot = CL ? 0 : tid / G;
  int j0 = tid - slot * G;
  Buf<CL> buf_a, buf_b;
  buf_a.log_c = buf_b.log_c = log_c;
  if constexpr (CL) {
    // this CTA's parts of the two buffers; the cluster's CTAs have all
    // started before any reads another's memory
    cg::cluster_group cluster = cg::this_cluster();
    j0 += (int)cluster.block_rank() * nthr;
    buf_a.base = bufs;
    buf_b.base = bufs + part;
    cluster.sync();
  } else {
    buf_a.base = bufs + (int64_t)slot * 2 * buf_len;
    buf_b.base = buf_a.base + buf_len;
  }
  for (int mg = m0; mg < m_end; mg += group * kPer) {
    const int m = mg + slot * kPer;
    const float* xa = m < m_end ? xw + (int64_t)(m - m0) * stride : nullptr;
    const float* xb = ODD && m + 1 < m_end ? xa + stride : nullptr;
    Buf<CL> res = buf_a, spare = buf_b;
    run_fft<BLUE ? kChirped : kSignal, ODD, CL>(spare, res, spare, chirp, twp, plan, xa, xb, wins,
                                                frame_length, L, M, G, j0, slot);
    if constexpr (BLUE) {
      fft_sync<CL>(slot, G);
      const Buf<CL> first_out = res;  // the second FFT reads it, then ping-pongs with it
      res = spare;
      spare = first_out;
      run_fft<kFiltered, ODD, CL>(first_out, res, spare, filt, twp, plan, nullptr, nullptr, wins,
                                  frame_length, L, M, G, j0, slot);
    }
    fft_sync<CL>(slot, G);

    // the post-pass from Z
    write_spectrum<POWER, ODD, BLUE>(res, chirp, tbl, out,
                                     (ch * num_frames + m) * (int64_t)bins, m < m_end,
                                     ODD && m + 1 < m_end, bins, n_fft, L, G, j0);
    fft_sync<CL>(slot, G);  // the buffers are read before the next frames fill them
  }
}

// ---- the persistent loop kernel (a power-of-two M: the power-of-two n_fft
// past the small kernel's range, and Bluestein's power-of-two M)

// Threads of a CTA: kLoopThreads up to M = 2048 and for odd n_fft,
// kLoopWide (64 registers a thread) for M = 4096 and 8192
constexpr int kLoopThreads = 512;
constexpr int kLoopWide = 1024;
// Shared memory a CTA may take for the staged frames: two CTAs of
// kLoopThreads share an SM at 112 KB each
constexpr size_t kLoopBudget = 112 * 1024;

// One Stockham pass of radix R (8, 4 or 2) over this FFT's M-point buffer
// after Ns = 2^ns_log points have been combined: butterfly j = j0 + it G
// (it < IT, IT G = M/R) reads points j + r M/R (a later pass from the
// buffer, where the previous pass stored index t at t + (t / Ns) in_pad,
// times twiddle tbl[r Ns + j mod Ns]; a first pass from SRC as
// mixed_pass's), every read of the FFT's threads completes, then it writes
// its DFT to (j / Ns) (Ns R + out_pad) + j mod Ns + r Ns of the same buffer.
template <int R, int IT, int SRC, bool ODD>
__device__ __forceinline__ void loop_pass(float2* buf, int in_pad, int out_pad,
                                          const float2* tbl, const float* xa, const float* xb,
                                          const float* wins, int frame_length, int L, int M,
                                          int ns_log, int G, int j0, int slot) {
  const int ns = 1 << ns_log;
  const int span = M / R;
  const int stride_g = ns * R + out_pad;
  if constexpr (SRC == kSignal || SRC == kChirped) {
    // a first pass reads no buffer, so each butterfly is stored at once
    // (Ns = 1: output j R + r at j (R + out_pad) + r)
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int j = j0 + it * G;
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = j + r * span;
        v[r] = load_point<ODD>(t, xa, xb, wins, frame_length, L);
        if (SRC == kChirped && t < L) v[r] = cmul(v[r], tbl[t]);
      }
      dft<R>(v);
#pragma unroll
      for (int r = 0; r < R; ++r) buf[j * stride_g + r] = v[r];
    }
    return;
  }
  float2 v[IT][R];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int j = j0 + it * G;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = j + r * span;
      if constexpr (SRC == kFiltered) {
        const float2 c = cmul(buf[t], tbl[t]);
        v[it][r] = make_float2(c.x, -c.y);
      } else {
        v[it][r] = buf[t + (t >> ns_log) * in_pad];
      }
    }
    if constexpr (SRC == kBuffer) {
      const int jm = j & (ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[it][r] = cmul(v[it][r], tbl[r * ns + jm]);
    }
    dft<R>(v[it]);
  }
  slot_sync(slot, G);  // every read of this pass is done
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int j = j0 + it * G;
    float2* o = buf + (j >> ns_log) * stride_g + (j & (ns - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * ns] = v[it][r];
  }
}

// Radix 8, else the plan's last radix: LAST (8, 4 or 2) where M fixes it,
// 0 for 4 or 2 (the passes a kernel instance cannot meet are not compiled,
// so they take no registers)
template <int SRC, bool ODD, int LAST>
__device__ __forceinline__ void run_loop_pass(int R, float2* buf, int in_pad, int out_pad,
                                              const float2* tbl, const float* xa,
                                              const float* xb, const float* wins,
                                              int frame_length, int L, int M, int ns_log, int G,
                                              int j0, int slot) {
  if (R == 8 || LAST == 8) {
    loop_pass<8, 1, SRC, ODD>(buf, in_pad, out_pad, tbl, xa, xb, wins, frame_length, L, M,
                              ns_log, G, j0, slot);
  } else if (LAST != 2 && (LAST == 4 || R == 4)) {
    if constexpr (LAST != 2 && LAST != 8) {
      loop_pass<4, 2, SRC, ODD>(buf, in_pad, out_pad, tbl, xa, xb, wins, frame_length, L, M,
                                ns_log, G, j0, slot);
    }
  } else if constexpr (LAST != 4 && LAST != 8) {
    loop_pass<2, 4, SRC, ODD>(buf, in_pad, out_pad, tbl, xa, xb, wins, frame_length, L, M,
                              ns_log, G, j0, slot);
  }
}

// One FFT of M points through every pass of the plan in this slot's buffer:
// the first from SRC (`first`: its chirp or filter spectrum), the rest
// with the twiddles twp; the result, unpadded and in natural order, is in
// the buffer once the slot has synced.
template <int SRC, bool ODD, int LAST>
__device__ __forceinline__ void loop_fft(float2* buf, const float2* first, const float2* twp,
                                         uint64_t plan, const float* xa, const float* xb,
                                         const float* wins, int frame_length, int L, int M,
                                         int G, int j0, int slot) {
  int R = plan_radix(plan, 0);
  run_loop_pass<SRC, ODD, LAST>(R, buf, 0, plan_pad(plan, 0), first, xa, xb, wins,
                                frame_length, L, M, 0, G, j0, slot);
  int ns_log = __ffs(R) - 1;
  for (int p = 1; p < kMaxPasses && plan_radix(plan, p) != 0; ++p) {
    slot_sync(slot, G);  // the previous pass's writes are visible
    R = plan_radix(plan, p);
    run_loop_pass<kBuffer, ODD, LAST>(R, buf, plan_pad(plan, p - 1), plan_pad(plan, p), twp,
                                      nullptr, nullptr, wins, frame_length, L, M, ns_log, G, j0,
                                      slot);
    twp += R << ns_log;
    ns_log += __ffs(R) - 1;
  }
}

// Stages the samples of item `item` (channel item / tiles, frames from
// (item mod tiles) * tile) into dst and commits the copies as one group.
__device__ __forceinline__ void stage_item(float* dst, const float* x, int64_t item,
                                           int64_t tiles, int tile, int64_t length, int stride,
                                           int frame_length, int num_frames, int tid, int nthr) {
  const int64_t ch = item / tiles;
  const int m0 = (int)(item - ch * tiles) * tile;
  const int m_end = min(num_frames, m0 + tile);
  stage_window(dst, x + ch * length, length, (int64_t)m0 * stride,
               (int64_t)(m_end - 1) * stride + frame_length, tid, nthr);
}

// M / 8 threads per FFT, each one radix-8 butterfly of a pass (two of radix
// 4, four of radix 2), THREADS / that FFTs at once: THREADS kLoopThreads (at
// most 128 registers a thread; a floor of two CTAs an SM, 64 registers,
// spills the odd-n_fft instances) up to M = 2048 and for odd n_fft,
// kLoopWide (64 registers) at M = 4096 (LAST 8) and 8192 (LAST 2). The
// twiddles are read from the table in global memory (L2); `slot_len` floats
// per staged x slot (0: the frames and the window read from global memory).
template <bool POWER, bool ODD, bool BLUE, int THREADS, int LAST>
__global__ void __launch_bounds__(THREADS, 1)
framed_fft_loop_kernel(const float* __restrict__ x, const float* __restrict__ win,
                       const float2* __restrict__ table, void* __restrict__ out, int64_t length,
                       int stride, int frame_length, int n_fft, int num_frames, int bins,
                       int64_t channels, int tile, uint64_t plan, int M, int buf_len,
                       int slot_len) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPer = ODD ? 2 : 1;  // frames per FFT
  const int L = ODD ? n_fft : n_fft / 2;
  const int G = M / 8;
  const int group = blockDim.x / G;
  const int post_len = ODD ? 0 : L / 2 + 1;
  // the table: post-pass twiddles (even n_fft), [chirp, filter spectrum],
  // the passes' twiddles
  const float2* chirp = table + post_len;
  const float2* filt = chirp + L;
  const float2* twp = BLUE ? filt + M : chirp;
  float2* bufs = reinterpret_cast<float2*>(smem);
  float* wins_s = reinterpret_cast<float*>(bufs + ((int64_t)group * buf_len + 1) / 2 * 2);
  float* xs = wins_s + round4(frame_length);  // two slots of slot_len floats
  const bool stage_x = slot_len > 0;
  const float* wins = stage_x ? wins_s : win;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int64_t tiles = (num_frames + tile - 1) / tile;
  const int64_t items = channels * tiles;
  int64_t item = blockIdx.x;
  if (stage_x) {
    for (int i = tid; i < frame_length; i += nthr) wins_s[i] = win[i];
    if (item < items) {
      stage_item(xs, x, item, tiles, tile, length, stride, frame_length, num_frames, tid, nthr);
    }
  }
  __syncthreads();  // the window is in place

  // each FFT's G threads run it and write its bins on their own: FFT slot
  // takes frames mg + kPer*slot (and the next, odd n_fft) of the item
  const int slot = tid / G;
  const int j0 = tid - slot * G;
  float2* const buf = bufs + (int64_t)slot * buf_len;
  for (int k = 0; item < items; ++k, item += gridDim.x) {
    const int64_t ch = item / tiles;
    const int m0 = (int)(item - ch * tiles) * tile;
    const int m_end = min(num_frames, m0 + tile);
    const float* xw = x + ch * length + (int64_t)m0 * stride;  // sample m0 * stride
    if (stage_x) {
      // the next item's samples into the other slot, while this one runs
      const int64_t next = item + gridDim.x;
      if (next < items) {
        stage_item(xs + ((k + 1) & 1) * slot_len, x, next, tiles, tile, length, stride,
                   frame_length, num_frames, tid, nthr);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();  // this item's samples are staged
      xw = xs + (k & 1) * slot_len + ((reinterpret_cast<uintptr_t>(xw) >> 2) & 3);
    }
    for (int mg = m0; mg < m_end; mg += group * kPer) {
      const int m = mg + slot * kPer;
      const float* xa = m < m_end ? xw + (int64_t)(m - m0) * stride : nullptr;
      const float* xb = ODD && m + 1 < m_end ? xa + stride : nullptr;
      loop_fft<BLUE ? kChirped : kSignal, ODD, LAST>(buf, chirp, twp, plan, xa, xb, wins,
                                                     frame_length, L, M, G, j0, slot);
      if constexpr (BLUE) {
        slot_sync(slot, G);
        loop_fft<kFiltered, ODD, LAST>(buf, filt, twp, plan, nullptr, nullptr, wins,
                                       frame_length, L, M, G, j0, slot);
      }
      slot_sync(slot, G);
      write_spectrum<POWER, ODD, BLUE>(buf, chirp, table, out,
                                       (ch * num_frames + m) * (int64_t)bins, m < m_end,
                                       ODD && m + 1 < m_end, bins, n_fft, L, G, j0);
      slot_sync(slot, G);  // the buffer is read before the next frames fill it
    }
    if (stage_x) __syncthreads();  // the slot is read before it is refilled
  }
}

// Whether a packed plan covers M points: radices 2, 3, 4, 5, 7, 8, 9, 11 or
// 13 whose product is M, zero bytes after the last pass, no padding on the
// last.
inline bool valid_plan(uint64_t plan, int M) {
  int64_t prod = 1;
  int passes = 0;
  while (passes < kMaxPasses && plan_radix(plan, passes) != 0) {
    const int r = plan_radix(plan, passes);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 9 && r != 11 &&
        r != 13) {
      return false;
    }
    prod *= r;
    ++passes;
  }
  return passes > 0 && prod == M && (passes == kMaxPasses || (plan >> (8 * passes)) == 0) &&
         plan_pad(plan, passes - 1) == 0;
}

// Shared memory of a loop-kernel CTA: the FFT buffers of `group` FFTs (an
// even count, so what follows stays 16-byte aligned), and where x is staged
// (slot_len > 0) the window and two slots of slot_len floats.
inline size_t loop_smem_bytes(int group, int buf_len, int frame_length, int64_t slot_len) {
  return (size_t)(8 * (((int64_t)group * buf_len + 1) / 2 * 2) +
                  (slot_len > 0 ? 4 * round4(frame_length) + 8 * slot_len : 0));
}

}  // namespace

// x (channels, length) f32, win (frame_length) f32, out (channels,
// num_frames, bins) complex64 (as float2) or, with power, f32; all
// contiguous on the current device; any frame_length (folded modulo n_fft
// past it), bins n_fft/2 + 1 or n_fft, every frame inside the signal,
// n_fft in [8, 65536]. plan 0: n_fft a power of two up to 1024 and tw the
// (n_fft) float2 table exp(-2 pi i t / n_fft) (framed_fft_kernel; points
// 0). Else the packed pass plan of M = `points` (byte p: radix | pad << 4)
// and its float2 table, from kernels/dft.py: _fft_plan for a 13-smooth
// n_fft (M = L) or _bluestein_plan for any n_fft (2L - 1 <= M <= 131072);
// a power-of-two M to 8192 (4096 for odd n_fft) runs
// framed_fft_loop_kernel, any other framed_fft_mixed_kernel, on a cluster
// of up to 16 CTAs where one CTA does not hold its two buffers. Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int nx_framed_fft_f32(const void* x, const void* win, const void* tw, void* out,
                                 int64_t channels, int64_t length, int64_t stride,
                                 int64_t frame_length, int64_t n_fft, int64_t num_frames,
                                 int64_t bins, int64_t plan, int64_t points, int64_t power,
                                 void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (channels < 1 || stride < 1 || stride > kIntMax || n_fft < kMinFft || n_fft > kMaxFft ||
      frame_length < 1 || frame_length > kIntMax || num_frames < 1 || num_frames > kIntMax ||
      (bins != n_fft / 2 + 1 && bins != n_fft) ||
      (num_frames - 1) * stride + frame_length > length) {
    return (int)cudaErrorInvalidValue;
  }
  const int fft = (int)n_fft, fl = (int)frame_length;
  const bool pow2 = plan == 0;  // framed_fft_kernel
  const bool odd = (fft & 1) != 0;
  const int L = odd ? fft : fft / 2;  // points of the complex transform
  const bool blue = !pow2 && points != L;
  const uint64_t packed = (uint64_t)plan;
  if (pow2 ? (fft & (fft - 1)) != 0 || fft > kMaxSmallFft || points != 0
           : L > kMaxPoints / 2 || points < 1 || points > kMaxPoints ||
                 (blue && points < 2 * L - 1) || !valid_plan(packed, (int)points)) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = pow2 ? L : (int)points;
  // a power-of-two M runs the loop kernel up to 8192 points (4096 for odd
  // n_fft), every other M the mixed kernel, over a cluster where one CTA
  // does not hold its two buffers
  const bool loop = !pow2 && (M & (M - 1)) == 0 && M >= 8 && M <= (odd ? 4096 : 8192);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(win);
  const float2* tf = static_cast<const float2*>(tw);
  const size_t out_elem = power ? sizeof(float) : 2 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (loop) {
    // the kernel's shape (see framed_fft_loop_kernel): threads a CTA, M / 8
    // threads per FFT, group FFTs at once; the plan's passes are radix 8
    // but the last; items of `tile` frames (a multiple of group * per),
    // staged in two slots where they fit kLoopBudget, else one round of
    // FFTs each with the frames read from global memory
    for (int p = 0; p + 1 < kMaxPasses && plan_radix(packed, p + 1) != 0; ++p) {
      if (plan_radix(packed, p) != 8) return (int)cudaErrorInvalidValue;
    }
    const int threads = M <= 2048 || odd ? kLoopThreads : kLoopWide;
    const int G = M / 8;
    const int group = threads / G;
    const int per = odd ? 2 : 1, step = group * per;
    const int buf_len = mixed_buf_len(packed, M);
    auto slot_of = [&](int t) { return round4((int64_t)(t - 1) * stride + fl + 3); };
    int tile = step;
    int64_t slot_len = 0;
    if (loop_smem_bytes(group, buf_len, fl, slot_of(step)) <= kLoopBudget) {
      tile = step * (kTileTarget > step ? kTileTarget / step : 1);
      while (tile > step && loop_smem_bytes(group, buf_len, fl, slot_of(tile)) > kLoopBudget) {
        tile = step * ((tile / step + 1) / 2);
      }
      slot_len = slot_of(tile);
    }
    const size_t smem = loop_smem_bytes(group, buf_len, fl, slot_len);
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int64_t items = channels * ((num_frames + tile - 1) / tile);
    auto launch = [&](auto kernel) -> int {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      const int64_t grid = items < (int64_t)per_sm * sms ? items : (int64_t)per_sm * sms;
      kernel<<<(unsigned)grid, threads, smem, s>>>(
          xf, wf, tf, out, length, (int)stride, fl, fft, (int)num_frames, (int)bins, channels,
          tile, packed, M, buf_len, (int)slot_len);
      return (int)cudaGetLastError();
    };
#define NX_LOOP(POWER, ODD, BLUE)                                                   \
  (threads == kLoopThreads                                                          \
       ? launch(framed_fft_loop_kernel<POWER, ODD, BLUE, kLoopThreads, 0>)          \
       : M == 4096 ? launch(framed_fft_loop_kernel<POWER, ODD, BLUE, kLoopWide, 8>) \
                   : launch(framed_fft_loop_kernel<POWER, ODD, BLUE, kLoopWide, 2>))
    if (odd) {
      if (!blue) return (int)cudaErrorInvalidValue;
      return power ? launch(framed_fft_loop_kernel<true, true, true, kLoopThreads, 0>)
                   : launch(framed_fft_loop_kernel<false, true, true, kLoopThreads, 0>);
    }
    return blue ? (power ? NX_LOOP(true, false, true) : NX_LOOP(false, false, true))
                : (power ? NX_LOOP(true, false, false) : NX_LOOP(false, false, false));
#undef NX_LOOP
  }

  // FFTs at once (group, each of `per` frames) and frames per CTA (tile, a
  // multiple of group * per): up to kTileTarget frames within the budget,
  // fewer where the staged window or the FFT buffers need it. The mixed
  // kernel stages its table up to NX_FFT_L2_TABLE_POINTS points where that
  // leaves room for one FFT and its frames, else reads it from global
  // memory, and reads the frames and the window from global memory where
  // staging them beside one FFT's buffers takes more than half an SM's
  // shared memory.
  const int per_fft = pow2 ? threads_per_frame(L) : mixed_threads(M, blue);
  const int per = odd ? 2 : 1;
  const int buf_len = pow2 ? 0 : mixed_buf_len(packed, M);
  const int table_len = pow2 ? 0 : mixed_table_len(packed, L, M, odd);
  bool staged = true, stage_x = true;
  auto bytes = [&](int group, int tile) {
    return pow2 ? smem_bytes(fft, fl, stride, group, tile)
                : mixed_smem_bytes(staged ? table_len : 0, buf_len, fl, stride, group, tile,
                                   stage_x);
  };
  if (!pow2 && (M > NX_FFT_L2_TABLE_POINTS || bytes(1, per) > (size_t)max_smem)) {
    staged = false;
  }
  // the frames and the window from global memory where staging them would
  // leave one CTA an SM (or not fit)
  if (!pow2 && bytes(1, per) > (size_t)max_smem / 2) stage_x = false;
  int group = kThreads / per_fft;
  int step = group * per;
  int tile = step * (kTileTarget > step ? kTileTarget / step : 1);
  while (tile > step && bytes(group, tile) > kSmemBudget) tile = step * ((tile / step + 1) / 2);
  while (group > 1 && bytes(group, tile) > (size_t)max_smem) {
    group /= 2;
    step = group * per;
    tile = step;
  }
  size_t smem = bytes(group, tile);
  // where one FFT's buffer pair does not fit a CTA, a cluster of C = 2, 4,
  // 8 or 16 CTAs shares it, `part` float2 of each buffer in each CTA
  // (whole runs, cluster_part), one FFT of C * per_fft threads a tile of
  // `per` frames
  int C = 1, log_c = 0, part = 0, G = per_fft;
  if (!pow2 && smem > (size_t)max_smem) {
    staged = stage_x = false;
    for (C = 2, log_c = 1; C <= kMaxCluster; C *= 2, ++log_c) {
      part = cluster_part(buf_len, log_c);
      if (16 * (size_t)part <= (size_t)max_smem) break;
    }
    group = 1;
    tile = per;
    smem = 16 * (size_t)part;
    G = C * per_fft;
  }
  if (C > kMaxCluster || smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;

  const dim3 block(group * per_fft);
  // the kernel's own arguments follow the shared ones
  auto launch = [&](auto kernel, auto... own) -> int {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (C > 8) {  // past the portable cluster size
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridY) {
      const int64_t nc = channels - c0 < kMaxGridY ? channels - c0 : kMaxGridY;
      const dim3 grid((unsigned)((num_frames + tile - 1) / tile * C), (unsigned)nc);
      const float* xc = xf + c0 * length;
      void* oc = static_cast<char*>(out) + c0 * num_frames * bins * out_elem;
      if (C == 1) {
        kernel<<<grid, block, smem, s>>>(xc, wf, tf, oc, length, (int)stride, fl, fft,
                                         (int)num_frames, (int)bins, tile, group, own...);
        e = cudaGetLastError();
      } else {
        cudaLaunchConfig_t config = {};
        config.gridDim = grid;
        config.blockDim = block;
        config.dynamicSmemBytes = smem;
        config.stream = s;
        cudaLaunchAttribute cluster[1];
        cluster[0].id = cudaLaunchAttributeClusterDimension;
        cluster[0].val.clusterDim.x = C;
        cluster[0].val.clusterDim.y = 1;
        cluster[0].val.clusterDim.z = 1;
        config.attrs = cluster;
        config.numAttrs = 1;
        e = cudaLaunchKernelEx(&config, kernel, xc, wf, tf, oc, length, (int)stride, fl, fft,
                               (int)num_frames, (int)bins, tile, group, own...);
      }
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaSuccess;
  };
  if (pow2) {
    const bool warp_sync = per_fft <= 32;
    return launch(power ? (warp_sync ? framed_fft_kernel<true, true>
                                     : framed_fft_kernel<true, false>)
                        : (warp_sync ? framed_fft_kernel<false, true>
                                     : framed_fft_kernel<false, false>));
  }
#define NX_MIXED_AT(POWER, ODD, BLUE, STAGED, CL)                                   \
  launch(framed_fft_mixed_kernel<POWER, ODD, BLUE, STAGED, CL>, packed, G, buf_len, \
         table_len, M, (int)stage_x, part, log_c)
#define NX_MIXED(POWER, ODD, BLUE)                                                       \
  (C > 1 ? NX_MIXED_AT(POWER, ODD, BLUE, false, true)                                    \
         : staged ? NX_MIXED_AT(POWER, ODD, BLUE, true, false)                           \
                  : NX_MIXED_AT(POWER, ODD, BLUE, false, false))
  if (blue) {
    return power ? (odd ? NX_MIXED(true, true, true) : NX_MIXED(true, false, true))
                 : (odd ? NX_MIXED(false, true, true) : NX_MIXED(false, false, true));
  }
  return power ? (odd ? NX_MIXED(true, true, false) : NX_MIXED(true, false, false))
               : (odd ? NX_MIXED(false, true, false) : NX_MIXED(false, false, false));
#undef NX_MIXED
#undef NX_MIXED_AT
}

// Kernel B-ifft. z (frames, zbins) complex64 (as float2), win
// (frame_length) f32, tw the (n_fft) float2 table exp(-2 pi i t / n_fft) of
// framed_fft_kernel, out (frames, frame_length) f32; all contiguous on the
// current device; n_fft a power of two from 8 to 1024, 1 <= frame_length <=
// n_fft, any zbins >= 0 (bins past n_fft/2 are not read, bins past zbins
// are zeros). Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
extern "C" int nx_framed_ifft_f32(const void* z, const void* win, const void* tw, void* out,
                                  int64_t frames, int64_t zbins, int64_t frame_length,
                                  int64_t n_fft, void* stream) {
  if (frames < 1 || zbins < 0 || zbins > 0x7fffffff || n_fft < kMinFft ||
      n_fft > kMaxSmallFft || (n_fft & (n_fft - 1)) != 0 || frame_length < 1 ||
      frame_length > n_fft) {
    return (int)cudaErrorInvalidValue;
  }
  const int fft = (int)n_fft;
  const int per_fft = threads_per_frame(fft / 2);
  const int group = kThreads / per_fft;
  const int tile = group * kIfftRounds;
  const size_t smem = ifft_smem_bytes(fft, (int)frame_length, group);
  const int64_t blocks = (frames + tile - 1) / tile;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel) -> int {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)blocks, group * per_fft, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(z), static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out), frames, 1.0f / (float)fft,
        (int)zbins, (int)frame_length, fft, tile, group);
    return (int)cudaGetLastError();
  };
  return per_fft <= 32 ? launch(framed_ifft_kernel<true>) : launch(framed_ifft_kernel<false>);
}
