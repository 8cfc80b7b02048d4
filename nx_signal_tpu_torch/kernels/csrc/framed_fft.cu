// Hopper kernel B (power-of-two n_fft): the windowed framed DFT as one real
// FFT per frame, in shared memory.
//
// Replaces (TPU kernel of the JAX package):
//   nx_signal_tpu/kernels/pallas_dft.py:framed_dft_pallas
// for n_fft a power of two from 8 to 1024; other n_fft keep the dense
// contraction of framed_dft.cu.
//
// For channel c and frame m (0 <= m < num_frames), with
//   xw[i] = x[c, m*stride + i] * win[i] for i < frame_length, 0 up to n_fft,
//   X[k] = sum_i xw[i] exp(-2 pi i k i / n_fft),
// out[c, m, k] is X[k] (complex64 as interleaved float2) or, with POWER,
// re^2 + im^2 (f32), for the bins = n_fft/2 + 1 (onesided) or n_fft bins.
//
// The transform: the real frame of n = n_fft becomes one complex FFT of
// h = n/2 points, z[j] = xw[2j] + i xw[2j+1] (the window multiply fused
// into the load), run as Stockham autosort passes of radix 8 (a last pass
// of radix 4 or 2 where log2 h is not a multiple of 3) with the butterflies
// in registers and one shared-memory exchange per pass; then the split
// post-pass
//   X[k] = (Z[k] + conj Z[h-k]) / 2 - i W^k (Z[k] - conj Z[h-k]) / 2,
//   W = exp(-2 pi i / n), k = 0..h (indices mod h), X[n-k] = conj X[k],
// which forms X[k] and X[h-k] from the same two values and one twiddle.
// Twiddles come from the (n_fft) float2 table exp(-2 pi i t / n_fft) the
// host builds in f64. Each CTA copies it, and lays out the entries each
// Stockham pass after the first reads, exp(-2 pi i jm r / (Ns R)) at r*Ns +
// jm, so that a warp's twiddle loads hit consecutive addresses.
//
// What bounds it on the H100: bytes. Per input sample it moves 4 B in and
// 8 * bins / stride B out (complex64), against about 2.5 n log2 n / stride
// FLOP (~90 at n = 512, hop 128), far below the card's ratio. So:
//   * One CTA per (channel, tile of frames). It stages the tile's window of
//     x once with 16-byte cp.async where the alignment allows, so each
//     sample is read from device memory about once, not once per frame.
//   * h/8 threads per frame, several frames per CTA at once; each pass
//     reads and writes each value once in shared memory (index i stored at
//     i + i/8, which spreads the radix-8 strides over the banks). A frame's
//     threads wait only for each other: for n_fft <= 512 they are one warp
//     (or part of one), so the passes sync with __syncwarp and the warps of
//     a CTA never wait for each other after the staging.
//   * The output is written straight into the complex64 tensor, consecutive
//     threads on consecutive bins (no stacked [Re | Im] and no copy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinFft = 8;
constexpr int kMaxFft = 1024;
constexpr int kTileTarget = 32;                 // frames per CTA where they fit
constexpr size_t kSmemBudget = 96 * 1024;       // keeps two or more CTAs per SM
constexpr int64_t kMaxGridY = 65535;

__host__ __device__ inline int pad_index(int i) { return i + (i >> 3); }
__host__ __device__ inline int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

// threads per frame (each holds min(h, 8) values) and the padded h
__host__ __device__ inline int threads_per_frame(int h) { return h >= 8 ? h >> 3 : 1; }
__host__ __device__ inline int padded_len(int h) { return h + (h >> 3); }

// Shared memory of a CTA: twiddles and the passes' twiddle tables (n_fft
// float2 each), the FFT buffers of `group` frames (an even count of float2,
// so what follows stays 16-byte aligned), the window, and the staged x
// window of `tile` frames (+3 for the alignment offset).
inline size_t smem_bytes(int n_fft, int frame_length, int64_t stride, int group, int tile) {
  const int64_t bufs = ((int64_t)group * padded_len(n_fft / 2) + 1) / 2 * 2;
  return (size_t)(16 * (int64_t)n_fft + 8 * bufs + 4 * round4(frame_length) +
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

// One Stockham pass of radix R over this frame's h-point buffer, after Ns
// points have been combined: thread j0 takes butterflies j = j0 + it*G.
// The first pass (Ns = 1, no twiddles) loads the windowed frame from the
// staged x; the others take their twiddles from the pass's table `twp`
// (entry r*Ns + j mod Ns), read the buffer, wait for every read, then write.
template <int R, int ITERS, bool FIRST, bool WARP_SYNC>
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
      if constexpr (FIRST) {
        // (x, window) pairs as 8-byte loads where the frame starts 8-byte
        // aligned in the staged window (the window itself is)
        const int i0 = 2 * n;
        float re = 0.0f, im = 0.0f;
        if (xf != nullptr && i0 + 1 < frame_length) {
          if ((reinterpret_cast<uintptr_t>(xf) & 7) == 0) {
            const float2 xv = *reinterpret_cast<const float2*>(xf + i0);
            const float2 wv = *reinterpret_cast<const float2*>(wins + i0);
            re = xv.x * wv.x;
            im = xv.y * wv.y;
          } else {
            re = xf[i0] * wins[i0];
            im = xf[i0 + 1] * wins[i0 + 1];
          }
        } else if (xf != nullptr && i0 < frame_length) {
          re = xf[i0] * wins[i0];
        }
        v[it][r] = make_float2(re, im);
      } else {
        v[it][r] = fbuf[pad_index(n)];
      }
    }
    if constexpr (!FIRST) {
      const int jm = j & (Ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[it][r] = cmul(v[it][r], twp[r * Ns + jm]);
    }
    dft<R>(v[it]);
  }
  if constexpr (!FIRST) frame_sync<WARP_SYNC>();  // every read of this pass is done
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = j0 + it * G;
    const int jm = j & (Ns - 1);
    const int base = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) fbuf[pad_index(base + r * Ns)] = v[it][r];
  }
}

template <bool FIRST, bool WARP_SYNC>
__device__ __forceinline__ void run_pass(int R, float2* fbuf, const float2* twp, const float* xf,
                                         const float* wins, int frame_length, int h, int Ns,
                                         int G, int j0) {
  if (R == 8) {
    fft_pass<8, 1, FIRST, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
  } else if (R == 4) {
    if (h >= 8) {
      fft_pass<4, 2, FIRST, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
    } else {
      fft_pass<4, 1, FIRST, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
    }
  } else {
    fft_pass<2, 4, FIRST, WARP_SYNC>(fbuf, twp, xf, wins, frame_length, h, Ns, G, j0);
  }
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
  float2* twp = tws + n_fft;  // the passes' tables, one after another
  float2* bufs = twp + n_fft;
  float* wins = reinterpret_cast<float*>(bufs + ((int64_t)group * hp + 1) / 2 * 2);
  float* xs = wins + round4(frame_length);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int64_t ch = blockIdx.y;
  const int m0 = blockIdx.x * tile;
  const int m_end = min(num_frames, m0 + tile);

  // the tile's window of x: samples [m0*stride, (m_end-1)*stride + frame),
  // staged from the 16-byte boundary at or below its start
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride;
  const int64_t s_end = (int64_t)(m_end - 1) * stride + frame_length;
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
  for (int i = tid; i < n_fft; i += nthr) tws[i] = tw[i];
  const int r1 = h < 8 ? h : 8;
  for (int Ns = r1, off = 0; Ns < h;) {
    const int R = h / Ns < 8 ? h / Ns : 8;  // exp(-2 pi i jm r / (Ns R))
    for (int i = tid; i < Ns * R; i += nthr) {
      const int r = i / Ns, jm = i - r * Ns;
      twp[off + i] = tw[2 * jm * r * (h / (Ns * R))];
    }
    off += Ns * R;
    Ns *= R;
  }
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
    run_pass<true, WARP_SYNC>(r1, fbuf, nullptr, xf, wins, frame_length, h, 1, G, j0);
    for (int Ns = r1, off = 0; Ns < h;) {
      frame_sync<WARP_SYNC>();  // the previous pass's writes are visible
      const int R = h / Ns < 8 ? h / Ns : 8;
      run_pass<false, WARP_SYNC>(R, fbuf, twp + off, nullptr, wins, frame_length, h, Ns, G, j0);
      off += Ns * R;
      Ns *= R;
    }
    frame_sync<WARP_SYNC>();

    // the split post-pass, X[k] and X[h-k] from the same Z[k], Z[h-k] and
    // W^k (W^(h-k) = -conj W^k), k = 0..h/2; the full spectrum adds
    // X[n-k] = conj X[k]. Consecutive threads write consecutive bins.
    if (m < m_end) {
      const int64_t row = (ch * num_frames + m) * (int64_t)bins;
      const bool full = bins == n_fft;
      auto emit = [&](int k, float re, float im) {
        if constexpr (POWER) {
          const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
          static_cast<float*>(out)[row + k] = p;
          if (full && k >= 1 && k < h) static_cast<float*>(out)[row + n_fft - k] = p;
        } else {
          static_cast<float2*>(out)[row + k] = make_float2(re, im);
          if (full && k >= 1 && k < h) {
            static_cast<float2*>(out)[row + n_fft - k] = make_float2(re, -im);
          }
        }
      };
      for (int k = j0; k <= (h >> 1); k += G) {
        const float2 a = fbuf[pad_index(k & (h - 1))];        // Z[k]
        const float2 b = fbuf[pad_index((h - k) & (h - 1))];  // Z[h-k]
        const float sr = a.x + b.x, si = a.y - b.y;           // Z[k] + conj Z[h-k]
        const float dr = a.x - b.x, di = a.y + b.y;           // Z[k] - conj Z[h-k]
        const float2 w = tws[k];
        const float pr = w.x * dr - w.y * di, pi = w.x * di + w.y * dr;
        emit(k, 0.5f * (sr + pi), 0.5f * (si - pr));
        if (h - k != k) emit(h - k, 0.5f * (sr - pi), -0.5f * (si + pr));
      }
    }
    frame_sync<WARP_SYNC>();  // the buffer is read before the next frame fills it
  }
}

}  // namespace

// x (channels, length) f32, win (frame_length) f32, tw (n_fft) float2 =
// exp(-2 pi i t / n_fft), out (channels, num_frames, bins) complex64 (as
// float2) or, with power, f32; all contiguous on the current device. n_fft
// a power of two in [8, 1024], frame_length <= n_fft, bins n_fft/2 + 1 or
// n_fft, every frame inside the signal. Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
extern "C" int nx_framed_fft_f32(const void* x, const void* win, const void* tw, void* out,
                                 int64_t channels, int64_t length, int64_t stride,
                                 int64_t frame_length, int64_t n_fft, int64_t num_frames,
                                 int64_t bins, int64_t power, void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (channels < 1 || stride < 1 || stride > kIntMax || n_fft < kMinFft || n_fft > kMaxFft ||
      (n_fft & (n_fft - 1)) != 0 || frame_length < 1 || frame_length > n_fft ||
      num_frames < 1 || num_frames > kIntMax ||
      (bins != n_fft / 2 + 1 && bins != n_fft) ||
      (num_frames - 1) * stride + frame_length > length) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;

  // frames at once (group) and per CTA (tile, a multiple of group): up to
  // 64 frames within the budget, fewer where the staged window needs it
  const int fft = (int)n_fft, fl = (int)frame_length;
  const int per_frame = threads_per_frame(fft / 2);
  int group = kThreads / per_frame;
  int tile = group * (kTileTarget > group ? kTileTarget / group : 1);
  while (tile > group && smem_bytes(fft, fl, stride, group, tile) > kSmemBudget) {
    tile = group * ((tile / group + 1) / 2);
  }
  while (group > 1 && smem_bytes(fft, fl, stride, group, tile) > (size_t)max_smem) {
    group /= 2;
    tile = group;
  }
  const size_t smem = smem_bytes(fft, fl, stride, group, tile);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;

  const bool warp_sync = per_frame <= 32;
  auto kernel = power ? (warp_sync ? framed_fft_kernel<true, true> : framed_fft_kernel<true, false>)
                      : (warp_sync ? framed_fft_kernel<false, true>
                                   : framed_fft_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const size_t out_elem = power ? sizeof(float) : 2 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(group * per_frame);
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridY) {
    const int64_t nc = channels - c0 < kMaxGridY ? channels - c0 : kMaxGridY;
    const dim3 grid((unsigned)((num_frames + tile - 1) / tile), (unsigned)nc);
    kernel<<<grid, block, smem, s>>>(
        xf + c0 * length, static_cast<const float*>(win), static_cast<const float2*>(tw),
        static_cast<char*>(out) + c0 * num_frames * bins * out_elem, length, (int)stride, fl,
        fft, (int)num_frames, (int)bins, tile, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return cudaSuccess;
}
