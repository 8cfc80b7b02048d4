// Hopper kernel M: Whisper's log-mel tail (openai/whisper audio.py:
// log_mel_spectrogram, the floor per clip) straight from a complex64
// spectrum, in exact f32.
//
// Replaces no TPU kernel: the JAX package's log-mel is a dense product and
// elementwise XLA ops. It was added because on the card that tail was about
// ten torch passes over device memory (a complex abs through a temporary,
// the square, a dense exact-f32 product over a filterbank that is 98%
// zeros, then clamp, log10, the clip's max, the floor, + 4 and / 4), where
// the work needs one read of z and one write of the result.
//
// For clip c, mel m and frame f < frames (the spectrum's last frame, f =
// frames, is never read):
//   p[f, b]    = re^2 + im^2 of z[c, f, b]          (fmaf(re, re, im * im))
//   e[m, f]    = sum over the band of m of w[k] p[f, first[m] + k], k = 0..count[m]-1
//                in increasing k, fmaf in f32 (no TF32, no tensor cores)
//   v[m, f]    = log10(max(e, 1e-10))               (a NaN stays NaN, as torch.clamp)
//   top[c]     = max over m, f of v                  (a NaN wins, as torch.amax)
//   out[c,m,f] = (max(v, top[c] - 8) + 4) / 4        (a NaN wins, as torch.maximum)
// Each Slaney row's nonzeros are one run of bins (first[m], count[m]; count
// 0 for an empty row), their weights packed at offset[m] (the band table,
// kernels/cuda_mel.py:mel_bands).
//
// What bounds it on the H100: device memory. Per call of 512 x 3001 x 201
// complex64 z (2.47 GB) and a (512, 128, 3000) f32 output (0.79 GB), reading
// z and writing the output once is 3.26 GB, 0.97 ms at 3.35 TB/s; the
// arithmetic (2 x 394 nonzeros a frame, one log10 a value) is a few percent
// of that. The floor needs the clip's max, known only once every tile of the
// clip is done, so the floor is a second pass over the clip's output, made
// by the clip's last CTA so that it reads what the 50 MB L2 still holds of
// it. (On an H100 80GB HBM3 at 700 W the floor in a kernel of its own took
// 0.51 ms a call, the whole 1.97-2.09 ms against 1.86-2.04 ms so; 60
// registers a thread, 4 CTAs an SM, ran faster than 32 and 8.)
//
// One CTA per (clip, tile of kFrames frames): the tile of z is one
// contiguous run of float2, read once with streaming 16-byte loads (an odd
// clip's tile starts 8-byte aligned, since a frame is 201 x 8 B: its first
// value is read alone), turned into power in shared memory as
// [frame][bin]. With an odd row stride (201) a warp reading one bin of its
// 32 frames touches 32 banks. Each warp then takes whole mels, a lane a
// frame, so that its store of the log values is 128 contiguous bytes; the
// CTA's largest log value goes into the clip's slot with one atomicMax on
// an order-preserving unsigned image of the float, which makes the result
// independent of the order the CTAs finish in. Then the CTA counts itself
// done in the clip's counter (after a fence: its log values and its max
// are visible first), and the clip's last CTA, the one that sees every
// other counted, floors and scales the whole clip in place from L2, 16
// bytes a load.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;        // frames a pass-1 CTA: one per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFloorLoads = 8;     // 16-byte loads in flight a thread in the floor
constexpr int64_t kMaxGridY = 65535;
constexpr int kMaxBins = 47 * 1024 / (kFrames * 4);   // the tile's power, in 48 KB

// An order-preserving image of a float as an unsigned: a > b exactly where
// key(a) > key(b) for non-NaN floats; 0 is below every float's image.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.maximum's max: a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float power(float2 v) { return fmaf(v.x, v.x, v.y * v.y); }

__device__ __forceinline__ float floored(float v, float floor) {
  return (nan_max(v, floor) + 4.0f) * 0.25f;    // * 0.25f is / 4 exactly
}

// The floor and the scaling of one clip's (per_clip) log values, in place,
// by one CTA; read through L2 (another SM wrote them)
__device__ void floor_clip(float* o, float floor, int64_t per_clip) {
  if (per_clip % 4 == 0) {       // then every clip's row starts 16-byte aligned
    float4* o4 = reinterpret_cast<float4*>(o);
    const int64_t n4 = per_clip / 4;
    for (int64_t i0 = threadIdx.x; i0 < n4; i0 += (int64_t)kThreads * kFloorLoads) {
      float4 v[kFloorLoads];
#pragma unroll
      for (int u = 0; u < kFloorLoads; ++u) {
        const int64_t i = i0 + (int64_t)u * kThreads;
        if (i < n4) v[u] = __ldcg(o4 + i);
      }
#pragma unroll
      for (int u = 0; u < kFloorLoads; ++u) {
        const int64_t i = i0 + (int64_t)u * kThreads;
        if (i < n4) {
          v[u] = make_float4(floored(v[u].x, floor), floored(v[u].y, floor),
                             floored(v[u].z, floor), floored(v[u].w, floor));
          o4[i] = v[u];
        }
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < per_clip; i += kThreads) {
      o[i] = floored(__ldcg(o + i), floor);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float2* __restrict__ z, const int* __restrict__ bands,
               const float* __restrict__ weights, float* __restrict__ out,
               unsigned* __restrict__ top, unsigned* __restrict__ done, int mels, int frames,
               int zframes, int bins, int nweights) {
  extern __shared__ float p[];     // [kFrames][bins]
  __shared__ float warp_top[kWarps];
  __shared__ bool last;
  const int64_t clip = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, frames - f0);
  const int n = nf * bins;
  const float2* src = z + (clip * zframes + f0) * bins;

  const int head = (reinterpret_cast<uintptr_t>(src) & 15) != 0;
  const int pairs = (n - head) >> 1;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  if (threadIdx.x == 0) {
    if (head) p[0] = power(__ldcs(src));
    if ((n - head) & 1) p[n - 1] = power(__ldcs(src + n - 1));
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < pairs; i += kThreads) {
    const float4 v = __ldcs(src4 + i);
    p[head + 2 * i] = fmaf(v.x, v.x, v.y * v.y);
    p[head + 2 * i + 1] = fmaf(v.z, v.z, v.w * v.w);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float best = -INFINITY;
  if (lane < nf) {
    const float* row = p + lane * bins;
    float* dst = out + clip * mels * frames + f0 + lane;
    for (int m = warp; m < mels; m += kWarps) {
      const int first = __ldg(bands + 3 * m), count = __ldg(bands + 3 * m + 1);
      const int offset = __ldg(bands + 3 * m + 2);
      // a band outside the row or the weights (a table of another
      // filterbank) reads nothing, and its NaN fills the clip
      const bool fits = first >= 0 && count >= 0 && first <= bins - count && offset >= 0 &&
                        offset <= nweights - count;
      const float* w = weights + offset;
      float e = fits ? 0.0f : NAN;
      for (int k = 0; k < (fits ? count : 0); ++k) e = fmaf(__ldg(w + k), row[first + k], e);
      const float v = log10f(e < 1e-10f ? 1e-10f : e);
      dst[(int64_t)m * frames] = v;
      best = nan_max(best, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (lane == 0) warp_top[warp] = best;
  __threadfence();                 // this thread's log values, before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) best = nan_max(best, warp_top[i]);
    // one NaN for every NaN, above every other float's image
    atomicMax(top + clip, best != best ? 0xffffffffu : order_key(best));
    __threadfence();               // the max, before the count
    last = atomicAdd(done + clip, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                 // every other CTA's values and max, after the count
  const int64_t per_clip = (int64_t)mels * frames;
  // a NaN's image decodes to a NaN
  floor_clip(out + clip * per_clip, from_key(__ldcg(top + clip)) - 8.0f, per_clip);
}

}  // namespace

// z (clips, zframes, bins) complex64 as float2, 8-byte aligned; bands (mels,
// 3) int32 rows (first bin, count, offset into weights); weights f32; out
// (clips, mels, frames) f32, 16-byte aligned; scratch (2 x clips) 4-byte
// words; all on the current device, z, bands and out contiguous. frames <
// zframes, the frames read of each clip; nweights, the length of weights.
// A band that does not fit in bins or in weights makes its clip NaN. Launches a fill of `scratch` (each
// clip's max and count of CTAs done) and the kernel on `stream` (of that
// device) without synchronising; returns the first failing call's
// cudaError_t.
extern "C" int nx_log_mel_f32(const void* z, const void* bands, const void* weights, void* out,
                              void* scratch, int64_t clips, int64_t mels, int64_t frames,
                              int64_t zframes, int64_t bins, int64_t nweights,
                              void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (clips < 1 || mels < 1 || frames < 1 || zframes <= frames || bins < 1 ||
      bins > kMaxBins || nweights < 0 || mels > kIntMax || zframes > kIntMax ||
      nweights > kIntMax ||
      (reinterpret_cast<uintptr_t>(z) & 7) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float2* zf = static_cast<const float2*>(z);
  const int* b = static_cast<const int*>(bands);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  unsigned* top = static_cast<unsigned*>(scratch);
  unsigned* done = top + clips;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(top, 0, 2 * clips * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kFrames * bins * sizeof(float);
  const unsigned tiles = (unsigned)((frames + kFrames - 1) / kFrames);
  for (int64_t c0 = 0; c0 < clips; c0 += kMaxGridY) {
    const int64_t nc = clips - c0 < kMaxGridY ? clips - c0 : kMaxGridY;
    log_mel_kernel<<<dim3(tiles, (unsigned)nc), kThreads, smem, s>>>(
        zf + c0 * zframes * bins, b, w, o + c0 * mels * frames, top + c0, done + c0, (int)mels,
        (int)frames, (int)zframes, (int)bins, (int)nweights);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
