// Hopper kernels A and B: the framed DFT as one contraction of hop-strided
// frame windows with a stacked [Re | Im] weight matrix, on the CUDA cores in
// exact f32 FMA.
//
// Replaces (TPU kernels of the JAX package):
//   A  POWER = true, FIR folded into the weights:
//      nx_signal_tpu/kernels/pallas_dft.py:fir_framed_dft_power_pallas
//   B  no fold (W = window-scaled DFT), [Re | Im] or power output:
//      nx_signal_tpu/kernels/pallas_dft.py:framed_dft_pallas
//
// For channel c and frame m (0 <= m < num_frames):
//   xe[m, k] = x[c, m*stride - pad_left + k]   (0 outside [0, length))
//   re[b] = sum_k xe[m, k] * W[k, b],  im[b] = sum_k xe[m, k] * W[k, bins + b]
//   POWER: out[c, m, b] = re^2 + im^2               (bins columns)
//   else:  out[c, m, :] = [re | im]                  (2*bins columns)
// k runs over the krows rows of W (frame + K - 1 for A, frame for B); the
// signal is never padded or copied.
//
// What bounds it on the H100: each frame costs 2 * krows * 2*bins FLOP, i.e.
// 2 * krows * 2*bins / stride FLOP per input sample: 6152 FLOP for the
// 255-tap / 512-frame / hop-128 chain, against about 12 B per sample of
// device-memory traffic that cannot be avoided (read x, write the power).
// So the kernel is compute-bound; this version uses the CUDA cores' f32 FMA,
// whose peak is far below the tensor cores' (wgmma with 3xTF32 splits is the
// next step). What the design does about it:
//   * One CTA per (tile of frames, tile of 96 bins, channel). It stages its
//     frames' whole window of x in shared memory once (hop blocks overlap,
//     so each sample is read from device memory once per bin tile, not once
//     per frame) and streams the weight rows through shared memory in chunks
//     of 32; the 1.58 MB folded W of the chain stays in the 50 MB L2.
//   * Each thread keeps FPT frames x 3 bins x (Re, Im) sums in registers, so
//     re^2 + im^2 is formed on chip and only the power is written.
//   * A warp shares its frames: each x value is a shared-memory broadcast
//     (float4 along k when stride % 4 == 0), and the warp's 32 lanes read 32
//     consecutive weight columns without bank conflicts.
//   * Offsets into x and out are 64-bit: the chain's output has 7.4e8
//     elements.
// Sums run over k in increasing order with fmaf; the power epilogue rounds
// each product and the sum separately, as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                          // threads along bins
constexpr int kWarps = 8;                           // threads along frames
constexpr int kThreads = kLanes * kWarps;
constexpr int kBinsPerThread = 3;
constexpr int kTileBins = kLanes * kBinsPerThread;  // bins per CTA
constexpr int kChunk = 32;                          // weight rows per stage
constexpr int kWsCols = 2 * kTileBins;              // Re columns, then Im
constexpr int64_t kMaxGridZ = 65535;

// Samples of x one CTA stages: its frames' windows, with the weight rows
// rounded up to whole chunks (the extra rows meet zero weights).
__host__ __device__ inline int64_t window_len(int fpt, int64_t stride, int64_t krows) {
  const int64_t kext = (krows + kChunk - 1) / kChunk * kChunk;
  const int64_t n = (int64_t)(kWarps * fpt - 1) * stride + kext;
  return (n + 3) / 4 * 4;  // keeps the weight tile 16-byte aligned
}

inline size_t smem_bytes(int fpt, int64_t stride, int64_t krows) {
  return (size_t)(window_len(fpt, stride, krows) + (int64_t)kChunk * kWsCols) * sizeof(float);
}

template <int FPT, int VEC, bool POWER>
__global__ void __launch_bounds__(kThreads, 2)
framed_dft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int64_t length, int stride, int krows,
                  int64_t pad_left, int num_frames, int bins) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTileM = kWarps * FPT;
  const int win = (int)window_len(FPT, stride, krows);
  float* xs = smem;
  float* ws = smem + win;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int m0 = blockIdx.x * kTileM;
  const int b0 = blockIdx.y * kTileBins;
  const int64_t ch = blockIdx.z;

  // the window of x: samples [m0*stride - pad_left, ... + win), zero outside
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride - pad_left;
  for (int i = tid; i < win; i += kThreads) {
    const int64_t g = s0 + i;
    xs[i] = (g >= 0 && g < length) ? xc[g] : 0.0f;
  }

  float re[FPT][kBinsPerThread];
  float im[FPT][kBinsPerThread];
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      re[f][j] = 0.0f;
      im[f][j] = 0.0f;
    }
  }

  const float* xrow = xs + warp * FPT * stride;  // this warp's first frame
  const int64_t wcols = 2 * (int64_t)bins;

  for (int kc = 0; kc < krows; kc += kChunk) {
    __syncthreads();  // x staged (first pass), previous weight tile consumed
    for (int i = tid; i < kChunk * kWsCols; i += kThreads) {
      const int r = i / kWsCols;
      const int c = i - r * kWsCols;
      const int is_im = c >= kTileBins;
      const int b = b0 + c - is_im * kTileBins;
      const int k = kc + r;
      ws[i] = (k < krows && b < bins) ? w[(int64_t)k * wcols + is_im * bins + b] : 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < kChunk; r += VEC) {
      float xv[FPT][VEC];
#pragma unroll
      for (int f = 0; f < FPT; ++f) {
        const float* p = xrow + f * stride + kc + r;
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          xv[f][0] = v.x;
          xv[f][1] = v.y;
          xv[f][2] = v.z;
          xv[f][3] = v.w;
        } else {
          xv[f][0] = *p;
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float* wrow = ws + (r + v) * kWsCols + lane;
        float wre[kBinsPerThread];
        float wim[kBinsPerThread];
#pragma unroll
        for (int j = 0; j < kBinsPerThread; ++j) {
          wre[j] = wrow[j * kLanes];
          wim[j] = wrow[kTileBins + j * kLanes];
        }
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
#pragma unroll
          for (int j = 0; j < kBinsPerThread; ++j) {
            re[f][j] = fmaf(xv[f][v], wre[j], re[f][j]);
            im[f][j] = fmaf(xv[f][v], wim[j], im[f][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const int m = m0 + warp * FPT + f;
    if (m >= num_frames) continue;
    const int64_t row = ch * num_frames + m;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int b = b0 + j * kLanes + lane;
      if (b >= bins) continue;
      if constexpr (POWER) {
        out[row * bins + b] = __fadd_rn(__fmul_rn(re[f][j], re[f][j]),
                                        __fmul_rn(im[f][j], im[f][j]));
      } else {
        out[row * wcols + b] = re[f][j];
        out[row * wcols + bins + b] = im[f][j];
      }
    }
  }
}

template <int FPT, int VEC, bool POWER>
cudaError_t launch(const float* x, const float* w, float* out, int64_t channels,
                   int64_t length, int64_t stride, int64_t krows, int64_t pad_left,
                   int64_t num_frames, int64_t bins, cudaStream_t stream) {
  auto kernel = framed_dft_kernel<FPT, VEC, POWER>;
  const size_t smem = smem_bytes(FPT, stride, krows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kTileM = kWarps * FPT;
  const int64_t cols = POWER ? bins : 2 * bins;
  const dim3 block(kLanes, kWarps);
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    const dim3 grid((unsigned)((num_frames + kTileM - 1) / kTileM),
                    (unsigned)((bins + kTileBins - 1) / kTileBins), (unsigned)nc);
    kernel<<<grid, block, smem, stream>>>(x + c0 * length, w, out + c0 * num_frames * cols,
                                          length, (int)stride, (int)krows, pad_left,
                                          (int)num_frames, (int)bins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int FPT>
cudaError_t dispatch(const float* x, const float* w, float* out, int64_t channels,
                     int64_t length, int64_t stride, int64_t krows, int64_t pad_left,
                     int64_t num_frames, int64_t bins, bool power, cudaStream_t s) {
  const bool vec = stride % 4 == 0;
  if (power) {
    return vec ? launch<FPT, 4, true>(x, w, out, channels, length, stride, krows, pad_left,
                                      num_frames, bins, s)
               : launch<FPT, 1, true>(x, w, out, channels, length, stride, krows, pad_left,
                                      num_frames, bins, s);
  }
  return vec ? launch<FPT, 4, false>(x, w, out, channels, length, stride, krows, pad_left,
                                     num_frames, bins, s)
             : launch<FPT, 1, false>(x, w, out, channels, length, stride, krows, pad_left,
                                     num_frames, bins, s);
}

}  // namespace

extern "C" const char* nx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (channels, length) f32, w (krows, 2*bins) f32, out (channels, num_frames,
// bins if power else 2*bins) f32, all contiguous on the current device.
// Launches on `stream` (of that device) without synchronising; returns the
// launch's cudaError_t.
extern "C" int nx_framed_dft_f32(const void* x, const void* w, void* out, int64_t channels,
                                 int64_t length, int64_t stride, int64_t krows,
                                 int64_t pad_left, int64_t num_frames, int64_t bins,
                                 int64_t power, void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (channels < 1 || length < 1 || stride < 1 || krows < 1 || num_frames < 1 || bins < 1 ||
      stride > kIntMax || krows > kIntMax || num_frames > kIntMax || 2 * bins > kIntMax) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64 frames per CTA where the staged window fits, else 16
  if (smem_bytes(8, stride, krows) <= (size_t)max_smem) {
    err = dispatch<8>(xf, wf, of, channels, length, stride, krows, pad_left, num_frames, bins,
                      power != 0, s);
  } else if (smem_bytes(2, stride, krows) <= (size_t)max_smem) {
    err = dispatch<2>(xf, wf, of, channels, length, stride, krows, pad_left, num_frames, bins,
                      power != 0, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
