// Hopper kernels A and B: the framed DFT as one contraction of hop-strided
// frame windows with a stacked [Re | Im] weight matrix, on the CUDA cores in
// exact f32 FMA, register-tiled.
//
// Replaces (TPU kernels of the JAX package):
//   A  POWER = true, FIR folded into the weights:
//      nx_signal_tpu/kernels/pallas_dft.py:fir_framed_dft_power_pallas
//      (precision 'highest')
//   B  no fold (W = window-scaled DFT), [Re | Im] or power output:
//      nx_signal_tpu/kernels/pallas_dft.py:framed_dft_pallas, for the n_fft
//      kernel B-fft (framed_fft.cu) does not take
//
// For channel c and frame m (0 <= m < num_frames):
//   xe[m, k] = x[c, m*stride - pad_left + k]   (0 outside [0, length))
//   re[b] = sum_k xe[m, k] * W[k, b],  im[b] = sum_k xe[m, k] * W[k, bins + b]
//   POWER: out[c, m, b] = re^2 + im^2               (bins columns)
//   else:  out[c, m, :] = [re | im]                  (2*bins columns)
// k runs over the krows rows of W (frame + K - 1 for A, frame for B); the
// signal is never padded or copied.
//
// The weights come from the host laid out per tile of kTileBins bin slots
// (kernels/cuda_dft.py:_a_weights): w[t, k, 128] f32, krows rounded up to
// kChunk rows with zeros. In tile t, bin-warp wn (0, 1) reads the 64 floats
// at wn*64: the Re columns of its slots, then their Im columns, lane group
// bg (0..7) holding slots t*64 + wn*32 + bg + 8j, j = 0..3, at bg*4 + j, so a
// lane's 8 columns are two 16-byte loads and each load of a warp covers 128
// consecutive bytes. Slot s is bin s, except where `packed`: the DC bin's
// Im column (sin 0, exactly zero) is dropped, and slot 0 carries the last
// bin's (Nyquist) Re column in its place, its Im column (below f32
// resolution of the Re one, checked on the host) dropped too: 257 bins fill
// exactly 256 slots, 4 tiles.
//
// What bounds it on the H100: operations. Each frame costs 2 * krows *
// 2*bins FLOP, 6152 FLOP per input sample for the 255-tap / 512-frame /
// hop-128 chain (2.27 TFLOP at 768 x 480000), against about 12 B per sample
// of device-memory traffic that cannot be avoided (read x, write the power);
// exact f32 keeps it on the CUDA cores' FMA, 67 TFLOP/s at the peak. What
// the design does about it:
//   * An implicit GEMM per channel (M = frames, K = krows, N = 2*slots),
//     one CTA per (channel, tile of 16*FPT frames, tile of 64 slots), 8
//     warps: 4 along the frames, 2 along the slots. A warp is 4 frame
//     groups x 8 slot groups of lanes; a lane holds FPT frames (fg + 4i) x
//     4 slots x (Re, Im), 64 accumulators at FPT = 8, so re^2 + im^2 forms
//     in registers and only the power is written.
//   * Per 4 weight rows a lane loads its FPT frames as 16-byte loads along k
//     and 4 x 2 weight float4s, for 32 * FPT FMAs: 16 FMAs per shared-memory
//     load at FPT = 8. x loads are broadcast to the 8 lanes of a frame group,
//     weight loads to the 4 of a slot group.
//   * The CTA stages its frames' window of x once (4-byte cp.async, zeros
//     outside the signal) as (blocks, stride) hop rows at a pitch P = 4 (mod
//     32) floats: frame m at k is row m + k / stride, column k % stride, so
//     the 4 frame groups' loads (adjacent rows) fall in distinct banks.
//     Where that window does not fit even at 16 frames a CTA (a hop past
//     about 2900 samples with 255 taps), the CTA streams x instead (STREAM):
//     with each chunk of kChunk weight rows, rows [k0, k0 + kChunk) of each
//     of its 128 frames go through the same cp.async ring, a row of kXPitch
//     floats per frame, so shared memory is bounded by the ring at any hop.
//     The sums run in the same order either way, so both give the same bits.
//   * The weight tile streams through shared memory in chunks of kChunk rows
//     in a kStages-deep cp.async ring, one barrier per chunk (32 rows, 2
//     stages: the next chunk's load overlaps this chunk's 2048 FMAs per
//     lane, and 2 CTAs of 102 KB fit an SM at the bench chain); the chain's
//     folded W (1.6 MB) stays in the 50 MB L2.
//   * Each frame's sums run over k in increasing order with fmaf, whatever
//     its tile (no split-K): the sharded chain stays bitwise equal to the
//     single-device one. The power epilogue rounds each product and the sum
//     separately, as the plain version does. Offsets into x and out are
//     64-bit: the chain's output has 7.4e8 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 4;                 // warps along the frames
constexpr int kWarps = 2 * kWarpsM;        // and 2 along the slots
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBins = 64;              // bin slots per CTA
constexpr int kCols = 2 * kTileBins;       // floats per weight row of a tile
constexpr int kChunk = 32;                 // weight rows per stage
constexpr int kStages = 2;
constexpr int kXPitch = kChunk + 4;        // floats per streamed frame row, = 4 (mod 32)
constexpr int64_t kMaxGridZ = 65535;

// floats per staged x row: at least stride, = 4 (mod 32)
__host__ __device__ inline int64_t x_pitch(int64_t stride) {
  return stride + ((36 - stride % 32) % 32);
}

// hop rows holding the windows of bm frames
__host__ __device__ inline int64_t x_rows(int bm, int64_t stride, int64_t krows_pad) {
  return ((int64_t)(bm - 1) * stride + krows_pad + stride - 1) / stride;
}

// staged: the weight ring and the window of 16 * fpt frames; streamed: the
// weight ring and a ring of the same depth of kChunk-row slices of 16 * fpt
// frames
inline size_t smem_bytes(int fpt, int64_t stride, int64_t krows_pad, bool stream) {
  return (size_t)(4 * kStages * kChunk * kCols +
                  (stream ? 4 * kStages * 16 * fpt * kXPitch
                          : 4 * x_rows(16 * fpt, stride, krows_pad) * x_pitch(stride)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

// 4 bytes, or 4 zero bytes where src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, unsigned src_bytes) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes));
}

// FPT frames per lane (16 * FPT per CTA); VEC 4 loads x as float4 along k
// (stride % 4 == 0, or STREAM), VEC 1 as scalars; STREAM streams x with the
// weight chunks instead of staging the frames' window
template <int FPT, int VEC, bool POWER, bool STREAM>
__global__ void __launch_bounds__(kThreads, 2)
framed_dft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int64_t length, int stride, int krows_pad,
                  int64_t pad_left, int num_frames, int bins, int slots, int packed,
                  int bin_tiles) {
  constexpr int kBM = 16 * FPT;
  extern __shared__ __align__(16) float smem[];
  const int P = STREAM ? kXPitch : (int)x_pitch(stride);
  float* ws = smem;
  float* xs = smem + kStages * kChunk * kCols;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bg = lane & 7;   // slot group
  const int fg = lane >> 3;  // frame group
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int tile = blockIdx.x % bin_tiles;
  const int m0 = (blockIdx.x / bin_tiles) * kBM;
  const int64_t ch = blockIdx.z;
  const int nchunks = krows_pad / kChunk;

  const float* wt = w + (int64_t)tile * krows_pad * kCols;
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride - pad_left;
  // x index of frame f's sample k: s0 + f*stride + k (zeros outside the signal)
  auto load_x = [&](float* dst, int64_t gi) {
    const bool inside = gi >= 0 && gi < length;
    cp_async4(dst, xc + (inside ? gi : 0), inside ? 4 : 0);
  };
  auto load_chunk = [&](int chunk) {
    const float* src = wt + (int64_t)chunk * kChunk * kCols;
    float* dst = ws + (chunk % kStages) * kChunk * kCols;
    for (int i = 4 * tid; i < kChunk * kCols; i += 4 * kThreads) cp_async16(dst + i, src + i);
    if constexpr (STREAM) {
      // rows [chunk*kChunk, +kChunk) of every frame, one warp a frame row
      float* xd = xs + (chunk % kStages) * kBM * kXPitch;
      const int64_t k0 = s0 + (int64_t)chunk * kChunk + lane;
      for (int f = warp; f < kBM; f += kWarps) {
        load_x(xd + f * kXPitch + lane, k0 + (int64_t)f * stride);
      }
    }
  };

  if constexpr (!STREAM) {
    // the frames' window of x: sample s of the window (x index s0 + s) at
    // row s / stride, column s % stride
    const int rows = (int)x_rows(kBM, stride, krows_pad);
    for (int r = warp; r < rows; r += kWarps) {
      for (int c = lane; c < stride; c += 32) load_x(xs + r * P + c, s0 + (int64_t)r * stride + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < kStages - 1; ++c) {  // one commit group per chunk, even empty
    if (c < nchunks) load_chunk(c);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float re[FPT][4], im[FPT][4];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
  }

  // this lane's first frame row; frame i is 4 rows further per i. (q, r) is
  // k's (row, column) in the hop rows, advanced by VEC per step; streamed, a
  // frame's row of the stage holds its kChunk samples of the chunk
  const float* xrow = xs + (wm * 4 * FPT + fg) * P;
  const int p4 = 4 * P;
  const int wofs = wn * 64 + bg * 4;
  int q = 0, r = 0;

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // x staged; this chunk visible; every warp done with chunk - 1
    // refill the stage chunk - 1 used
    if (chunk + kStages - 1 < nchunks) load_chunk(chunk + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* wc = ws + (chunk % kStages) * kChunk * kCols + wofs;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += VEC) {
      float xv[FPT][VEC];
      const float* xk = STREAM ? xrow + (chunk % kStages) * kBM * kXPitch + kk : xrow + q * P + r;
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(xk + i * p4);
          xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
        } else {
          xv[i][0] = xk[i * p4];
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float4 wr = *reinterpret_cast<const float4*>(wc + (kk + v) * kCols);
        const float4 wi = *reinterpret_cast<const float4*>(wc + (kk + v) * kCols + 32);
        const float wre[4] = {wr.x, wr.y, wr.z, wr.w};
        const float wim[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(xv[i][v], wre[j], re[i][j]);
            im[i][j] = fmaf(xv[i][v], wim[j], im[i][j]);
          }
        }
      }
      if constexpr (!STREAM) {
        r += VEC;
        if (r >= stride) r -= stride, ++q;
      }
    }
  }

  // slot s = tile*64 + wn*32 + bg + 8j is bin s; where packed, slot 0's Im
  // accumulator is the last bin's Re sum, and each dropped Im part is written
  // as 0 times its bin's Re sum: zero for a finite frame, NaN where the frame
  // holds an inf or a NaN, as the sum over the zero column x @ W gives
  const int64_t cols = POWER ? bins : 2 * (int64_t)bins;
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int m = m0 + wm * 4 * FPT + fg + 4 * i;
    if (m >= num_frames) continue;
    float* orow = out + (ch * num_frames + m) * cols;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tile * kTileBins + wn * 32 + bg + 8 * j;
      if (s >= slots) continue;
      if (packed && s == 0) {
        const float dc_im = __fmul_rn(0.0f, re[i][j]);
        if constexpr (POWER) {
          orow[0] = __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(dc_im, dc_im));
          orow[bins - 1] = __fmul_rn(im[i][j], im[i][j]);
        } else {
          orow[0] = re[i][j];
          orow[bins] = dc_im;
          orow[bins - 1] = im[i][j];
          orow[2 * bins - 1] = __fmul_rn(0.0f, im[i][j]);
        }
      } else if constexpr (POWER) {
        orow[s] = __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
      } else {
        orow[s] = re[i][j];
        orow[bins + s] = im[i][j];
      }
    }
  }
}

template <int FPT, int VEC, bool POWER, bool STREAM>
cudaError_t launch(const float* x, const float* w, float* out, int64_t channels, int64_t length,
                   int64_t stride, int64_t krows_pad, int64_t pad_left, int64_t num_frames,
                   int64_t bins, bool packed, cudaStream_t stream) {
  auto kernel = framed_dft_kernel<FPT, VEC, POWER, STREAM>;
  const size_t smem = smem_bytes(FPT, stride, krows_pad, STREAM);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t slots = packed ? bins - 1 : bins;
  const int64_t bin_tiles = (slots + kTileBins - 1) / kTileBins;
  const int64_t blocks = (num_frames + 16 * FPT - 1) / (16 * FPT) * bin_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t cols = POWER ? bins : 2 * bins;
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    kernel<<<dim3((unsigned)blocks, 1, (unsigned)nc), kThreads, smem, stream>>>(
        x + c0 * length, w, out + c0 * num_frames * cols, length, (int)stride, (int)krows_pad,
        pad_left, (int)num_frames, (int)bins, (int)slots, packed ? 1 : 0, (int)bin_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int FPT, bool STREAM>
cudaError_t dispatch(const float* x, const float* w, float* out, int64_t channels,
                     int64_t length, int64_t stride, int64_t krows_pad, int64_t pad_left,
                     int64_t num_frames, int64_t bins, bool packed, bool power, cudaStream_t s) {
  const bool vec = stride % 4 == 0;
#define NX_LAUNCH(VEC, POWER)                                                                \
  launch<FPT, VEC, POWER, STREAM>(x, w, out, channels, length, stride, krows_pad, pad_left,  \
                                  num_frames, bins, packed, s)
  if constexpr (STREAM) {
    return power ? NX_LAUNCH(4, true) : NX_LAUNCH(4, false);
  } else if (power) {
    return vec ? NX_LAUNCH(4, true) : NX_LAUNCH(1, true);
  } else {
    return vec ? NX_LAUNCH(4, false) : NX_LAUNCH(1, false);
  }
#undef NX_LAUNCH
}

}  // namespace

extern "C" const char* nx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (channels, length) f32; w (ceil(slots / 64), krows_pad, 128) f32, the
// weights laid out as above (slots = bins - 1 where packed, else bins);
// out (channels, num_frames, bins if power else 2*bins) f32; all contiguous
// on the current device. krows_pad a multiple of kChunk. Launches on `stream`
// (of that device) without synchronising; returns the launch's cudaError_t.
extern "C" int nx_framed_dft_f32(const void* x, const void* w, void* out, int64_t channels,
                                 int64_t length, int64_t stride, int64_t krows_pad,
                                 int64_t pad_left, int64_t num_frames, int64_t bins,
                                 int64_t packed, int64_t power, void* stream) {
  if (channels < 1 || length < 1 || stride < 1 || stride > 0x7fffffff || krows_pad < kChunk ||
      krows_pad % kChunk != 0 || krows_pad > 0xffffff || num_frames < 1 ||
      num_frames > 0x7fffffff || bins < 1 + (packed != 0) || bins > 0xffffff) {
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
  // 128 frames per CTA where the staged window fits, else 16, else 128
  // frames with x streamed through the ring
#define NX_DISPATCH(FPT, STREAM)                                                            \
  dispatch<FPT, STREAM>(xf, wf, of, channels, length, stride, krows_pad, pad_left, num_frames, \
                        bins, packed != 0, power != 0, s)
  if (smem_bytes(8, stride, krows_pad, false) <= (size_t)max_smem) {
    err = NX_DISPATCH(8, false);
  } else if (smem_bytes(1, stride, krows_pad, false) <= (size_t)max_smem) {
    err = NX_DISPATCH(1, false);
  } else {
    err = NX_DISPATCH(8, true);
  }
#undef NX_DISPATCH
  return (int)err;
}
