// Hopper kernel A-tc: the fused FIR + framed DFT power chain (kernel A's
// function) on the tensor cores, at the precisions 'high' (3xTF32) and
// 'default' (one TF32 pass). 'highest' stays kernel A (framed_dft.cu).
//
// Replaces (TPU kernel of the JAX package):
//   nx_signal_tpu/kernels/pallas_dft.py:fir_framed_dft_power_pallas with
//   precision 'high' / 'default' (there a bf16 hi/lo split on the MXU,
//   pallas_dft.py:_split_bf16 and _block_dot).
//
// For channel c, frame m and bin b (0 <= b < bins):
//   xe[m, k] = x[c, m*stride - pad_left + k]   (0 outside [0, length))
//   re = sum_k xe[m, k] W[k, b],  im = sum_k xe[m, k] W[k, bins + b]
//   out[c, m, b] = re^2 + im^2
// with every operand v split into TF32 parts, hi = tf32(v) and lo =
// tf32(v - hi) (cvt.rna: round to nearest, ties away from zero), and each
// product taken as x_lo W_hi + x_hi W_lo + x_hi W_hi ('high', PASSES = 3)
// or x_hi W_hi ('default', PASSES = 1), summed in f32 on the tensor cores.
//
// The weights come from the host already split and laid out per tile of
// kTileBins bins: w[t, k, col, {hi, lo}] (tiles, krows_pad, 2*kTileBins, 2)
// f32, col < kTileBins the Re column of bin t*kTileBins + col and col >=
// kTileBins its Im column; bins past `bins` (257 -> 5 tiles of 64 = 320 at
// n_fft 512) and rows past krows are zeros. krows_pad is krows rounded up to
// kChunk.
//
// What bounds it on the H100: operations. The route is the dense folded
// DFT, 2 * krows * 2*bins FLOP per frame, three times over for 'high':
// 6.8 TFLOP at 768 x 480000 with the 255-tap / hann-512 / hop-128 chain,
// 13.8 ms at the 495 TFLOP/s TF32 peak ('default' 4.6 ms). What the design
// does about it:
//   * An implicit GEMM per channel (M = frames, K = krows, N = 2*bins): the
//     frame matrix is never built. One CTA per (channel, tile of BM = 256
//     frames, or 128 for long hops, tile of 64 bins), 8 warps, each 64 (or
//     32) frames x 32 bins, with the Re and Im columns of the same bins in
//     one thread, so re^2 + im^2 forms in registers and only the power is
//     written.
//   * The weights, not the operations, set the pace at first: every CTA
//     streams its whole weight tile (krows x 128 (hi, lo) pairs, 786 KB at
//     the chain) from L2, so the weight traffic is (frames / BM) x 3.9 MB per
//     channel, 90 GB at BM = 128. BM = 256 (one CTA per SM, 8 warps) halves
//     it; a thread-block cluster multicasting the tile is the next step.
//   * The CTA stages its frames' window of x once, in f32 (4-byte cp.async,
//     zero-filled outside the signal), as (blocks,
//     stride) rows with a pitch of P floats (P >= stride, P = 4 mod 32):
//     frame m at column k is row m + k / stride, offset k % stride, and the
//     32 (row, k) pairs of a fragment load fall in distinct banks. Each
//     fragment value is split into (hi, lo) in registers as it is loaded
//     (3 instructions): staging the split would double the window's shared
//     memory and halve the frames per CTA.
//   * The weight tile streams through shared memory in chunks of kChunk rows
//     with cp.async, kStages deep; the split weights of the chain (3.9 MB)
//     stay in the 50 MB L2.
//   * mma.sync.m16n8k8 TF32 with f32 accumulation. Every frame runs the same
//     k-steps and products in the same order whatever its tile, so a frame's
//     sum does not depend on where its CTA starts (the sharded chain stays
//     bitwise equal to the single-device one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 4;               // warps along the frames
constexpr int kWarps = 2 * kWarpsM;      // and 2 along the bins
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBins = 64;            // bins per CTA (Re and Im: 128 columns)
constexpr int kCols = 2 * kTileBins;
constexpr int kChunk = 16;               // weight rows per pipeline stage
constexpr int kStages = 3;
constexpr int kWPitch = kCols + 4;       // float2 per staged weight row (= 4 mod 16)
constexpr int64_t kMaxGridZ = 65535;

// floats per staged x row: at least stride, = 4 (mod 32) for conflict-free
// fragment loads
__host__ __device__ inline int x_pitch(int stride) { return stride + ((36 - stride % 32) % 32); }

__host__ __device__ inline int64_t x_rows(int bm, int64_t stride, int64_t krows_pad) {
  return ((int64_t)(bm - 1) * stride + krows_pad + stride - 1) / stride;
}

inline size_t smem_bytes(int bm, int64_t stride, int64_t krows_pad) {
  return (size_t)(8 * kStages * kChunk * kWPitch +
                  4 * x_rows(bm, stride, krows_pad) * x_pitch((int)stride));
}

// frames per CTA (256, or 128 where 256 frames' window does not fit), or 0
// when even 128 frames' window exceeds the shared memory
inline int frames_per_cta(int64_t stride, int64_t krows_pad, int max_smem) {
  if (smem_bytes(256, stride, krows_pad) <= (size_t)max_smem) return 256;
  return smem_bytes(128, stride, krows_pad) <= (size_t)max_smem ? 128 : 0;
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
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

// D = A * B + D, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// MF m16 fragments per warp (BM = 64 * MF frames per CTA), PASSES 3 or 1
template <int MF, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
framed_dft_tc_kernel(const float* __restrict__ x, const float2* __restrict__ w,
                     float* __restrict__ out, int64_t length, int stride, int krows_pad,
                     int64_t pad_left, int num_frames, int bins, int bin_tiles) {
  constexpr int kBM = kWarpsM * 16 * MF;
  constexpr int kWarpFrames = 16 * MF;
  extern __shared__ __align__(16) float2 smem2[];
  const int P = x_pitch(stride);
  const int rows = (int)x_rows(kBM, stride, krows_pad);
  float2* ws = smem2;
  float* xs = reinterpret_cast<float*>(smem2 + kStages * kChunk * kWPitch);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int tile = blockIdx.x % bin_tiles;
  const int m0 = (blockIdx.x / bin_tiles) * kBM;
  const int64_t ch = blockIdx.z;
  const int nchunks = krows_pad / kChunk;

  const float2* wt = w + (int64_t)tile * krows_pad * kCols;
  auto load_chunk = [&](int chunk) {
    const float2* src = wt + (int64_t)chunk * kChunk * kCols;
    float2* dst = ws + (chunk % kStages) * kChunk * kWPitch;
    for (int i = tid; i < kChunk * kCols / 2; i += kThreads) {
      const int r = i / (kCols / 2);
      const int c = 2 * (i - r * (kCols / 2));
      cp_async16(dst + r * kWPitch + c, src + r * kCols + c);
    }
  };

  // the frames' window of x: sample s of the window (x index m0*stride -
  // pad_left + s) at row s / stride, column s % stride
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride - pad_left;
  for (int r = warp; r < rows; r += kWarps) {
    for (int c = lane; c < stride; c += 32) {
      const int64_t gi = s0 + (int64_t)r * stride + c;
      const bool inside = gi >= 0 && gi < length;
      cp_async4(xs + r * P + c, xc + (inside ? gi : 0), inside ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < kStages - 1; ++c) {  // one commit group per chunk, even empty
    if (c < nchunks) load_chunk(c);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // this warp's bins: Re columns wn*32 + [0, 32), Im columns 64 + wn*32 + ...;
  // n-fragment pairs wholly past `bins` are skipped (warp-uniform)
  const int bin0 = tile * kTileBins + wn * 32;
  const int active = bins - bin0 <= 0 ? 0 : (bins - bin0 >= 32 ? 4 : (bins - bin0 + 7) / 8);

  float acc[MF][8][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // (block, offset) of k = k0 + t and k0 + t + 4, advanced by 8 per k-step
  int qa = t / stride, ra = t % stride;
  int qb = (t + 4) / stride, rb = (t + 4) % stride;
  const int frow = wm * kWarpFrames + g;  // this thread's first fragment row

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    // the stage of chunk + kStages - 1 was last read by chunk - 1, before the
    // barrier that ended its iteration
    if (chunk + kStages - 1 < nchunks) load_chunk(chunk + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();  // x staged; this chunk's weights visible to every warp
    const float2* wc = ws + (chunk % kStages) * kChunk * kWPitch;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 8) {
      uint32_t a_hi[MF][4], a_lo[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int row = frow + i * 16;
        const float v[4] = {xs[(row + qa) * P + ra], xs[(row + 8 + qa) * P + ra],
                            xs[(row + qb) * P + rb], xs[(row + 8 + qb) * P + rb]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_hi[i][e] = tf32(v[e]);
          if constexpr (PASSES == 3) a_lo[i][e] = tf32(v[e] - __uint_as_float(a_hi[i][e]));
        }
      }
      uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if ((j & 3) >= active) continue;
        const int col = (j < 4 ? 0 : kTileBins) + wn * 32 + (j & 3) * 8 + g;
        const float2 u0 = wc[(ks + t) * kWPitch + col];
        const float2 u1 = wc[(ks + t + 4) * kWPitch + col];
        b_hi[j][0] = __float_as_uint(u0.x), b_hi[j][1] = __float_as_uint(u1.x);
        b_lo[j][0] = __float_as_uint(u0.y), b_lo[j][1] = __float_as_uint(u1.y);
      }
      // each product pass over every accumulator in turn: consecutive mma
      // instructions never wait on each other, and every accumulator still
      // adds x_lo W_hi, x_hi W_lo, then x_hi W_hi at each k-step
      if constexpr (PASSES == 3) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((j & 3) >= active) continue;
#pragma unroll
          for (int i = 0; i < MF; ++i) mma(acc[i][j], a_lo[i], b_hi[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((j & 3) >= active) continue;
#pragma unroll
          for (int i = 0; i < MF; ++i) mma(acc[i][j], a_hi[i], b_lo[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if ((j & 3) >= active) continue;
#pragma unroll
        for (int i = 0; i < MF; ++i) mma(acc[i][j], a_hi[i], b_hi[j]);
      }
      ra += 8;
      while (ra >= stride) ra -= stride, ++qa;
      rb += 8;
      while (rb >= stride) rb -= stride, ++qb;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // power epilogue: accumulator e of fragment (i, j) is row g (+8 for e >= 2),
  // column 2t + (e & 1); Re fragment j pairs with Im fragment j + 4
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + frow + i * 16 + (e >> 1) * 8;
      if (m >= num_frames) continue;
      float* orow = out + (ch * num_frames + m) * (int64_t)bins;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = bin0 + j * 8 + 2 * t + (e & 1);
        if (b >= bins) continue;
        const float re = acc[i][j][e], im = acc[i][j + 4][e];
        orow[b] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
    }
  }
}

template <int MF, int PASSES>
cudaError_t launch(const float* x, const float2* w, float* out, int64_t channels, int64_t length,
                   int64_t stride, int64_t krows_pad, int64_t pad_left, int64_t num_frames,
                   int64_t bins, cudaStream_t stream) {
  auto kernel = framed_dft_tc_kernel<MF, PASSES>;
  const size_t smem = smem_bytes(64 * MF, stride, krows_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t bin_tiles = (bins + kTileBins - 1) / kTileBins;
  const int64_t blocks = (num_frames + 64 * MF - 1) / (64 * MF) * bin_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    kernel<<<dim3((unsigned)blocks, 1, (unsigned)nc), kThreads, smem, stream>>>(
        x + c0 * length, w, out + c0 * num_frames * bins, length, (int)stride, (int)krows_pad,
        pad_left, (int)num_frames, (int)bins, (int)bin_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int max_smem_optin(int* max_smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // namespace

// Writes the frames per CTA kernel A-tc takes for this geometry (256 or 128),
// or 0 where its staged window does not fit in shared memory, to *frames.
extern "C" int nx_framed_dft_tc_frames(int64_t stride, int64_t krows_pad, void* frames) {
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  *static_cast<int64_t*>(frames) =
      stride < 1 || stride > 0xffff || krows_pad < 1 ? 0
                                                     : frames_per_cta(stride, krows_pad, max_smem);
  return 0;
}

// x (channels, length) f32; w (ceil(bins / 64), krows_pad, 128, 2) f32, the
// split weights laid out as above; out (channels, num_frames, bins) f32; all
// contiguous on the current device. passes 3 ('high') or 1 ('default').
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t.
extern "C" int nx_framed_dft_tc_power_f32(const void* x, const void* w, void* out,
                                          int64_t channels, int64_t length, int64_t stride,
                                          int64_t krows_pad, int64_t pad_left,
                                          int64_t num_frames, int64_t bins, int64_t passes,
                                          void* stream) {
  if (channels < 1 || length < 1 || stride < 1 || stride > 0xffff || krows_pad < kChunk ||
      krows_pad % kChunk != 0 || krows_pad > 0xffffff || num_frames < 1 ||
      num_frames > 0x7fffffff || bins < 1 || bins > 0xffffff || (passes != 1 && passes != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const int bm = frames_per_cta(stride, krows_pad, max_smem);
  const float* xf = static_cast<const float*>(x);
  const float2* wf = static_cast<const float2*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 256) {
    return (int)(passes == 3 ? launch<4, 3>(xf, wf, of, channels, length, stride, krows_pad,
                                            pad_left, num_frames, bins, s)
                             : launch<4, 1>(xf, wf, of, channels, length, stride, krows_pad,
                                            pad_left, num_frames, bins, s));
  }
  if (bm == 128) {
    return (int)(passes == 3 ? launch<2, 3>(xf, wf, of, channels, length, stride, krows_pad,
                                            pad_left, num_frames, bins, s)
                             : launch<2, 1>(xf, wf, of, channels, length, stride, krows_pad,
                                            pad_left, num_frames, bins, s));
  }
  return (int)cudaErrorInvalidValue;
}
