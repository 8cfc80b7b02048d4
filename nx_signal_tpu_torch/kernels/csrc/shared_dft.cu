// Hopper kernel D: the FIR + windowed framed DFT power chain through shared
// hop-block partial DFTs, on the CUDA cores in exact f32.
//
// Replaces (TPU kernel of the JAX package):
//   D  nx_signal_tpu/kernels/pallas_dft.py:fir_framed_dft_power_shared_pallas
//
// For channel c, with J = n_fft / stride hop blocks per frame:
//   stage A  P[b, k] = sum_r xe[b, r] * E[r, k]   for every hop block b the
//            frames touch, xe[b, r] = x[c, b*stride - pad_left + r] (0 outside
//            [0, length)), E the (stride + K - 1, 2*bins) [Re | Im] partial-DFT
//            weights with the FIR folded in (kernels/dft.py:shared_fold_weights)
//   stage B  X[m, k] = sum_j tw[j, k] * P[m + j, k]            (complex, j = 0..J-1)
//   stage C  Xw[m, k] = a_0 X[m, k] + sum_c a_c (X[m, k-c] + X[m, k+c]),
//            a_0 = b_0 and a_c = b_c / 2 for the cosine-sum window
//            w[t] = sum_c b_c cos(2 pi c t / n_fft); below DC and past Nyquist
//            a bin reflects with a conjugate (X[-q] = conj X[q],
//            X[2(bins-1) - q] = conj X[q]; one-sided spectrum, even n_fft)
//   out[c, m, k] = re(Xw)^2 + im(Xw)^2                          (bins columns)
// The spectrum never reaches device memory: x is read, the power written.
//
// What bounds it on the H100: stage A costs 2 * (stride + K - 1) * 2*bins /
// stride FLOP per input sample, 3084 for the 255-tap / 512-point / hop-128
// chain, half of kernel A's 6152 (each hop block's partial DFT is computed
// once and reused by the J frames that overlap it); stages B and C add
// about 8*J + 6*len(coeffs) FLOP per output bin. Device-memory traffic is
// the same ~12 B per sample as A's, so the kernel is compute-bound on the
// CUDA cores' f32 FMA. What the design does about it:
//   * One CTA per (tile of 8*FPT hop blocks, tile of 96 bin columns,
//     channel). Stage A is kernel A's loop at hop-block granularity: the
//     blocks' window of x is staged in shared memory once, the weight rows
//     stream from L2 in chunks of 32, and each thread keeps FPT blocks x 3
//     columns x (Re, Im) sums in registers.
//   * A CTA's 8*FPT blocks give 8*FPT - J + 1 frames, and its 96 columns
//     give 96 - 2h bins, h = len(coeffs) - 1: the CTA computes the h
//     neighbouring bins on each side that stage C reads. A column past DC
//     or Nyquist is computed at its mirror bin and conjugated, so no CTA
//     needs another's results.
//   * P and then X pass through shared memory (the twiddle combine reads
//     other warps' blocks, the window other lanes' bins); X reuses the
//     staging area of stage A.
//   * The twiddles come from a host table built from the integer phase
//     (j * k * stride) % n_fft; an f32 angle of j*k*stride on the device
//     would lose digits at ~3e3 rad.
//   * Offsets into x and out are 64-bit: the chain's output has 7.4e8
//     elements.
// Stage A sums each chunk of 32 rows in increasing order with fmaf and adds
// the chunk sums in chunk order. Stages B and C and the power round every
// product and sum separately, in the order of the plain version
// (kernels/dft.py:_shared_epilogue_torch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                          // threads along bin columns
constexpr int kWarps = 8;                           // threads along hop blocks
constexpr int kThreads = kLanes * kWarps;
constexpr int kColsPerThread = 3;
constexpr int kTileCols = kLanes * kColsPerThread;  // bin columns per CTA
constexpr int kChunk = 32;                          // weight rows per stage
constexpr int kRowCols = 2 * kTileCols;             // Re columns, then Im
constexpr int kMaxCoeffs = 8;
constexpr int64_t kMaxGridZ = 65535;

// Samples of x one CTA stages for its 8*fpt hop blocks, with the weight rows
// rounded up to whole chunks (the extra rows meet zero weights).
__host__ __device__ inline int64_t window_len(int fpt, int64_t stride, int64_t krows) {
  const int64_t kext = (krows + kChunk - 1) / kChunk * kChunk;
  const int64_t n = (int64_t)(kWarps * fpt - 1) * stride + kext;
  return (n + 3) / 4 * 4;  // keeps the weight tile 16-byte aligned
}

// Shared memory: region 0 holds x's window and the weight tile during stage
// A and X afterwards; region 1 holds P.
__host__ __device__ inline int64_t region0_len(int fpt, int64_t stride, int64_t krows) {
  const int64_t stage_a = window_len(fpt, stride, krows) + (int64_t)kChunk * kRowCols;
  const int64_t spectrum = (int64_t)kWarps * fpt * kRowCols;
  return stage_a > spectrum ? stage_a : spectrum;
}

inline size_t smem_bytes(int fpt, int64_t stride, int64_t krows) {
  return (size_t)(region0_len(fpt, stride, krows) + (int64_t)kWarps * fpt * kRowCols) *
         sizeof(float);
}

// The bin whose partial DFT column `kl` reads: kl itself inside [0, bins),
// its mirror through DC or Nyquist within `halo` of them, else -1 (unused).
__device__ inline int mirror_bin(int kl, int bins, int halo) {
  if (kl < -halo || kl > bins - 1 + halo) return -1;
  if (kl < 0) return -kl;
  if (kl > bins - 1) return 2 * (bins - 1) - kl;
  return kl;
}

template <int FPT, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
shared_dft_power_kernel(const float* __restrict__ x, const float* __restrict__ e,
                        const float* __restrict__ tw, const float* __restrict__ wc,
                        float* __restrict__ out, int64_t length, int stride, int krows,
                        int64_t pad_left, int num_frames, int bins, int j_taps, int ncoef) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTileB = kWarps * FPT;
  const int tile_m = kTileB - j_taps + 1;      // frames per CTA
  const int halo = ncoef - 1;                  // neighbour bins on each side
  const int tile_k = kTileCols - 2 * halo;     // bins per CTA
  const int win = (int)window_len(FPT, stride, krows);
  float* xs = smem;                            // stage A: x's window
  float* ws = smem + win;                      // stage A: weight tile
  float* xspec = smem;                         // stages B-C: X, over region 0
  float* pspec = smem + region0_len(FPT, stride, krows);  // P

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int m0 = blockIdx.x * tile_m;          // first frame = first hop block
  const int k0 = blockIdx.y * tile_k - halo;   // bin of column 0
  const int64_t ch = blockIdx.z;

  // the window of x: samples [m0*stride - pad_left, ... + win), zero outside
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride - pad_left;
  for (int i = tid; i < win; i += kThreads) {
    const int64_t g = s0 + i;
    xs[i] = (g >= 0 && g < length) ? xc[g] : 0.0f;
  }

  // ---- stage A: P for this CTA's hop blocks and columns
  float re[FPT][kColsPerThread];
  float im[FPT][kColsPerThread];
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      re[f][j] = 0.0f;
      im[f][j] = 0.0f;
    }
  }

  const float* xrow = xs + warp * FPT * stride;  // this warp's first block
  const int64_t wcols = 2 * (int64_t)bins;

  for (int kc = 0; kc < krows; kc += kChunk) {
    __syncthreads();  // x staged (first pass), previous weight tile consumed
    for (int i = tid; i < kChunk * kRowCols; i += kThreads) {
      const int r = i / kRowCols;
      const int c = i - r * kRowCols;
      const int is_im = c >= kTileCols;
      const int kp = mirror_bin(k0 + c - is_im * kTileCols, bins, halo);
      const int k = kc + r;
      ws[i] = (k < krows && kp >= 0) ? e[(int64_t)k * wcols + is_im * bins + kp] : 0.0f;
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
        const float* wrow = ws + (r + v) * kRowCols + lane;
        float wre[kColsPerThread];
        float wim[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          wre[j] = wrow[j * kLanes];
          wim[j] = wrow[kTileCols + j * kLanes];
        }
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            re[f][j] = fmaf(xv[f][v], wre[j], re[f][j]);
            im[f][j] = fmaf(xv[f][v], wim[j], im[f][j]);
          }
        }
      }
    }
    // Two-level sum: this chunk's sums are added into P (each thread owns
    // its elements). The stopband bins of a low-pass chain come out of
    // stage C as small differences of large X (the window cancels the
    // hop block's leakage), so P's rounding error is magnified there; one
    // running sum over all rows carried ~3.6x the error of this one.
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      float* prow = pspec + (warp * FPT + f) * kRowCols + lane;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        prow[j * kLanes] = kc == 0 ? re[f][j] : __fadd_rn(prow[j * kLanes], re[f][j]);
        prow[kTileCols + j * kLanes] =
            kc == 0 ? im[f][j] : __fadd_rn(prow[kTileCols + j * kLanes], im[f][j]);
        re[f][j] = 0.0f;
        im[f][j] = 0.0f;
      }
    }
  }
  __syncthreads();  // P complete; stage A's reads of region 0 are done

  // ---- stage B: X[m] = sum_j tw[j] * P[m + j], in j order
  for (int jt = 0; jt < j_taps; ++jt) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = j * kLanes + lane;
      const int kp = mirror_bin(k0 + col, bins, halo);
      const float twr = kp >= 0 ? tw[(int64_t)jt * bins + kp] : 0.0f;
      const float twi = kp >= 0 ? tw[(int64_t)(j_taps + jt) * bins + kp] : 0.0f;
#pragma unroll
      for (int f = 0; f < FPT; ++f) {
        const int m = warp * FPT + f;
        if (m >= tile_m) continue;
        const float* prow = pspec + (m + jt) * kRowCols + col;
        const float pr = prow[0];
        const float pi = prow[kTileCols];
        re[f][j] = __fsub_rn(__fadd_rn(re[f][j], __fmul_rn(twr, pr)), __fmul_rn(twi, pi));
        im[f][j] = __fadd_rn(__fadd_rn(im[f][j], __fmul_rn(twr, pi)), __fmul_rn(twi, pr));
      }
    }
  }
  // columns past DC or Nyquist hold the conjugate of their mirror bin
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const int m = warp * FPT + f;
    if (m >= tile_m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = j * kLanes + lane;
      const int kl = k0 + col;
      xspec[m * kRowCols + col] = re[f][j];
      xspec[m * kRowCols + kTileCols + col] = (kl < 0 || kl > bins - 1) ? -im[f][j] : im[f][j];
    }
  }
  __syncthreads();

  // ---- stage C and the power
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const int m = warp * FPT + f;
    if (m >= tile_m || m0 + m >= num_frames) continue;
    const float* xr = xspec + m * kRowCols;
    const float* xi = xr + kTileCols;
    const int64_t row = (ch * num_frames + m0 + m) * (int64_t)bins;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = j * kLanes + lane;
      const int kl = k0 + col;
      if (col < halo || col >= kTileCols - halo || kl >= bins) continue;
      float o_re = __fmul_rn(wc[0], xr[col]);
      float o_im = __fmul_rn(wc[0], xi[col]);
      for (int c = 1; c < ncoef; ++c) {
        const float a = wc[c];
        if (a == 0.0f) continue;
        o_re = __fadd_rn(o_re, __fmul_rn(a, __fadd_rn(xr[col - c], xr[col + c])));
        o_im = __fadd_rn(o_im, __fmul_rn(a, __fadd_rn(xi[col - c], xi[col + c])));
      }
      out[row + kl] = __fadd_rn(__fmul_rn(o_re, o_re), __fmul_rn(o_im, o_im));
    }
  }
}

template <int FPT, int VEC>
cudaError_t launch(const float* x, const float* e, const float* tw, const float* wc,
                   float* out, int64_t channels, int64_t length, int64_t stride,
                   int64_t krows, int64_t pad_left, int64_t num_frames, int64_t bins,
                   int64_t j_taps, int64_t ncoef, cudaStream_t stream) {
  auto kernel = shared_dft_power_kernel<FPT, VEC>;
  const size_t smem = smem_bytes(FPT, stride, krows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t tile_m = kWarps * FPT - j_taps + 1;
  const int64_t tile_k = kTileCols - 2 * (ncoef - 1);
  const dim3 block(kLanes, kWarps);
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    const dim3 grid((unsigned)((num_frames + tile_m - 1) / tile_m),
                    (unsigned)((bins + tile_k - 1) / tile_k), (unsigned)nc);
    kernel<<<grid, block, smem, stream>>>(
        x + c0 * length, e, tw, wc, out + c0 * num_frames * bins, length, (int)stride,
        (int)krows, pad_left, (int)num_frames, (int)bins, (int)j_taps, (int)ncoef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int FPT>
cudaError_t dispatch(const float* x, const float* e, const float* tw, const float* wc,
                     float* out, int64_t channels, int64_t length, int64_t stride,
                     int64_t krows, int64_t pad_left, int64_t num_frames, int64_t bins,
                     int64_t j_taps, int64_t ncoef, cudaStream_t s) {
  if (stride % 4 == 0) {
    return launch<FPT, 4>(x, e, tw, wc, out, channels, length, stride, krows, pad_left,
                          num_frames, bins, j_taps, ncoef, s);
  }
  return launch<FPT, 1>(x, e, tw, wc, out, channels, length, stride, krows, pad_left,
                        num_frames, bins, j_taps, ncoef, s);
}

}  // namespace

// x (channels, length) f32; e (krows, 2*bins) f32; tw (2*j_taps, bins) f32,
// cos rows then sin rows; wc (ncoef) f32, [b_0, b_1/2, b_2/2, ...]; out
// (channels, num_frames, bins) f32; all contiguous on the current device.
// Launches on `stream` (of that device) without synchronising; returns the
// launch's cudaError_t.
extern "C" int nx_shared_dft_power_f32(const void* x, const void* e, const void* tw,
                                       const void* wc, void* out, int64_t channels,
                                       int64_t length, int64_t stride, int64_t krows,
                                       int64_t pad_left, int64_t num_frames, int64_t bins,
                                       int64_t j_taps, int64_t ncoef, void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (channels < 1 || length < 1 || stride < 1 || krows < 1 || num_frames < 1 || bins < 2 ||
      j_taps < 1 || ncoef < 1 || ncoef > kMaxCoeffs || ncoef - 1 >= bins - 1 ||
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
  const float* ef = static_cast<const float*>(e);
  const float* tf = static_cast<const float*>(tw);
  const float* cf = static_cast<const float*>(wc);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64 hop blocks per CTA where the staged window fits, else 16; a CTA
  // must hold at least one frame's J blocks
  if (j_taps <= kWarps * 8 && smem_bytes(8, stride, krows) <= (size_t)max_smem) {
    err = dispatch<8>(xf, ef, tf, cf, of, channels, length, stride, krows, pad_left,
                      num_frames, bins, j_taps, ncoef, s);
  } else if (j_taps <= kWarps * 2 && smem_bytes(2, stride, krows) <= (size_t)max_smem) {
    err = dispatch<2>(xf, ef, tf, cf, of, channels, length, stride, krows, pad_left,
                      num_frames, bins, j_taps, ncoef, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
