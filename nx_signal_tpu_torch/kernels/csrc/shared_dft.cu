// Hopper kernel D: the FIR + windowed framed DFT power chain through shared
// hop-block partial DFTs, on the CUDA cores in exact f32, register-tiled.
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
// The weights come from the host laid out per tile of kSlots = 96 bin columns
// (kernels/cuda_dft.py:_d_weights): w[t, k, 192] f32, the rows zero-padded to
// a multiple of kSumRows. With h = len(coeffs) - 1 neighbour bins on each
// side, tile t gives the 96 - 2h bins from t*(96 - 2h) on, and its column s
// (0..95) is bin position kl = t*(96 - 2h) - h + s: the h columns on each side
// are the neighbours stage C reads. A column past DC or Nyquist holds its
// mirror bin's weights (and is conjugated after stage B); one past the mirror
// range holds zeros. Column-warp wn (0..2) reads the 64 floats at wn*64: the
// Re weights of its 32 columns, then their Im weights, lane group bg (0..7)
// holding columns wn*32 + bg + 8j, j = 0..3, at bg*4 + j, so a lane's 8
// weights are two 16-byte loads and each load of a warp covers 128
// consecutive bytes. The twiddles come laid out by the same columns per tile
// (`_d_twiddles`: tw[t, j, 192], cos where a column's Re weights sit, sin
// where its Im weights sit), from a host table built from the integer phase
// (j * k * stride) % n_fft (an f32 angle of j*k*stride would lose digits at
// ~3e3 rad). The kernel does no index arithmetic on the weights or twiddles.
//
// What bounds it on the H100: operations. Stage A costs 2 * (stride + K - 1)
// * 2*bins / stride FLOP per input sample, 3068 for the 255-tap / 512-point /
// hop-128 chain, half of kernel A's (each hop block's partial DFT is computed
// once and reused by the J frames that overlap it): 1.131 TFLOP at 768 x
// 480000, 16.9 ms at the 67 TFLOP/s f32 peak. Stages B and C add about 8*J +
// 6*len(coeffs) FLOP per output bin. Device-memory traffic is the same ~12 B
// per sample as A's. What the design does about it:
//   * Stage A is kernel A's register-tiled contraction at hop-block
//     granularity: one CTA per (channel, tile of BM = 64 hop blocks, tile of
//     96 columns), 12 warps, 4 along the blocks and 3 along the columns. A
//     warp is 4 block groups x 8 column groups of lanes; a lane holds FPT = 4
//     blocks (fg + 4i) x 4 columns x (Re, Im), 32 accumulators, 80 registers,
//     so 2 CTAs (24 warps) fit an SM. A lane of 8 blocks (16 FMAs per shared
//     load against 10.7 here) needs ~148 registers, so 6-warp CTAs, 12 warps
//     per SM: 16% slower on the H100 (scripts/torch_kernel_variants.py).
//   * Per 4 weight rows a lane loads its FPT blocks' x as 16-byte loads along
//     k and 4 x 2 weight float4s, for 32 * FPT FMAs.
//   * The CTA stages its blocks' window of x once (4-byte cp.async, zeros
//     outside the signal) as (blocks, stride) hop rows at a pitch P = 4 (mod
//     32) floats: block b at k is row b + k / stride, column k % stride.
//   * The weight rows stream through a kStages-deep cp.async ring of kChunk
//     rows (16 x 2, 24 KB), 16-byte copies, one barrier per stage; the
//     chain's laid-out weights (0.9 MB) stay in the 50 MB L2.
//   * Edge waste at the bench chain: 3 tiles x 96 = 288 columns computed for
//     257 bins (+12%); 62 tiles x 64 = 3968 blocks computed for the 3750 the
//     3747 frames need (+5.8%): each tile of 64 blocks gives 61 frames.
//   * Shared memory at the bench chain: the ring (24 KB), x's 66 hop rows
//     (34 KB) and P (64 blocks x 192 floats, 48 KB), 106 KB: 2 CTAs per SM.
//     P lives through stage A; X (stage B's output) then reuses the ring and
//     x's rows. A hop whose window does not fit (a hop of 1000 with n_fft
//     2000) runs 16 blocks per CTA.
//   * Stage B reads P as stage A wrote it, a float4 of 4 columns per load
//     (16 threads per lane group's columns, one per frame set), and writes X
//     in the same layout; stage C reads a column's neighbours there.
//   * Offsets into x and out are 64-bit: the chain's output has 7.4e8
//     elements.
// Stage A sums each chunk of kSumRows = 32 rows in increasing order with fmaf
// and adds the chunk sums into P in chunk order, each thread owning its P
// elements (the stopband bins of a low-pass chain come out of stage C as
// small differences of large X, so P's rounding error is magnified there;
// one running sum over all rows carried ~3.6x the error of this one). Stages
// B and C and the power round every product and sum separately, in the order
// of the plain version (kernels/dft.py:_shared_epilogue_torch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The tile and ring choices; scripts/torch_kernel_variants.py builds the
// kernel with others through -D (NX_D_STAGE_A_ONLY cuts stages B and C, to
// time stage A alone)
#ifndef NX_D_WARPS_M
#define NX_D_WARPS_M 4
#endif
#ifndef NX_D_SUM_ROWS
#define NX_D_SUM_ROWS 32
#endif
#ifndef NX_D_CHUNK
#define NX_D_CHUNK 16
#endif
#ifndef NX_D_STAGES
#define NX_D_STAGES 2
#endif
#ifndef NX_D_BLOCKS
#define NX_D_BLOCKS 64
#endif
#ifndef NX_D_MIN_CTAS
#define NX_D_MIN_CTAS 2
#endif

constexpr int kWarpsM = NX_D_WARPS_M;      // warps along the hop blocks
constexpr int kWarpsN = 3;                 // and along the columns
constexpr int kWarps = kWarpsM * kWarpsN;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 32 * kWarpsN;       // bin columns per CTA
constexpr int kCols = 2 * kSlots;          // floats per weight row of a tile
constexpr int kSumRows = NX_D_SUM_ROWS;    // weight rows per chunk sum of stage A
constexpr int kChunk = NX_D_CHUNK;         // weight rows per ring stage
constexpr int kStages = NX_D_STAGES;
constexpr int kBlocks = NX_D_BLOCKS;       // hop blocks per CTA where the window fits
constexpr int kBlocksSmall = 16;           // and where it does not
constexpr int kMinCtas = NX_D_MIN_CTAS;    // CTAs per SM the register budget allows
constexpr int kMaxCoeffs = 8;
constexpr int64_t kMaxGridZ = 65535;
static_assert(kSumRows % kChunk == 0, "a chunk sum covers whole ring stages");
static_assert(kBlocksSmall % (4 * kWarpsM) == 0 && kBlocks % kBlocksSmall == 0,
              "whole blocks per lane");

// floats per staged x row: at least stride, = 4 (mod 32)
__host__ __device__ inline int x_pitch(int stride) { return stride + ((36 - stride % 32) % 32); }

// hop rows holding the windows of bm blocks
__host__ __device__ inline int64_t x_rows(int bm, int64_t stride, int64_t krows_pad) {
  return ((int64_t)(bm - 1) * stride + krows_pad + stride - 1) / stride;
}

// Shared memory for bm blocks per CTA: region 0 holds the ring and x's hop
// rows during stage A and X afterwards; then P (bm blocks x kCols).
__host__ __device__ inline int64_t region0_len(int bm, int64_t stride, int64_t krows_pad) {
  const int64_t stage_a = (int64_t)kStages * kChunk * kCols +
                          x_rows(bm, stride, krows_pad) * x_pitch((int)stride);
  const int64_t spectrum = (int64_t)bm * kCols;
  return stage_a > spectrum ? stage_a : spectrum;
}

inline size_t smem_bytes(int bm, int64_t stride, int64_t krows_pad) {
  return (size_t)(region0_len(bm, stride, krows_pad) + (int64_t)bm * kCols) * sizeof(float);
}

// Where column s (0..kSlots-1) of a tile sits in a laid-out row (its Re;
// its Im 32 further): column wn*32 + bg + 8j at wn*64 + bg*4 + j
__device__ __forceinline__ int col_pos(int s) { return (s / 32) * 64 + (s % 8) * 4 + (s / 8) % 4; }

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

// BM hop blocks per CTA, BM / (4 * kWarpsM) per lane; VEC 4 loads x as
// float4 along k (stride % 4 == 0), VEC 1 as scalars
template <int BM, int VEC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
shared_dft_power_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ tw, const float* __restrict__ wc,
                        float* __restrict__ out, int64_t length, int stride, int krows_pad,
                        int64_t pad_left, int num_frames, int bins, int j_taps, int ncoef,
                        int col_tiles) {
  constexpr int FPT = BM / (4 * kWarpsM);    // hop blocks per lane
  extern __shared__ __align__(16) float smem[];
  const int P = x_pitch(stride);
  const int rows = (int)x_rows(BM, stride, krows_pad);
  float* ws = smem;                                         // stage A: the weight ring
  float* xs = smem + kStages * kChunk * kCols;              // stage A: x's hop rows
  float* xspec = smem;                                      // stages B-C: X
  float* pspec = smem + region0_len(BM, stride, krows_pad);  // P

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bg = lane & 7;   // column group
  const int fg = lane >> 3;  // block group
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int tile = blockIdx.x % col_tiles;
  const int tile_m = BM - j_taps + 1;         // frames per CTA
  const int m0 = (blockIdx.x / col_tiles) * tile_m;  // first frame = first hop block
  const int halo = ncoef - 1;                 // neighbour bins on each side
  const int64_t ch = blockIdx.z;
  const int nstages = krows_pad / kChunk;

  const float* wt = w + (int64_t)tile * krows_pad * kCols;
  auto load_stage = [&](int st) {
    const float* src = wt + (int64_t)st * kChunk * kCols;
    float* dst = ws + (st % kStages) * kChunk * kCols;
    for (int i = 4 * tid; i < kChunk * kCols; i += 4 * kThreads) cp_async16(dst + i, src + i);
  };

  // the blocks' window of x: sample s of the window (x index m0*stride -
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
  for (int c = 0; c < kStages - 1; ++c) {  // one commit group per stage, even empty
    if (c < nstages) load_stage(c);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // ---- stage A: P for this CTA's hop blocks and columns
  float re[FPT][4], im[FPT][4];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
  }

  // this lane's first block row; block i is 4 rows further per i. (q, r) is
  // k's (row, column) in the hop rows, advanced by VEC per step. The lane's
  // P elements sit where its weights sit in a weight row.
  const float* xrow = xs + (wm * 4 * FPT + fg) * P;
  const int p4 = 4 * P;
  const int wofs = wn * 64 + bg * 4;
  float* prow = pspec + (wm * 4 * FPT + fg) * kCols + wofs;
  int q = 0, r = 0;

  for (int st = 0; st < nstages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // x staged; this stage visible; every warp done with st - 1
    // refill the slot stage st - 1 used
    if (st + kStages - 1 < nstages) load_stage(st + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* wst = ws + (st % kStages) * kChunk * kCols + wofs;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += VEC) {
      float xv[FPT][VEC];
      const float* xk = xrow + q * P + r;
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
        const float4 wr = *reinterpret_cast<const float4*>(wst + (kk + v) * kCols);
        const float4 wi = *reinterpret_cast<const float4*>(wst + (kk + v) * kCols + 32);
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
      r += VEC;
      if (r >= stride) r -= stride, ++q;
    }
    // Two-level sum: after each kSumRows rows, this chunk's sums are added
    // into P (the first chunk's stored as they are)
    if ((st + 1) % (kSumRows / kChunk) == 0) {
      const bool first = st < kSumRows / kChunk;
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        float4* pr = reinterpret_cast<float4*>(prow + 4 * i * kCols);
        float4* pi = reinterpret_cast<float4*>(prow + 4 * i * kCols + 32);
        float4 a = make_float4(re[i][0], re[i][1], re[i][2], re[i][3]);
        float4 b = make_float4(im[i][0], im[i][1], im[i][2], im[i][3]);
        if (!first) {
          const float4 pa = *pr, pb = *pi;
          a = make_float4(__fadd_rn(pa.x, a.x), __fadd_rn(pa.y, a.y), __fadd_rn(pa.z, a.z),
                          __fadd_rn(pa.w, a.w));
          b = make_float4(__fadd_rn(pb.x, b.x), __fadd_rn(pb.y, b.y), __fadd_rn(pb.z, b.z),
                          __fadd_rn(pb.w, b.w));
        }
        *pr = a;
        *pi = b;
#pragma unroll
        for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
      }
    }
  }
  __syncthreads();  // P complete; every read of the ring and of x's rows done
#ifdef NX_D_STAGE_A_ONLY
  if (P > 0) return;   // P, the pitch, is never 0: stage A is not cut away
#endif

  // ---- stage B: thread (column group cg, frame set fs) forms X[m] = sum_j
  // tw[j] * P[m + j], in j order, for the 4 columns stage A's lane group cg
  // % 8 of column-warp cg / 8 held (float4s of the P rows and of the laid-out
  // twiddles) and frames m = fs + 4*kWarpsM*i
  const int cg = tid % (kSlots / 4);
  const int fs = tid / (kSlots / 4);
  const int cofs = (cg / 8) * 64 + (cg % 8) * 4;   // its columns' Re in a row; Im 32 further
  const float* twc = tw + (int64_t)tile * j_taps * kCols + cofs;
  for (int jt = 0; jt < j_taps; ++jt) {
    const float4 tr = __ldg(reinterpret_cast<const float4*>(twc + jt * kCols));
    const float4 ti = __ldg(reinterpret_cast<const float4*>(twc + jt * kCols + 32));
    const float twr[4] = {tr.x, tr.y, tr.z, tr.w};
    const float twi[4] = {ti.x, ti.y, ti.z, ti.w};
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const int m = fs + 4 * kWarpsM * i;
      if (m >= tile_m) continue;
      const float4 a4 = *reinterpret_cast<const float4*>(pspec + (m + jt) * kCols + cofs);
      const float4 b4 = *reinterpret_cast<const float4*>(pspec + (m + jt) * kCols + cofs + 32);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // stage A's sums are zero again: X starts at 0
        re[i][j] = __fsub_rn(__fadd_rn(re[i][j], __fmul_rn(twr[j], a[j])), __fmul_rn(twi[j], b[j]));
        im[i][j] = __fadd_rn(__fadd_rn(im[i][j], __fmul_rn(twr[j], b[j])), __fmul_rn(twi[j], a[j]));
      }
    }
  }
  // a column past DC or Nyquist holds the conjugate of its mirror bin's X;
  // X is written where P was laid out, over the ring and x's rows
  const int tile_k = kSlots - 2 * halo;
  float sign[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kl = tile * tile_k - halo + (cg / 8) * 32 + cg % 8 + 8 * j;
    sign[j] = (kl < 0 || kl > bins - 1) ? -1.0f : 1.0f;
  }
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int m = fs + 4 * kWarpsM * i;
    if (m >= tile_m) continue;
    *reinterpret_cast<float4*>(xspec + m * kCols + cofs) =
        make_float4(re[i][0], re[i][1], re[i][2], re[i][3]);
    *reinterpret_cast<float4*>(xspec + m * kCols + cofs + 32) = make_float4(
        sign[0] * im[i][0], sign[1] * im[i][1], sign[2] * im[i][2], sign[3] * im[i][3]);
  }
  __syncthreads();

  // ---- stage C and the power: thread (column s, frame set tid / kSlots);
  // each output column reads its h neighbours in the tile
  const int s = tid % kSlots;
  const int kl = tile * tile_k - halo + s;
  if (s < halo || s >= kSlots - halo || kl >= bins) return;
  const int p0 = col_pos(s);
  for (int m = tid / kSlots; m < tile_m; m += kThreads / kSlots) {
    if (m0 + m >= num_frames) break;
    const float* xm = xspec + m * kCols;
    float o_re = __fmul_rn(wc[0], xm[p0]);
    float o_im = __fmul_rn(wc[0], xm[p0 + 32]);
    for (int c = 1; c < ncoef; ++c) {
      const float a = wc[c];
      if (a == 0.0f) continue;
      const int pl = col_pos(s - c), pr = col_pos(s + c);
      o_re = __fadd_rn(o_re, __fmul_rn(a, __fadd_rn(xm[pl], xm[pr])));
      o_im = __fadd_rn(o_im, __fmul_rn(a, __fadd_rn(xm[pl + 32], xm[pr + 32])));
    }
    out[(ch * num_frames + m0 + m) * (int64_t)bins + kl] =
        __fadd_rn(__fmul_rn(o_re, o_re), __fmul_rn(o_im, o_im));
  }
}

// The column tiles of the laid-out weights and twiddles
inline int64_t col_tiles_of(int64_t bins, int64_t ncoef) {
  const int64_t tile_k = kSlots - 2 * (ncoef - 1);
  return (bins + tile_k - 1) / tile_k;
}

// The hop blocks per CTA a launch takes: kBlocks where the staged window
// fits and a CTA holds a frame's J blocks, else kBlocksSmall, else 0 (no
// launch)
int blocks_per_cta(int64_t stride, int64_t krows_pad, int64_t j_taps, int max_smem) {
  if (j_taps <= kBlocks && smem_bytes(kBlocks, stride, krows_pad) <= (size_t)max_smem) {
    return kBlocks;
  }
  if (j_taps <= kBlocksSmall && smem_bytes(kBlocksSmall, stride, krows_pad) <= (size_t)max_smem) {
    return kBlocksSmall;
  }
  return 0;
}

using KernelFn = decltype(&shared_dft_power_kernel<kBlocks, 4>);

// The kernel a geometry takes on the current device (its blocks per CTA,
// float4 loads of x where stride % 4 == 0) and its shared memory, with the
// kernel's attributes set for it; cudaErrorInvalidValue where none takes it
struct Plan {
  KernelFn kernel;
  int bm;
  size_t smem;
};

cudaError_t plan_for(int64_t stride, int64_t krows_pad, int64_t j_taps, Plan* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int bm = blocks_per_cta(stride, krows_pad, j_taps, max_smem);
  if (bm == 0) return cudaErrorInvalidValue;
  const bool vec = stride % 4 == 0;
  plan->kernel = bm == kBlocks ? (vec ? shared_dft_power_kernel<kBlocks, 4>
                                      : shared_dft_power_kernel<kBlocks, 1>)
                               : (vec ? shared_dft_power_kernel<kBlocksSmall, 4>
                                      : shared_dft_power_kernel<kBlocksSmall, 1>);
  plan->bm = bm;
  plan->smem = smem_bytes(bm, stride, krows_pad);
  err = cudaFuncSetAttribute(plan->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan->smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(plan->kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// x (channels, length) f32; w (col_tiles, krows_pad, 192) f32, the weights
// laid out as above; tw (col_tiles, j_taps, 192) f32, the twiddles laid out
// as above (col_tiles = ceil(bins / (96 - 2*(ncoef - 1)))); wc (ncoef) f32,
// [b_0, b_1/2, b_2/2, ...]; out (channels, num_frames, bins) f32; all
// contiguous on the current device. krows_pad a multiple of kSumRows.
// Launches on `stream` (of that device) without synchronising; returns the
// launch's cudaError_t.
extern "C" int nx_shared_dft_power_f32(const void* x, const void* w, const void* tw,
                                       const void* wc, void* out, int64_t channels,
                                       int64_t length, int64_t stride, int64_t krows_pad,
                                       int64_t pad_left, int64_t num_frames, int64_t bins,
                                       int64_t j_taps, int64_t ncoef, void* stream) {
  if (channels < 1 || length < 1 || stride < 1 || stride > 0xffff || krows_pad < kSumRows ||
      krows_pad % kSumRows != 0 || krows_pad > 0xffffff || num_frames < 1 ||
      num_frames > 0x7fffffff || bins < 2 || bins > 0xffffff || j_taps < 1 || ncoef < 1 ||
      ncoef > kMaxCoeffs || ncoef - 1 >= bins - 1) {
    return (int)cudaErrorInvalidValue;
  }
  Plan plan;
  cudaError_t err = plan_for(stride, krows_pad, j_taps, &plan);
  if (err != cudaSuccess) return (int)err;
  const int64_t tile_m = plan.bm - j_taps + 1;
  const int64_t col_tiles = col_tiles_of(bins, ncoef);
  const int64_t blocks = (num_frames + tile_m - 1) / tile_m * col_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    plan.kernel<<<dim3((unsigned)blocks, 1, (unsigned)nc), kThreads, plan.smem,
                  static_cast<cudaStream_t>(stream)>>>(
        xf + c0 * length, static_cast<const float*>(w), static_cast<const float*>(tw),
        static_cast<const float*>(wc), of + c0 * num_frames * bins, length, (int)stride,
        (int)krows_pad, pad_left, (int)num_frames, (int)bins, (int)j_taps, (int)ncoef,
        (int)col_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The CTAs of kernel D that one SM holds at once for this geometry (the
// occupancy calculator, on the current device, for the kernel a launch
// takes), written to *ctas; cudaErrorInvalidValue where no launch takes it.
extern "C" int nx_shared_dft_ctas_per_sm(int64_t stride, int64_t krows_pad, int64_t j_taps,
                                         void* ctas) {
  int64_t* result = static_cast<int64_t*>(ctas);
  *result = 0;
  if (stride < 1 || stride > 0xffff || krows_pad < kSumRows || krows_pad % kSumRows != 0 ||
      j_taps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Plan plan;
  cudaError_t err = plan_for(stride, krows_pad, j_taps, &plan);
  if (err != cudaSuccess) return (int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, plan.kernel, kThreads, plan.smem);
  if (err != cudaSuccess) return (int)err;
  *result = n;
  return (int)cudaSuccess;
}
