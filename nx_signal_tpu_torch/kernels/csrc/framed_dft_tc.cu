// Hopper kernel A-tc: the fused FIR + framed DFT power chain (kernel A's
// function) on the tensor cores with wgmma, at the precisions 'high'
// (3xTF32) and 'default' (one TF32 pass). 'highest' stays kernel A
// (framed_dft.cu).
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
// The weights come from the host already split and laid out
// (kernels/cuda_dft.py:_tc_weights), per tile of kTileBins bin slots: the
// tile's 128 columns are the Re columns of its slots, then their Im columns.
// Slot s is bin s, except where `packed` (one-sided weights of an even
// n_fft, checked on the host): the DC bin's Im column (exactly zero) is
// dropped and slot 0 carries the last (Nyquist) bin's Re column in its
// place, its Im column (below f32 resolution of the Re one) dropped too, so
// 257 bins fill exactly 256 slots, 4 tiles. Each tile's krows_pad rows
// (a multiple of kChunk, zeros past krows) stream as stages of kStageBytes:
// kChunk rows of W_hi at one pass, kChunk/2 rows of W_hi then W_lo at three.
// Within a stage each k-step of 8 rows is W^T in wgmma's canonical K-major
// layout without swizzle: core matrices of 8 columns x 4 rows (128
// contiguous bytes, column n at 16 n bytes), the 16 column groups 128 bytes
// apart, the two 4-row halves of the k-step 2048 bytes apart.
//
// What bounds it on the H100: operations. The route is the dense folded
// DFT, 2 * krows * 2*slots FLOP per frame, three times over for 'high':
// 6.8 TFLOP at 768 x 480000 with the 255-tap / hann-512 / hop-128 chain,
// 13.7 ms at the 495 TFLOP/s TF32 peak ('default' 4.6 ms). What the design
// does about it:
//   * An implicit GEMM per channel (M = frames, K = krows, N = 2*slots):
//     the frame matrix is never built. One CTA per (channel, tile of 256
//     frames, or 128 for long hops) walks every bin tile, so its window of
//     x is staged once: f32, 4-byte cp.async zero-filled outside the signal,
//     as (blocks, stride) rows at a pitch P = 4 (mod 32) floats. Frame m at
//     column k is row m + k / stride, offset k % stride; frame rows sit at
//     any offset of that window, which no swizzle atom of a shared-memory
//     descriptor can follow, so A comes from registers.
//   * Three warpgroups: two consumers (setmaxnreg 232) each own 128 (or 64)
//     frames as MF m64 blocks of wgmma.mma_async.m64n128k8.f32.tf32.tf32,
//     A from registers, B (the weight stage) from shared memory; one
//     producer warp (setmaxnreg 40) streams the stages with bulk copies
//     (cp.async.bulk, the TMA engine; the host has laid each stage out as
//     its shared-memory image) into a kStages ring of full/empty mbarriers.
//   * A consumer loads each m64 block's fragment from the staged window
//     (the mma.m16n8k8 layout per warp: rows g and g + 8, columns t and
//     t + 4; the 32 lanes' loads fall in distinct banks) and rounds it with
//     cvt.rna before it issues (wgmma truncates TF32 operands), into a
//     register double buffer: each k-step's products go out as one wgmma
//     group, and the next k-step's fragments load while it runs (commit,
//     then wait for all but the newest group). A group per whole stage
//     measured slower at one pass and the same at three
//     (scripts/torch_kernel_variants.py).
//   * Re and Im of the same slots sit in one thread's accumulators (column
//     n and 64 + n), so re^2 + im^2 forms in registers and only the power
//     is written.
//   * 'default' streams W_hi alone: 393 KB per bin tile at the chain, half
//     the (hi, lo) pairs; 256 packed slots are 20% less tensor work and
//     weight traffic than 257 bins padded to 320.
//   * Every frame runs the same k-steps and, at each, the products x_lo
//     W_hi, x_hi W_lo, x_hi W_hi into the same accumulators in that order,
//     whatever its tile: a frame's sum does not depend on where its CTA
//     starts (the sharded chain stays bitwise equal to the single-device
//     one).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileBins = 64;            // bin slots per tile (Re and Im: 128 columns)
constexpr int kCols = 2 * kTileBins;
constexpr int kChunk = 32;               // weight rows per stage at one pass
constexpr int kStageBytes = kChunk * kCols * 4;
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRingOffset = 1024;        // the mbarriers, then the ring
constexpr int64_t kMaxGridZ = 65535;
// k-steps of 8 weight rows per wgmma group (commit, then wait for all but
// the newest group); 0 takes a whole stage (scripts/torch_kernel_variants.py
// builds that to compare)
constexpr int kGroupSteps = 1;

// floats per staged x row: at least stride, = 4 (mod 32) for conflict-free
// fragment loads
__host__ __device__ inline int x_pitch(int stride) { return stride + ((36 - stride % 32) % 32); }

__host__ __device__ inline int64_t x_rows(int bm, int64_t stride, int64_t krows_pad) {
  return ((int64_t)(bm - 1) * stride + krows_pad + stride - 1) / stride;
}

inline size_t smem_bytes(int bm, int64_t stride, int64_t krows_pad) {
  return (size_t)(kRingOffset + kStages * kStageBytes +
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes, or 4 zero bytes where src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, unsigned src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from global to shared memory on the TMA engine, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared-memory descriptor of a K-major, unswizzled B operand at `addr`:
// core matrices 2048 bytes apart along K (leading), 128 along N (stride)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma boundaries
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 8, TF32, registers) * B (8 x 128, TF32, the
// descriptor), over the warpgroup
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// MF m64 blocks per consumer warpgroup (kConsumers * 64 * MF frames per
// CTA), PASSES 3 or 1
template <int MF, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
framed_dft_tc_kernel(const float* __restrict__ x, const char* __restrict__ w,
                     float* __restrict__ out, int64_t length, int stride, int krows_pad,
                     int64_t pad_left, int num_frames, int bins, int slots, int bin_tiles,
                     int packed) {
  constexpr int kBM = kConsumers * 64 * MF;
  constexpr int kRows = PASSES == 3 ? kChunk / 2 : kChunk;  // weight rows per stage
  constexpr int kSteps = kRows / 8;
  constexpr int kGroup = kGroupSteps > 0 && kGroupSteps < kSteps ? kGroupSteps : kSteps;
  constexpr int kGroups = kSteps / kGroup;
  static_assert(kSteps % kGroup == 0, "a wgmma group takes whole k-steps of a stage");
  extern __shared__ __align__(1024) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  char* ring = smem + kRingOffset;
  const int P = x_pitch(stride);
  const int rows = (int)x_rows(kBM, stride, krows_pad);
  float* xs = reinterpret_cast<float*>(ring + kStages * kStageBytes);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int64_t ch = blockIdx.z;
  const int nchunks = krows_pad / kRows;
  const int fills = bin_tiles * nchunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the frames' window of x: sample s of the window (x index m0*stride -
  // pad_left + s) at row s / stride, column s % stride
  const float* xc = x + ch * length;
  const int64_t s0 = (int64_t)m0 * stride - pad_left;
  for (int r = tid >> 5; r < rows; r += kThreads / 32) {
    for (int c = tid & 31; c < stride; c += 32) {
      const int64_t gi = s0 + (int64_t)r * stride + c;
      const bool inside = gi >= 0 && gi < length;
      cp_async4(xs + r * P + c, xc + (inside ? gi : 0), inside ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // x staged, barriers initialised

  const int wg = tid >> 7;
  if (wg == kConsumers) {
    // the producer: one thread streams every stage of every bin tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      for (int f = 0; f < fills; ++f) {
        const int s = f % kStages;
        if (f >= kStages) mbar_wait(&empty[s], (f / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        bulk_load(ring + s * kStageBytes, w + (int64_t)f * kStageBytes, kStageBytes, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int warp = (tid >> 5) & 3;
    const int frow = wg * 64 * MF + warp * 16 + g;  // this thread's first frame row
    const float* xrow = xs + frow * P;
    const uint32_t ring_addr = smem_addr(ring);

    float acc[MF][64];
    for (int tile = 0; tile < bin_tiles; ++tile) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < MF; ++i) pin(acc[i]);
      // (block, offset) of k = k0 + t and k0 + t + 4, advanced by 8 per k-step
      int qa = t / stride, ra = t % stride;
      int qb = (t + 4) / stride, rb = (t + 4) % stride;
      int pending = -1;  // the stage whose wgmmas may still be reading it
      // the A fragments of kGroup k-steps, double-buffered across groups
      uint32_t a_hi[2][kGroup][MF][4], a_lo[2][kGroup][MF][4];
      // one stage: its k-steps' fragments loaded and rounded, then their
      // products issued, kGroup k-steps per wgmma group; PARITY is the
      // chunk's parity, so every buffer index is known at compile time
      auto run_chunk = [&](int chunk, auto parity) {
        constexpr int kParity = decltype(parity)::value;
        const int f = tile * nchunks + chunk;
        const int s = f % kStages;
        mbar_wait(&full[s], (f / kStages) & 1);
        const uint32_t stage = ring_addr + s * kStageBytes;
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const int b = (kParity * kGroups + gi) & 1;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
#pragma unroll
            for (int i = 0; i < MF; ++i) {
              const float* xi = xrow + i * 64 * P;
              const float v[4] = {xi[qa * P + ra], xi[(qa + 8) * P + ra], xi[qb * P + rb],
                                  xi[(qb + 8) * P + rb]};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                a_hi[b][j][i][e] = tf32(v[e]);
                if constexpr (PASSES == 3) {
                  a_lo[b][j][i][e] = tf32(v[e] - __uint_as_float(a_hi[b][j][i][e]));
                }
              }
            }
            ra += 8;
            while (ra >= stride) ra -= stride, ++qa;
            rb += 8;
            while (rb >= stride) rb -= stride, ++qb;
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int ks = gi * kGroup + j;
            const uint64_t hi = b_desc(stage + ks * 4096);
            if constexpr (PASSES == 3) {
              const uint64_t lo = b_desc(stage + (kSteps + ks) * 4096);
#pragma unroll
              for (int i = 0; i < MF; ++i) wgmma_tf32(acc[i], a_lo[b][j][i], hi);
#pragma unroll
              for (int i = 0; i < MF; ++i) wgmma_tf32(acc[i], a_hi[b][j][i], lo);
            }
#pragma unroll
            for (int i = 0; i < MF; ++i) wgmma_tf32(acc[i], a_hi[b][j][i], hi);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous group's products are done
          if (gi == 0 && pending >= 0) {
            if (lane == 0) mbar_arrive(&empty[pending]);  // its stage is free
            pending = -1;
          }
        }
        pending = s;
      };
      for (int chunk = 0; chunk < nchunks; chunk += 2) {
        run_chunk(chunk, std::integral_constant<int, 0>{});
        if (chunk + 1 < nchunks) run_chunk(chunk + 1, std::integral_constant<int, 1>{});
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MF; ++i) pin(acc[i]);
      if (lane == 0) mbar_arrive(&empty[pending]);

      // power epilogue: accumulator 4j + e of block i is frame row g (+8 for
      // e >= 2) and column 8j + 2t + (e & 1); Re column n pairs with Im
      // column 64 + n (j + 8). Where packed, slot 0's Im sum is the last
      // bin's Re, and the DC bin's dropped Im is 0 times its Re sum: zero
      // for a finite frame, NaN where it holds an inf or a NaN, as x @ W
      // gives over the zero column
#pragma unroll
      for (int i = 0; i < MF; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + frow + i * 64 + (e >> 1) * 8;
          if (m >= num_frames) continue;
          float* orow = out + (ch * num_frames + m) * (int64_t)bins;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int slot = tile * kTileBins + j * 8 + 2 * t + (e & 1);
            if (slot >= slots) continue;
            const float re = acc[i][4 * j + e], im = acc[i][4 * (j + 8) + e];
            if (packed && slot == 0) {
              const float dc_im = __fmul_rn(0.0f, re);
              orow[0] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(dc_im, dc_im));
              orow[bins - 1] = __fmul_rn(im, im);
            } else {
              orow[slot] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            }
          }
        }
      }
    }
  }
}

template <int MF, int PASSES>
cudaError_t launch(const float* x, const char* w, float* out, int64_t channels, int64_t length,
                   int64_t stride, int64_t krows_pad, int64_t pad_left, int64_t num_frames,
                   int64_t bins, bool packed, cudaStream_t stream) {
  auto kernel = framed_dft_tc_kernel<MF, PASSES>;
  const size_t smem = smem_bytes(kConsumers * 64 * MF, stride, krows_pad);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t slots = packed ? bins - 1 : bins;
  const int64_t bin_tiles = (slots + kTileBins - 1) / kTileBins;
  const int64_t blocks = (num_frames + kConsumers * 64 * MF - 1) / (kConsumers * 64 * MF);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridZ) {
    const int64_t nc = channels - c0 < kMaxGridZ ? channels - c0 : kMaxGridZ;
    kernel<<<dim3((unsigned)blocks, 1, (unsigned)nc), kThreads, smem, stream>>>(
        x + c0 * length, w, out + c0 * num_frames * bins, length, (int)stride, (int)krows_pad,
        pad_left, (int)num_frames, (int)bins, (int)slots, (int)bin_tiles, packed ? 1 : 0);
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

// x (channels, length) f32; w the laid-out weights, ceil(slots / 64) tiles
// of krows_pad / kChunk * (passes == 3 ? 2 : 1) stages of kStageBytes
// (slots = bins - 1 where packed, else bins), 16-byte aligned; out
// (channels, num_frames, bins) f32; all contiguous on the current device.
// passes 3 ('high') or 1 ('default'). Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
extern "C" int nx_framed_dft_tc_power_f32(const void* x, const void* w, void* out,
                                          int64_t channels, int64_t length, int64_t stride,
                                          int64_t krows_pad, int64_t pad_left,
                                          int64_t num_frames, int64_t bins, int64_t packed,
                                          int64_t passes, void* stream) {
  if (channels < 1 || length < 1 || stride < 1 || stride > 0xffff || krows_pad < kChunk ||
      krows_pad % kChunk != 0 || krows_pad > 0xffffff || num_frames < 1 ||
      num_frames > 0x7fffffff || bins < 1 + (packed != 0) || bins > 0xffffff ||
      (passes != 1 && passes != 3) || (reinterpret_cast<uintptr_t>(w) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int max_smem = 0;
  const int err = max_smem_optin(&max_smem);
  if (err != 0) return err;
  const int bm = frames_per_cta(stride, krows_pad, max_smem);
  const float* xf = static_cast<const float*>(x);
  const char* wb = static_cast<const char*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pk = packed != 0;
#define NX_LAUNCH(MF, PASSES)                                                                 \
  launch<MF, PASSES>(xf, wb, of, channels, length, stride, krows_pad, pad_left, num_frames, \
                     bins, pk, s)
  if (bm == 256) return (int)(passes == 3 ? NX_LAUNCH(2, 3) : NX_LAUNCH(2, 1));
  if (bm == 128) return (int)(passes == 3 ? NX_LAUNCH(1, 3) : NX_LAUNCH(1, 1));
#undef NX_LAUNCH
  return (int)cudaErrorInvalidValue;
}
