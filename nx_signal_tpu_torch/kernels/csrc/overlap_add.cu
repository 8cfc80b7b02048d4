// Hopper kernel C: scatter-free overlap-add of (channels, M, N) frames at
// hop `stride`, bitwise equal to the plain left fold
// (nx_signal_tpu_torch/spectral/framing.py:_ola_fold_torch).
//
// Replaces nx_signal_tpu/kernels/pallas_dft.py:overlap_add_pallas.
//
// Output sample p = q*stride + s receives frames[q - j, j*stride + s] for
// j = C-1, ..., 0 (C = ceil(N / stride)), i.e. its contributing frames in
// increasing frame order, exactly the association of the fold. One thread
// per output sample runs that loop with plain round-to-nearest f32 adds: no
// atomics, no contraction, no reordering. Any hop works, including a ragged
// last block (N % stride != 0) and an out_length that cuts the last row.
//
// An optional seed `init` (channels, out_length) starts the accumulator
// (zeros when it is null): the sharded overlap-add seeds each block's fold
// with its left neighbour's tail. Every j adds a term, +0.0 where no frame
// covers the sample, as the reference fold adds its zero-padded blocks, so
// a seed of -0.0 comes out as it does there; without a seed the extra
// +0.0 adds change nothing.
//
// What bounds it on the H100: device memory. Each output sample reads about
// N / stride frame values and writes one; neighbouring threads read
// neighbouring columns of a frame, so loads and stores are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
overlap_add_kernel(const float* __restrict__ frames, const float* __restrict__ init,
                   float* __restrict__ out, int num_frames, int frame_length, int stride,
                   int c_blocks, int64_t out_length) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= out_length) return;
  const int64_t ch = blockIdx.y;
  const float* f = frames + ch * num_frames * (int64_t)frame_length;
  const int64_t q = p / stride;
  const int s = (int)(p - q * stride);
  float acc = init != nullptr ? init[ch * out_length + p] : 0.0f;
  for (int j = c_blocks - 1; j >= 0; --j) {
    const int64_t m = q - j;
    const int col = j * stride + s;
    const bool covered = m >= 0 && m < num_frames && col < frame_length;
    acc = __fadd_rn(acc, covered ? f[m * frame_length + col] : 0.0f);
  }
  out[ch * out_length + p] = acc;
}

}  // namespace

// frames (channels, num_frames, frame_length) f32, init (channels,
// out_length) f32 or null, and out (channels, out_length) f32, contiguous
// on the current device. Launches on `stream` (of that device) without
// synchronising; returns the launch's cudaError_t.
extern "C" int nx_overlap_add_f32(const void* frames, const void* init, void* out,
                                  int64_t channels,
                                  int64_t num_frames, int64_t frame_length, int64_t stride,
                                  int64_t out_length, void* stream) {
  const int64_t kIntMax = 0x7fffffff;
  if (channels < 1 || num_frames < 1 || frame_length < 1 || stride < 1 || out_length < 1 ||
      num_frames > kIntMax || frame_length > kIntMax || stride > kIntMax) {
    return (int)cudaErrorInvalidValue;
  }
  const int c_blocks = (int)((frame_length + stride - 1) / stride);
  const float* fr = static_cast<const float*>(frames);
  const float* seed = static_cast<const float*>(init);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t c0 = 0; c0 < channels; c0 += kMaxGridY) {
    const int64_t nc = channels - c0 < kMaxGridY ? channels - c0 : kMaxGridY;
    const dim3 grid((unsigned)((out_length + kThreads - 1) / kThreads), (unsigned)nc);
    overlap_add_kernel<<<grid, kThreads, 0, s>>>(fr + c0 * num_frames * frame_length,
                                                 seed != nullptr ? seed + c0 * out_length
                                                                 : nullptr,
                                                 o + c0 * out_length, (int)num_frames,
                                                 (int)frame_length, (int)stride, c_blocks,
                                                 out_length);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
