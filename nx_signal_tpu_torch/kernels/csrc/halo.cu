// Hopper kernel E: the halo exchange between neighbouring time blocks as a
// peer copy, and the receive buffers it copies into.
//
// Replaces nx_signal_tpu/kernels/pallas_halo.py:halo_extend_dma, where each
// TPU core sends its block's tail to its right neighbour and its head to its
// left neighbour by remote DMA (pltpu.make_async_remote_copy) and assembles
// [left halo | block | right halo], zeros at the stream edges.
//
// Here a rank is a process. Each rank cudaMallocs two receive buffers, (C,
// hl) and (C, hr), and exports them with cudaIpcGetMemHandle; its
// neighbours map them with cudaIpcOpenMemHandle (the wrapper,
// kernels/cuda_halo.py, swaps the handles and keeps the mappings). Then:
//   put       one kernel stores this rank's tail x[:, n-hl:] into the right
//             neighbour's left buffer and its head x[:, :hr] into the left
//             neighbour's right buffer: plain global stores through the
//             mapped pointers, on one card into the shared device memory,
//             across cards over NVLink (the mapping enables peer access);
//   assemble  one kernel writes ext = [received left | x | received right],
//             zeros where there is no neighbour.
// Between them the wrapper synchronises its stream and takes a barrier of
// the block group, so every put has landed before any rank assembles; no
// kernel waits on a flag stored by another process (kernels of different
// processes on one card are time-sliced, so a spinning kernel could wait a
// whole slice or forever).
//
// Both kernels copy 4-byte words, so they serve any element of 4 or 8
// bytes bitwise.
//
// What bounds it on the H100: device memory. The halos are small (C x (hl +
// hr) words); the assemble reads the block once and writes ext once, about
// 2 x C x n x 4 bytes. Each ext row is written with aligned 16-byte stores
// (the few words before a row's first 16-byte boundary and after its last
// one singly), and neighbouring threads read neighbouring words of x, so
// loads and stores are coalesced. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "the wrapper swaps 64-byte IPC handles");

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

// Tail of row r into the right neighbour's left buffer, head into the left
// neighbour's right buffer (null where there is no such neighbour).
__global__ void __launch_bounds__(kThreads)
halo_put_kernel(const uint32_t* __restrict__ x, uint32_t* right_left, uint32_t* left_right,
                int64_t row0, int64_t nw, int64_t hlw, int64_t hrw) {
  const int64_t r = row0 + blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint32_t* xr = x + r * nw;
  if (t < hlw) {
    if (right_left != nullptr) right_left[r * hlw + t] = xr[nw - hlw + t];
  } else if (t - hlw < hrw) {
    if (left_right != nullptr) left_right[r * hrw + (t - hlw)] = xr[t - hlw];
  }
}

// Word c of ext row r: [left halo | block | right halo], zeros where a
// received buffer is null.
__device__ __forceinline__ uint32_t ext_word(const uint32_t* xr, const uint32_t* lr,
                                             const uint32_t* rr, int64_t c, int64_t hlw,
                                             int64_t nw) {
  if (c < hlw) return lr != nullptr ? lr[c] : 0u;
  c -= hlw;
  if (c < nw) return xr[c];
  c -= nw;
  return rr != nullptr ? rr[c] : 0u;
}

__global__ void __launch_bounds__(kThreads)
halo_assemble_kernel(const uint32_t* __restrict__ x, const uint32_t* recv_left,
                     const uint32_t* recv_right, uint32_t* __restrict__ ext, int64_t row0,
                     int64_t nw, int64_t hlw, int64_t hrw) {
  const int64_t r = row0 + blockIdx.y;
  const int64_t ww = hlw + nw + hrw;
  uint32_t* er = ext + r * ww;
  const uint32_t* xr = x + r * nw;
  const uint32_t* lr = recv_left != nullptr ? recv_left + r * hlw : nullptr;
  const uint32_t* rr = recv_right != nullptr ? recv_right + r * hrw : nullptr;
  // words before the row's first 16-byte boundary, then whole 16-byte chunks
  const int64_t lead = (int64_t)(((uintptr_t)0 - (uintptr_t)er) & 15u) >> 2;
  const int64_t chunks = ww > lead ? (ww - lead) >> 2 : 0;
  const int64_t done = ww > lead ? lead + 4 * chunks : ww;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < chunks) {
    const int64_t c = lead + 4 * t;
    uint4 v;
    v.x = ext_word(xr, lr, rr, c, hlw, nw);
    v.y = ext_word(xr, lr, rr, c + 1, hlw, nw);
    v.z = ext_word(xr, lr, rr, c + 2, hlw, nw);
    v.w = ext_word(xr, lr, rr, c + 3, hlw, nw);
    *reinterpret_cast<uint4*>(er + c) = v;
  }
  if (t < lead && t < ww) er[t] = ext_word(xr, lr, rr, t, hlw, nw);
  if (t < ww - done) er[done + t] = ext_word(xr, lr, rr, done + t, hlw, nw);
}

int grid_x(int64_t threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

// A device buffer of `bytes` (> 0) on the current device; *(void**)out gets
// its address. Memory of its own, not a suballocation, so its IPC handle
// names it alone.
extern "C" int nx_halo_alloc(int64_t bytes, void* out) {
  if (bytes < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaMalloc(static_cast<void**>(out), (size_t)bytes);
}

extern "C" int nx_halo_free(void* ptr) { return (int)cudaFree(ptr); }

// The 64-byte IPC handle of a buffer of nx_halo_alloc, written to `handle`.
extern "C" int nx_ipc_get_handle(void* ptr, void* handle) {
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

// Maps another process's buffer from its 64-byte handle; *(void**)out gets
// the address here. Refused for a handle of this process.
extern "C" int nx_ipc_open_handle(const void* handle, void* out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(static_cast<void**>(out), h,
                                   cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int nx_ipc_close_handle(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

extern "C" int nx_stream_synchronize(void* stream) {
  return (int)cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
}

// x (rows, nw words) contiguous; right_left (rows, hlw) and left_right
// (rows, hrw) are the neighbours' mapped buffers, either null. Launches on
// `stream` without synchronising.
extern "C" int nx_halo_put(const void* x, void* right_left, void* left_right, int64_t rows,
                           int64_t nw, int64_t hlw, int64_t hrw, void* stream) {
  if (rows < 1 || nw < 1 || hlw < 0 || hrw < 0 || hlw > nw || hrw > nw) {
    return (int)cudaErrorInvalidValue;
  }
  if ((right_left == nullptr || hlw == 0) && (left_right == nullptr || hrw == 0)) {
    return (int)cudaSuccess;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t nr = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    const dim3 grid(grid_x(hlw + hrw), (unsigned)nr);
    halo_put_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(right_left),
        static_cast<uint32_t*>(left_right), r0, nw, hlw, hrw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ext (rows, hlw + nw + hrw words) from x (rows, nw) and this rank's
// received halos recv_left (rows, hlw) and recv_right (rows, hrw), either
// null for zeros. Launches on `stream` without synchronising.
extern "C" int nx_halo_assemble(const void* x, const void* recv_left, const void* recv_right,
                                void* ext, int64_t rows, int64_t nw, int64_t hlw,
                                int64_t hrw, void* stream) {
  if (rows < 1 || nw < 1 || hlw < 0 || hrw < 0 || (reinterpret_cast<uintptr_t>(ext) & 3u)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t ww = hlw + nw + hrw;
  const int64_t threads = (ww >> 2) + 4;  // the chunks, and at least the ragged words
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t nr = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    const dim3 grid(grid_x(threads), (unsigned)nr);
    halo_assemble_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(recv_left),
        static_cast<const uint32_t*>(recv_right), static_cast<uint32_t*>(ext), r0, nw, hlw,
        hrw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
