// Hopper kernel E: the halo exchange between neighbouring time blocks as a
// stream-ordered peer put, with its signals in device memory.
//
// Replaces nx_signal_tpu/kernels/pallas_halo.py:halo_extend_dma, where each
// TPU core sends its block's tail to its right neighbour and its head to its
// left neighbour by remote DMA (pltpu.make_async_remote_copy), each copy
// signalling a receive semaphore that the receiver waits on before it writes
// [left halo | block | right halo], zeros at the stream edges.
//
// Here a rank is a process. Each rank cudaMallocs one buffer per block
// group, exports it with cudaIpcGetMemHandle, and its neighbours map it with
// cudaIpcOpenMemHandle (the wrapper, kernels/cuda_halo.py, swaps the handles
// once and keeps the mappings). The buffer holds four 64-bit sequence
// counters (arrived from left, arrived from right, freed by left, freed by
// right: the TPU kernel's semaphores) and two slots each of the left and the
// right receive buffer. Call k (numbered per group, the same on every rank)
// uses slot k mod 2 and issues on the caller's stream, in order:
//   wait      until each neighbour it puts into has freed the slot of call
//             k - 2 (a stream wait, `cuStreamWaitValue64`, >= k - 2);
//   put       one kernel stores this rank's tail x[:, n-hl:] into the right
//             neighbour's left slot and its head x[:, :hr] into the left
//             neighbour's right slot: plain global stores through the mapped
//             pointers, on one card into the shared device memory, across
//             cards over NVLink;
//   signal    a stream write (`cuStreamWriteValue64`, fenced) of k into each
//             neighbour's "arrived" counter;
//   interior  one kernel writes ext[:, hl:hl+n] = x, and the zeros at a
//             stream edge, while the neighbours' puts are in flight;
//   wait      until this rank's own "arrived" counters reach k;
//   edges     one kernel copies the received slots into ext's edge columns;
//   signal    a stream write of k into each neighbour's "freed" counter.
// A rank waits only on counters in its own memory and writes only into its
// neighbours'. The waiting is done by the stream's front end, not by an SM:
// no kernel spins on a flag that another process stores (kernels of
// different processes on one card are time-sliced, so a spinning kernel
// could wait a whole slice or forever), and no call needs a host barrier or
// a host sync after set-up.
//
// The kernels copy 4-byte words, so they serve any element of 4 or 8 bytes
// bitwise.
//
// What bounds it on the H100: device memory. The halos are small (C x (hl +
// hr) words); the interior reads the block once and writes ext once, about
// 2 x C x n x 4 bytes. Each ext row's interior is written with aligned
// 16-byte stores (the few words before its first 16-byte boundary and after
// its last one singly: hl = 127 puts the interior 3 words off x's
// alignment), and neighbouring threads read neighbouring words of x, so
// loads and stores are coalesced. Offsets are 64-bit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "the wrapper swaps 64-byte IPC handles");

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

// Tail of row r into the right neighbour's left slot, head into the left
// neighbour's right slot (null where nothing goes that way).
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

// Word c of an ext row outside the received columns: the block, or zero.
__device__ __forceinline__ uint32_t interior_word(const uint32_t* xr, int64_t c, int64_t hlw,
                                                  int64_t nw) {
  c -= hlw;
  return c >= 0 && c < nw ? xr[c] : 0u;
}

// Columns [c0, c1) of each ext row: the block, zeros in the halo columns
// (those of a stream edge; the received ones are the edges kernel's).
__global__ void __launch_bounds__(kThreads)
halo_interior_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ ext, int64_t row0,
                     int64_t nw, int64_t hlw, int64_t hrw, int64_t c0, int64_t c1) {
  const int64_t r = row0 + blockIdx.y;
  uint32_t* er = ext + r * (hlw + nw + hrw);
  const uint32_t* xr = x + r * nw;
  const int64_t w = c1 - c0;
  // words before the range's first 16-byte boundary, then whole 16-byte chunks
  const int64_t lead = (int64_t)(((uintptr_t)0 - (uintptr_t)(er + c0)) & 15u) >> 2;
  const int64_t chunks = w > lead ? (w - lead) >> 2 : 0;
  const int64_t done = w > lead ? lead + 4 * chunks : w;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < chunks) {
    const int64_t c = c0 + lead + 4 * t;
    uint4 v;
    v.x = interior_word(xr, c, hlw, nw);
    v.y = interior_word(xr, c + 1, hlw, nw);
    v.z = interior_word(xr, c + 2, hlw, nw);
    v.w = interior_word(xr, c + 3, hlw, nw);
    *reinterpret_cast<uint4*>(er + c) = v;
  }
  if (t < lead && t < w) er[c0 + t] = interior_word(xr, c0 + t, hlw, nw);
  if (t < w - done) er[c0 + done + t] = interior_word(xr, c0 + done + t, hlw, nw);
}

// ext[:, :hlw] = recv_left and ext[:, hlw+nw:] = recv_right, a null slot
// left as it is.
__global__ void __launch_bounds__(kThreads)
halo_edges_kernel(const uint32_t* recv_left, const uint32_t* recv_right,
                  uint32_t* __restrict__ ext, int64_t row0, int64_t nw, int64_t hlw,
                  int64_t hrw) {
  const int64_t r = row0 + blockIdx.y;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  uint32_t* er = ext + r * (hlw + nw + hrw);
  if (t < hlw) {
    if (recv_left != nullptr) er[t] = recv_left[r * hlw + t];
  } else if (t - hlw < hrw) {
    if (recv_right != nullptr) er[nw + t] = recv_right[r * hrw + (t - hlw)];
  }
}

int grid_x(int64_t threads) { return (int)((threads + kThreads - 1) / kThreads); }

// CUDA's stream memory operations (cuStreamWaitValue64 and
// cuStreamWriteValue64) and the device queries they need, resolved once
// through the runtime's entry-point lookup (no link against libcuda).
typedef CUresult (*StreamValue64Fn)(CUstream, CUdeviceptr, cuuint64_t, unsigned int);
typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*DeviceGetAttributeFn)(int*, CUdevice_attribute, CUdevice);
StreamValue64Fn g_wait_value64 = nullptr;
StreamValue64Fn g_write_value64 = nullptr;

cudaError_t cuda_entry_point(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  return found == cudaDriverEntryPointSuccess && *fn != nullptr ? cudaSuccess
                                                                : cudaErrorNotSupported;
}

}  // namespace

// Resolves cuStreamWaitValue64 and cuStreamWriteValue64 and checks that the
// current device takes 64-bit stream memory operations
// (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS); cudaErrorNotSupported
// where it does not. *(int64_t*)can_flush gets
// CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES (CU_STREAM_WAIT_VALUE_FLUSH
// allowed). A CUresult is returned as it is: its codes are cudaError_t's.
extern "C" int nx_stream_ops_init(void* can_flush) {
  if (can_flush == nullptr) return (int)cudaErrorInvalidValue;
  int ordinal = 0;
  cudaError_t err = cudaGetDevice(&ordinal);
  if (err != cudaSuccess) return (int)err;
  void *get = nullptr, *attribute = nullptr, *wait = nullptr, *write = nullptr;
  if ((err = cuda_entry_point("cuDeviceGet", &get)) != cudaSuccess ||
      (err = cuda_entry_point("cuDeviceGetAttribute", &attribute)) != cudaSuccess ||
      (err = cuda_entry_point("cuStreamWaitValue64", &wait)) != cudaSuccess ||
      (err = cuda_entry_point("cuStreamWriteValue64", &write)) != cudaSuccess) {
    return (int)err;
  }
  CUdevice dev;
  CUresult res = reinterpret_cast<DeviceGetFn>(get)(&dev, ordinal);
  if (res != CUDA_SUCCESS) return (int)res;
  int mem_ops = 0, flush = 0;
  const DeviceGetAttributeFn query = reinterpret_cast<DeviceGetAttributeFn>(attribute);
  if ((res = query(&mem_ops, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev)) !=
          CUDA_SUCCESS ||
      (res = query(&flush, CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES, dev)) != CUDA_SUCCESS) {
    return (int)res;
  }
  if (!mem_ops) return (int)cudaErrorNotSupported;
  g_wait_value64 = reinterpret_cast<StreamValue64Fn>(wait);
  g_write_value64 = reinterpret_cast<StreamValue64Fn>(write);
  *static_cast<int64_t*>(can_flush) = flush;
  return (int)cudaSuccess;
}

// Holds `stream` until the 64-bit word at `addr` (device memory of this
// process) reaches `value` (>=, as a signed difference); with `flush`, the
// wait is followed by a flush of remote writes. Host-side: it only enqueues.
extern "C" int nx_stream_wait_geq(void* stream, void* addr, int64_t value, int64_t flush) {
  if (g_wait_value64 == nullptr) return (int)cudaErrorInitializationError;
  const unsigned flags = CU_STREAM_WAIT_VALUE_GEQ | (flush ? CU_STREAM_WAIT_VALUE_FLUSH : 0u);
  return (int)g_wait_value64(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addr),
                             (cuuint64_t)value, flags);
}

// Stores `value` into the 64-bit word at `addr` (possibly a neighbour's
// mapped memory) when `stream` reaches this point, after a fence that makes
// the stream's earlier stores visible first.
extern "C" int nx_stream_write(void* stream, void* addr, int64_t value) {
  if (g_write_value64 == nullptr) return (int)cudaErrorInitializationError;
  return (int)g_write_value64(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addr),
                              (cuuint64_t)value, CU_STREAM_WRITE_VALUE_DEFAULT);
}

// A zeroed device buffer of `bytes` (> 0) on the current device, complete
// when this returns; *(void**)out gets its address. Memory of its own, not a
// suballocation, so its IPC handle names it alone.
extern "C" int nx_halo_alloc(int64_t bytes, void* out) {
  if (bytes < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMalloc(static_cast<void**>(out), (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*static_cast<void**>(out), 0, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

extern "C" int nx_halo_free(void* ptr) { return (int)cudaFree(ptr); }

// The ordinal (in this process) of the device that holds `ptr`, to
// *(int64_t*)out.
extern "C" int nx_pointer_device(const void* ptr, void* out) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return (int)err;
  *static_cast<int64_t*>(out) = attr.device;
  return (int)cudaSuccess;
}

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

// x (rows, nw words) contiguous; right_left (rows, hlw) and left_right
// (rows, hrw) are slots of the neighbours' mapped buffers, either null.
// Launches on `stream` without synchronising.
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

// ext (rows, hlw + nw + hrw words) from x (rows, nw): the block, and zeros
// in the left halo columns where zero_left and in the right ones where
// zero_right; the other halo columns are left to nx_halo_edges. Launches on
// `stream` without synchronising.
extern "C" int nx_halo_interior(const void* x, void* ext, int64_t rows, int64_t nw, int64_t hlw,
                                int64_t hrw, int64_t zero_left, int64_t zero_right,
                                void* stream) {
  if (rows < 1 || nw < 1 || hlw < 0 || hrw < 0 || (reinterpret_cast<uintptr_t>(ext) & 3u)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t c0 = zero_left ? 0 : hlw;
  const int64_t c1 = zero_right ? hlw + nw + hrw : hlw + nw;
  const int64_t threads = ((c1 - c0) >> 2) + 4;  // the chunks, and at least the ragged words
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t nr = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    const dim3 grid(grid_x(threads), (unsigned)nr);
    halo_interior_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(x),
                                                   static_cast<uint32_t*>(ext), r0, nw, hlw,
                                                   hrw, c0, c1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ext's halo columns from this rank's received slots recv_left (rows, hlw)
// and recv_right (rows, hrw), either null (those columns left as they are).
// Launches on `stream` without synchronising.
extern "C" int nx_halo_edges(const void* recv_left, const void* recv_right, void* ext,
                             int64_t rows, int64_t nw, int64_t hlw, int64_t hrw, void* stream) {
  if (rows < 1 || nw < 1 || hlw < 0 || hrw < 0) return (int)cudaErrorInvalidValue;
  if ((recv_left == nullptr || hlw == 0) && (recv_right == nullptr || hrw == 0)) {
    return (int)cudaSuccess;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t nr = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    const dim3 grid(grid_x(hlw + hrw), (unsigned)nr);
    halo_edges_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(recv_left), static_cast<const uint32_t*>(recv_right),
        static_cast<uint32_t*>(ext), r0, nw, hlw, hrw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
