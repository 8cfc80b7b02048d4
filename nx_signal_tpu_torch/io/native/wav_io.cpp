// Native audio IO for nx_signal_tpu_torch: WAV (RIFF) reader/writer, raw
// interleaved streams and a lock-free SPSC ring buffer for streaming
// ingestion. The same source as nx_signal_tpu's io/native/wav_io.cpp (the
// port keeps its own copy and imports nothing of that package).
//
// Kept in C++ so long streams decode (PCM -> planar f32) at memory
// bandwidth off the Python GIL. Exposed through a plain C ABI consumed via
// ctypes (nx_signal_tpu_torch/io/wav.py, which builds it at first use).
//
// Supported formats: PCM u8 / s16 / s24 / s32 and IEEE float32, any
// channel count, with chunked (seekable) block reads.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>

namespace {

#pragma pack(push, 1)
struct RiffHeader {
  char riff[4];
  uint32_t size;
  char wave[4];
};
struct ChunkHeader {
  char id[4];
  uint32_t size;
};
struct FmtChunk {
  uint16_t format;       // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits;
};
#pragma pack(pop)

constexpr uint16_t kPcm = 1;
constexpr uint16_t kFloat = 3;
constexpr uint16_t kExtensible = 0xFFFE;

struct WavReader {
  FILE* file = nullptr;
  FmtChunk fmt{};
  uint16_t resolved_format = 0;
  long data_offset = 0;
  uint64_t data_bytes = 0;
  uint64_t frames_total = 0;
  uint64_t frames_read = 0;
};

bool id_is(const char id[4], const char* s) { return std::memcmp(id, s, 4) == 0; }

// Decode interleaved raw frames into planar f32 [channels][stride]
// (stride = the caller's row capacity; only the first `frames` columns of
// each row are written).
void decode_block(const WavReader* r, const uint8_t* raw, uint64_t frames,
                  float* out, uint64_t stride) {
  const uint32_t ch = r->fmt.channels;
  const uint32_t bytes_per_sample = r->fmt.bits / 8;
  for (uint64_t f = 0; f < frames; ++f) {
    const uint8_t* p = raw + f * r->fmt.block_align;
    for (uint32_t c = 0; c < ch; ++c) {
      const uint8_t* s = p + c * bytes_per_sample;
      float v = 0.0f;
      if (r->resolved_format == kFloat && r->fmt.bits == 32) {
        std::memcpy(&v, s, 4);
      } else if (r->fmt.bits == 16) {
        int16_t x;
        std::memcpy(&x, s, 2);
        v = static_cast<float>(x) / 32768.0f;
      } else if (r->fmt.bits == 24) {
        int32_t x = (s[0] << 8) | (s[1] << 16) | (static_cast<int32_t>(s[2]) << 24);
        x >>= 8;  // sign-extend
        v = static_cast<float>(x) / 8388608.0f;
      } else if (r->fmt.bits == 32) {
        int32_t x;
        std::memcpy(&x, s, 4);
        v = static_cast<float>(x) / 2147483648.0f;
      } else if (r->fmt.bits == 8) {
        v = (static_cast<float>(s[0]) - 128.0f) / 128.0f;
      }
      out[static_cast<uint64_t>(c) * stride + f] = v;
    }
  }
}

}  // namespace

extern "C" {

// ---- WAV reader ----

void* wav_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  RiffHeader rh;
  if (std::fread(&rh, sizeof rh, 1, f) != 1 || !id_is(rh.riff, "RIFF") ||
      !id_is(rh.wave, "WAVE")) {
    std::fclose(f);
    return nullptr;
  }
  auto* r = new WavReader();
  r->file = f;
  bool have_fmt = false;
  ChunkHeader chdr;
  while (std::fread(&chdr, sizeof chdr, 1, f) == 1) {
    if (id_is(chdr.id, "fmt ")) {
      uint32_t n = chdr.size < sizeof(FmtChunk) ? chdr.size : sizeof(FmtChunk);
      if (std::fread(&r->fmt, n, 1, f) != 1) break;
      uint32_t consumed = n;
      r->resolved_format = r->fmt.format;
      if (r->fmt.format == kExtensible && chdr.size >= sizeof(FmtChunk) + 10) {
        // extension: cbSize(2) validBits(2) channelMask(4) subformat GUID —
        // the GUID's first two bytes are the real format tag
        uint8_t ext[10];
        if (std::fread(ext, sizeof ext, 1, f) == 1) {
          consumed += sizeof ext;
          r->resolved_format =
              static_cast<uint16_t>(ext[8] | (ext[9] << 8));
        }
      }
      if (chdr.size > consumed) std::fseek(f, chdr.size - consumed, SEEK_CUR);
      if (chdr.size & 1) std::fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (id_is(chdr.id, "data")) {
      r->data_offset = std::ftell(f);
      r->data_bytes = chdr.size;
      std::fseek(f, (chdr.size + 1) & ~1u, SEEK_CUR);
    } else {
      std::fseek(f, (chdr.size + 1) & ~1u, SEEK_CUR);
    }
  }
  // reject inconsistent headers (block_align must hold all channels'
  // samples, or decode_block would read past the raw buffer)
  if (!have_fmt || r->data_offset == 0 || r->fmt.block_align == 0 ||
      (r->fmt.bits != 8 && r->fmt.bits != 16 && r->fmt.bits != 24 &&
       r->fmt.bits != 32) ||
      (r->resolved_format != kPcm && r->resolved_format != kFloat) ||
      (r->resolved_format == kFloat && r->fmt.bits != 32) ||
      static_cast<uint32_t>(r->fmt.block_align) <
          static_cast<uint32_t>(r->fmt.channels) * (r->fmt.bits / 8)) {
    std::fclose(f);
    delete r;
    return nullptr;
  }
  r->frames_total = r->data_bytes / r->fmt.block_align;
  std::fseek(f, r->data_offset, SEEK_SET);
  return r;
}

int32_t wav_channels(void* h) { return static_cast<WavReader*>(h)->fmt.channels; }
int32_t wav_sample_rate(void* h) { return static_cast<WavReader*>(h)->fmt.sample_rate; }
int64_t wav_frames(void* h) { return static_cast<WavReader*>(h)->frames_total; }
int32_t wav_bits(void* h) { return static_cast<WavReader*>(h)->fmt.bits; }

// Read up to `frames` frames into planar f32 out[channels][frames].
// Returns frames actually read (0 at EOF, -1 on error).
int64_t wav_read(void* h, float* out, int64_t frames) {
  auto* r = static_cast<WavReader*>(h);
  uint64_t remaining = r->frames_total - r->frames_read;
  uint64_t want = frames < 0 ? 0 : static_cast<uint64_t>(frames);
  if (want > remaining) want = remaining;
  if (want == 0) return 0;
  uint64_t bytes = want * r->fmt.block_align;
  uint8_t* raw = static_cast<uint8_t*>(std::malloc(bytes));
  if (!raw) return -1;
  uint64_t got = std::fread(raw, 1, bytes, r->file) / r->fmt.block_align;
  decode_block(r, raw, got, out, static_cast<uint64_t>(frames));
  std::free(raw);
  r->frames_read += got;
  return static_cast<int64_t>(got);
}

int64_t wav_seek(void* h, int64_t frame) {
  auto* r = static_cast<WavReader*>(h);
  if (frame < 0 || static_cast<uint64_t>(frame) > r->frames_total) return -1;
  std::fseek(r->file, r->data_offset + frame * r->fmt.block_align, SEEK_SET);
  r->frames_read = frame;
  return frame;
}

void wav_close(void* h) {
  auto* r = static_cast<WavReader*>(h);
  if (r->file) std::fclose(r->file);
  delete r;
}

// ---- WAV writer (PCM16 or float32) ----

int32_t wav_write(const char* path, const float* planar, int32_t channels,
                  int64_t frames, int32_t sample_rate, int32_t as_float) {
  const uint16_t bits = as_float ? 32 : 16;
  const uint16_t block = channels * bits / 8;
  const uint64_t total_bytes = static_cast<uint64_t>(frames) * block;
  // RIFF sizes are 32-bit; refuse instead of writing a wrapped header
  if (total_bytes > 0xFFFFFFFFu - 36u) return -2;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = static_cast<uint32_t>(total_bytes);
  RiffHeader rh{{'R', 'I', 'F', 'F'}, 36 + data_bytes, {'W', 'A', 'V', 'E'}};
  std::fwrite(&rh, sizeof rh, 1, f);
  ChunkHeader fmt_h{{'f', 'm', 't', ' '}, 16};
  std::fwrite(&fmt_h, sizeof fmt_h, 1, f);
  FmtChunk fmt{static_cast<uint16_t>(as_float ? kFloat : kPcm),
               static_cast<uint16_t>(channels),
               static_cast<uint32_t>(sample_rate),
               static_cast<uint32_t>(sample_rate * block),
               block,
               bits};
  std::fwrite(&fmt, sizeof fmt, 1, f);
  ChunkHeader data_h{{'d', 'a', 't', 'a'}, data_bytes};
  std::fwrite(&data_h, sizeof data_h, 1, f);
  // interleave into a chunk buffer and write in bulk (one fwrite per
  // sample would be ~100x slower)
  const int64_t chunk_frames = 1 << 16;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(chunk_frames * block));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  for (int64_t start = 0; start < frames; start += chunk_frames) {
    const int64_t n = std::min<int64_t>(chunk_frames, frames - start);
    for (int64_t i = 0; i < n; ++i) {
      uint8_t* p = buf + i * block;
      for (int32_t c = 0; c < channels; ++c) {
        float v = planar[static_cast<int64_t>(c) * frames + start + i];
        if (as_float) {
          std::memcpy(p + c * 4, &v, 4);
        } else {
          float clamped = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
          float scaled = clamped * 32767.0f;
          int32_t q = static_cast<int32_t>(scaled + (scaled >= 0 ? 0.5f : -0.5f));
          int16_t s = static_cast<int16_t>(q);
          std::memcpy(p + c * 2, &s, 2);
        }
      }
    }
    std::fwrite(buf, 1, n * block, f);
  }
  std::free(buf);
  std::fclose(f);
  return 0;
}

// ---- lock-free SPSC ring buffer (f32 samples) ----

struct Ring {
  float* buf;
  uint64_t capacity;  // power of two
  std::atomic<uint64_t> head{0};  // write index (producer)
  std::atomic<uint64_t> tail{0};  // read index (consumer)
};

void* ring_create(uint64_t min_capacity) {
  uint64_t cap = 1;
  while (cap < min_capacity) cap <<= 1;
  auto* r = new Ring();
  r->buf = static_cast<float*>(std::malloc(cap * sizeof(float)));
  if (!r->buf) {
    delete r;
    return nullptr;
  }
  r->capacity = cap;
  return r;
}

uint64_t ring_capacity(void* h) { return static_cast<Ring*>(h)->capacity; }

uint64_t ring_size(void* h) {
  auto* r = static_cast<Ring*>(h);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// Returns samples actually written (partial when full).
uint64_t ring_push(void* h, const float* data, uint64_t n) {
  auto* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t space = r->capacity - (head - tail);
  if (n > space) n = space;
  for (uint64_t i = 0; i < n; ++i)
    r->buf[(head + i) & (r->capacity - 1)] = data[i];
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Returns samples actually read (partial when empty).
uint64_t ring_pop(void* h, float* out, uint64_t n) {
  auto* r = static_cast<Ring*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  if (n > avail) n = avail;
  for (uint64_t i = 0; i < n; ++i)
    out[i] = r->buf[(tail + i) & (r->capacity - 1)];
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

void ring_destroy(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::free(r->buf);
  delete r;
}

// ---- raw (headerless) stream reader: the SDR ingest path ----
//
// Interleaved fixed-dtype sample streams with no container (the common
// wideband-SDR capture format; an IQ stream is channels = 2). Decodes to
// planar f32 exactly like the WAV reader. dtype codes:
// 0 = float32, 1 = int16, 2 = int8, 3 = uint8 (offset-128), 4 = int32.

struct RawReader {
  FILE* file = nullptr;
  int dtype = 0;
  uint32_t channels = 0;
  uint32_t elem_bytes = 0;
  uint64_t frames_total = 0;
  uint64_t frames_read = 0;
};

static uint32_t raw_elem_bytes(int dtype) {
  switch (dtype) {
    case 0: return 4;
    case 1: return 2;
    case 2: return 1;
    case 3: return 1;
    case 4: return 4;
  }
  return 0;
}

static float raw_decode_one(int dtype, const uint8_t* s) {
  switch (dtype) {
    case 0: {
      float v;
      std::memcpy(&v, s, 4);
      return v;
    }
    case 1: {
      int16_t x;
      std::memcpy(&x, s, 2);
      return static_cast<float>(x) / 32768.0f;
    }
    case 2:
      return static_cast<float>(static_cast<int8_t>(s[0])) / 128.0f;
    case 3:
      return (static_cast<float>(s[0]) - 128.0f) / 128.0f;
    case 4: {
      int32_t x;
      std::memcpy(&x, s, 4);
      return static_cast<float>(x) / 2147483648.0f;
    }
  }
  return 0.0f;
}

extern "C" {

// 64-bit-safe file offsets: C `long` is 32-bit on LLP64 (Windows), and
// SDR captures routinely exceed 2 GiB.
static int seek64(FILE* f, int64_t off, int whence) {
#ifdef _WIN32
  return _fseeki64(f, off, whence);
#else
  return fseeko(f, static_cast<off_t>(off), whence);
#endif
}

static int64_t tell64(FILE* f) {
#ifdef _WIN32
  return _ftelli64(f);
#else
  return static_cast<int64_t>(ftello(f));
#endif
}

void* raw_open(const char* path, int dtype, int channels) {
  const uint32_t eb = raw_elem_bytes(dtype);
  if (eb == 0 || channels < 1) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  seek64(f, 0, SEEK_END);
  const int64_t bytes = tell64(f);
  seek64(f, 0, SEEK_SET);
  auto* r = new RawReader();
  r->file = f;
  r->dtype = dtype;
  r->channels = static_cast<uint32_t>(channels);
  r->elem_bytes = eb;
  r->frames_total = static_cast<uint64_t>(bytes) / (eb * r->channels);
  return r;
}

int32_t raw_channels(void* h) {
  return static_cast<int32_t>(static_cast<RawReader*>(h)->channels);
}
int64_t raw_frames(void* h) {
  return static_cast<int64_t>(static_cast<RawReader*>(h)->frames_total);
}

// Planar f32 out, row stride = requested `frames` (same contract as
// wav_read). Returns frames decoded (0 at EOF, -1 on IO error).
int64_t raw_read(void* h, float* out, int64_t frames) {
  auto* r = static_cast<RawReader*>(h);
  if (frames < 1) return 0;
  const uint64_t remaining = r->frames_total - r->frames_read;
  const uint64_t want =
      std::min<uint64_t>(static_cast<uint64_t>(frames), remaining);
  if (want == 0) return 0;
  const uint64_t frame_bytes =
      static_cast<uint64_t>(r->elem_bytes) * r->channels;
  // Decode through a bounded scratch buffer (read_raw() requests whole
  // files; a request-sized transient would double peak RSS on multi-GB
  // SDR captures).
  const uint64_t kChunkFrames = 1 << 20;
  const uint64_t chunk = std::min<uint64_t>(want, kChunkFrames);
  auto* raw = static_cast<uint8_t*>(std::malloc(chunk * frame_bytes));
  if (!raw) return -1;
  uint64_t done = 0;
  while (done < want) {
    const uint64_t ask = std::min<uint64_t>(chunk, want - done);
    const uint64_t got = std::fread(raw, frame_bytes, ask, r->file);
    for (uint64_t f = 0; f < got; ++f) {
      const uint8_t* p = raw + f * frame_bytes;
      for (uint32_t c = 0; c < r->channels; ++c)
        out[static_cast<uint64_t>(c) * frames + done + f] =
            raw_decode_one(r->dtype, p + c * r->elem_bytes);
    }
    done += got;
    if (got < ask) break;  // EOF / short read
  }
  std::free(raw);
  r->frames_read += done;
  return static_cast<int64_t>(done);
}

int64_t raw_seek(void* h, int64_t frame) {
  auto* r = static_cast<RawReader*>(h);
  if (frame < 0 || static_cast<uint64_t>(frame) > r->frames_total) return -1;
  const int64_t frame_bytes =
      static_cast<int64_t>(r->elem_bytes) * r->channels;
  if (seek64(r->file, frame * frame_bytes, SEEK_SET)) return -1;
  r->frames_read = static_cast<uint64_t>(frame);
  return frame;
}

void raw_close(void* h) {
  auto* r = static_cast<RawReader*>(h);
  if (r->file) std::fclose(r->file);
  delete r;
}

}  // extern "C"

// ---- background prefetcher: decode thread -> SPSC ring -> consumer ----
//
// The data-loader piece of the streaming runtime: a producer thread decodes
// WAV blocks (planar f32) off the GIL and ahead of consumption, so disk +
// decode overlap with TPU compute. Block protocol on the ring:
// [frame_count (1 float, exact for counts < 2^24), frame_count * channels
// planar samples]; a frame_count of 0 marks end-of-stream.

struct Prefetcher {
  void* reader = nullptr;       // wav_open or raw_open handle
  int kind = 0;                 // 0 = wav, 1 = raw
  Ring* ring = nullptr;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<bool> failed{false};
  int64_t block_frames = 0;
  int channels = 0;
};

static int64_t prefetch_read(Prefetcher* p, float* buf, int64_t frames) {
  return p->kind == 0 ? wav_read(p->reader, buf, frames)
                      : raw_read(p->reader, buf, frames);
}

static void prefetch_push_all(Prefetcher* p, const float* data, uint64_t n) {
  uint64_t done = 0;
  while (done < n && !p->stop.load(std::memory_order_acquire)) {
    done += ring_push(p->ring, data + done, n - done);
    if (done < n)
      std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

static void prefetch_worker(Prefetcher* p) {
  const uint64_t block = static_cast<uint64_t>(p->block_frames) * p->channels;
  float* buf = static_cast<float*>(std::malloc(block * sizeof(float)));
  if (!buf) {
    p->failed.store(true, std::memory_order_release);
    return;
  }
  while (!p->stop.load(std::memory_order_acquire)) {
    int64_t got = prefetch_read(p, buf, p->block_frames);
    if (got < 0) {
      p->failed.store(true, std::memory_order_release);
      break;
    }
    float header = static_cast<float>(got);
    prefetch_push_all(p, &header, 1);
    if (got == 0) break;  // EOS marker pushed
    if (got == p->block_frames) {
      prefetch_push_all(p, buf, block);
    } else {
      // wav_read lays rows out with stride = REQUESTED frames; compact the
      // short final block to row stride = got while pushing
      for (int c = 0; c < p->channels; ++c)
        prefetch_push_all(p, buf + static_cast<uint64_t>(c) * p->block_frames,
                          static_cast<uint64_t>(got));
      float eos = 0.0f;
      prefetch_push_all(p, &eos, 1);
      break;
    }
  }
  std::free(buf);
}

// Returns a handle, or null when the file cannot be opened. `depth_blocks`
// decoded blocks are buffered ahead of the consumer.
void* prefetch_start(const char* path, int64_t block_frames,
                     int64_t depth_blocks) {
  if (block_frames < 1 || depth_blocks < 1) return nullptr;
  void* reader = wav_open(path);
  if (!reader) return nullptr;
  auto* p = new Prefetcher();
  p->reader = reader;
  p->block_frames = block_frames;
  p->channels = wav_channels(reader);
  uint64_t cap = static_cast<uint64_t>(depth_blocks) *
                 (static_cast<uint64_t>(block_frames) * p->channels + 1);
  p->ring = static_cast<Ring*>(ring_create(cap));
  if (!p->ring) {
    wav_close(reader);
    delete p;
    return nullptr;
  }
  p->worker = std::thread(prefetch_worker, p);
  return p;
}

// Raw-stream variant: same ring protocol, headerless interleaved input
// (dtype codes as raw_open).
void* prefetch_start_raw(const char* path, int dtype, int channels,
                         int64_t block_frames, int64_t depth_blocks) {
  if (block_frames < 1 || depth_blocks < 1) return nullptr;
  void* reader = raw_open(path, dtype, channels);
  if (!reader) return nullptr;
  auto* p = new Prefetcher();
  p->reader = reader;
  p->kind = 1;
  p->block_frames = block_frames;
  p->channels = channels;
  uint64_t cap = static_cast<uint64_t>(depth_blocks) *
                 (static_cast<uint64_t>(block_frames) * p->channels + 1);
  p->ring = static_cast<Ring*>(ring_create(cap));
  if (!p->ring) {
    raw_close(reader);
    delete p;
    return nullptr;
  }
  p->worker = std::thread(prefetch_worker, p);
  return p;
}

int prefetch_channels(void* h) { return static_cast<Prefetcher*>(h)->channels; }
int prefetch_sample_rate(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  return p->kind == 0 ? wav_sample_rate(p->reader) : 0;
}
int64_t prefetch_total_frames(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  return p->kind == 0 ? wav_frames(p->reader) : raw_frames(p->reader);
}

// Pop the next block into `out` (capacity block_frames*channels floats,
// planar with row stride = returned frame count). Blocks until a full
// block, EOS, or a decode failure. Returns frames (0 = end of stream,
// -1 = decode error).
int64_t prefetch_next(void* h, float* out) {
  auto* p = static_cast<Prefetcher*>(h);
  float header = 0.0f;
  while (ring_pop(p->ring, &header, 1) == 0) {
    if (p->failed.load(std::memory_order_acquire)) return -1;
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
  const auto frames = static_cast<int64_t>(header);
  if (frames <= 0) return 0;
  uint64_t want = static_cast<uint64_t>(frames) * p->channels;
  uint64_t done = 0;
  while (done < want) {
    done += ring_pop(p->ring, out + done, want - done);
    if (done < want) {
      if (p->failed.load(std::memory_order_acquire)) return -1;
      std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
  }
  return frames;
}

uint64_t prefetch_buffered(void* h) {
  return ring_size(static_cast<Prefetcher*>(h)->ring);
}

void prefetch_stop(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  p->stop.store(true, std::memory_order_release);
  if (p->worker.joinable()) p->worker.join();
  ring_destroy(p->ring);
  if (p->kind == 0)
    wav_close(p->reader);
  else
    raw_close(p->reader);
  delete p;
}

}  // extern "C"
