// framepump — native prefetching frame reader with an SPSC ring buffer.
//
// The PyTorch port's own copy of the JAX package's frame pump
// (cudacam_tpu/native/framepump.cpp), analog of the reference's C++ IO
// layer (io::webcam wraps cv::VideoCapture and blocks the app thread per
// frame, reference src/io/webcam.cpp:65-83). A producer thread reads frames
// from a raw stream file into a preallocated ring of page-aligned slots while
// the Python consumer overlaps device work; the consumer borrows slots
// zero-copy, so the hot loop never allocates or copies on the host side.
//
// What the port adds: a consumer may hold several slots at once. fp_acquire
// lends the next filled slot without giving back the ones it holds, and
// fp_release gives back the oldest slot lent (slots go back in the order
// they were lent). The app lends a slot, starts a non-blocking upload from
// it (the slots are registered as pinned memory by the caller, through
// fp_slot), and gives it back only once that upload has completed, so the
// producer never overwrites a slot a copy still reads.
//
// Stream format (".rawv"): little-endian header
//   magic "RAWV" | u32 version=1 | u32 height | u32 width | u32 channels
//   | u64 n_frames
// followed by n_frames contiguous uint8 frames (H*W*C bytes each).
//
// C ABI only — consumed from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x56574152;  // "RAWV" little-endian

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t height;
  uint32_t width;
  uint32_t channels;
  uint64_t n_frames;
} __attribute__((packed));

struct Pump {
  FILE* f = nullptr;
  Header hdr{};
  size_t frame_bytes = 0;
  bool loop = false;

  // Ring of preallocated slots. head = next write, tail = next read;
  // producer owns head, consumer owns tail; count guarded by mutex (control
  // plane only — the data plane is the slot memory itself).
  // lent = slots handed to the consumer and not yet given back: the oldest
  // is slots[tail], and the next fp_acquire lends slots[(tail + lent) %
  // n_slots] once count > lent.
  std::vector<uint8_t*> slots;
  size_t n_slots = 0;
  size_t head = 0, tail = 0, count = 0, lent = 0;
  uint64_t produced = 0, consumed = 0;

  std::mutex mu;
  std::condition_variable cv_can_produce, cv_can_consume, cv_idle;
  std::mutex stop_mu;  // serializes concurrent stop()/close() (join races)
  std::thread producer;
  std::atomic<bool> running{false};
  std::atomic<bool> eof{false};
  std::atomic<int> error{0};
  // Consumers inside a blocking call (fp_acquire); fp_close waits for this
  // to reach zero after stop() so a woken waiter never touches freed state.
  size_t active_calls = 0;

  ~Pump() { stop_and_free(); }

  // Phase 1 of shutdown: stop the producer and wake every blocked waiter.
  // Safe to call from ANY thread, any number of times, including
  // concurrently (stop_mu serializes the joinable/join pair — concurrent
  // std::thread::join on one thread object is a data race); after it
  // returns, blocked fp_acquire calls return null promptly.
  void stop() {
    std::lock_guard<std::mutex> stop_lk(stop_mu);
    {
      std::unique_lock<std::mutex> lk(mu);
      running.store(false);
      cv_can_produce.notify_all();
      cv_can_consume.notify_all();
    }
    if (producer.joinable()) producer.join();
  }

  void stop_and_free() {
    stop();
    {
      // Phase 2: drain in-flight consumers before freeing (a consumer woken
      // from the cv still holds/reacquires the mutex on its way out).
      std::unique_lock<std::mutex> lk(mu);
      cv_idle.wait(lk, [&] { return active_calls == 0; });
    }
    for (auto* p : slots) std::free(p);
    slots.clear();
    if (f) {
      std::fclose(f);
      f = nullptr;
    }
  }

  void produce_loop() {
    bool just_looped = false;
    while (running.load()) {
      uint8_t* slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_can_produce.wait(lk, [&] { return !running.load() || count < n_slots; });
        if (!running.load()) return;
        slot = slots[head];
      }
      size_t got = std::fread(slot, 1, frame_bytes, f);
      if (got != frame_bytes) {
        // A loop restart that immediately hits EOF again means the stream
        // holds zero complete frames (header-only/truncated file): report
        // EOF instead of busy-spinning on the seek.
        if (loop && got == 0 && std::feof(f) && !just_looped) {
          std::fseek(f, sizeof(Header), SEEK_SET);
          just_looped = true;
          continue;
        }
        // Publish EOF under the mutex: a consumer between its predicate
        // check and blocking would otherwise miss this final notification
        // (lost wakeup) and hang forever.
        std::unique_lock<std::mutex> lk(mu);
        if (got != 0) error.store(1);  // torn frame
        eof.store(true);
        cv_can_consume.notify_all();
        return;
      }
      just_looped = false;
      {
        std::unique_lock<std::mutex> lk(mu);
        head = (head + 1) % n_slots;
        ++count;
        ++produced;
        cv_can_consume.notify_one();
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns a handle, or null on failure. loop != 0 restarts at EOF.
void* fp_open(const char* path, int loop) {
  auto* p = new Pump();
  p->f = std::fopen(path, "rb");
  if (!p->f) {
    delete p;
    return nullptr;
  }
  if (std::fread(&p->hdr, sizeof(Header), 1, p->f) != 1 ||
      p->hdr.magic != kMagic || p->hdr.version != 1 ||
      p->hdr.height == 0 || p->hdr.width == 0 ||
      (p->hdr.channels != 1 && p->hdr.channels != 3)) {
    delete p;
    return nullptr;
  }
  p->frame_bytes =
      size_t(p->hdr.height) * p->hdr.width * p->hdr.channels;
  p->loop = loop != 0;
  return p;
}

void fp_spec(void* h, uint32_t* height, uint32_t* width, uint32_t* channels,
             uint64_t* n_frames) {
  auto* p = static_cast<Pump*>(h);
  *height = p->hdr.height;
  *width = p->hdr.width;
  *channels = p->hdr.channels;
  *n_frames = p->hdr.n_frames;
}

// Start the producer thread with an n_slots-deep ring. Returns 0 on success.
int fp_start(void* h, int n_slots) {
  auto* p = static_cast<Pump*>(h);
  if (p->running.load() || n_slots <= 0) return -1;
  p->n_slots = size_t(n_slots);
  p->slots.resize(p->n_slots);
  for (auto& s : p->slots) {
    // Page-aligned slots: keeps memcpy-to-pinned and DMA-friendly layouts.
    if (posix_memalign(reinterpret_cast<void**>(&s), 4096, p->frame_bytes)) {
      return -2;
    }
  }
  p->head = p->tail = p->count = p->lent = 0;
  p->eof.store(false);
  p->running.store(true);
  p->producer = std::thread([p] { p->produce_loop(); });
  return 0;
}

// Lend the next filled slot (blocking), keeping the ones already lent.
// Returns the slot pointer the consumer may read until it gives the slot
// back with fp_release, or null at end-of-stream/stop.
const uint8_t* fp_acquire(void* h) {
  auto* p = static_cast<Pump*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  ++p->active_calls;
  p->cv_can_consume.wait(lk, [&] {
    return p->count > p->lent || p->eof.load() || !p->running.load();
  });
  const uint8_t* r = nullptr;
  if (p->count > p->lent) {
    r = p->slots[(p->tail + p->lent) % p->n_slots];
    ++p->lent;
  }
  if (--p->active_calls == 0) p->cv_idle.notify_all();
  return r;
}

// Give the oldest lent slot back to the producer.
void fp_release(void* h) {
  auto* p = static_cast<Pump*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->lent == 0) return;
  p->tail = (p->tail + 1) % p->n_slots;
  --p->count;
  --p->lent;
  ++p->consumed;
  p->cv_can_produce.notify_one();
}

// Copying read for convenience: fills dst, returns 1 on success, 0 at EOS,
// -1 while slots are lent (its release would give back the oldest of them).
int fp_read(void* h, uint8_t* dst) {
  auto* p = static_cast<Pump*>(h);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->lent) return -1;
  }
  const uint8_t* slot = fp_acquire(h);
  if (!slot) return 0;
  std::memcpy(dst, slot, p->frame_bytes);
  fp_release(h);
  return 1;
}

// The ring's slots, for the caller to register as pinned memory: the number
// of slots (0 before fp_start), slot i's address (null out of range) and the
// bytes of one slot (one frame).
int fp_slot_count(void* h) { return int(static_cast<Pump*>(h)->n_slots); }

uint8_t* fp_slot(void* h, int i) {
  auto* p = static_cast<Pump*>(h);
  return i >= 0 && size_t(i) < p->slots.size() ? p->slots[i] : nullptr;
}

uint64_t fp_frame_bytes(void* h) { return static_cast<Pump*>(h)->frame_bytes; }

uint64_t fp_frames_buffered(void* h) {
  auto* p = static_cast<Pump*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  return p->count;
}

int fp_error(void* h) { return static_cast<Pump*>(h)->error.load(); }

// Phase-1 shutdown, callable from ANY thread: stops the producer and wakes
// every waiter (blocked fp_acquire calls return null promptly). Idempotent.
void fp_stop(void* h) { static_cast<Pump*>(h)->stop(); }

// Destroys the pump. THREADING CONTRACT: the handle itself dangles after
// this call, so the caller must guarantee no fp_* call on this handle can
// START after fp_close begins (e.g. call fp_stop first from the shutting-
// down thread, then fp_close once consumers are known to have returned —
// the Python wrapper's close() does exactly this). Consumers already
// INSIDE a blocking fp_acquire are handled: fp_close waits until they
// leave before freeing.
void fp_close(void* h) { delete static_cast<Pump*>(h); }

// Writer utility: create a .rawv file from caller-provided frames.
int fp_write_file(const char* path, const uint8_t* data, uint32_t height,
                  uint32_t width, uint32_t channels, uint64_t n_frames) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header hdr{kMagic, 1, height, width, channels, n_frames};
  size_t fb = size_t(height) * width * channels;
  int rc = 0;
  if (std::fwrite(&hdr, sizeof(hdr), 1, f) != 1 ||
      std::fwrite(data, fb, n_frames, f) != n_frames) {
    rc = -2;
  }
  std::fclose(f);
  return rc;
}

}  // extern "C"
