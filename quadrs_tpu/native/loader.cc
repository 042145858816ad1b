// Native capture loader: pread + deinterleave + readahead.
//
// The counterpart of the reference's Rust sample reader
// (src/samples.rs:44-94: positional pread + per-sample decode).  Numeric
// decode stays ON CHIP (quadrs_tpu.formats); this library owns the byte
// path: positional reads, interleaved->planar conversion (the device
// requires contiguous component planes; see quadrs_tpu/formats.py), and
// a double-buffered background prefetcher so disk latency overlaps
// device compute.
//
// Exposed as a plain C ABI for ctypes (no pybind dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Capture {
  int fd = -1;
  int64_t file_bytes = 0;
  int type_bytes = 1;  // bytes per scalar component

  int64_t pair_bytes() const { return 2 * type_bytes; }
  int64_t samples() const { return file_bytes / pair_bytes(); }
};

// Split interleaved component pairs into two contiguous planes.
// __restrict lets the compiler vectorize the stride-2 gather.
template <typename T>
void deinterleave(const T* __restrict src, T* __restrict re, T* __restrict im,
                  int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    re[i] = src[2 * i];
    im[i] = src[2 * i + 1];
  }
}

void deinterleave_any(const uint8_t* src, uint8_t* re, uint8_t* im, int64_t n,
                      int type_bytes) {
  switch (type_bytes) {
    case 1:
      deinterleave<uint8_t>(src, re, im, n);
      break;
    case 2:
      deinterleave<uint16_t>(reinterpret_cast<const uint16_t*>(src),
                             reinterpret_cast<uint16_t*>(re),
                             reinterpret_cast<uint16_t*>(im), n);
      break;
    case 4:
      deinterleave<uint32_t>(reinterpret_cast<const uint32_t*>(src),
                             reinterpret_cast<uint32_t*>(re),
                             reinterpret_cast<uint32_t*>(im), n);
      break;
  }
}

// Background readahead: a ring of chunk buffers filled by N reader
// threads (pread + deinterleave scale across cores), popped in stream
// order by the host staging loop.  Each chunk may carry an ``overlap``
// tail re-read from the next chunk's head, so the consumer gets its
// filter lookahead without any host-side stitching copies.
struct Prefetcher {
  Capture* cap = nullptr;
  int64_t chunk_samples = 0;
  int64_t overlap_samples = 0;
  int64_t start_off = 0;

  struct Slot {
    std::vector<uint8_t> raw, re, im;
    int64_t off = -1;
    int64_t n = 0;
    int64_t turn = 0;    // the next seq this slot serves
    int state = 0;       // 0 empty, 1 ready
  };
  std::vector<Slot> slots;
  int64_t pop_seq = 0;
  std::atomic<int64_t> next_seq{0};
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void run() {
    const int64_t n_slots = static_cast<int64_t>(slots.size());
    for (;;) {
      if (stop.load()) return;
      int64_t seq = next_seq.fetch_add(1);
      Slot& s = slots[seq % n_slots];
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() || (s.state == 0 && s.turn == seq);
        });
        if (stop.load()) return;
      }

      int64_t off = start_off + seq * chunk_samples;
      int64_t want =
          std::min(chunk_samples + overlap_samples, cap->samples() - off);
      int64_t got = 0;
      if (want > 0) {
        int64_t bytes = want * cap->pair_bytes();
        s.raw.resize(bytes);
        int64_t r = pread(cap->fd, s.raw.data(), bytes, off * cap->pair_bytes());
        if (r < 0) r = 0;
        got = r / cap->pair_bytes();
        s.re.resize(got * cap->type_bytes);
        s.im.resize(got * cap->type_bytes);
        deinterleave_any(s.raw.data(), s.re.data(), s.im.data(), got,
                         cap->type_bytes);
      }

      {
        std::lock_guard<std::mutex> lk(mu);
        s.off = off;
        s.n = got;
        s.state = 1;
      }
      cv_ready.notify_all();
      if (got <= 0) return;  // past EOF: the 0-marker is queued in order
    }
  }
};

}  // namespace

extern "C" {

void* qt_open(const char* path, int type_bytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* cap = new Capture();
  cap->fd = fd;
  cap->file_bytes = st.st_size;
  cap->type_bytes = type_bytes;
  return cap;
}

int64_t qt_samples(void* h) { return static_cast<Capture*>(h)->samples(); }

// Read [off, off+n) samples as planes into caller buffers (native dtype,
// n*type_bytes each).  Returns samples read (short at EOF), -1 on error.
int64_t qt_read_planes(void* h, int64_t off, int64_t n, void* re, void* im) {
  auto* cap = static_cast<Capture*>(h);
  if (off < 0 || n < 0) return -1;
  int64_t avail = cap->samples() - off;
  if (avail <= 0) return 0;
  int64_t want = std::min(n, avail);
  int64_t bytes = want * cap->pair_bytes();
  std::vector<uint8_t> buf(bytes);
  int64_t r = pread(cap->fd, buf.data(), bytes, off * cap->pair_bytes());
  if (r < 0) return -1;
  int64_t got = r / cap->pair_bytes();
  deinterleave_any(buf.data(), static_cast<uint8_t*>(re),
                   static_cast<uint8_t*>(im), got, cap->type_bytes);
  return got;
}

void qt_close(void* h) {
  auto* cap = static_cast<Capture*>(h);
  close(cap->fd);
  delete cap;
}

void* qt_prefetch_start(void* h, int64_t chunk_samples, int n_buffers,
                        int64_t start_off, int64_t overlap_samples,
                        int n_workers) {
  auto* p = new Prefetcher();
  p->cap = static_cast<Capture*>(h);
  p->chunk_samples = chunk_samples;
  p->overlap_samples = overlap_samples;
  p->start_off = start_off;
  if (n_workers < 1) n_workers = 1;
  if (n_buffers < n_workers + 2) n_buffers = n_workers + 2;
  p->slots.resize(n_buffers);
  for (size_t i = 0; i < p->slots.size(); ++i) p->slots[i].turn = i;
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back([p] { p->run(); });
  return p;
}

// Pop the next prefetched chunk (in stream order) into caller plane
// buffers, each at least (chunk_samples+overlap_samples)*type_bytes.
// Returns samples delivered (0 past EOF).
int64_t qt_prefetch_next(void* ph, int64_t* off_out, void* re, void* im) {
  auto* p = static_cast<Prefetcher*>(ph);
  const int64_t n_slots = static_cast<int64_t>(p->slots.size());
  auto& s = p->slots[p->pop_seq % n_slots];
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return s.state == 1; });
  }
  int64_t n = s.n;
  *off_out = s.off;
  if (n > 0) {
    std::memcpy(re, s.re.data(), n * p->cap->type_bytes);
    std::memcpy(im, s.im.data(), n * p->cap->type_bytes);
  }
  {
    std::lock_guard<std::mutex> lk(p->mu);
    s.state = 0;
    s.turn += n_slots;
  }
  p->cv_free.notify_all();
  ++p->pop_seq;
  return n;
}

void qt_prefetch_stop(void* ph) {
  auto* p = static_cast<Prefetcher*>(ph);
  p->stop.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& w : p->workers)
    if (w.joinable()) w.join();
  delete p;
}

}  // extern "C"
