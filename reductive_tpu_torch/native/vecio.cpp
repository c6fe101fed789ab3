// Native IO runtime of reductive_tpu_torch: an mmap-backed vector-dataset
// reader and code packing, bound with ctypes (native/__init__.py).
//
// Corpora for production encode and training jobs live in the standard
// ANN-benchmark on-disk formats:
//
//   fvecs: per row  [int32 dim][dim x float32]
//   bvecs: per row  [int32 dim][dim x uint8]
//   ivecs: per row  [int32 dim][dim x int32]
//
// The reader mmaps the file and converts row ranges into dense float32
// batches with a small thread pool, feeding the streaming encode and the
// streamed trainers (reductive_tpu_torch/data.py, pq/streamed.py), which
// stage each batch through pinned host memory to the GPU.  Code packing
// converts between byte-per-code and two-4-bit-codes-per-byte layouts for
// compact code stores (k <= 16).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct VecsFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;
  int64_t n = 0;
  int32_t dim = 0;
  int32_t kind = 0;  // 0=fvecs, 1=bvecs, 2=ivecs
  size_t row_bytes = 0;
};

size_t elem_size(int32_t kind) { return kind == 1 ? 1 : 4; }

template <typename SrcT>
void convert_rows(const uint8_t* base, size_t row_bytes, int32_t dim,
                  int64_t start, int64_t count, float* out) {
  for (int64_t r = 0; r < count; ++r) {
    const uint8_t* row = base + (start + r) * row_bytes + sizeof(int32_t);
    const SrcT* src = reinterpret_cast<const SrcT*>(row);
    float* dst = out + r * dim;
    for (int32_t c = 0; c < dim; ++c) dst[c] = static_cast<float>(src[c]);
  }
}

}  // namespace

extern "C" {

VecsFile* vecs_open(const char* path, int32_t kind) {
  if (kind < 0 || kind > 2) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(int32_t)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* f = new VecsFile;
  f->fd = fd;
  f->base = static_cast<const uint8_t*>(base);
  f->file_size = st.st_size;
  f->kind = kind;
  std::memcpy(&f->dim, f->base, sizeof(int32_t));
  if (f->dim <= 0) {
    munmap(base, st.st_size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  f->row_bytes = sizeof(int32_t) + (size_t)f->dim * elem_size(kind);
  if (f->file_size % f->row_bytes != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  f->n = f->file_size / f->row_bytes;
  madvise(base, st.st_size, MADV_SEQUENTIAL);
  return f;
}

void vecs_close(VecsFile* f) {
  if (!f) return;
  if (f->base) munmap(const_cast<uint8_t*>(f->base), f->file_size);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

int64_t vecs_count(const VecsFile* f) { return f ? f->n : -1; }
int32_t vecs_dim(const VecsFile* f) { return f ? f->dim : -1; }

// Read rows [start, start+count) as a dense float32 (count, dim) batch.
// Returns 0 on success.  Conversion is split across n_threads.
int32_t vecs_read_f32(const VecsFile* f, int64_t start, int64_t count,
                      float* out, int32_t n_threads) {
  if (!f || start < 0 || count < 0 || start + count > f->n) return -1;
  if (count == 0) return 0;
  if (n_threads < 1) n_threads = 1;
  int64_t per = (count + n_threads - 1) / n_threads;

  auto work = [&](int64_t lo, int64_t hi) {
    switch (f->kind) {
      case 0:
        convert_rows<float>(f->base, f->row_bytes, f->dim, start + lo,
                            hi - lo, out + lo * f->dim);
        break;
      case 1:
        convert_rows<uint8_t>(f->base, f->row_bytes, f->dim, start + lo,
                              hi - lo, out + lo * f->dim);
        break;
      case 2:
        convert_rows<int32_t>(f->base, f->row_bytes, f->dim, start + lo,
                              hi - lo, out + lo * f->dim);
        break;
    }
  };

  if (n_threads == 1 || count < 1024) {
    work(0, count);
    return 0;
  }
  std::vector<std::thread> threads;
  for (int64_t lo = 0; lo < count; lo += per) {
    int64_t hi = lo + per < count ? lo + per : count;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetch executor: a producer thread reads + converts batches ahead of
// the consumer into a ring of reusable buffers.  The consumer (the Python
// streaming-encode loop) blocks only when IO cannot keep up with the
// device; with `depth` buffers in flight, disk read, f32 conversion, the
// host->device copy, and GPU compute all overlap.
// ---------------------------------------------------------------------------

namespace {

struct Slot {
  int32_t index;
  int64_t offset;
  int64_t count;
};

struct Prefetcher {
  const VecsFile* f = nullptr;
  int64_t batch = 0;
  int64_t stop = 0;
  int64_t next_read = 0;
  int32_t depth = 0;
  int32_t n_threads = 1;
  std::vector<std::vector<float>> buffers;
  std::deque<int32_t> free_slots;
  std::deque<Slot> ready;
  bool done = false;
  std::mutex mu;
  std::condition_variable cv_free;
  std::condition_variable cv_ready;
  std::thread producer;
};

void producer_loop(Prefetcher* p) {
  while (true) {
    int64_t off;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->next_read >= p->stop) {
        p->done = true;
        p->cv_ready.notify_all();
        return;
      }
      off = p->next_read;
      p->next_read += p->batch;
    }
    int32_t slot;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_free.wait(lk, [&] { return !p->free_slots.empty(); });
      slot = p->free_slots.front();
      p->free_slots.pop_front();
    }
    int64_t count = p->stop - off < p->batch ? p->stop - off : p->batch;
    vecs_read_f32(const_cast<VecsFile*>(p->f), off, count,
                  p->buffers[slot].data(), p->n_threads);
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->ready.push_back({slot, off, count});
      p->cv_ready.notify_all();
    }
  }
}

}  // namespace

Prefetcher* prefetch_create(const VecsFile* f, int64_t start, int64_t stop,
                            int64_t batch, int32_t depth, int32_t n_threads) {
  if (!f || batch <= 0 || depth < 1 || start < 0 || stop > f->n ||
      start > stop)
    return nullptr;
  auto* p = new Prefetcher;
  p->f = f;
  p->batch = batch;
  p->stop = stop;
  p->next_read = start;
  p->depth = depth;
  p->n_threads = n_threads < 1 ? 1 : n_threads;
  p->buffers.resize(depth);
  for (int32_t i = 0; i < depth; ++i) {
    p->buffers[i].resize((size_t)batch * f->dim);
    p->free_slots.push_back(i);
  }
  p->producer = std::thread(producer_loop, p);
  return p;
}

// Block until the next batch is ready.  Returns the slot index (>= 0) and
// fills offset/count/data; returns -1 when the stream is exhausted.  The
// buffer stays valid until prefetch_release(slot).
int32_t prefetch_next(Prefetcher* p, int64_t* offset, int64_t* count,
                      float** data) {
  if (!p) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return !p->ready.empty() || p->done; });
  if (p->ready.empty()) return -1;
  Slot s = p->ready.front();
  p->ready.pop_front();
  *offset = s.offset;
  *count = s.count;
  *data = p->buffers[s.index].data();
  return s.index;
}

void prefetch_release(Prefetcher* p, int32_t slot) {
  if (!p || slot < 0 || slot >= p->depth) return;
  std::unique_lock<std::mutex> lk(p->mu);
  p->free_slots.push_back(slot);
  p->cv_free.notify_all();
}

void prefetch_destroy(Prefetcher* p) {
  if (!p) return;
  {
    // Unblock the producer if it is waiting for a free slot, and stop
    // further reads.
    std::unique_lock<std::mutex> lk(p->mu);
    p->next_read = p->stop;
    for (int32_t i = 0; i < p->depth; ++i) p->free_slots.push_back(i);
    p->cv_free.notify_all();
  }
  if (p->producer.joinable()) p->producer.join();
  delete p;
}

// Pack pairs of 4-bit codes (values < 16): out[i] = codes[2i] | codes[2i+1]<<4.
// n is the number of input codes; if odd, the final nibble is zero-padded.
void pack_u4(const uint8_t* codes, int64_t n, uint8_t* out) {
  int64_t pairs = n / 2;
  for (int64_t i = 0; i < pairs; ++i)
    out[i] = (uint8_t)((codes[2 * i] & 0x0F) | ((codes[2 * i + 1] & 0x0F) << 4));
  if (n & 1) out[pairs] = (uint8_t)(codes[n - 1] & 0x0F);
}

void unpack_u4(const uint8_t* packed, int64_t n, uint8_t* out) {
  int64_t pairs = n / 2;
  for (int64_t i = 0; i < pairs; ++i) {
    out[2 * i] = packed[i] & 0x0F;
    out[2 * i + 1] = (packed[i] >> 4) & 0x0F;
  }
  if (n & 1) out[n - 1] = packed[pairs] & 0x0F;
}

// Write a float32 (n, dim) batch as fvecs rows appended at out_fd's
// current offset.  Returns 0 on success.  Used by test/data generators.
int32_t fvecs_write(int32_t fd, const float* data, int64_t n, int32_t dim) {
  size_t row_bytes = sizeof(int32_t) + (size_t)dim * sizeof(float);
  std::vector<uint8_t> row(row_bytes);
  std::memcpy(row.data(), &dim, sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(row.data() + sizeof(int32_t), data + i * dim,
                (size_t)dim * sizeof(float));
    ssize_t w = ::write(fd, row.data(), row_bytes);
    if (w != (ssize_t)row_bytes) return -1;
  }
  return 0;
}

}  // extern "C"
