// Native packed-dataset reader for the LITPKDS format.
//
// The reference's input pipeline leans on torch's C++-backed DataLoader workers
// (`lit_llama/packed_dataset.py` is consumed through `torch.utils.data.DataLoader`);
// this is the TPU framework's native equivalent: a C++ reader with a background
// prefetch thread that mmaps chunk files, walks a seeded block permutation, and
// assembles ready-to-ship int32 batches into a ring buffer — the Python side
// (ctypes, `lit_llama_ja_tpu/data/native_loader.py`) only hands buffers to JAX.
//
// Format (must match lit_llama/packed_dataset.py:33-34,98-107 and the Python
// implementation in data/packed_dataset.py):
//   magic "LITPKDS" | u64 version=1 | u8 dtype_code | u64 chunk_size | payload
// dtype codes: 1=u8 2=i8 3=i16 4=i32 5=i64 6=f32 7=f64 8=u16

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <random>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <deque>
#include <atomic>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[] = "LITPKDS";
constexpr size_t kHdrSize = 24;

struct MappedFile {
  void* base = nullptr;
  size_t size = 0;
  const uint8_t* payload = nullptr;
  uint8_t dtype_code = 0;
  uint64_t chunk_size = 0;

  bool open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < kHdrSize) {
      ::close(fd);
      return false;
    }
    size = st.st_size;
    base = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) {
      base = nullptr;
      return false;
    }
    const uint8_t* p = static_cast<const uint8_t*>(base);
    if (memcmp(p, kMagic, 7) != 0) return false;
    uint64_t version;
    memcpy(&version, p + 7, 8);
    if (version != 1) return false;
    dtype_code = p[15];
    memcpy(&chunk_size, p + 16, 8);
    payload = p + kHdrSize;
    return true;
  }

  void close() {
    if (base) munmap(base, size);
    base = nullptr;
  }
};

size_t dtype_itemsize(uint8_t code) {
  switch (code) {
    case 1: case 2: return 1;
    case 3: case 8: return 2;
    case 4: case 6: return 4;
    case 5: case 7: return 8;
  }
  return 0;
}

int64_t read_elem(const uint8_t* p, uint8_t code, size_t idx) {
  switch (code) {
    case 1: return p[idx];
    case 2: return reinterpret_cast<const int8_t*>(p)[idx];
    case 3: return reinterpret_cast<const int16_t*>(p)[idx];
    case 8: return reinterpret_cast<const uint16_t*>(p)[idx];
    case 4: return reinterpret_cast<const int32_t*>(p)[idx];
    case 5: return reinterpret_cast<const int64_t*>(p)[idx];
  }
  return 0;
}

struct Reader {
  std::vector<std::string> files;
  long block_size = 0;
  int n_chunks = 0;
  uint64_t seed = 0;
  bool shuffle = true;
  bool wrap = false;
  int batch = 1;
  int prefetch_depth = 4;
  uint64_t skip_rows = 0;  // data-loader resume: rows to fast-forward at start

  // iteration state (owned by the producer thread)
  size_t file_idx = 0;
  std::vector<MappedFile> mapped;
  std::vector<uint64_t> block_order;
  size_t order_pos = 0;
  uint64_t n_blocks_per_chunk = 0;
  std::mt19937_64 rng;

  // ring of ready batches
  std::deque<std::vector<int32_t>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> done{false}, stop{false};
  std::thread producer;

  ~Reader() { shutdown(); }

  void shutdown() {
    stop = true;
    cv_space.notify_all();
    cv_ready.notify_all();
    if (producer.joinable()) producer.join();
    for (auto& m : mapped) m.close();
    mapped.clear();
  }

  bool load_window() {
    for (auto& m : mapped) m.close();
    mapped.clear();
    if (files.size() - file_idx < (size_t)n_chunks) {
      if (!wrap) return false;
      file_idx = 0;
    }
    for (int i = 0; i < n_chunks; i++) {
      MappedFile m;
      if (!m.open(files[file_idx + i].c_str())) return false;
      mapped.push_back(m);
    }
    file_idx += n_chunks;
    n_blocks_per_chunk = mapped[0].chunk_size / block_size;
    uint64_t total = n_blocks_per_chunk * n_chunks;
    block_order.resize(total);
    for (uint64_t i = 0; i < total; i++) block_order[i] = i;
    if (shuffle) {
      for (uint64_t i = total - 1; i > 0; i--) {
        uint64_t j = rng() % (i + 1);
        std::swap(block_order[i], block_order[j]);
      }
    }
    order_pos = 0;
    return true;
  }

  bool fill_row(int32_t* out) {
    if (order_pos >= block_order.size()) {
      if (!load_window()) return false;
    }
    uint64_t b = block_order[order_pos++];
    const MappedFile& m = mapped[b / n_blocks_per_chunk];
    size_t elem0 = (b % n_blocks_per_chunk) * block_size;
    for (long i = 0; i < block_size; i++) {
      out[i] = (int32_t)read_elem(m.payload, m.dtype_code, elem0 + i);
    }
    return true;
  }

  // advance the block cursor one row without touching payload bytes (resume
  // fast-forward: replays the same seeded shuffle, skips the reads)
  bool skip_row() {
    if (order_pos >= block_order.size()) {
      if (!load_window()) return false;
    }
    order_pos++;
    return true;
  }

  void produce() {
    rng.seed(seed);
    if (!load_window()) {
      done = true;
      cv_ready.notify_all();
      return;
    }
    for (uint64_t i = 0; i < skip_rows && !stop; i++) {
      if (!skip_row()) {
        done = true;
        cv_ready.notify_all();
        return;
      }
    }
    while (!stop) {
      std::vector<int32_t> buf((size_t)batch * block_size);
      bool ok = true;
      for (int r = 0; r < batch && ok; r++) {
        ok = fill_row(buf.data() + (size_t)r * block_size);
      }
      if (!ok) break;
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return (int)ready.size() < prefetch_depth || stop; });
      if (stop) break;
      ready.push_back(std::move(buf));
      cv_ready.notify_one();
    }
    done = true;
    cv_ready.notify_all();
  }

  void start() { producer = std::thread([this] { produce(); }); }

  // returns 1 on success, 0 on exhaustion
  int next(int32_t* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return !ready.empty() || done; });
    if (ready.empty()) return 0;
    std::vector<int32_t> buf = std::move(ready.front());
    ready.pop_front();
    cv_space.notify_one();
    lk.unlock();
    memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
    return 1;
  }
};

}  // namespace

extern "C" {

void* pr_create(const char** filenames, int n_files, long block_size, int n_chunks,
                unsigned long long seed, int shuffle, int wrap, int batch,
                int prefetch_depth, unsigned long long skip_rows) {
  auto* r = new Reader();
  for (int i = 0; i < n_files; i++) r->files.emplace_back(filenames[i]);
  r->block_size = block_size;
  r->n_chunks = n_chunks;
  r->seed = seed;
  r->shuffle = shuffle != 0;
  r->wrap = wrap != 0;
  r->batch = batch;
  r->prefetch_depth = prefetch_depth;
  r->skip_rows = skip_rows;
  r->start();
  return r;
}

// fills out[batch * block_size] int32; returns 1 on success, 0 when exhausted
int pr_next(void* handle, int32_t* out) {
  return static_cast<Reader*>(handle)->next(out);
}

void pr_destroy(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"
