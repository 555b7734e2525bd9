// py4cast_tpu_torch's parallel npy batch reader (host C++, no CUDA).
//
// A Titan-style sample is one small npy file per (date, param). This
// reads a batch of them on a persistent thread pool: it parses each npy
// header, checks the declared shape per dimension, and copies the
// float32 payload straight into the caller's numpy buffer, with no
// Python object and no GIL on the way.
//
// Built with the host compiler at first use by py4cast_tpu_torch/native.py
// (g++ -O3 -std=c++17 -fPIC -pthread -shared), loaded with ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------- thread pool
class ThreadPool {
 public:
  explicit ThreadPool(size_t n) : stop_(false) {
    for (size_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> f) {
    {
      std::unique_lock<std::mutex> lock(mu_);
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool& pool() {
  static ThreadPool p(std::max(2u, std::thread::hardware_concurrency()));
  return p;
}

// -------------------------------------------------------- npy parsing
// Reads a .npy v1/v2 file of little-endian float32 ('<f4') C-order data
// into `out` (expected_elems floats). When `dims`/`ndim` are given the
// declared shape must match PER-DIM (a (4,3) file must not fill a (3,4)
// slot even though the element counts agree). Returns 0 on success.
int read_npy_f32(const char* path, float* out, int64_t expected_elems,
                 const int64_t* dims = nullptr, int ndim = 0) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return 2;
  }
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (std::fread(hl, 1, 2, f) != 2) { std::fclose(f); return 3; }
    header_len = hl[0] | (hl[1] << 8);
  } else {
    unsigned char hl[4];
    if (std::fread(hl, 1, 4, f) != 4) { std::fclose(f); return 3; }
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) | (uint32_t(hl[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return 4;
  }
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    std::fclose(f);
    return 5;  // only C-order little-endian float32 supported
  }
  // Validate the declared shape against the caller's expectation: a file
  // with MORE elements than expected would otherwise silently fill the
  // batch buffer with truncated data (the batch reader assumes every
  // file matches the probed shape of the first one).
  const size_t shape_pos = header.find("'shape': (");
  if (shape_pos == std::string::npos) {
    std::fclose(f);
    return 5;
  }
  int64_t elems = 1;
  int n_dims = 0;
  bool dim_mismatch = false;
  for (size_t i = shape_pos + 10; i < header.size() && header[i] != ')';) {
    if (header[i] >= '0' && header[i] <= '9') {
      int64_t d = 0;
      while (i < header.size() && header[i] >= '0' && header[i] <= '9') {
        d = d * 10 + (header[i] - '0');
        ++i;
      }
      elems *= d;
      if (dims && (n_dims >= ndim || dims[n_dims] != d)) dim_mismatch = true;
      ++n_dims;
    } else {
      ++i;
    }
  }
  if (n_dims > 0 && elems != expected_elems) {
    std::fclose(f);
    return 7;  // shape mismatch vs the probed batch item shape
  }
  if (dims && n_dims > 0 && (dim_mismatch || n_dims != ndim)) {
    std::fclose(f);
    return 7;  // same element count but transposed/reshaped dims
  }
  const size_t want = size_t(expected_elems) * sizeof(float);
  const size_t got = std::fread(out, 1, want, f);
  std::fclose(f);
  return got == want ? 0 : 6;
}

}  // namespace

extern "C" {

// Read n npy files in parallel; file i fills out[i * per_item_elems ...].
// Each file's declared shape must equal dims[0..ndim) exactly.
// Returns 0 on success, or (1 + index of the first failing file).
int p4t_read_npy_batch_shaped(const char** paths, int n, float* out,
                              int64_t per_item_elems, const int64_t* dims,
                              int ndim) {
  std::atomic<int> first_error{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; ++i) {
    pool().submit([&, i] {
      int rc = read_npy_f32(paths[i], out + int64_t(i) * per_item_elems,
                            per_item_elems, dims, ndim);
      if (rc != 0) {
        int expected = 0;
        first_error.compare_exchange_strong(expected, i + 1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mu);
  done_cv.wait(lock, [&] { return remaining.load() == 0; });
  return first_error.load();
}

// Element-count-only variant kept for ABI continuity.
int p4t_read_npy_batch(const char** paths, int n, float* out,
                       int64_t per_item_elems) {
  return p4t_read_npy_batch_shaped(paths, n, out, per_item_elems, nullptr, 0);
}

// Version / health probe for the ctypes binding.
int p4t_version() { return 3; }

}  // extern "C"
