// Multithreaded prefetching batch loader of the port's data pipeline.
//
// Worker threads decode random training segments (wavio.cpp) into a ring of
// host batch slots; buddy_tpu_torch/data/loader.py::NativeBatchLoader pops a
// filled slot, copies it out and hands the slot back.  Decoding is C++ with
// no interpreter lock, straight into the slot.  The code is that of the JAX
// package's loader.cpp, so that one worker and a seed give the same batches
// bit for bit in both packages.  With several workers the order is
// not deterministic: they share seed_ctr and race for slots.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int wav_read_segment(const char* path, float* out, int64_t segment_length,
                     uint64_t seed);
}

namespace {

struct Loader {
  std::vector<std::string> files;
  int64_t segment_length = 0;
  int batch_size = 0;
  int n_slots = 0;

  std::vector<float*> slots;          // n_slots buffers of batch*segment floats
  std::queue<int> free_q, ready_q;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seed_ctr{0};

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    for (auto* s : slots) delete[] s;
  }

  void worker_main(uint64_t wseed) {
    std::mt19937_64 rng(wseed);
    while (true) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_q.empty(); });
        if (stop) return;
        slot = free_q.front();
        free_q.pop();
      }
      float* buf = slots[slot];
      std::uniform_int_distribution<size_t> pick(0, files.size() - 1);
      for (int b = 0; b < batch_size; ++b) {
        const std::string& path = files[pick(rng)];
        uint64_t seed = seed_ctr.fetch_add(1) * 0x9E3779B97F4A7C15ull ^ rng();
        if (wav_read_segment(path.c_str(), buf + (int64_t)b * segment_length,
                             segment_length, seed) != 0) {
          memset(buf + (int64_t)b * segment_length, 0,
                 sizeof(float) * segment_length);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_q.push(slot);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_files, int batch_size,
                    int64_t segment_length, int n_slots, int n_workers,
                    uint64_t seed) {
  auto* L = new Loader();
  L->files.reserve(n_files);
  for (int i = 0; i < n_files; ++i) L->files.emplace_back(paths[i]);
  L->segment_length = segment_length;
  L->batch_size = batch_size;
  L->n_slots = n_slots;
  for (int i = 0; i < n_slots; ++i) {
    L->slots.push_back(new float[(int64_t)batch_size * segment_length]);
    L->free_q.push(i);
  }
  for (int w = 0; w < n_workers; ++w)
    L->workers.emplace_back(&Loader::worker_main, L, seed + 1000003ull * w);
  return L;
}

// Blocks until a batch is ready; returns the slot id and sets *data to the
// buffer, or -1 once the loader is stopping. Call loader_release(slot) when
// the batch has been copied out.
int loader_next(void* handle, float** data) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->stop.load() || !L->ready_q.empty(); });
  if (L->stop) return -1;
  int slot = L->ready_q.front();
  L->ready_q.pop();
  *data = L->slots[slot];
  return slot;
}

void loader_release(void* handle, int slot) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_q.push(slot);
  }
  L->cv_free.notify_one();
}

void loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
