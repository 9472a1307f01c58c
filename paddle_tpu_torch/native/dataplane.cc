// Native data plane: multithreaded file -> sample -> batch pipeline.
//
// The port's copy of paddle_tpu/native/dataplane.cc (the reference's C++
// Dataset/DataFeed stack: paddle/fluid/framework/data_set.h:157,
// data_feed.h:117 MultiSlotDataFeed, channel.h blocking channels): N parser
// threads consume a shared file list, parse MultiSlot-format text lines,
// pack contiguous per-slot batch buffers and push them through a bounded
// blocking queue that Python drains via ctypes (no Python in the parse and
// pack path). Also the InMemoryDataset behaviours: load_into_memory /
// local_shuffle / release_memory (reference data_set.h:101-111). Host code
// only: nothing here touches the GPU.
//
// One change from the reference: load_into_memory keeps the samples in
// file order, each file's lines in order, whatever the number of threads
// (the reference appends each thread's samples as the thread finishes), so
// a loaded dataset and its seeded local_shuffle are the same on every run.
//
// MultiSlot text line format (reference data_feed.cc):
//   for each slot, in declared order:  <n> <v_1> ... <v_n>
// float slots (type 0) are dense, padded/truncated to `dim` floats;
// int64 slots (type 1) are id lists, padded with 0 / truncated to `dim`.
//
// Build (paddle_tpu_torch/native/__init__.py, at first use):
//   g++ -O2 -std=c++17 -shared -fPIC -o libdataplane-<hash>.so dataplane.cc
//       -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct SlotSpec {
  int type;  // 0 = float dense, 1 = int64 ids
  int dim;   // values per sample (pad/truncate)
};

// One parsed sample: flat per-slot values, already padded to slot dim.
struct Sample {
  std::vector<float> fvals;    // concatenated float slots
  std::vector<int64_t> ivals;  // concatenated int64 slots
};

// One packed batch: per-slot contiguous buffers.
struct Batch {
  int rows = 0;
  std::vector<std::vector<float>> fbufs;    // one per float slot
  std::vector<std::vector<int64_t>> ibufs;  // one per int64 slot
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t cap) : cap_(cap) {}

  void Push(Batch&& b) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push_back(std::move(b));
    not_empty_.notify_one();
  }

  // false = queue closed and drained (epoch end)
  bool Pop(Batch* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  void Reopen() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = false;
    q_.clear();
  }

 private:
  size_t cap_;
  bool closed_ = false;
  std::deque<Batch> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

class DataPlane {
 public:
  DataPlane(int n_slots, const int* types, const int* dims, int batch_size,
            int n_threads, int capacity)
      : batch_size_(batch_size),
        n_threads_(n_threads < 1 ? 1 : n_threads),
        queue_(capacity < 2 ? 2 : capacity) {
    for (int i = 0; i < n_slots; ++i) {
      slots_.push_back({types[i], dims[i]});
      if (types[i] == 0) {
        fdim_total_ += dims[i];
        n_fslots_++;
      } else {
        idim_total_ += dims[i];
        n_islots_++;
      }
    }
  }

  ~DataPlane() { StopWorkers(); }

  void SetFiles(const char** paths, int n) {
    files_.clear();
    for (int i = 0; i < n; ++i) files_.emplace_back(paths[i]);
  }

  bool ParseLine(const std::string& line, Sample* s) const {
    const char* p = line.c_str();
    char* end = nullptr;
    s->fvals.reserve(fdim_total_);
    s->ivals.reserve(idim_total_);
    for (const auto& slot : slots_) {
      long n = strtol(p, &end, 10);
      if (end == p) return false;  // malformed line
      p = end;
      if (slot.type == 0) {
        int i = 0;
        for (; i < n && i < slot.dim; ++i) {
          float v = strtof(p, &end);
          if (end == p) return false;
          p = end;
          s->fvals.push_back(v);
        }
        for (long skip = i; skip < n; ++skip) {  // truncate extras
          strtof(p, &end);
          p = end;
        }
        for (; i < slot.dim; ++i) s->fvals.push_back(0.0f);
      } else {
        int i = 0;
        for (; i < n && i < slot.dim; ++i) {
          int64_t v = strtoll(p, &end, 10);
          if (end == p) return false;
          p = end;
          s->ivals.push_back(v);
        }
        for (long skip = i; skip < n; ++skip) {
          strtoll(p, &end, 10);
          p = end;
        }
        for (; i < slot.dim; ++i) s->ivals.push_back(0);
      }
    }
    return true;
  }

  void PackInto(Batch* b, const Sample& s) const {
    int fi = 0, ii = 0, foff = 0, ioff = 0;
    for (const auto& slot : slots_) {
      if (slot.type == 0) {
        auto& buf = b->fbufs[fi++];
        buf.insert(buf.end(), s.fvals.begin() + foff,
                   s.fvals.begin() + foff + slot.dim);
        foff += slot.dim;
      } else {
        auto& buf = b->ibufs[ii++];
        buf.insert(buf.end(), s.ivals.begin() + ioff,
                   s.ivals.begin() + ioff + slot.dim);
        ioff += slot.dim;
      }
    }
    b->rows++;
  }

  Batch NewBatch() const {
    Batch b;
    b.fbufs.resize(n_fslots_);
    b.ibufs.resize(n_islots_);
    for (auto& v : b.fbufs) v.reserve(batch_size_ * 16);
    for (auto& v : b.ibufs) v.reserve(batch_size_ * 16);
    return b;
  }

  // ---- streaming (QueueDataset) -------------------------------------------
  void StreamWorker() {
    Batch cur = NewBatch();
    for (;;) {
      size_t idx = next_file_.fetch_add(1);
      if (idx >= files_.size()) break;
      std::ifstream in(files_[idx]);
      std::string line;
      while (std::getline(in, line)) {
        if (line.empty()) continue;
        Sample s;
        if (!ParseLine(line, &s)) continue;  // skip malformed (counted)
        PackInto(&cur, s);
        if (cur.rows == batch_size_) {
          queue_.Push(std::move(cur));
          cur = NewBatch();
        }
      }
    }
    if (cur.rows > 0) queue_.Push(std::move(cur));
    if (active_workers_.fetch_sub(1) == 1) queue_.Close();
  }

  // ---- in-memory (InMemoryDataset) ----------------------------------------
  void LoadIntoMemory() {
    StopWorkers();
    memory_.clear();
    // one slot per file, filled by whichever thread parses it, joined in
    // file order below
    std::vector<std::vector<Sample>> per_file(files_.size());
    std::vector<std::thread> loaders;
    next_file_.store(0);
    for (int t = 0; t < n_threads_; ++t) {
      loaders.emplace_back([&] {
        for (;;) {
          size_t idx = next_file_.fetch_add(1);
          if (idx >= files_.size()) break;
          std::ifstream in(files_[idx]);
          std::string line;
          while (std::getline(in, line)) {
            if (line.empty()) continue;
            Sample s;
            if (ParseLine(line, &s)) per_file[idx].push_back(std::move(s));
          }
        }
      });
    }
    for (auto& th : loaders) th.join();
    size_t total = 0;
    for (const auto& f : per_file) total += f.size();
    memory_.reserve(total);
    for (auto& f : per_file)
      for (auto& s : f) memory_.push_back(std::move(s));
    in_memory_ = true;
  }

  void LocalShuffle(uint64_t seed) {
    std::mt19937_64 rng(seed);
    for (size_t i = memory_.size(); i > 1; --i) {
      std::swap(memory_[i - 1], memory_[rng() % i]);
    }
  }

  void MemoryWorker() {
    Batch cur = NewBatch();
    for (size_t i = 0; i < memory_.size(); ++i) {
      PackInto(&cur, memory_[i]);
      if (cur.rows == batch_size_) {
        queue_.Push(std::move(cur));
        cur = NewBatch();
      }
    }
    if (cur.rows > 0) queue_.Push(std::move(cur));
    if (active_workers_.fetch_sub(1) == 1) queue_.Close();
  }

  // ---- epoch control ------------------------------------------------------
  void Start() {
    StopWorkers();
    queue_.Reopen();
    next_file_.store(0);
    if (in_memory_) {
      active_workers_.store(1);
      workers_.emplace_back([this] { MemoryWorker(); });
    } else {
      int n = n_threads_;
      active_workers_.store(n);
      for (int t = 0; t < n; ++t) {
        workers_.emplace_back([this] { StreamWorker(); });
      }
    }
  }

  // returns rows (0 = epoch end). out_ptrs: caller buffers, float slots
  // first then int slots, each sized batch_size*dim.
  int Next(void** out_ptrs) {
    Batch b;
    if (!queue_.Pop(&b)) return 0;
    int k = 0;
    for (size_t i = 0; i < b.fbufs.size(); ++i, ++k) {
      std::memcpy(out_ptrs[k], b.fbufs[i].data(),
                  b.fbufs[i].size() * sizeof(float));
    }
    for (size_t i = 0; i < b.ibufs.size(); ++i, ++k) {
      std::memcpy(out_ptrs[k], b.ibufs[i].data(),
                  b.ibufs[i].size() * sizeof(int64_t));
    }
    return b.rows;
  }

  void StopWorkers() {
    queue_.Close();
    for (auto& th : workers_) {
      if (th.joinable()) th.join();
    }
    workers_.clear();
  }

  int64_t MemorySize() const { return (int64_t)memory_.size(); }

  void ReleaseMemory() {
    memory_.clear();
    memory_.shrink_to_fit();
    in_memory_ = false;
  }

  int batch_size_;
  int n_threads_;
  int fdim_total_ = 0, idim_total_ = 0, n_fslots_ = 0, n_islots_ = 0;
  bool in_memory_ = false;
  std::vector<SlotSpec> slots_;
  std::vector<std::string> files_;
  std::vector<Sample> memory_;
  std::vector<std::thread> workers_;
  std::atomic<size_t> next_file_{0};
  std::atomic<int> active_workers_{0};
  BlockingQueue queue_;
};

}  // namespace

extern "C" {

void* dp_create(int n_slots, const int* types, const int* dims, int batch_size,
                int n_threads, int capacity) {
  return new DataPlane(n_slots, types, dims, batch_size, n_threads, capacity);
}

void dp_set_files(void* h, const char** paths, int n) {
  static_cast<DataPlane*>(h)->SetFiles(paths, n);
}

void dp_start(void* h) { static_cast<DataPlane*>(h)->Start(); }

int dp_next(void* h, void** out_ptrs) {
  return static_cast<DataPlane*>(h)->Next(out_ptrs);
}

void dp_load_into_memory(void* h) {
  static_cast<DataPlane*>(h)->LoadIntoMemory();
}

void dp_local_shuffle(void* h, unsigned long long seed) {
  static_cast<DataPlane*>(h)->LocalShuffle(seed);
}

long long dp_memory_size(void* h) {
  return static_cast<DataPlane*>(h)->MemorySize();
}

void dp_release_memory(void* h) {
  static_cast<DataPlane*>(h)->ReleaseMemory();
}

void dp_destroy(void* h) { delete static_cast<DataPlane*>(h); }

}  // extern "C"
