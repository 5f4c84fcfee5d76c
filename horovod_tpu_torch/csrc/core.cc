// Native runtime core of horovod_tpu_torch: the host-side control-plane
// pieces of the fusion cycle, a copy of the JAX package's
// horovod_tpu/csrc/core.cc (the port builds from its own copy only).
//
// Reference parity: the C++ control-plane pieces that stay CPU-bound and
// latency-critical on any accelerator --
//   * greedy fusion bin planning   (FuseResponses, controller.cc:887-986)
//   * chrome-trace timeline writer (TimelineWriter, timeline.cc:150,298 --
//     dedicated writer thread fed by a bounded queue; serialization and
//     file IO never run on a framework thread)
//   * batched segment pack        (cuda/cuda_kernels.cu batched-memcpy
//     analogue, here for host-side staging buffers)
//
// Exposed as a plain C ABI consumed via ctypes;
// horovod_tpu_torch/native/__init__.py builds it with g++ at first use
// (into build/horovod_tpu_torch/) and holds the Python bindings.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fusion planner (ref FuseResponses controller.cc:887: walk the queue in
// order, greedily adding tensors that still fit under the threshold,
// skipping — not stopping at — ones that don't; repeat for further bins).
//
// sizes:        n tensor byte-sizes, queue order.
// threshold:    bin capacity in bytes; the first tensor of a bin always
//               fits (oversized tensors get their own bin).
// out_bin_ids:  bin index per tensor (written for all n entries).
// returns:      number of bins.
int32_t hvd_plan_fusion_bins(const int64_t* sizes, int32_t n,
                             int64_t threshold, int32_t* out_bin_ids) {
  if (n <= 0) return 0;
  std::vector<int32_t> remaining;
  remaining.reserve(n);
  for (int32_t i = 0; i < n; ++i) remaining.push_back(i);
  int32_t bin = 0;
  std::vector<int32_t> leftover;
  while (!remaining.empty()) {
    leftover.clear();
    int64_t acc = 0;
    bool first = true;
    for (int32_t idx : remaining) {
      if (first || acc + sizes[idx] <= threshold) {
        out_bin_ids[idx] = bin;
        acc += sizes[idx];
        first = false;
      } else {
        leftover.push_back(idx);
      }
    }
    remaining.swap(leftover);
    ++bin;
  }
  return bin;
}

// ---------------------------------------------------------------------------
// Timeline writer.

namespace {

struct TimelineEvent {
  std::string name;
  std::string cat;        // empty -> omitted
  std::string args_json;  // empty -> omitted; must be a JSON object literal
  double ts_us;
  int32_t tid;
  char ph;                // 'B' | 'E' | 'i'
};

void AppendEscaped(std::string* out, const std::string& s) {
  for (char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          *out += c;
        }
    }
  }
}

class TimelineWriter {
 public:
  TimelineWriter(const char* path, int32_t pid, int64_t capacity)
      : pid_(pid), capacity_(capacity > 0 ? capacity : 1 << 16) {
    file_ = std::fopen(path, "w");
    if (file_ == nullptr) return;
    std::fputs("[\n", file_);
    thread_ = std::thread([this] { Loop(); });
  }

  bool ok() const { return file_ != nullptr; }

  void Emit(TimelineEvent ev) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_) return;
      if (static_cast<int64_t>(queue_.size()) >= capacity_) {
        // Never block a framework thread on trace IO (the reference's
        // lock-free queues have the same policy); count the drop instead.
        dropped_.fetch_add(1, std::memory_order_relaxed);
        return;
      }
      queue_.push_back(std::move(ev));
    }
    cv_.notify_one();
  }

  int64_t dropped() const {
    return dropped_.load(std::memory_order_relaxed);
  }

  void Close(double end_ts_us) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_) return;
      closed_ = true;
    }
    cv_.notify_one();
    if (thread_.joinable()) thread_.join();
    if (file_ != nullptr) {
      std::string line = "{\"name\": \"timeline_end\", \"ph\": \"i\", ";
      char buf[96];
      std::snprintf(buf, sizeof(buf), "\"ts\": %.3f, \"pid\": %d}\n]\n",
                    end_ts_us, pid_);
      line += buf;
      std::fputs(line.c_str(), file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  ~TimelineWriter() { Close(0.0); }

 private:
  void Loop() {
    std::string line;
    for (;;) {
      std::deque<TimelineEvent> batch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return closed_ || !queue_.empty(); });
        if (queue_.empty() && closed_) return;
        batch.swap(queue_);
      }
      for (const TimelineEvent& ev : batch) {
        line.clear();
        line += "{\"name\": \"";
        AppendEscaped(&line, ev.name);
        line += "\"";
        if (!ev.cat.empty()) {
          line += ", \"cat\": \"";
          AppendEscaped(&line, ev.cat);
          line += "\"";
        }
        char buf[128];
        std::snprintf(buf, sizeof(buf),
                      ", \"ph\": \"%c\", \"ts\": %.3f, \"pid\": %d",
                      ev.ph, ev.ts_us, pid_);
        line += buf;
        if (ev.ph == 'i') {
          line += ", \"s\": \"p\"";
        } else {
          std::snprintf(buf, sizeof(buf), ", \"tid\": %d", ev.tid);
          line += buf;
        }
        if (!ev.args_json.empty()) {
          line += ", \"args\": ";
          line += ev.args_json;  // caller-provided JSON object
        }
        line += "},\n";
        std::fputs(line.c_str(), file_);
      }
      std::fflush(file_);
    }
  }

  std::FILE* file_ = nullptr;
  int32_t pid_;
  int64_t capacity_;
  std::deque<TimelineEvent> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::atomic<int64_t> dropped_{0};
  bool closed_ = false;
  std::thread thread_;
};

}  // namespace

void* hvd_timeline_open(const char* path, int32_t pid, int64_t capacity) {
  TimelineWriter* w = new TimelineWriter(path, pid, capacity);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

void hvd_timeline_event(void* handle, const char* name, const char* cat,
                        char ph, double ts_us, int32_t tid,
                        const char* args_json) {
  if (handle == nullptr) return;
  TimelineEvent ev;
  ev.name = name ? name : "";
  ev.cat = cat ? cat : "";
  ev.args_json = args_json ? args_json : "";
  ev.ph = ph;
  ev.ts_us = ts_us;
  ev.tid = tid;
  static_cast<TimelineWriter*>(handle)->Emit(std::move(ev));
}

int64_t hvd_timeline_dropped(void* handle) {
  if (handle == nullptr) return 0;
  return static_cast<TimelineWriter*>(handle)->dropped();
}

void hvd_timeline_close(void* handle, double end_ts_us) {
  if (handle == nullptr) return;
  TimelineWriter* w = static_cast<TimelineWriter*>(handle);
  w->Close(end_ts_us);
  delete w;
}

// ---------------------------------------------------------------------------
// Batched segment pack (host staging). Copies n segments into one
// contiguous buffer, splitting the total byte range across threads
// (ref cuda_kernels.cu BatchedScaledMemcpy: one launch for many copies).

namespace {

void ParallelSegmentCopy(const void** srcs, void** dsts,
                         const int64_t* sizes, int32_t n,
                         int32_t num_threads) {
  int64_t total = 0;
  for (int32_t i = 0; i < n; ++i) total += sizes[i];
  if (total <= 0) return;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads <= 0) num_threads = hw > 0 ? hw : 4;
  // Below ~4 MiB the spawn cost dominates; copy inline.
  if (total < (4 << 20) || num_threads == 1) {
    for (int32_t i = 0; i < n; ++i)
      std::memcpy(dsts[i], srcs[i], static_cast<size_t>(sizes[i]));
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (total + num_threads - 1) / num_threads;
  int64_t seg_start = 0;
  int32_t seg = 0;
  for (int t = 0; t < num_threads && seg < n; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(total, begin + chunk);
    if (begin >= end) break;
    // Advance to the segment containing `begin`.
    while (seg < n && seg_start + sizes[seg] <= begin)
      seg_start += sizes[seg++];
    int32_t first_seg = seg;
    int64_t first_off = begin - seg_start;
    threads.emplace_back([=] {
      int64_t remaining = end - begin;
      int32_t s = first_seg;
      int64_t off = first_off;
      while (remaining > 0 && s < n) {
        int64_t take = std::min(sizes[s] - off, remaining);
        std::memcpy(static_cast<char*>(dsts[s]) + off,
                    static_cast<const char*>(srcs[s]) + off,
                    static_cast<size_t>(take));
        remaining -= take;
        ++s;
        off = 0;
      }
    });
  }
  for (std::thread& th : threads) th.join();
}

}  // namespace

// Pack: n source segments -> one contiguous dst at running offsets.
void hvd_pack_segments(const void** srcs, const int64_t* sizes, int32_t n,
                       void* dst, int32_t num_threads) {
  std::vector<void*> dsts(n);
  char* p = static_cast<char*>(dst);
  for (int32_t i = 0; i < n; ++i) {
    dsts[i] = p;
    p += sizes[i];
  }
  ParallelSegmentCopy(srcs, dsts.data(), sizes, n, num_threads);
}

// Version tag for the loader's staleness check.
int32_t hvd_native_abi_version() { return 1; }

}  // extern "C"
