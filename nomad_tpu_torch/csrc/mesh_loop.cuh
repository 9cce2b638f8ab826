// The step loop of a pass laid out over a node-axis mesh whose merge runs
// once a step on the mesh lead (csrc/hetero.cu, csrc/cp.cu).
//
// Cell c runs on devices[c] and its tensors were made on the stream
// home[c]; cell 0 is the lead. Every cell's work runs on a stream of its
// own, after its home stream's work so far; at the end every home stream
// waits for its cell's last launch, so the caching allocator reuses the
// cell's tensors only after them. A step: each cell's shard launch, then
// a peer copy of its candidates to the lead; the lead's merge once every
// copy has landed; the lead's record copied to every cell; each cell's
// apply. No host sync a step: every `every` steps the lead's stop word
// is copied into pinned host memory, and the host reads the copy made
// `every` steps before, so it queues at most 2 `every` steps past the
// stop, each of which returns at once.

#pragma once

#include <cstdint>
#include <vector>

#include <cuda_runtime.h>

namespace {

class MeshLoop {
 public:
  MeshLoop(int cells, const int* devices, const std::vector<void*>& home)
      : cells_(cells), devices_(devices), home_(home), st_(cells, nullptr), done_(cells, nullptr) {
    err_ = cudaGetDevice(&prev_);
    for (int c = 0; c < cells_ && ok(); ++c) {
      check(cudaSetDevice(devices_[c])) &&
          check(cudaStreamCreateWithFlags(&st_[c], cudaStreamNonBlocking)) &&
          check(cudaEventCreateWithFlags(&done_[c], cudaEventDisableTiming)) &&
          check(cudaEventRecord(done_[c], static_cast<cudaStream_t>(home_[c]))) &&
          check(cudaStreamWaitEvent(st_[c], done_[c], 0));
    }
    ok() && check(cudaSetDevice(devices_[0])) &&
        check(cudaEventCreateWithFlags(&merged_, cudaEventDisableTiming)) &&
        check(cudaEventCreateWithFlags(&polled_, cudaEventDisableTiming));
  }

  bool ok() const { return err_ == cudaSuccess; }

  // The first error sticks.
  bool check(cudaError_t e) {
    if (err_ == cudaSuccess && e != cudaSuccess) err_ = e;
    return ok();
  }

  // `launch(c, stream)` on every cell's stream.
  template <class Launch>
  void each(Launch launch) {
    for (int c = 0; c < cells_ && ok(); ++c) {
      check(cudaSetDevice(devices_[c])) && check(launch(c, st_[c]));
    }
  }

  // Whether to queue step `step`: false once an error stuck, or once the
  // lead's stop word (`word`, one int32 on the lead) read `every` steps
  // before was set.
  bool go_on(int step, int every, int32_t* poll, const void* word) {
    if (!ok()) return false;
    if (step % every != 0) return true;
    if (step > 0) {
      if (!check(cudaEventSynchronize(polled_))) return false;
      if (*static_cast<volatile int32_t*>(poll) != 0) return false;
    }
    return check(cudaSetDevice(devices_[0])) &&
           check(cudaMemcpyAsync(poll, word, 4, cudaMemcpyDeviceToHost, st_[0])) &&
           check(cudaEventRecord(polled_, st_[0]));
  }

  // One step: `shard(c, stream)` a cell and its `cand_bytes` from
  // `cand(c)` to `slot(c)` on the lead, `merge(stream)` on the lead, its
  // `rec_bytes` of `master` to `record(c)`, `apply(c, stream)` a cell.
  template <class Shard, class Cand, class Slot, class Merge, class Record, class Apply>
  void step(Shard shard, size_t cand_bytes, Cand cand, Slot slot, Merge merge,
            const void* master, size_t rec_bytes, Record record, Apply apply) {
    for (int c = 0; c < cells_ && ok(); ++c) {
      check(cudaSetDevice(devices_[c])) && check(shard(c, st_[c])) &&
          check(cudaMemcpyPeerAsync(slot(c), devices_[0], cand(c), devices_[c], cand_bytes,
                                    st_[c])) &&
          check(cudaEventRecord(done_[c], st_[c]));
    }
    check(cudaSetDevice(devices_[0]));
    for (int c = 1; c < cells_ && ok(); ++c) check(cudaStreamWaitEvent(st_[0], done_[c], 0));
    ok() && check(merge(st_[0])) && check(cudaEventRecord(merged_, st_[0]));
    for (int c = 0; c < cells_ && ok(); ++c) {
      check(cudaSetDevice(devices_[c])) &&
          (c == 0 || check(cudaStreamWaitEvent(st_[c], merged_, 0))) &&
          check(cudaMemcpyPeerAsync(record(c), devices_[c], master, devices_[0], rec_bytes,
                                    st_[c])) &&
          check(apply(c, st_[c]));
    }
  }

  // Every home stream waits for its cell; then the streams and events go
  // (their resources are released once the device is done with them).
  // Returns the first error.
  cudaError_t finish() {
    for (int c = 0; c < cells_; ++c) {
      if (st_[c] == nullptr) continue;
      cudaSetDevice(devices_[c]);
      if (done_[c] != nullptr) {
        check(cudaEventRecord(done_[c], st_[c]));
        check(cudaStreamWaitEvent(static_cast<cudaStream_t>(home_[c]), done_[c], 0));
      }
    }
    for (int c = 0; c < cells_; ++c) {
      cudaSetDevice(devices_[c]);
      if (done_[c] != nullptr) cudaEventDestroy(done_[c]);
      if (st_[c] != nullptr) cudaStreamDestroy(st_[c]);
    }
    cudaSetDevice(devices_[0]);
    if (merged_ != nullptr) cudaEventDestroy(merged_);
    if (polled_ != nullptr) cudaEventDestroy(polled_);
    cudaSetDevice(prev_);
    return err_;
  }

 private:
  int cells_;
  const int* devices_;
  std::vector<void*> home_;
  std::vector<cudaStream_t> st_;
  std::vector<cudaEvent_t> done_;
  cudaEvent_t merged_ = nullptr;
  cudaEvent_t polled_ = nullptr;
  cudaError_t err_ = cudaSuccess;
  int prev_ = 0;
};

}  // namespace
