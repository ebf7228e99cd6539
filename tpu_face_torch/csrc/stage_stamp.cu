// Device time stamps for utils/profiling's spans: a one-thread kernel that
// writes the card's global timer (%globaltimer, ns) into a slot of a
// per-device stamp ring.
//
// The ring is one int64 array:
//   ring[0]                 the sequence number of the call being stamped
//                           (the ring's call counter on the device)
//   ring[1]                 the clock pairing's stamp (stage_stamp_pair)
//   ring[2 + r * (1 + S)]   row r: the sequence number that owns it, then
//                           S slots, two per span (begin, end); 0 is unset
// with kRows rows of kSlots slots; utils/profiling.py holds the same
// constants.  A call's first stamp (stage_stamp_open, launched eagerly with
// the host's sequence number) advances the counter, takes the row
// seq % kRows and clears it; every later stamp of the call, eager or a node
// of a captured CUDA graph (an IF node's body included), writes into the
// row the counter names.  A branch that does not run leaves its slots 0.
// The stamps of one row are on one stream, so they run in order and no
// atomics are needed.
//
// stage_stamp_pair launches one stamp on an idle stream between two reads
// of CLOCK_MONOTONIC (Python's time.perf_counter_ns on Linux) and waits for
// it: the stamp ran inside that bracket, which pairs the two clocks to
// within the bracket's width.
#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

namespace {

constexpr int64_t kRows = 4096;
constexpr int kSlots = 512;
constexpr int64_t kHead = 2;

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

__device__ __forceinline__ int64_t* row_of(int64_t* ring, int64_t seq) {
  return ring + kHead + (seq % kRows) * (1 + kSlots);
}

__global__ void stamp_open(int64_t* ring, int64_t seq, int slot) {
  int64_t t = global_ns();
  int64_t* row = row_of(ring, seq);
  ring[0] = seq;
  row[0] = seq;
  for (int i = 0; i < kSlots; ++i) row[1 + i] = 0;
  row[1 + slot] = t;
}

__global__ void stamp(int64_t* ring, int slot) {
  int64_t t = global_ns();
  row_of(ring, ring[0])[1 + slot] = t;
}

__global__ void stamp_at(int64_t* at) { *at = global_ns(); }

int64_t monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

}  // namespace

extern "C" int stage_stamp_open(void* ring, int64_t seq, int slot,
                                void* stream) {
  if (slot < 0 || slot >= kSlots) return cudaErrorInvalidValue;
  stamp_open<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(ring), seq, slot);
  return cudaGetLastError();
}

extern "C" int stage_stamp(void* ring, int slot, void* stream) {
  if (slot < 0 || slot >= kSlots) return cudaErrorInvalidValue;
  stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(ring), slot);
  return cudaGetLastError();
}

// out (host, int64[3]): the host's clock before the launch and after the
// wait, and the stamp
extern "C" int stage_stamp_pair(void* at, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* host = static_cast<int64_t*>(out);
  int64_t before = monotonic_ns();
  stamp_at<<<1, 1, 0, s>>>(static_cast<int64_t*>(at));
  cudaError_t err = cudaStreamSynchronize(s);
  int64_t after = monotonic_ns();
  if (err != cudaSuccess) return err;
  err = cudaMemcpy(&host[2], at, sizeof(int64_t), cudaMemcpyDeviceToHost);
  host[0] = before;
  host[1] = after;
  return err;
}
