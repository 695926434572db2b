// A kernel's status flags in pinned host memory, and the one wait a call
// makes for them: shared by the launchers of onehot_embed, moe_dispatch and
// relational_matmul, each of which must raise for a bad id before anyone
// uses its result.
//
// A zeroed device word a call costs a memset launch, and reading it back
// (err.item()) a device-to-host copy and a full synchronisation.  Here each
// device has kWords flags for the life of the process, in pinned host
// memory mapped into the device's address space
// (cudaHostAlloc(cudaHostAllocMapped)), made at the first call; a kernel
// writes a flag only on a fault (a plain store of 1: every writer stores
// the same value, so no atomic crosses the bus).  The launcher records an
// event on the stream right after its kernel and waits on that event alone
// (cudaEventSynchronize), not on the device, then reads the flags from host
// memory and clears them, so a call that follows a bad one starts clean:
// no memset, no copy.  Calls on one device hold that device's mutex from
// the launch to the clear, so two host threads calling at once run one
// after the other, and each reads the flags of its own kernel and no other.
//
// Each library that includes this is its own translation unit, so each has
// its own flags (internal linkage).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kFlagWords = 3;

// One device's flags (host side and the device's view of them), the event
// a call waits on, and the lock that keeps calls apart.
struct Status {
  std::mutex lock;
  volatile int32_t* host = nullptr;
  int32_t* dev = nullptr;
  cudaEvent_t done = nullptr;
};
Status status[kMaxDevices];

cudaError_t ready(Status& st) {
  if (st.done) return cudaSuccess;
  void* host;
  cudaError_t e = cudaHostAlloc(&host, kFlagWords * sizeof(int32_t),
                                cudaHostAllocMapped);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < kFlagWords; ++i)
    static_cast<volatile int32_t*>(host)[i] = 0;
  void* dev;
  e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e == cudaSuccess)
    e = cudaEventCreateWithFlags(&st.done, cudaEventDisableTiming);
  if (e != cudaSuccess) {
    cudaFreeHost(host);
    st.done = nullptr;
    return e;
  }
  st.host = static_cast<volatile int32_t*>(host);
  st.dev = static_cast<int32_t*>(dev);
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int current;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// The device's status, made ready, for a launcher that holds its lock.
cudaError_t open_status(int device, Status** st) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  *st = &status[device];
  return cudaSuccess;
}

// After the launch on stream s: the launch's error if it had one, else
// waits for the work queued so far and sets *bits to the flags raised
// (flag i is bit i), clearing them.
cudaError_t take_flags(Status& st, cudaStream_t s, int* bits) {
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(st.done, s);
  if (e == cudaSuccess) e = cudaEventSynchronize(st.done);
  if (e != cudaSuccess) return e;
  *bits = 0;
  for (int i = 0; i < kFlagWords; ++i) {
    if (st.host[i]) {
      *bits |= 1 << i;
      st.host[i] = 0;
    }
  }
  return cudaSuccess;
}

}  // namespace
