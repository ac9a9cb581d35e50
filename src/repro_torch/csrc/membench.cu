// The paper's Section-3 memory benchmark cells for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel src/repro/kernels/membench/kernel.py
// (membench_pallas, body membench_kernel): the cells {contentious,
// noncontentious} x {read, write} over 512-byte rows of 128 floats.
// Step i is one CTA of 128 threads, one float lane each; it hammers row 0
// (contentious) or its own row i (noncontentious) ``repeats`` times:
//
//   write: store (it + i + 1) for it in [0, repeats); the row ends at
//          repeats + i; checksum = sum of the row read back after the loop
//   read:  load the row ``repeats`` times; checksum = sum of every load
//
// Every access reaches memory: the loads and stores are relaxed
// device-scope atomic_ref accesses (ld/st.relaxed.gpu), which the
// compiler may neither merge nor hoist out of the loop, so the time
// measures the accesses. Read checksums accumulate each lane's loads in
// double (exact for any repeats below 2^29) and round once to float, so
// they agree with the plain repeats * row_sum to float32 rounding.
//
// The read cells and the noncontentious write cell are order-free and
// run every step at once. The contentious write cell is not: its result
// (row 0 ends at repeats + n_steps - 1, step i's checksum is
// 128 * (repeats + i)) is defined by the TPU's sequential grid. That cell
// hands row 0 from step to step: each CTA takes its step number from a
// global counter (atomicAdd, so every lower step is already resident and
// the wait cannot deadlock), polls a step-turn word with acquire loads
// until it is its turn, runs its loop, and release-stores the next turn.
// Its time is therefore a serialized hand-off, not concurrent contention.
// A poll budget turns a stuck hand-off into an error word the host
// raises on, never a hang.
//
// What bounds it on this card: the function moves only the buffer in and
// out once, so the bound is tiny; what the cells measure is the latency
// and throughput of repeated accesses to one line (contentious: all CTAs
// on one L2 line) or to distinct lines (noncontentious).
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxPolls = 1 << 24;
constexpr unsigned kSleepNs = 32;

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;
using DeviceFloat = cuda::atomic_ref<float, cuda::thread_scope_device>;

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < kLane / 32; ++w) total += scratch[w];
  return total;
}

// state: [step counter, step turn, error], zeroed by the caller.
__global__ void __launch_bounds__(kLane) membench_kernel(
    float* buf, float* __restrict__ sums, int* state, int contentious,
    int write, int repeats) {
  __shared__ double dscratch[kLane / 32];
  __shared__ float fscratch[kLane / 32];
  __shared__ int step_s;
  __shared__ int ok_s;
  const bool ordered = contentious && write;
  DeviceInt counter(state[0]), turn(state[1]), error(state[2]);
  if (threadIdx.x == 0) {
    int step = blockIdx.x;
    int ok = 1;
    if (ordered) {
      step = counter.fetch_add(1, cuda::memory_order_relaxed);
      for (int polls = 0;
           turn.load(cuda::memory_order_acquire) != step; ++polls) {
        if (polls >= kMaxPolls || error.load(cuda::memory_order_relaxed)) {
          error.store(1, cuda::memory_order_relaxed);
          ok = 0;
          break;
        }
        __nanosleep(kSleepNs);
      }
    }
    step_s = step;
    ok_s = ok;
  }
  __syncthreads();
  if (!ok_s) return;
  const int step = step_s;
  const int row = contentious ? 0 : step;
  DeviceFloat word(buf[row * kLane + threadIdx.x]);
  if (write) {
    for (int it = 0; it < repeats; ++it) {
      word.store(static_cast<float>(it + step + 1),
                 cuda::memory_order_relaxed);
    }
    const float total =
        block_sum(word.load(cuda::memory_order_relaxed), fscratch);
    if (threadIdx.x == 0) sums[step] = total;
    if (ordered) {
      __syncthreads();  // every lane's stores precede the hand-off
      if (threadIdx.x == 0) {
        __threadfence();
        turn.store(step + 1, cuda::memory_order_release);
      }
    }
  } else {
    double acc = 0.0;
    for (int it = 0; it < repeats; ++it) {
      acc += static_cast<double>(word.load(cuda::memory_order_relaxed));
    }
    const double total = block_sum(acc, dscratch);
    if (threadIdx.x == 0) sums[step] = static_cast<float>(total);
  }
}

}  // namespace

// Returns a cudaError_t; the error word (state[2]) is read by the host.
extern "C" int membench_launch(void* buf, void* sums, void* state,
                               int n_steps, int contentious, int write,
                               int repeats, void* stream) {
  if (n_steps <= 0) return 0;
  membench_kernel<<<n_steps, kLane, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), static_cast<float*>(sums),
      static_cast<int*>(state), contentious, write, repeats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* membench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
