// Algorithm-5 sleeping-semaphore admission timeline for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/semaphore/kernel.py
// (sleeping_semaphore_pallas, body sleeping_semaphore_kernel): the
// paper's FIFO count/ticket/turn semaphore with K slots is a K-server
// FIFO queue, so for N arrivals sorted ascending
//     grant_i   = max(arrive_i, min over slots of slot-free time)
//     release_i = grant_i + hold_i
//     waited_i  = (min slot-free time > arrive_i)
// and the earliest-free slot (lowest index on a tie, as jnp.argmin)
// becomes busy until release_i. Only max, min and one float add touch
// the values, so the output is bit-identical to the TPU kernel's.
//
// What bounds it on this card: neither bytes (5 words per request) nor
// operations (N x K compares), but latency. The recurrence is strictly
// sequential over the N arrivals, so the kernel is one launch plus N
// dependent warp reductions, and the caller's device-to-host copy of
// the plan is part of every planning call.
//
// What the design does about it: one CTA of one warp. The K slot-free
// times live in shared memory (K <= 1024); each arrival is one
// strided scan per lane and a 5-step shuffle argmin, with no block-wide
// barrier. The TPU kernel's padding of N and K to 128 lanes was TPU
// layout and is gone; the far-future padding of the planning window
// (semaphore_admission_window) is semantics and stays on the host.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCapacity = 1024;
constexpr float kBig = 3.4e38f;

__global__ void __launch_bounds__(32) semaphore_admission_kernel(
    const float* __restrict__ arrive, const float* __restrict__ hold,
    float* __restrict__ grant, float* __restrict__ release,
    int* __restrict__ waited, int n, int capacity) {
  __shared__ float slots[kMaxCapacity];
  const int lane = threadIdx.x;
  // all K slots free since t = -inf
  for (int k = lane; k < capacity; k += 32) slots[k] = -kBig;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    float best = __int_as_float(0x7f800000);  // +inf: loses to any slot
    int idx = INT_MAX;
    for (int k = lane; k < capacity; k += 32) {
      const float s = slots[k];
      if (idx == INT_MAX || s < best) {
        best = s;
        idx = k;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob < best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    const float arr = arrive[i];
    const float g = fmaxf(arr, best);
    const float r = __fadd_rn(g, hold[i]);
    if (lane == 0) {
      slots[idx] = r;
      grant[i] = g;
      release[i] = r;
      waited[i] = best > arr ? 1 : 0;
    }
    __syncwarp();
  }
}

}  // namespace

// Returns cudaGetLastError(); capacity must be in [1, 1024].
extern "C" int semaphore_admission_launch(const void* arrive,
                                          const void* hold, void* grant,
                                          void* release, void* waited,
                                          int n, int capacity,
                                          void* stream) {
  if (capacity < 1 || capacity > kMaxCapacity) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  semaphore_admission_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(arrive), static_cast<const float*>(hold),
      static_cast<float*>(grant), static_cast<float*>(release),
      static_cast<int*>(waited), n, capacity);
  return (int)cudaGetLastError();
}

extern "C" const char* semaphore_admission_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
