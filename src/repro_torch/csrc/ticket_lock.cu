// Algorithm-3 fetch-and-add (ticket) mutex for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/ticket_lock/kernel.py
// (ticket_lock_pallas, body ticket_lock_kernel). There, grid steps ran in
// order on one core, so a read-modify-write of a scratch word stood in
// for the fetch-and-add and the turn poll exited on its first check. Here
// the concurrency is real: N requesters are N CTAs that run at once and
// contend for the lock through device memory.
//
//   lock():   my = atomicAdd(&ticket, 1)           (one global atomic)
//             poll turn with acquire loads until turn == my, sleeping
//             between polls (__nanosleep: the paper's "GPU sleeping")
//   critical: grant[my] = arrival[j], trace[my] = observed turn,
//             acc = acc * m[my] + b[my]           (order-sensitive chain)
//   unlock(): turn = my + 1                        (release store, no atomic)
//
// Ticket order follows ``arrival``: CTA j first waits for an arrival-gate
// word to reach j, takes its ticket, then bumps the gate. The contention
// on the turn word stays real (every later requester polls it while the
// holder runs), but the timeline is the one the reference computes.
// m, b are positional (entry t belongs to the t-th ticket), as on the TPU.
// The chain uses __fmul_rn / __fadd_rn so nvcc cannot contract it into an
// FMA: it is then bit-equal to the plain float32 fold.
//
// What bounds it on this card: neither bytes (5 words per requester) nor
// operations, but latency. N gate hand-offs and N turn hand-offs, each an
// L2 round trip plus a sleep, run one after another by construction; the
// N CTAs must be co-resident or a waiter could block the CTA it waits
// for from ever being scheduled. The launch is cooperative so a grid too
// large to be co-resident is refused (cudaErrorCooperativeLaunchTooLarge)
// instead of hanging. Every wait has the reference's 1,000,000-poll
// budget; on expiry the CTA sets an error word, every other waiter sees
// it and leaves, and the host raises.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPolls = 1000000;
constexpr unsigned kSleepNs = 32;

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;
using DeviceFloat = cuda::atomic_ref<float, cuda::thread_scope_device>;

// Poll ``word`` until it equals ``want``. False when the budget ran out
// or another CTA already reported an error.
__device__ bool wait_for(DeviceInt word, int want, DeviceInt error,
                         int* seen) {
  for (int polls = 0;; ++polls) {
    const int v = word.load(cuda::memory_order_acquire);
    if (v == want) {
      *seen = v;
      return true;
    }
    if (polls >= kMaxPolls || error.load(cuda::memory_order_relaxed)) {
      error.store(1, cuda::memory_order_relaxed);
      return false;
    }
    __nanosleep(kSleepNs);
  }
}

// state: [gate, ticket, turn, error], zeroed by the caller.
__global__ void __launch_bounds__(32) ticket_lock_kernel(
    const int* __restrict__ arrival, const float* __restrict__ m,
    const float* __restrict__ b, int* __restrict__ grant,
    int* __restrict__ trace, float* __restrict__ acc, int* state) {
  if (threadIdx.x != 0) return;
  const int j = blockIdx.x;
  DeviceInt gate(state[0]), ticket(state[1]), turn(state[2]),
      error(state[3]);
  int seen;
  if (!wait_for(gate, j, error, &seen)) return;
  const int my = ticket.fetch_add(1, cuda::memory_order_relaxed);
  gate.store(j + 1, cuda::memory_order_release);
  if (!wait_for(turn, my, error, &seen)) return;
  // ---- critical section (ordered after the previous holder's by the
  // acquire above and its release below)
  grant[my] = arrival[j];
  trace[my] = seen;
  DeviceFloat chain(*acc);
  const float a = chain.load(cuda::memory_order_relaxed);
  chain.store(__fadd_rn(__fmul_rn(a, m[my]), b[my]),
              cuda::memory_order_relaxed);
  // ---- unlock: plain release store of the next turn
  turn.store(my + 1, cuda::memory_order_release);
}

}  // namespace

// Returns a cudaError_t; the error word (state[3]) is read by the host.
extern "C" int ticket_lock_launch(const void* arrival, const void* m,
                                  const void* b, void* grant, void* trace,
                                  void* acc, void* state, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int* arrival_p = static_cast<const int*>(arrival);
  const float* m_p = static_cast<const float*>(m);
  const float* b_p = static_cast<const float*>(b);
  int* grant_p = static_cast<int*>(grant);
  int* trace_p = static_cast<int*>(trace);
  float* acc_p = static_cast<float*>(acc);
  int* state_p = static_cast<int*>(state);
  void* args[] = {&arrival_p, &m_p, &b_p, &grant_p, &trace_p, &acc_p,
                  &state_p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)ticket_lock_kernel, dim3(n), dim3(32),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ticket_lock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
