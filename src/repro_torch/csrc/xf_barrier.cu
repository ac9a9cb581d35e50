// One epoch of the Xiao-Feng (XF) flag barrier for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel src/repro/kernels/xf_barrier/kernel.py
// (xf_barrier_pallas, body xf_barrier_kernel). There, participants were
// grid steps run in order on one core and the master's poll found every
// flag already set. Here each participant is a CTA and they run at once:
//
//   arrive:  a present CTA release-stores ``epoch`` into its own flag
//            word (single owner: no atomics anywhere, as in the paper)
//   master:  the last CTA (the TPU's last grid step) checks the required
//            flags, then re-checks up to ``max_polls`` times, sleeping
//            between polls (__nanosleep: "GPU sleeping"); it writes
//            done, the straggler bitmap, and release = epoch on the
//            required slots only when every one arrived.
//
// The caller copies arrive' = arrive before the launch (the TPU kernel's
// step-0 copy), so the master never reads an unwritten word of a slot
// that is not present this epoch, and zeroes release and stragglers.
// The master polls with relaxed loads, which do not serialise one after
// another as acquire loads would, and issues one acquire fence once it
// has seen every flag.
//
// What bounds it on this card: neither bytes (6 words per participant)
// nor operations, but latency: one launch, one store per CTA, and the
// master's polls. The CTAs must be co-resident, or a participant that is
// never scheduled could not arrive; the launch is cooperative, so a grid
// that cannot be co-resident is refused (cudaErrorCooperativeLaunchTooLarge)
// instead of timing out. The poll budget is a barrier with timeout: each
// poll sleeps kSleepNs, so the default 1024 polls give the master about a
// millisecond, far beyond the few microseconds over which the CTAs of one
// launch start.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kSleepNs = 1000;

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

// 1 on every lane iff all required flags have reached ``epoch``.
__device__ bool all_arrived(int* arrive, const int* required, int epoch,
                            int n) {
  bool ok = true;
  for (int k = threadIdx.x; k < n; k += 32) {
    if (required[k] > 0 &&
        DeviceInt(arrive[k]).load(cuda::memory_order_relaxed) < epoch) {
      ok = false;
    }
  }
  return __all_sync(0xffffffffu, ok);
}

__global__ void __launch_bounds__(32) xf_barrier_kernel(
    int* arrive, const int* __restrict__ present,
    const int* __restrict__ required, int* __restrict__ release,
    int* __restrict__ stragglers, int* __restrict__ done, int epoch,
    int max_polls, int n) {
  const int i = blockIdx.x;
  // ---- arrive: single-owner write of my own flag word
  if (threadIdx.x == 0 && present[i] > 0) {
    DeviceInt(arrive[i]).store(epoch, cuda::memory_order_release);
  }
  if (i != n - 1) return;
  // ---- master: scan the required flags with a poll budget
  bool arrived = all_arrived(arrive, required, epoch, n);
  for (int polls = 0; !arrived && polls < max_polls; ++polls) {
    __nanosleep(kSleepNs);
    arrived = all_arrived(arrive, required, epoch, n);
  }
  cuda::atomic_thread_fence(cuda::memory_order_acquire,
                            cuda::thread_scope_device);
  for (int k = threadIdx.x; k < n; k += 32) {
    const bool req = required[k] > 0;
    const int a = DeviceInt(arrive[k]).load(cuda::memory_order_relaxed);
    stragglers[k] = (req && a < epoch) ? 1 : 0;
    // broadcast release flags only on success (unique slot per lane)
    if (req && arrived) release[k] = epoch;
  }
  if (threadIdx.x == 0) *done = arrived ? 1 : 0;
}

}  // namespace

// Returns a cudaError_t.
extern "C" int xf_barrier_launch(void* arrive, const void* present,
                                 const void* required, void* release,
                                 void* stragglers, void* done, int epoch,
                                 int max_polls, int n, void* stream) {
  if (n <= 0) return 0;
  int* arrive_p = static_cast<int*>(arrive);
  const int* present_p = static_cast<const int*>(present);
  const int* required_p = static_cast<const int*>(required);
  int* release_p = static_cast<int*>(release);
  int* stragglers_p = static_cast<int*>(stragglers);
  int* done_p = static_cast<int*>(done);
  void* args[] = {&arrive_p, &present_p, &required_p, &release_p,
                  &stragglers_p, &done_p, &epoch, &max_polls, &n};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)xf_barrier_kernel, dim3(n), dim3(32), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises with this code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xf_barrier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
