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
// and one slot holding that minimum becomes busy until release_i.
//
// The update is order-free. Only the minimum's value reaches an output,
// and replacing any one of several tied minima leaves the same multiset
// of slot times, so neither slot identity nor the reference's tie rule
// (lowest index, as jnp.argmin) matters. The kernel keeps the multiset
// in whatever layout is cheapest; min, max and one __fadd_rn touch the
// values, so every output is bit-identical to the TPU kernel's.
//
// What bounds it on this card: neither bytes (5 words per request) nor
// operations (N x K compares), but the latency of the recurrence, which
// is strictly sequential over the N arrivals.
//
// What the design does about it: one warp, slot times in registers, no
// memory access inside the recurrence. Arrivals and holds are loaded
// coalesced, 32 at a time (the next 32 while these are planned), and
// broadcast per step by __shfl_sync; each lane keeps the outputs of its
// own arrival and stores them coalesced after the 32 steps. Lane l keeps
// slots l, l+32, ... sorted ascending in registers (padded with +inf,
// which is the minimum only when every real slot is +inf too). The warp
// minimum is one __reduce_min_sync on an order-preserving integer key of
// each lane's s[0]; the key decodes back to the exact value; the first
// lane whose key ties (__ballot_sync + __ffs) replaces its s[0] by
// release_i through a fixed insertion network of min/max. With K <= 32
// (the serving engine's K is 4) a lane holds one slot.
//
// Above kRegisterCapacity (1024) slots the rows no longer fit in
// registers. Then lane l owns a contiguous column of ceil(K / 32) slot
// times in a global scratch buffer the caller allocates (K floats), with
// the key and position of its column's minimum in registers. The warp
// step is the same; only the lane that takes release_i touches memory:
// it stores release_i over its minimum and rescans its own column for
// the new one (K / 32 loads, all from lines that lane alone writes, so
// they stay in its SM's L1). No lane reads another's column, so nothing
// needs a fence. The outputs are those of the register path: the
// update is order-free.
//
// The TPU kernel's padding of N and K to 128 lanes was TPU layout and is
// gone; the far-future padding of the planning window
// (semaphore_admission_window) is semantics and stays on the host.
#include <cuda_runtime.h>

namespace {

constexpr int kRegisterCapacity = 1024;  // slot times in registers
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// a < b as floats (no NaN; -0 below +0) iff key(a) < key(b).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// s sorted ascending: drop s[0], insert r, keep s sorted.
template <int S>
__device__ __forceinline__ void insert_sorted(float (&s)[S], float r) {
  if constexpr (S == 1) {
    s[0] = r;
  } else {
    float t[S];
    t[0] = fminf(s[1], r);
#pragma unroll
    for (int k = 1; k < S - 1; ++k) t[k] = fminf(s[k + 1], fmaxf(s[k], r));
    t[S - 1] = fmaxf(s[S - 1], r);
#pragma unroll
    for (int k = 0; k < S; ++k) s[k] = t[k];
  }
}

// Lane l holds slots l + 32 k, k < S (32 S >= K), sorted ascending.
template <int S>
struct RegisterSlots {
  float s[S];
  unsigned key;  // order key of s[0], the lane's minimum

  __device__ RegisterSlots(int lane, int capacity) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      s[k] = lane + 32 * k < capacity ? -kBig : pos_inf();  // free since -inf
    key = order_key(s[0]);
  }

  __device__ void replace_min(float r) {
    insert_sorted(s, r);
    key = order_key(s[0]);
  }
};

// Lane l owns slots [l w, min((l + 1) w, K)) of a global scratch buffer,
// w = ceil(K / 32); ``at`` is where its minimum sits.
struct ColumnSlots {
  float* col;
  int len, at;
  unsigned key;

  __device__ ColumnSlots(float* scratch, int lane, int capacity) {
    const int width = (capacity + 31) / 32;
    const int lo = min(lane * width, capacity);
    col = scratch + lo;
    len = min(lo + width, capacity) - lo;
    for (int i = 0; i < len; ++i) col[i] = -kBig;
    at = 0;
    key = order_key(len > 0 ? -kBig : pos_inf());
  }

  __device__ void replace_min(float r) {
    col[at] = r;
    unsigned best = order_key(col[0]);
    int where = 0;
#pragma unroll 8
    for (int i = 1; i < len; ++i) {
      const unsigned k = order_key(col[i]);
      if (k < best) {
        best = k;
        where = i;
      }
    }
    key = best;
    at = where;
  }
};

template <class Slots>
__device__ __forceinline__ void admit(Slots& slots,
                                      const float* __restrict__ arrive,
                                      const float* __restrict__ hold,
                                      float* __restrict__ grant,
                                      float* __restrict__ release,
                                      int* __restrict__ waited, int n) {
  const int lane = threadIdx.x;
  float a_next = lane < n ? arrive[lane] : 0.f;
  float h_next = lane < n ? hold[lane] : 0.f;
  for (int base = 0; base < n; base += 32) {
    const float a_l = a_next, h_l = h_next;
    const int ahead = base + 32 + lane;
    if (ahead < n) {
      a_next = arrive[ahead];
      h_next = hold[ahead];
    }
    const int steps = min(32, n - base);
    float g_l = 0.f, r_l = 0.f;
    int w_l = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j >= steps) break;  // uniform over the warp
      const float a = __shfl_sync(kFull, a_l, j);
      const float h = __shfl_sync(kFull, h_l, j);
      const unsigned kmin = __reduce_min_sync(kFull, slots.key);
      const float free_t = from_key(kmin);
      const float g = fmaxf(a, free_t);
      const float r = __fadd_rn(g, h);
      if (lane == __ffs(__ballot_sync(kFull, slots.key == kmin)) - 1)
        slots.replace_min(r);
      if (lane == j) {
        g_l = g;
        r_l = r;
        w_l = free_t > a ? 1 : 0;
      }
    }
    if (lane < steps) {
      grant[base + lane] = g_l;
      release[base + lane] = r_l;
      waited[base + lane] = w_l;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(32) semaphore_admission_kernel(
    const float* __restrict__ arrive, const float* __restrict__ hold,
    float* __restrict__ grant, float* __restrict__ release,
    int* __restrict__ waited, int n, int capacity) {
  RegisterSlots<S> slots(threadIdx.x, capacity);
  admit(slots, arrive, hold, grant, release, waited, n);
}

__global__ void __launch_bounds__(32) semaphore_admission_kernel_columns(
    const float* __restrict__ arrive, const float* __restrict__ hold,
    float* __restrict__ grant, float* __restrict__ release,
    int* __restrict__ waited, int n, int capacity, float* scratch) {
  ColumnSlots slots(scratch, threadIdx.x, capacity);
  admit(slots, arrive, hold, grant, release, waited, n);
}

template <int S>
void launch(const float* arrive, const float* hold, float* grant,
            float* release, int* waited, int n, int capacity,
            cudaStream_t stream) {
  semaphore_admission_kernel<S><<<1, 32, 0, stream>>>(
      arrive, hold, grant, release, waited, n, capacity);
}

// The instantiation for ``capacity``: the narrowest power-of-2 slots per
// lane, or the column kernel above kRegisterCapacity (``scratch``: K
// floats on the device).
cudaError_t launch_for(const float* arrive, const float* hold, float* grant,
                       float* release, int* waited, int n, int capacity,
                       float* scratch, cudaStream_t stream) {
  if (capacity < 1) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (capacity > kRegisterCapacity) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    semaphore_admission_kernel_columns<<<1, 32, 0, stream>>>(
        arrive, hold, grant, release, waited, n, capacity, scratch);
    return cudaGetLastError();
  }
  const int per_lane = (capacity + 31) / 32;
  auto* go = per_lane <= 1    ? launch<1>
             : per_lane <= 2  ? launch<2>
             : per_lane <= 4  ? launch<4>
             : per_lane <= 8  ? launch<8>
             : per_lane <= 16 ? launch<16>
                              : launch<32>;
  go(arrive, hold, grant, release, waited, n, capacity, stream);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; capacity >= 1. Above 1024, ``scratch`` holds
// ``capacity`` floats on the device (else it may be null).
extern "C" int semaphore_admission_launch(const void* arrive,
                                          const void* hold, void* grant,
                                          void* release, void* waited,
                                          int n, int capacity,
                                          void* scratch, void* stream) {
  return (int)launch_for(
      static_cast<const float*>(arrive), static_cast<const float*>(hold),
      static_cast<float*>(grant), static_cast<float*>(release),
      static_cast<int*>(waited), n, capacity, static_cast<float*>(scratch),
      static_cast<cudaStream_t>(stream));
}

// One whole plan on ``stream``: copy the packed inputs (arrive | hold,
// 2n words) from pinned host memory, launch, copy the packed outputs
// (grant | release | waited, 3n words) back into pinned host memory,
// synchronise. ``scratch`` as for semaphore_admission_launch.
extern "C" int semaphore_admission_plan(const void* host_in, void* dev_in,
                                        void* dev_out, void* host_out,
                                        int n, int capacity, void* scratch,
                                        void* stream_p) {
  const auto stream = static_cast<cudaStream_t>(stream_p);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, 2 * (size_t)n * 4,
                                    cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const float* in = static_cast<const float*>(dev_in);
  float* out = static_cast<float*>(dev_out);
  err = launch_for(in, in + n, out, out + n,
                   reinterpret_cast<int*>(out + 2 * n), n, capacity,
                   static_cast<float*>(scratch), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_out, dev_out, 3 * (size_t)n * 4,
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(stream);
}

extern "C" const char* semaphore_admission_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
