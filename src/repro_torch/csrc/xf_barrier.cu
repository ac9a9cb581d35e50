// One epoch of the Xiao-Feng (XF) flag barrier for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel src/repro/kernels/xf_barrier/kernel.py
// (xf_barrier_pallas, body xf_barrier_kernel). There, participants were
// grid steps run in order on one core, so every present flag was set
// before the master's step and the result never depended on the poll
// budget. Here the participants are threads of one CTA that run at once:
//
//   arrive:  thread t owns participants t, t + T, ... (T = the CTA's
//            threads); each present one release-stores ``epoch`` into its
//            own flag word (single owner: no atomics, as in the paper)
//   master:  the warp that owns participant n - 1 (the TPU's last grid
//            step) first waits, without the budget, until every present
//            flag reads ``epoch``: those participants are in this launch
//            and must arrive, which is the TPU's sequential order. Then
//            it runs the reference's budgeted loop over the required
//            flags: one check, then up to ``max_polls`` re-checks,
//            sleeping between them (__nanosleep: "GPU sleeping").
//   release: after one __syncthreads the CTA writes arrive', release =
//            epoch on the required slots (only if every one arrived),
//            the straggler bitmap, done and the error word, coalesced.
//
// The first wait makes the result independent of timing: a master that
// scanned before a present thread had stored its flag would otherwise
// report done = 0 under a small budget (the former design, one CTA per
// participant, did). The wait carries a 1,000,000-poll guard; on expiry
// the error word is set and the host raises, so a stuck wait is never a
// silent result. The budgeted loop still polls the flags: a required
// participant that is absent is what the barrier with timeout reports.
//
// What bounds it on this card: neither bytes (6 words per participant)
// nor operations, but latency: one launch, one shared-memory store per
// participant, and the master's scans; with a straggler, the budget's
// polls one after another.
//
// What the design does about it: every flag lives in the CTA's shared
// memory (with one byte of present and required bits beside it), so an
// arrival is a shared-memory store and a scan reads shared memory, not
// L2; there is no cooperative launch, so N is not bound by how many
// CTAs the card holds at once. The master polls with relaxed
// block-scope loads and __all_sync, and issues one acquire fence after
// the hit. Its scan is warp-uniform: a cursor
// walks the flags in chunks of kChunk words, each lane checking four of
// them with independent loads, and a chunk whose words all meet the
// condition is never read again (a present flag only ever becomes
// ``epoch``, and ">= epoch" cannot be lost within the epoch), so a
// straggler epoch re-reads one chunk per poll. A first version in which
// each lane walked its own words with a dependent, divergent loop took
// several times longer per word and per poll on an H100. Between polls
// the master sleeps kSleepNs: on an H100, 0 and 32 ns gave the same
// straggler epoch and 100 ns a third more, so the paper's sleeping wait
// costs nothing here. A thread-block cluster holding the flags in
// distributed shared memory (participants on several SMs) was not
// tried: it would lengthen every load of the master's polls, which set
// the straggler epoch's time, and one CTA already holds kSharedN.
//
// Above kSharedN participants (5 bytes each: 160 KiB) the flags are the
// output's arrive' words in global memory and membership is read from
// the input; the schedule, the present-flag wait with its guard and the
// budgeted loop are the same. Every participant and the master are
// threads of this one CTA, so the flag stores and loads stay block
// scope (release and relaxed; the SM's L1 is coherent within the CTA),
// and N is bound only by the buffers' size.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSharedN = 32768;     // 5 bytes each in shared memory: 160 KiB
constexpr int kChunk = 128;         // words one master check reads: 4 a lane
constexpr int kMaxPolls = 1000000;  // guard of the wait for present flags
constexpr unsigned kSleepNs = 32;   // back-off between polls

enum : unsigned char { kPresent = 1, kRequired = 2 };

using BlockInt = cuda::atomic_ref<int, cuda::thread_scope_block>;

// Single-owner flag accesses, block scope, on the shared-memory window.
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// Advance the warp's cursor ``base`` over chunks of kChunk words that all
// meet ``met``; true once it passes n_pad. Warp-uniform: each lane checks
// four words of the chunk with independent loads, __all_sync decides.
template <typename Met>
__device__ bool scan(int& base, int n_pad, Met met) {
  const int lane = threadIdx.x & 31;
  for (; base < n_pad; base += kChunk) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < kChunk / 32; ++j) ok &= met(base + lane + 32 * j);
    if (!__all_sync(0xffffffffu, ok)) return false;
  }
  return true;
}

// in: arrive[n] | present[n] | required[n];
// out: arrive'[n] | release[n] | stragglers[n] | done | error.
// kShared: flags[n_pad] in shared memory, then one mask byte each; the
// padding is neither present nor required. Else the flags are out[0, n)
// (the padding's words are in bounds, never present or required, and
// their values are not used).
template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) xf_barrier_kernel(
    const int* __restrict__ in, int* __restrict__ out, int epoch,
    int max_polls, int n, int n_pad) {
  extern __shared__ int smem[];
  int* const flags = kShared ? smem : out;
  unsigned char* mask = reinterpret_cast<unsigned char*>(smem + n_pad);
  __shared__ int result[2];  // done, error
  const int t = threadIdx.x, threads = blockDim.x;
  const auto is_present = [&](int k) -> bool {
    if constexpr (kShared)
      return mask[k] & kPresent;
    else
      return k < n && in[n + k] > 0;
  };
  const auto is_required = [&](int k) -> bool {
    if constexpr (kShared)
      return mask[k] & kRequired;
    else
      return k < n && in[2 * n + k] > 0;
  };
  const auto load = [&](int k) -> int {
    if constexpr (kShared)
      return load_relaxed(&flags[k]);
    else
      return BlockInt(flags[k]).load(cuda::memory_order_relaxed);
  };
  // the TPU kernel's step-0 copy: flags of absent slots carry over
  if constexpr (kShared) {
    for (int k = t; k < n_pad; k += threads) {
      flags[k] = k < n ? in[k] : 0;
      mask[k] = k < n ? (in[n + k] > 0 ? kPresent : 0) |
                            (in[2 * n + k] > 0 ? kRequired : 0)
                      : 0;
    }
  } else {
    for (int k = t; k < n; k += threads) flags[k] = in[k];
  }
  __syncthreads();
  // ---- arrive: single-owner release store of my own flag words
  for (int k = t; k < n; k += threads) {
    if (!is_present(k)) continue;
    if constexpr (kShared)
      store_release(&flags[k], epoch);
    else
      BlockInt(flags[k]).store(epoch, cuda::memory_order_release);
  }
  // ---- master: the warp that owns participant n - 1
  const int master = n > 0 ? ((n - 1) % threads) >> 5 : 0;
  if ((t >> 5) == master) {
    const auto present_met = [&](int k) {
      const int f = load(k);
      return !is_present(k) | (f == epoch);
    };
    const auto required_met = [&](int k) {
      const int f = load(k);
      return !is_required(k) | (f >= epoch);
    };
    int base = 0, error = 0;
    for (int polls = 0; !scan(base, n_pad, present_met); ++polls) {
      if (polls >= kMaxPolls) {
        error = 1;
        break;
      }
      __nanosleep(kSleepNs);
    }
    bool arrived = false;
    if (!error) {
      base = 0;
      arrived = scan(base, n_pad, required_met);
      for (int polls = 0; !arrived && polls < max_polls; ++polls) {
        __nanosleep(kSleepNs);
        arrived = scan(base, n_pad, required_met);
      }
    }
    cuda::atomic_thread_fence(cuda::memory_order_acquire,
                              cuda::thread_scope_block);
    if ((t & 31) == 0) {
      result[0] = arrived ? 1 : 0;
      result[1] = error;
    }
  }
  __syncthreads();
  const int done = result[0];
  for (int k = t; k < n; k += threads) {
    const int a = flags[k];
    const bool req = is_required(k);
    out[k] = a;
    out[n + k] = (req && done) ? epoch : 0;
    out[2 * n + k] = (req && a < epoch) ? 1 : 0;
  }
  if (t == 0) {
    out[3 * n] = done;
    out[3 * n + 1] = result[1];
  }
}

cudaError_t launch(const int* in, int* out, int epoch, int max_polls, int n,
                   cudaStream_t stream) {
  if (n < 0 || max_polls < 0) return cudaErrorInvalidValue;
  const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
  // one warp at least: with n = 0 it still writes done = 1, no error
  int threads = (n + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  if (n > kSharedN) {
    xf_barrier_kernel<false><<<1, threads, 0, stream>>>(
        in, out, epoch, max_polls, n, n_pad);
    return cudaGetLastError();
  }
  const int smem = 5 * n_pad;
  if (smem > 48 * 1024) {  // above the default only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        xf_barrier_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  xf_barrier_kernel<true><<<1, threads, smem, stream>>>(
      in, out, epoch, max_polls, n, n_pad);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; the error word (out[3n + 1]) is read by the
// host. n >= 0.
extern "C" int xf_barrier_launch(const void* in, void* out, int epoch,
                                 int max_polls, int n, void* stream) {
  return (int)launch(static_cast<const int*>(in), static_cast<int*>(out),
                     epoch, max_polls, n, static_cast<cudaStream_t>(stream));
}

// One whole plan on ``stream``: copy the packed inputs (arrive | present |
// required, 3n words) from pinned host memory, launch, copy the packed
// outputs (3n + 2 words) back into pinned host memory, synchronise.
extern "C" int xf_barrier_plan(const void* host_in, void* dev_in,
                               void* dev_out, void* host_out, int epoch,
                               int max_polls, int n, void* stream_p) {
  const auto stream = static_cast<cudaStream_t>(stream_p);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, 3 * (size_t)n * 4,
                                    cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch(static_cast<const int*>(dev_in), static_cast<int*>(dev_out),
               epoch, max_polls, n, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_out, dev_out, (3 * (size_t)n + 2) * 4,
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(stream);
}

extern "C" const char* xf_barrier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
