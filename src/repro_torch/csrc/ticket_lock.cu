// Algorithm-3 fetch-and-add (ticket) mutex for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/ticket_lock/kernel.py
// (ticket_lock_pallas, body ticket_lock_kernel). There, grid steps ran in
// order on one core, so a read-modify-write of a scratch word stood in
// for the fetch-and-add and the turn poll exited on its first check. Here
// the concurrency is real: the requesters are threads of one CTA that
// run at once and contend for the lock.
//
//   lock():   my = ticket.fetch_add(1)             (one atomic)
//             poll turn with acquire loads until turn == my, sleeping
//             between polls (__nanosleep: the paper's "GPU sleeping")
//   critical: grant[my] = arrival[j], trace[my] = observed turn,
//             acc = acc * m[my] + b[my]           (order-sensitive chain)
//   unlock(): turn = my + 1                        (release store, no atomic)
//
// Ticket order follows ``arrival``: requester j first waits for an
// arrival-gate word to reach j, takes its ticket, then bumps the gate.
// The contention on the turn word stays real (every requester that holds
// a ticket polls it while the holder runs), but the timeline is the one
// the reference computes. m, b are positional (entry t belongs to the
// t-th ticket), as on the TPU. The chain uses __fmul_rn / __fadd_rn so
// nvcc cannot contract it into an FMA: it is then bit-equal to the plain
// float32 fold.
//
// What bounds it on this card: neither bytes (5 words per requester) nor
// operations, but latency: the N turn hand-offs run one after another by
// construction, and the gate's N hand-offs run beside them.
//
// What the design does about it: the words live where every waiter can
// reach them fastest. The requesters are threads of one CTA; gate,
// ticket, turn, error and acc sit in that CTA's shared memory and every
// atomic is block-scope, so a hand-off is a shared-memory store seen by
// a shared-memory load instead of an L2 round trip (the former design,
// one requester per CTA under a cooperative launch, took ~1.06 us per
// requester). The requesters are lane 0 of each of up to 32 warps: slot
// s = warp owns requesters s, s + 32, s + 64, ... and serves them in
// order. That cannot deadlock: gate, tickets and turns all advance in
// arrival order, so when the gate reaches s + 32, requester s already
// holds an earlier ticket. No warp-collective sits in a poll loop.
//
// One requester per warp was chosen over every thread a requester (up
// to 1024), measured on an H100 (700 W, profiler kernel time, no
// back-off): 11.8 us against 16.6 us at N 64, 174 us against 269 us at
// N 1024. Waiters that share a warp with the holder only make progress
// as independent thread scheduling interleaves the diverged paths, so
// each hand-off inside a warp costs more than one between warps; a
// cluster spreading the words over distributed shared memory would add
// latency to every hand-off and was not needed. What remains, ~170 ns
// per requester, is the two chains of shared-memory hand-offs (the
// gate's atomic and release store; the turn's poll, the chain's load
// and the release store). Waiters back off in proportion to their place
// in line (kSleepNs per place, the next in line spins): 32 ns cost under
// 1 % against pure spinning (0 and 100 ns were measured too) and keeps
// far waiters off the holder's scheduler. The kernel initialises its own words, stages
// grant and trace in shared memory and stores them coalesced after one
// __syncthreads, with the chain's bits and the error word behind them
// in the same int32 output. Above kStagedN requesters (128 KiB of
// staging) the holder stores grant and trace straight into the output
// in global memory instead; the hand-off words stay in shared memory,
// so only the two stores of each critical section move, and N is bound
// only by the output's size. Every wait keeps the reference's
// 1,000,000-poll budget; on expiry the requester sets the error word,
// every other waiter sees it and leaves, and the host raises.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPolls = 1000000;
constexpr int kMaxWarps = 32;       // requester slots: lane 0 of each warp
constexpr unsigned kSleepNs = 32;   // back-off per place in line
constexpr int kStagedN = 16384;  // grant + trace staged: 128 KiB of shared memory

using BlockInt = cuda::atomic_ref<int, cuda::thread_scope_block>;
using BlockFloat = cuda::atomic_ref<float, cuda::thread_scope_block>;

// Poll ``word`` until it equals ``want``. False when the budget ran out
// or another requester reported an error (read every 64 polls). The
// poll is relaxed and one acquire fence follows the hit. Back-off is
// proportional: the next in line spins, a waiter d places behind sleeps
// about (d - 1) kSleepNs between polls (d capped at 32), so the holder's
// scheduler is not flooded by waiters far from their turn.
__device__ bool wait_for(BlockInt word, int want, BlockInt error) {
  for (int polls = 0;; ++polls) {
    const int seen = word.load(cuda::memory_order_relaxed);
    if (seen == want) {
      cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                cuda::thread_scope_block);
      return true;
    }
    if (polls >= kMaxPolls ||
        ((polls & 63) == 63 && error.load(cuda::memory_order_relaxed))) {
      error.store(1, cuda::memory_order_relaxed);
      return false;
    }
    const int behind = want - seen - 1;
    if (behind > 0)
      __nanosleep(kSleepNs * (unsigned)(behind < 32 ? behind : 32));
  }
}

// out: grant[n], trace[n], acc bits, error word. kStaged: grant and
// trace are staged in shared memory and copied out at the end; else they
// are written to ``out`` in place.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32) ticket_lock_kernel(
    const int* __restrict__ arrival, const float* __restrict__ m,
    const float* __restrict__ b, int* __restrict__ out, int n) {
  extern __shared__ int staged[];  // grant[n], trace[n]
  __shared__ int words[4];         // gate, ticket, turn, error
  __shared__ float acc_word;
  int* const rec = kStaged ? staged : out;
  const int t = threadIdx.x;
  if (t < 4) words[t] = 0;
  if (t == 0) acc_word = 0.f;
  for (int i = t; i < 2 * n; i += blockDim.x) rec[i] = -1;
  __syncthreads();
  BlockInt gate(words[0]), ticket(words[1]), turn(words[2]), error(words[3]);
  BlockFloat chain(acc_word);
  const int slots = blockDim.x >> 5;
  if ((t & 31) == 0) {
    for (int j = t >> 5; j < n; j += slots) {
      if (!wait_for(gate, j, error)) break;
      const int my = ticket.fetch_add(1, cuda::memory_order_relaxed);
      gate.store(j + 1, cuda::memory_order_release);
      // independent of the lock: loaded while waiting for the turn
      const int rid = arrival[j];
      const float mm = m[my], bb = b[my];
      if (!wait_for(turn, my, error)) break;
      // ---- critical section (ordered after the previous holder's by the
      // acquire fence in wait_for and its release below)
      rec[my] = rid;
      rec[n + my] = my;  // the turn the poll observed
      const float a = chain.load(cuda::memory_order_relaxed);
      chain.store(__fadd_rn(__fmul_rn(a, mm), bb),
                  cuda::memory_order_relaxed);
      // ---- unlock: plain release store of the next turn
      turn.store(my + 1, cuda::memory_order_release);
    }
  }
  __syncthreads();
  if (kStaged)
    for (int i = t; i < 2 * n; i += blockDim.x) out[i] = staged[i];
  if (t == 0) {
    out[2 * n] = __float_as_int(acc_word);
    out[2 * n + 1] = words[3];
  }
}

cudaError_t launch(const int* arrival, const float* m, const float* b,
                   int* out, int n, cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  // one warp at least: with n = 0 it still writes acc = 0 and no error
  const int warps = n < 1 ? 1 : n > kMaxWarps ? kMaxWarps : n;
  if (n > kStagedN) {
    ticket_lock_kernel<false><<<1, warps * 32, 0, stream>>>(arrival, m, b,
                                                             out, n);
    return cudaGetLastError();
  }
  const int smem = 2 * n * (int)sizeof(int);
  if (smem > 48 * 1024) {  // above the default only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        ticket_lock_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ticket_lock_kernel<true><<<1, warps * 32, smem, stream>>>(arrival, m, b,
                                                           out, n);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; the error word (out[2n + 1]) is read by the
// host. n >= 0.
extern "C" int ticket_lock_launch(const void* arrival, const void* m,
                                  const void* b, void* out, int n,
                                  void* stream) {
  return (int)launch(static_cast<const int*>(arrival),
                     static_cast<const float*>(m),
                     static_cast<const float*>(b), static_cast<int*>(out), n,
                     static_cast<cudaStream_t>(stream));
}

// One whole plan on ``stream``: copy the packed inputs (arrival | m bits
// | b bits, 3n words) from pinned host memory, launch, copy the packed
// outputs (2n + 2 words) back into pinned host memory, synchronise.
extern "C" int ticket_lock_plan(const void* host_in, void* dev_in,
                                void* dev_out, void* host_out, int n,
                                void* stream_p) {
  const auto stream = static_cast<cudaStream_t>(stream_p);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, 3 * (size_t)n * 4,
                                    cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const int* in = static_cast<const int*>(dev_in);
  err = launch(in, reinterpret_cast<const float*>(in + n),
               reinterpret_cast<const float*>(in + 2 * n),
               static_cast<int*>(dev_out), n, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_out, dev_out, (2 * (size_t)n + 2) * 4,
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(stream);
}

extern "C" const char* ticket_lock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
