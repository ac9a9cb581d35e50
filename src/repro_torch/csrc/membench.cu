// The paper's Section-3 memory benchmark cells for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel src/repro/kernels/membench/kernel.py
// (membench_pallas, body membench_kernel): the cells {contentious,
// noncontentious} x {read, write} over 512-byte rows of 128 floats.
// Step i runs 128 threads, one float lane each; it hammers row 0
// (contentious) or its own row i (noncontentious) ``repeats`` times:
//
//   write: store (it + i + 1) for it in [0, repeats); the row ends at
//          repeats + i; checksum = sum of the row read back after the loop
//   read:  load the row ``repeats`` times; checksum = sum of every load
//
// Every access reaches memory, so the time measures the accesses. The
// loads are relaxed device-scope atomic_ref loads (ld.relaxed.gpu), each
// of which the compiled loop keeps. The stores are st.volatile, which the
// PTX memory model treats as relaxed at system scope (stronger than the
// cell's device scope) and which ptxas never merges: relaxed stores,
// as atomic_ref stores and as inline st.relaxed.gpu alike, were merged
// four to one (a store loop unrolled four times kept one store per
// unrolled iteration, so the write cells made a quarter of their
// stores), which the memory model allows, since no thread can tell the
// merged stores apart. Read checksums accumulate each lane's loads in
// double (exact for any repeats below 2^29) and round once to float, so
// they agree with the plain repeats * row_sum to float32 rounding.
//
// The read cells and the noncontentious write cell are order-free: one
// CTA per step, all steps at once. The contentious write cell is not:
// its result (row 0 ends at repeats + n_steps - 1, step i's checksum is
// 128 * (repeats + i)) is defined by the TPU's sequential grid on one
// core. So that cell is one CTA of 128 threads that runs the steps in
// order, as that core did: per step every lane makes its ``repeats``
// stores to row 0, reads its word back, the CTA sums the row into
// sums[step], and a __syncthreads closes the step. What it measures is
// serialized single-CTA stores to one line, with no hand-off between
// CTAs: no step counter, turn word or poll, so nothing can get stuck.
// The paper's concurrent contended write, every CTA storing to one line
// at once, is a different cell; the port does not run it.
//
// What bounds it on this card: the function moves only the buffer in and
// out once, so the bound is tiny; what the cells measure is the latency
// and throughput of repeated accesses to one line (contentious) or to
// distinct lines (noncontentious): 512 bytes per access step of a CTA.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;

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

// One store that reaches memory as written: never merged with the next.
__device__ __forceinline__ void store_volatile(float* p, float v) {
  asm volatile("st.volatile.global.f32 [%0], %1;" ::"l"(
                   __cvta_generic_to_global(p)), "f"(v)
               : "memory");
}

// One write step: ``repeats`` stores of (it + step + 1) to this lane's
// word, then the row read back and summed.
__device__ float write_step(float* word, int step, int repeats,
                            float* scratch) {
  for (int it = 0; it < repeats; ++it) {
    store_volatile(word, static_cast<float>(it + step + 1));
  }
  return block_sum(DeviceFloat(*word).load(cuda::memory_order_relaxed),
                   scratch);
}

// One CTA per step: the read cells and the noncontentious write cell.
__global__ void __launch_bounds__(kLane) membench_kernel(
    float* buf, float* __restrict__ sums, int contentious, int write,
    int repeats) {
  __shared__ double dscratch[kLane / 32];
  __shared__ float fscratch[kLane / 32];
  const int step = blockIdx.x;
  const int row = contentious ? 0 : step;
  float* word = &buf[row * kLane + threadIdx.x];
  if (write) {
    const float total = write_step(word, step, repeats, fscratch);
    if (threadIdx.x == 0) sums[step] = total;
  } else {
    const DeviceFloat cell(*word);
    double acc = 0.0;
    for (int it = 0; it < repeats; ++it) {
      acc += static_cast<double>(cell.load(cuda::memory_order_relaxed));
    }
    const double total = block_sum(acc, dscratch);
    if (threadIdx.x == 0) sums[step] = static_cast<float>(total);
  }
}

// The contentious write cell: one CTA runs every step in order.
__global__ void __launch_bounds__(kLane) membench_serial_kernel(
    float* buf, float* __restrict__ sums, int n_steps, int repeats) {
  __shared__ float fscratch[kLane / 32];
  for (int step = 0; step < n_steps; ++step) {
    const float total =
        write_step(&buf[threadIdx.x], step, repeats, fscratch);
    if (threadIdx.x == 0) sums[step] = total;
    __syncthreads();  // the step ends; the next reuses the scratch
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int membench_launch(void* buf, void* sums, int n_steps,
                               int contentious, int write, int repeats,
                               void* stream) {
  if (n_steps <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(buf);
  float* out = static_cast<float*>(sums);
  if (contentious && write) {
    membench_serial_kernel<<<1, kLane, 0, s>>>(b, out, n_steps, repeats);
  } else {
    membench_kernel<<<n_steps, kLane, 0, s>>>(b, out, contentious, write,
                                             repeats);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* membench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
