// Fused paged-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (fused_paged_decode, body paged_decode_kernel): single-token GQA
// attention over the paged KV arena [num_pages, ps, KV, hd], walking each
// row's block table [B, P] in position order with an fp32 online softmax.
//
// Semantics, held to the TPU kernel and to the plain version beside the
// wrapper (repro_torch/kernels/paged_attention.py):
//   * a table entry >= num_pages is a sentinel page: masked whole;
//   * positions >= len, and below len - window when a window is given,
//     are masked BEFORE the exp, and a masked lane gets p = 0 explicitly
//     (a NEG_INF score alone would leak exp(NEG_INF - NEG_INF) = 1);
//   * a row where every lane is masked has l == 0 and emits exact zeros.
// A page whose lanes are all masked leaves (m, l, acc) unchanged in the
// TPU kernel too, so such pages (sentinels, pages past the length or
// before the window) are skipped outright.
//
// What bounds it on this card: bytes. Each live K/V page is read from
// device memory once and the arithmetic is two length-hd dot products
// per (query head, position), far below the card's ops-per-byte line.
// At decode batch sizes the grid is only B x KV CTAs (32 at B = 4,
// KV = 8, on 132 SMs), so it is launch- and latency-bound long before
// it is bandwidth-bound.
//
// What the design does about it: one CTA per (row, kv head) loads its
// own table row and length; all G query heads of the kv head share each
// page, staged once in shared memory as fp32; scores use one warp per
// (query head, position) pair with a shuffle reduction. No tensor cores,
// no TMA and no split over pages yet: this version is right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,         // [B, KV, G, hd]
    const T* __restrict__ k_arena,   // [num_pages, ps, KV, hd]
    const T* __restrict__ v_arena,   // [num_pages, ps, KV, hd]
    const int* __restrict__ pages,   // [B, P]
    const int* __restrict__ lens,    // [B]
    T* __restrict__ out,             // [B, KV, G, hd]
    int kv_heads, int groups, int head_dim, int num_pages, int page_size,
    int table_width, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = groups, hd = head_dim, ps = page_size;
  float* q_s = smem;             // [G, hd] pre-scaled queries
  float* acc = q_s + G * hd;     // [G, hd] unnormalised output
  float* k_s = acc + G * hd;     // [ps, hd] this page's keys
  float* v_s = k_s + ps * hd;    // [ps, hd] this page's values
  float* p_s = v_s + ps * hd;    // [G, ps] scores, then probabilities
  float* m_s = p_s + G * ps;     // [G] running max
  float* l_s = m_s + G;          // [G] running denominator
  float* a_s = l_s + G;          // [G] this page's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int length = lens[b];
  // live positions are [lo, length); lo may be negative (no clipping
  // needed: positions are never negative)
  const int lo = window >= 0 ? length - window : 0;

  const T* qb = q + ((size_t)b * kv_heads + h) * G * hd;
  for (int e = tid; e < G * hd; e += blockDim.x) {
    q_s[e] = to_float(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int first = lo > 0 ? lo / ps : 0;
  for (int j = first; j < table_width && j * ps < length; ++j) {
    const int page = pages[(size_t)b * table_width + j];
    if (page < 0 || page >= num_pages) continue;  // sentinel: whole page masked
    const size_t base = (size_t)page * ps;
    for (int e = tid; e < ps * hd; e += blockDim.x) {
      const int t = e / hd;
      const int d = e - t * hd;
      const size_t off = ((base + t) * kv_heads + h) * hd + d;
      k_s[e] = to_float(k_arena[off]);
      v_s[e] = to_float(v_arena[off]);
    }
    __syncthreads();

    for (int pr = warp; pr < G * ps; pr += n_warps) {
      const int g = pr / ps;
      const int t = pr - g * ps;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += q_s[g * hd + d] * k_s[t * hd + d];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const int pos = j * ps + t;
        p_s[pr] = (pos < length && pos >= lo) ? s : kNegInf;
      }
    }
    __syncthreads();

    for (int g = tid; g < G; g += blockDim.x) {
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, p_s[g * ps + t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const int pos = j * ps + t;
        const bool ok = pos < length && pos >= lo;
        const float p = ok ? expf(p_s[g * ps + t] - m_new) : 0.f;
        p_s[g * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      a_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += blockDim.x) {
      const int g = e / hd;
      const int d = e - g * hd;
      float a = acc[e] * a_s[g];
      for (int t = 0; t < ps; ++t) a += p_s[g * ps + t] * v_s[t * hd + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * kv_heads + h) * G * hd;
  for (int e = tid; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    store(ob + e, acc[e] / fmaxf(l_s[g], 1e-37f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pages,
           const void* lens, void* out, int batch, int kv_heads, int groups,
           int head_dim, int num_pages, int page_size, int table_width,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)groups * head_dim +
                       2 * (size_t)page_size * head_dim +
                       (size_t)groups * page_size + 3 * (size_t)groups);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(batch, kv_heads);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pages),
      static_cast<const int*>(lens), static_cast<T*>(out), kv_heads, groups,
      head_dim, num_pages, page_size, table_width, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both arenas and out share it).
// window < 0 means no sliding window. Returns cudaGetLastError().
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pages,
                                   const void* lens, void* out, int batch,
                                   int kv_heads, int groups, int head_dim,
                                   int num_pages, int page_size,
                                   int table_width, int window, float scale,
                                   int dtype, void* stream) {
  if (batch == 0 || kv_heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, pages, lens, out, batch, kv_heads, groups,
                         head_dim, num_pages, page_size, table_width, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, pages, lens, out, batch, kv_heads,
                                 groups, head_dim, num_pages, page_size,
                                 table_width, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
