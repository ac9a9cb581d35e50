// Fused paged-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (fused_paged_decode, body paged_decode_kernel): single-token GQA
// attention over the paged KV arena [num_pages, ps, KV, hd] through a
// [B, P] block table, with an fp32 online softmax.
//
// Semantics, held to the TPU kernel and to the plain version beside the
// wrapper (repro_torch/kernels/paged_attention.py):
//   * only a table entry >= num_pages is a sentinel page, masked whole; a
//     negative entry is clipped to page 0 and read as live, as the TPU
//     kernel's clip does;
//   * positions >= len, and below len - window when a window is given,
//     are masked BEFORE the exp, and a masked lane gets p = 0 explicitly
//     (a NEG_INF score alone would leak exp(NEG_INF - NEG_INF) = 1);
//   * a row where every lane is masked has l == 0 and emits exact zeros;
//   * scores, softmax and both products accumulate in fp32.
//
// What bounds it on this card: bytes, and at decode batch sizes latency.
// Each live K/V row is read once and costs two length-hd products per
// query head, far below the card's ops-per-byte line. With one CTA per
// (row, kv head) walking its pages in order, a decode batch gives 32 CTAs
// on 132 SMs and a chain of dependent page loads: latency-bound, not
// bandwidth-bound.
//
// What the design does about it:
//   * split over pages (flash-decoding): grid (KV, splits, B). Each CTA
//     takes a contiguous range of table entries of one (row, kv head);
//     the wrapper picks the split from the table width, B, KV and the SM
//     count without reading the lengths, aiming at about two CTAs per SM.
//     A CTA whose range holds no live position writes an empty partial.
//   * a ring of page stages per warp filled by 16-byte cp.async: each of
//     the 4 warps walks its own tiles of 16 positions (tile w, w + 4, ...)
//     and keeps the next tiles in flight while it scores the current one.
//     K/V stay in shared memory in the arena's dtype; a row's address
//     costs one divide per row, not per element.
//   * bf16 (the serving path) on the tensor cores: mma.sync m16n8k16 with
//     the G <= 8 query heads as the rows of A (rows 8-15 zero), K and V
//     through ldmatrix from an XOR-swizzled ring. The softmax works on the
//     accumulator fragments: two shuffles per max and per sum for all
//     heads at once. P enters PV as bf16 hi + lo halves (16 bits of p,
//     fp32 accumulation). wgmma needs 64-row tiles: 92 % padding at G = 5.
//     Only rows 0-7 of each accumulator are kept in registers: rows 8-15
//     are zero in and dropped out of every mma, so hd 256 holds 64
//     accumulator floats a thread, not 128.
//   * the ring's depth follows the tile: 3 stages while a stage (K + V of
//     16 positions) is at most 8 KB, 2 up to 16 KB, else 1 (no overlap).
//     bf16 hd 256 runs 2 stages of 16 KB a warp, 128 KB a CTA: one CTA per
//     SM, which the wrapper's split plan counts with; fp32 hd 256 runs one
//     stage of 32 KB a warp, also 128 KB.
//   * fp32 on the FMA pipes: scores with a shuffle sum across the lanes
//     of a position, one shuffle tree per query head for the softmax, PV
//     with the lanes across hd.
//   * a deterministic last-arriver combine: each CTA merges its 4 warps
//     in a fixed order and writes (m, l, acc[G, hd]) to a workspace; then
//     one __threadfence and one atomicInc on a per-(row, kv head) counter.
//     The CTA that arrives last merges every split by log-sum-exp in split
//     order, so two launches give bit-equal outputs. atomicInc wraps the
//     counter back to 0 in that same operation, so the counter buffer is
//     zeroed once and reused; no CTA ever spins.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;              // positions per warp tile

template <typename T, int HD, int GM>
struct Cfg {
  static constexpr int EL = sizeof(T);
  static constexpr int VE = 16 / EL;            // elements per 16-B chunk
  static constexpr int CH = HD / VE;            // chunks per row
  static constexpr int QE = 8;                  // q elements per lane (QK)
  static constexpr int LP = HD / QE;            // lanes per position (QK)
  static constexpr int CPL = QE / VE;           // chunks per lane (QK)
  static constexpr int RPP = 32 / LP;           // positions per QK pass
  static constexpr int NPASS = (kTile + RPP - 1) / RPP;
  static constexpr int PE = HD >= 32 ? HD / 32 : 1;  // d per lane (PV)
  static constexpr int LPR = HD / PE;           // lanes per row (PV)
  static constexpr int RPI = 32 / LPR;          // rows per PV step
  static constexpr int TILE_BYTES = kTile * HD * EL;   // K or V of a tile
  static constexpr int NS =                                 // ring depth
      2 * TILE_BYTES <= 8192 ? 3 : 2 * TILE_BYTES <= 16384 ? 2 : 1;
  static constexpr int RING = kWarps * NS * 2 * TILE_BYTES;
  static constexpr int SCORES = kWarps * 2 * kTile * GM * 4;
  static constexpr int WARP_PARTS = kWarps * (GM * HD + 2 * GM) * 4;
  static_assert(HD % QE == 0 && QE % VE == 0 && CH % LP == 0, "hd layout");
  static_assert(RPI <= kTile && kTile % RPI == 0, "PV layout");
  // bf16 runs on the tensor cores (mma.sync m16n8k16), fp32 on the FMA
  // pipes. The mma path reads 8 x 16-byte rows at once (ldmatrix), so it
  // stores chunk c of row r at c ^ f(r): the 8 rows of one read then hit 8
  // different bank groups.
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int SWZ = CH < 8 ? CH : 8;
  static __device__ __forceinline__ int phys_chunk(int r, int c) {
    if constexpr (MMA) return c ^ ((r / (8 / SWZ)) & (SWZ - 1));
    return c;
  }
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

template <typename T, int HD, int GM>
__host__ __device__ inline int region_bytes(int splits) {
  using C = Cfg<T, HD, GM>;
  int r = C::RING > C::WARP_PARTS ? C::RING : C::WARP_PARTS;
  int comb = splits * GM * 2 * 4;
  return r > comb ? r : comb;
}

template <typename T, int HD, int GM>
__host__ __device__ inline int smem_bytes(int pps, int splits) {
  return round16(pps * 4) + Cfg<T, HD, GM>::SCORES +
         region_bytes<T, HD, GM>(splits);
}

// n elements of T at p (n * sizeof(T) in {2, 4, 8, 16} bytes, aligned to
// that size, or a multiple of 16 bytes aligned to 16), widened to fp32. A
// bf16 is the high half of an fp32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&o)[N]) {
  constexpr int B = N * int(sizeof(T));
  if constexpr (B > 16) {
    constexpr int H = 16 / int(sizeof(T));
#pragma unroll
    for (int c = 0; c < N / H; ++c) {
      float t[H];
      load_f32<T, H>(p + c * H, t);
#pragma unroll
      for (int i = 0; i < H; ++i) o[c * H + i] = t[i];
    }
  } else {
    unsigned u[4];
    constexpr int W = B >= 4 ? B / 4 : 1;
    if constexpr (B == 16) {
      uint4 w = *reinterpret_cast<const uint4*>(p);
      u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
    } else if constexpr (B == 8) {
      uint2 w = *reinterpret_cast<const uint2*>(p);
      u[0] = w.x; u[1] = w.y;
    } else if constexpr (B == 4) {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < W; ++i) o[i] = __uint_as_float(u[i]);
    } else if constexpr (B == 2) {
      o[0] = __uint_as_float(u[0] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        o[2 * i] = __uint_as_float(u[i] << 16);
        o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of position pos's row for kv head h, or -1 when the
// position is past the CTA's live range or on a sentinel page. tab holds
// the CTA's table entries from entry j_base on, already clipped.
__device__ __forceinline__ long long row_offset(int pos, int pos_hi,
                                                const int* tab, int j_base,
                                                int ps, int kv_heads, int h,
                                                int hd) {
  if (pos >= pos_hi) return -1;
  const int j = pos / ps;
  const int page = tab[j - j_base];
  if (page < 0) return -1;
  return (((long long)page * ps + (pos - j * ps)) * kv_heads + h) * hd;
}

// Bit r set when row r of the tile starting at `start` is live (inside
// the CTA's range and on a page that is not a sentinel). Warp-uniform.
__device__ __forceinline__ unsigned valid_rows(int start, int pos_hi,
                                               const int* tab, int j_base,
                                               int ps, int lane) {
  const int pos = start + lane;
  bool ok = lane < kTile && pos < pos_hi;
  if (ok) ok = tab[pos / ps - j_base] >= 0;
  return __ballot_sync(0xffffffffu, ok);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p,
                                            bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a * b for one m16n8k16 bf16 tile with fp32 accumulation, rows 0-7
// of d only: the a rows 8-15 (registers 1 and 3) are zero here, so rows
// 8-15 of d go in as zeros and come out as zeros, into scratch that dies.
__device__ __forceinline__ void mma_bf16(float (&d)[2], unsigned a0,
                                         unsigned a2, unsigned b0,
                                         unsigned b1) {
  float z2, z3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(z2), "=f"(z3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// One 16-position tile on the tensor cores (bf16). Lane t holds query
// head g = t / 4 (heads >= G have zero queries and are never stored):
// scores S[g][p] for p = 2(t % 4) + {0, 1} and 8 + 2(t % 4) + {0, 1},
// and acc[j] = O[g][8j + 2(t % 4) + {0, 1}]. The softmax needs two
// shuffles per reduction for
// all heads at once. P enters PV as bf16 hi + lo halves, so the product
// keeps 16 bits of p, not 8.
template <int HD>
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs,
                                         const unsigned (&qa)[HD / 16][2],
                                         float (&acc)[HD / 8][2], float& m,
                                         float& l, int lane, unsigned valid,
                                         float scale) {
  using C = Cfg<__nv_bfloat16, HD, 8>;
  const int mat = lane >> 3, mr = lane & 7;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  {
    // matrix mat: positions 8 (mat / 2) + mr, chunk 2 kk + mat % 2
    const int r = (mat >> 1) * 8 + mr;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, ks + r * HD + C::phys_chunk(r, 2 * kk + (mat & 1)) * 8,
                  false);
      mma_bf16(s[0], qa[kk][0], qa[kk][1], b[0], b[1]);
      mma_bf16(s[1], qa[kk][0], qa[kk][1], b[2], b[3]);
    }
  }
  const int p0 = (lane & 3) * 2;
  float v[4] = {s[0][0] * scale, s[0][1] * scale, s[1][0] * scale,
                s[1][1] * scale};
  bool ok[4];
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ok[i] = (valid >> ((i >> 1) * 8 + p0 + (i & 1))) & 1u;
    if (ok[i]) mx = fmaxf(mx, v[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = ok[i] ? expf(v[i] - m_new) : 0.f;
    sum += v[i];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float alpha = expf(m - m_new);
  l = l * alpha + sum;
  m = m_new;

  const unsigned hi0 = pack_bf16(v[0], v[1]), hi2 = pack_bf16(v[2], v[3]);
  const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&hi0);
  const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi2);
  const unsigned lo0 = pack_bf16(v[0] - __low2float(h0),
                                 v[1] - __high2float(h0));
  const unsigned lo2 = pack_bf16(v[2] - __low2float(h2),
                                 v[3] - __high2float(h2));
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[j][0] *= alpha;
    acc[j][1] *= alpha;
  }
  // matrix mat: positions 8 (mat % 2) + mr, chunk 2 jj + mat / 2
  const int r = (mat & 1) * 8 + mr;
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) {
    unsigned b[4];
    ldmatrix_x4(b, vs + r * HD + C::phys_chunk(r, 2 * jj + (mat >> 1)) * 8,
                true);
    mma_bf16(acc[2 * jj], hi0, hi2, b[0], b[1]);
    mma_bf16(acc[2 * jj], lo0, lo2, b[0], b[1]);
    mma_bf16(acc[2 * jj + 1], hi0, hi2, b[2], b[3]);
    mma_bf16(acc[2 * jj + 1], lo0, lo2, b[2], b[3]);
  }
}

// One 16-position tile on the FMA pipes (fp32). Scores: LP lanes per
// position, QE query elements each, a shuffle sum; softmax: one shuffle
// tree per query head over the tile; PV: lanes across hd, PE each.
template <typename T, int HD, int GM>
__device__ __forceinline__ void tile_simt(
    const T* ks, const T* vs, const float (&qr)[GM][Cfg<T, HD, GM>::QE],
    float (&acc)[GM][Cfg<T, HD, GM>::PE], float (&m)[GM], float (&l)[GM],
    float* sc, float* pp, int lane, int qc, int G, unsigned valid) {
  using C = Cfg<T, HD, GM>;
#pragma unroll
  for (int pass = 0; pass < C::NPASS; ++pass) {
    const int r = pass * C::RPP + lane / C::LP;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    if (r < kTile) {
#pragma unroll
      for (int i = 0; i < C::CPL; ++i) {
        float kf[C::VE];
        load_f32<T, C::VE>(ks + r * HD + (qc + C::LP * i) * C::VE, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < C::VE; ++e)
              s[g] = fmaf(qr[g][i * C::VE + e], kf[e], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int o = C::LP / 2; o > 0; o >>= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
    }
    if (qc == 0 && r < kTile) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) sc[r * GM + g] = s[g];
    }
  }
  __syncwarp();

  const int rr = lane % kTile;
  const bool ok = (valid >> rr) & 1u;
  float alpha[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    alpha[g] = 1.f;
    if (g < G) {
      const float sv = ok ? sc[rr * GM + g] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = kTile / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = kTile / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[g] = expf(m[g] - m_new);
      l[g] = l[g] * alpha[g] + sum;
      m[g] = m_new;
      if (lane < kTile) pp[rr * GM + g] = p;
    }
  }
  __syncwarp();

  const int d0 = (lane % C::LPR) * C::PE;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < C::PE; ++e) acc[g][e] *= alpha[g];
#pragma unroll 4
  for (int r = lane / C::LPR; r < kTile; r += C::RPI) {
    float vf[C::PE];
    load_f32<T, C::PE>(vs + r * HD + d0, vf);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float p = pp[r * GM + g];
#pragma unroll
        for (int e = 0; e < C::PE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // [B, KV, G, hd]
    const T* __restrict__ k_arena,    // [num_pages, ps, KV, hd]
    const T* __restrict__ v_arena,    // [num_pages, ps, KV, hd]
    const int* __restrict__ pages,    // [B, P]
    const int* __restrict__ lens,     // [B]
    T* __restrict__ out,              // [B, KV, G, hd]
    float* __restrict__ ws,           // partials, when splits > 1
    unsigned* __restrict__ counters,  // [B * KV], zero between launches
    int kv_heads, int groups, int num_pages, int page_size,
    int table_width, int pages_per_split, int window, float scale) {
  using C = Cfg<T, HD, GM>;
  extern __shared__ __align__(16) unsigned char smem[];
  // kv heads vary fastest, so the CTAs that run together read all kv
  // heads of the same pages: whole 2 KB rows of the arena, not 256 B
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.y;
  const int G = groups, ps = page_size;
  const int bh = b * kv_heads + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int* tab = reinterpret_cast<int*>(smem);
  float* sc_all = reinterpret_cast<float*>(smem + round16(pages_per_split * 4));
  unsigned char* region = reinterpret_cast<unsigned char*>(sc_all) + C::SCORES;
  float* sc = sc_all + warp * 2 * kTile * GM;   // [kTile][GM] scores
  float* pp = sc + kTile * GM;                  // [kTile][GM] probabilities

  // live positions of this split: table entries [j0, j1), inside
  // [len - window, len)
  const int length = lens[b];
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, table_width);
  int pos_lo = j0 * ps;
  if (window >= 0) pos_lo = max(pos_lo, length - window);
  const int pos_hi = min(j1 * ps, length);

  float* ws_ml = ws;   // [B*KV, splits, 2, G]
  float* ws_acc = ws + (size_t)gridDim.x * gridDim.z * splits * 2 * G;

  __shared__ int s_last;
  if (pos_lo >= pos_hi) {
    // empty partial: m = NEG_INF, l = 0, acc = 0
    if (splits == 1) {
      T* ob = out + (size_t)bh * G * HD;
      for (int e = tid; e < G * HD; e += kThreads) store(ob + e, 0.f);
      return;
    }
    for (int g = tid; g < G; g += kThreads) {
      ws_ml[((size_t)bh * splits + split) * 2 * G + g] = kNegInf;
      ws_ml[((size_t)bh * splits + split) * 2 * G + G + g] = 0.f;
    }
    for (int e = tid; e < G * HD; e += kThreads)
      ws_acc[((size_t)bh * splits + split) * G * HD + e] = 0.f;
  } else {
    const int jl0 = pos_lo / ps;
    const int jl1 = (pos_hi + ps - 1) / ps;
    for (int i = tid; i < jl1 - jl0; i += kThreads) {
      const int page = pages[(size_t)b * table_width + jl0 + i];
      tab[i] = page >= num_pages ? -1 : max(page, 0);
    }
    __syncthreads();

    T* ring = reinterpret_cast<T*>(region) +
              (size_t)warp * C::NS * 2 * kTile * HD;
    const int n_tiles = (pos_hi - pos_lo + kTile - 1) / kTile;
    const int my_tiles =
        warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

    // start the copies of this warp's tile number it into its ring slot
    auto fetch = [&](int it) {
      const int start = pos_lo + (warp + it * kWarps) * kTile;
      T* ks = ring + (size_t)(it % C::NS) * 2 * kTile * HD;
      T* vs = ks + kTile * HD;
      const long long mine =
          row_offset(start + (lane % kTile), pos_hi, tab, jl0, ps, kv_heads,
                     h, HD);
#pragma unroll
      for (int x = lane; x < kTile * C::CH; x += 32) {
        const int r = x / C::CH, ch = x % C::CH;
        const long long off = __shfl_sync(0xffffffffu, mine, r);
        const size_t src = off >= 0 ? (size_t)off + ch * C::VE : 0;
        const int nb = off >= 0 ? 16 : 0;
        const int dst = r * HD + C::phys_chunk(r, ch) * C::VE;
        cp_async16(ks + dst, k_arena + src, nb);
        cp_async16(vs + dst, v_arena + src, nb);
      }
    };

    // this warp's online-softmax state, in the path's own layout
    float m_w[C::MMA ? 1 : GM], l_w[C::MMA ? 1 : GM];
    float acc[C::MMA ? HD / 8 : GM][C::MMA ? 2 : C::PE];
#pragma unroll
    for (int g = 0; g < (C::MMA ? 1 : GM); ++g) {
      m_w[g] = kNegInf;
      l_w[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < (C::MMA ? HD / 8 : GM); ++i)
#pragma unroll
      for (int e = 0; e < (C::MMA ? 2 : C::PE); ++e) acc[i][e] = 0.f;

    // query operand: bf16 pairs as mma A fragments (rows = query heads,
    // rows 8-15 zero), or pre-scaled fp32 elements for the fp32 path
    const int qc = lane % C::LP;
    const T* qb = q + (size_t)bh * G * HD;
    unsigned qa[C::MMA ? HD / 16 : 1][2];
    float qr[C::MMA ? 1 : GM][C::QE];
    if constexpr (C::MMA) {
      const int g = lane >> 2, k2 = (lane & 3) * 2;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = g < G ? *reinterpret_cast<const unsigned*>(
                                qb + g * HD + kk * 16 + k2) : 0u;
        qa[kk][1] = g < G ? *reinterpret_cast<const unsigned*>(
                                qb + g * HD + kk * 16 + 8 + k2) : 0u;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int i = 0; i < C::CPL; ++i) {
          float t[C::VE];
          if (g < G) {
            load_f32<T, C::VE>(qb + g * HD + (qc + C::LP * i) * C::VE, t);
          } else {
#pragma unroll
            for (int e = 0; e < C::VE; ++e) t[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < C::VE; ++e) qr[g][i * C::VE + e] = t[e] * scale;
        }
      }
    }

#pragma unroll
    for (int s = 0; s < C::NS - 1; ++s) {
      if (s < my_tiles) fetch(s);
      cp_async_commit();
    }
    for (int it = 0; it < my_tiles; ++it) {
      if (it + C::NS - 1 < my_tiles) fetch(it + C::NS - 1);
      cp_async_commit();
      cp_async_wait<C::NS - 1>();
      __syncwarp();
      const int start = pos_lo + (warp + it * kWarps) * kTile;
      const T* ks = ring + (size_t)(it % C::NS) * 2 * kTile * HD;
      const T* vs = ks + kTile * HD;
      if constexpr (C::MMA) {
        tile_mma<HD>(ks, vs, qa, acc, m_w[0], l_w[0], lane,
                     valid_rows(start, pos_hi, tab, jl0, ps, lane), scale);
      } else {
        tile_simt<T, HD, GM>(ks, vs, qr, acc, m_w, l_w, sc, pp, lane, qc, G,
                             valid_rows(start, pos_hi, tab, jl0, ps, lane));
      }
      __syncwarp();
    }
    cp_async_wait<0>();

    // ---- each warp's (m, l, acc[G, hd]) to shared memory
    __syncthreads();   // every warp is done with its ring
    float* wpart = reinterpret_cast<float*>(region);   // [warp][2*GM + GM*HD]
    constexpr int WS = 2 * GM + GM * HD;
    float* wp = wpart + warp * WS;
    if constexpr (C::MMA) {
      const int g = lane >> 2, d2 = (lane & 3) * 2;
      if (g < G) {
        if ((lane & 3) == 0) {
          wp[g] = m_w[0];
          wp[GM + g] = l_w[0];
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          wp[2 * GM + g * HD + j * 8 + d2] = acc[j][0];
          wp[2 * GM + g * HD + j * 8 + d2 + 1] = acc[j][1];
        }
      }
    } else {
      // rows of one PV step were summed apart: fold the row groups
#pragma unroll
      for (int o = C::LPR; o < 32; o <<= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < C::PE; ++e)
            acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          wp[g] = m_w[g];
          wp[GM + g] = l_w[g];
        }
      }
      if (lane < C::LPR) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < C::PE; ++e)
            wp[2 * GM + g * HD + lane * C::PE + e] = acc[g][e];
      }
    }
    __syncthreads();

    // ---- merge the 4 warps in warp order
    for (int x = tid; x < G * HD; x += kThreads) {
      const int g = x / HD, d = x % HD;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wpart[w * WS + g]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(wpart[w * WS + g] - mx);
        lsum += wpart[w * WS + GM + g] * f;
        a += wpart[w * WS + 2 * GM + g * HD + d] * f;
      }
      if (splits == 1) {
        store(out + (size_t)bh * G * HD + x, a / fmaxf(lsum, 1e-37f));
      } else {
        ws_acc[((size_t)bh * splits + split) * G * HD + x] = a;
        if (d == 0) {
          ws_ml[((size_t)bh * splits + split) * 2 * G + g] = mx;
          ws_ml[((size_t)bh * splits + split) * 2 * G + G + g] = lsum;
        }
      }
    }
    if (splits == 1) return;
  }

  // ---- last arriver: one fence, one atomic; the counter wraps to 0
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(&counters[bh], (unsigned)(splits - 1)) ==
             (unsigned)(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  float* fm = reinterpret_cast<float*>(region);   // [splits][G] m -> weight
  float* fl = fm + splits * G;                    // [splits][G] l
  const float* mlb = ws_ml + (size_t)bh * splits * 2 * G;
  for (int x = tid; x < splits * G; x += kThreads) {
    const int s = x / G, g = x % G;
    fm[x] = __ldcg(mlb + s * 2 * G + g);
    fl[x] = __ldcg(mlb + s * 2 * G + G + g);
  }
  __syncthreads();
  float* lsum_s = sc_all;   // [G] (scores area is free now)
  if (tid < G) {
    const int g = tid;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, fm[s * G + g]);
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = fl[s * G + g] > 0.f ? expf(fm[s * G + g] - mx) : 0.f;
      fm[s * G + g] = f;
      lsum += fl[s * G + g] * f;
    }
    lsum_s[g] = lsum;
  }
  __syncthreads();
  // every split wrote its acc (zeros when empty): start the loads of SB
  // splits at once for all of this thread's elements (64 loads in flight
  // at most: 8 splits at hd 128, 4 at hd 256), then add in order
  constexpr int E = (GM * HD + kThreads - 1) / kThreads;
  constexpr int SB = E >= 8 ? 64 / E : 8;
  const float* accb = ws_acc + (size_t)bh * splits * G * HD;
  float a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += SB) {
    float v[E][SB];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = tid + e * kThreads;
#pragma unroll
      for (int j = 0; j < SB; ++j)
        v[e][j] = x < G * HD && s0 + j < splits
                      ? __ldcg(accb + (size_t)(s0 + j) * G * HD + x) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = tid + e * kThreads;
      if (x < G * HD) {
        const int g = x / HD;
#pragma unroll
        for (int j = 0; j < SB; ++j)
          if (s0 + j < splits) a[e] = fmaf(fm[(s0 + j) * G + g], v[e][j], a[e]);
      }
    }
  }
  T* ob = out + (size_t)bh * G * HD;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = tid + e * kThreads;
    if (x < G * HD) store(ob + x, a[e] / fmaxf(lsum_s[x / HD], 1e-37f));
  }
}

template <typename T, int HD, int GM>
int launch(const void* q, const void* k, const void* v, const void* pages,
           const void* lens, void* out, void* ws, void* counters, int batch,
           int kv_heads, int groups, int num_pages, int page_size,
           int table_width, int pages_per_split, int splits, int window,
           float scale, cudaStream_t stream) {
  const int smem = smem_bytes<T, HD, GM>(pages_per_split, splits);
  auto kernel = paged_decode_kernel<T, HD, GM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kv_heads, splits, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pages),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(counters), kv_heads,
      groups, num_pages, page_size, table_width, pages_per_split, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_groups(int gm, const void* q, const void* k, const void* v,
              const void* pages, const void* lens, void* out, void* ws,
              void* counters, int batch, int kv_heads, int groups,
              int num_pages, int page_size, int table_width,
              int pages_per_split, int splits, int window, float scale,
              cudaStream_t s) {
#define PD_ARGS q, k, v, pages, lens, out, ws, counters, batch, kv_heads, \
    groups, num_pages, page_size, table_width, pages_per_split, splits,   \
    window, scale, s
  // the tensor-core path keeps one query head per mma row: one variant
  if constexpr (Cfg<T, HD, 8>::MMA) {
    return launch<T, HD, 8>(PD_ARGS);
  } else {
    switch (gm) {
      case 1: return launch<T, HD, 1>(PD_ARGS);
      case 4: return launch<T, HD, 4>(PD_ARGS);
      case 8: return launch<T, HD, 8>(PD_ARGS);
    }
  }
#undef PD_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_head_dim(int head_dim, int gm, const void* q, const void* k,
                const void* v, const void* pages, const void* lens, void* out,
                void* ws, void* counters, int batch, int kv_heads, int groups,
                int num_pages, int page_size, int table_width,
                int pages_per_split, int splits, int window, float scale,
                cudaStream_t s) {
#define PD_ARGS gm, q, k, v, pages, lens, out, ws, counters, batch, kv_heads, \
    groups, num_pages, page_size, table_width, pages_per_split, splits,       \
    window, scale, s
  switch (head_dim) {
    case 16: return by_groups<T, 16>(PD_ARGS);
    case 32: return by_groups<T, 32>(PD_ARGS);
    case 128: return by_groups<T, 128>(PD_ARGS);
    case 256: return by_groups<T, 256>(PD_ARGS);
  }
#undef PD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both arenas and out share it).
// head_dim in {16, 32, 128, 256}; groups <= 8 (fp32 rounds it up to 1, 4 or 8
// for its register arrays). window < 0 means no sliding window. The grid is
// (kv_heads, splits, batch) with splits = ceil(table_width /
// pages_per_split). ws holds batch * kv_heads * splits * groups * (2 +
// head_dim) floats (unused when splits == 1); counters holds batch *
// kv_heads zeros and is left zeroed. Returns cudaGetLastError().
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pages,
                                   const void* lens, void* out, void* ws,
                                   void* counters, int batch, int kv_heads,
                                   int groups, int head_dim, int num_pages,
                                   int page_size, int table_width,
                                   int pages_per_split, int splits,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (batch == 0 || kv_heads == 0 || groups == 0) return 0;
  if (groups > 8 || splits < 1 || pages_per_split < 1 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  const int gm = groups <= 1 ? 1 : groups <= 4 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(head_dim, gm, q, k, v, pages, lens, out, ws,
                              counters, batch, kv_heads, groups, num_pages,
                              page_size, table_width, pages_per_split, splits,
                              window, scale, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(head_dim, gm, q, k, v, pages, lens, out,
                                      ws, counters, batch, kv_heads, groups,
                                      num_pages, page_size, table_width,
                                      pages_per_split, splits, window, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
