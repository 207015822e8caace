// Paged-decode GQA attention for Hopper (sm_90a), fp and int8 KV pools.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:
// paged_decode_kernel (body _paged_decode_body), both variants: K1 with
// fp pools of the query's type, and K1-int8 (quantized=True) with int8
// pools and fp32 per-(position, KV head) scale sidecars.
//
// What it computes: for each slot b and KV head h, the G query rows of
// that head attend over the slot's KV, which lives in pool blocks named by
// the slot's block-table row: s = (q * scale) . k^T, an optional tanh
// softcap, a mask pos < len (and (len-1) - pos < window), a softmax in
// fp32, and out = acc / max(l, 1e-30).  With int8 pools each K/V element
// is dequantized in fp32 as it is used, float(int8) * scale[position,
// head], as the Pallas kernel does.  A row with len == 0 gives zeros.
//
// What bounds it on this card: bytes, in principle.  K and V are read
// once (len x hd x 2 values per KV head, plus two fp32 scales a position
// for int8) at O(G) flops per byte, far below the ~295 flop/byte ridge of
// the H100: at B=8 and 512-token contexts one layer's bf16 K and V are
// 2 MiB, 0.63 us at 3.35 TB/s.  At decode sizes what is left is latency:
// a launch, the chain lengths -> table -> K/V of dependent reads, one
// CTA's pass over its blocks, and the combine.
//
// Design (split-KV, like FlashDecoding):
//   * Grid (n_splits, KV, B).  The wrapper's split_plan fixes
//     blocks_per_split and n_splits from the shapes alone (about two CTAs
//     per SM), never from the lengths, so a call reads no device value.
//     A CTA takes the blocks of its split that hold valid positions; one
//     whose split lies wholly past len or before the window exits without
//     reading K/V.  Table entries past len -- the NULL block 0 among
//     them -- are never read.
//   * Staging: a (slot, head) block is bs rows of hd contiguous elements
//     at stride KV * hd.  The CTA reads its table entries and q in one
//     round trip, then copies its blocks into shared memory in their
//     stored type (bf16, fp32, or int8 with its fp32 scales) with 16-byte
//     cp.async (hd 64 bf16: one copy a thread for K and one for V; byte
//     copies where a row is not 16-byte aligned) into a ring of 3-5
//     stages.  The fp32 K/V tile never exists in device memory.  A split
//     of up to 4 blocks (the main path's) is staged whole by the prologue
//     and folded in one pass; a longer one runs the ring, the next blocks
//     in flight while one is folded, one barrier a block.
//   * Compute: warp w owns the row pairs w and w + 4 (G <= 16); half-warp
//     j takes row 2 pair + j.  Scores: lane t of a half takes position t
//     of each block in the pass and dots its K rows, read as 16-byte
//     chunks, with the row's pre-scaled fp32 q broadcast from shared
//     memory.  K rows are padded to an odd number of chunks, so the 8
//     lanes of a quarter warp read 8 rows without a bank conflict; no
//     shuffle is needed for a dot.  Each row's max and sum are reductions
//     over the half (__shfl_xor_sync), one exp a lane and position.  The
//     probabilities go to the warp's slice of shared memory; lane l then
//     accumulates dims 2l, 2l + 1 (+ 64c) of p . V for both rows in
//     registers, four positions a step.  fp32 CUDA-core FMAs throughout
//     (no TF32).
//   * Combine: each live split writes (acc[G, hdv], m, l) in fp32 to
//     scratch (B, KV, S, G, hdv + 2) that the wrapper allocates; a second
//     small kernel (paged_decode_combine) reads a row's live splits in
//     the order s = 0..S-1 and writes out.  No float atomics: two calls
//     give bit-equal outputs.  A second kernel, rather than a last-CTA
//     counter, keeps no state between calls (nothing to reset, nothing
//     shared between streams or graph replays); it is a programmatic
//     dependent launch, so its CTAs start while the split kernel runs and
//     wait for its results (griddepcontrol).  A row with one live split
//     (short contexts) is written by that split, and with S == 1 the
//     combine is not launched.
//
// Measured (chip_smoke.py, phase timing, NVIDIA H100 80GB HBM3 at 700 W,
// B=8, KV=2, G=7, hd 64, bs 16, bf16, L2 flushed): 11.3, 15.3 and 16.0 us
// at 32, 512 and 1024 tokens, a fit of 11.7 us fixed + 0.08 us a 16-
// position block; SDPA over pre-gathered KV takes 7.4, 14.0 and 21.7 us.
// The serial one-CTA-per-(slot, head) kernel this design replaced took
// 257.6 us at 512 tokens, about 8 us a block.  What is left is the fixed
// part: the launch, the dependent reads lengths -> table -> K/V, and the
// combine kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 2;  // row pairs a warp owns: G <= 2 kWarps kPairs
constexpr int kUnits = 4;  // blocks folded in one pass: stages - 1 <= 4
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemOptIn = 48 * 1024;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max and sum over each half warp (lanes 0-15, 16-31)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// Positions of a row that attend: [lo, hi), lo = max(0, len - window) with
// a window (window >= 0), hi = min(len, nbs * bs); blocks [blk_lo, blk_hi)
// hold them (empty when lo >= hi).  Split s covers blocks [s * bps, (s+1) *
// bps) and is live iff it meets [blk_lo, blk_hi); the split kernel and the
// combine both decide it here.
struct Span {
  int lo, hi, blk_lo, blk_hi;
};

__device__ __forceinline__ Span row_span(int len, int window, int bs,
                                         int nbs) {
  Span sp;
  sp.hi = min(len, nbs * bs);
  sp.lo = window >= 0 ? max(0, len - window) : 0;
  if (sp.lo >= sp.hi) {
    sp.lo = sp.hi = sp.blk_lo = sp.blk_hi = 0;
  } else {
    sp.blk_lo = sp.lo / bs;
    sp.blk_hi = (sp.hi + bs - 1) / bs;
  }
  return sp;
}

// (first live split, number of live splits) of a row.
__device__ __forceinline__ int2 live_splits(const Span& sp, int bps) {
  if (sp.blk_hi <= sp.blk_lo) return make_int2(0, 0);
  const int s_lo = sp.blk_lo / bps;
  return make_int2(s_lo, (sp.blk_hi + bps - 1) / bps - s_lo);
}

// cp.async of 16 bytes (L2 only) and of 4 bytes, global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A tile global -> shared: rows of rb bytes, global rows gstride bytes
// apart, shared rows drs bytes apart.  Copied in 16-byte cp.async chunks
// (w = 16), or a byte at a time (w = 1) where a row or a pool address is
// not 16-byte aligned.  Each thread's first chunk and its step are fixed
// for the kernel, so staging a block divides nothing.
struct TileCopy {
  int w, per_row, total, r0, k0, dr, dk;

  __device__ TileCopy(int rows, int rb, int w_) : w(w_) {
    per_row = rb / w;
    total = rows * per_row;
    r0 = threadIdx.x / per_row;
    k0 = threadIdx.x - r0 * per_row;
    dr = kThreads / per_row;
    dk = kThreads - dr * per_row;
  }

  __device__ __forceinline__ void run(char* dst, const char* src, int drs,
                                      long gstride) const {
    int r = r0, k = k0;
    for (int c = threadIdx.x; c < total; c += kThreads) {
      char* d = dst + r * drs + k * w;
      const char* g = src + r * gstride + k * w;
      if (w == 16)
        cp_async16(d, g);
      else
        *d = *g;
      r += dr;
      k += dk;
      if (k >= per_row) {
        k -= per_row;
        ++r;
      }
    }
  }
};

// Shared-memory layout, in bytes.  The wrapper (paged_attention.
// _smem_bytes) sizes it the same way.
//   front: q, G rows of q_stride fp32 (pre-scaled, zero past hd), the
//          warps' probabilities, kWarps x 2 x kUnits x 16 fp32, the entries
//          of the CTA's first kThreads blocks;
//   ring:  stages x stage: bs K rows k_stride bytes apart (the row, zero to
//          the next 16 bytes, then a pad), bs V rows v_stride bytes apart,
//          and with int8 pools bs K then bs V scales.
// The pad makes K rows an odd number of 16-byte chunks long, so the 8
// lanes of a quarter warp that read one chunk of 8 consecutive rows hit
// 8 disjoint groups of 4 banks: no bank conflict.
__host__ __device__ __forceinline__ int k_chunks(int hd, int elem) {
  return align16(hd * elem) / 16;
}
__host__ __device__ __forceinline__ int k_stride(int hd, int elem) {
  const int ck = k_chunks(hd, elem);
  return 16 * (ck + 1 + (ck & 1));
}
__host__ __device__ __forceinline__ int v_stride(int hdv, int elem) {
  return align16(hdv * elem);
}
__host__ __device__ __forceinline__ int q_stride(int hd, int elem) {
  return k_chunks(hd, elem) * (16 / elem);
}
__host__ __device__ __forceinline__ int front_bytes(int G, int hd, int elem) {
  return 4 * (G * q_stride(hd, elem) + kWarps * 32 * kUnits + kThreads);
}
__host__ __device__ __forceinline__ int stage_bytes(int bs, int hd, int hdv,
                                                    int elem, bool quant) {
  return bs * (k_stride(hd, elem) + v_stride(hdv, elem)) +
         (quant ? align16(2 * bs * 4) : 0);
}

// Two consecutive V elements as fp32.
template <typename KVT>
__device__ __forceinline__ void load_pair(const char* p, float& a, float& b);
template <>
__device__ __forceinline__ void load_pair<float>(const char* p, float& a,
                                                 float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <>
__device__ __forceinline__ void load_pair<__nv_bfloat16>(const char* p,
                                                         float& a, float& b) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load_pair<int8_t>(const char* p, float& a,
                                                  float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = static_cast<float>(v.x);
  b = static_cast<float>(v.y);
}

// A 16-byte chunk of a K row as fp32 values.
template <typename KVT> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const char* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const char* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void load(const char* p, float* o) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      o[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
};

// q (B, KV, G, hd); pools (nb, bs, KV, hd|hdv) in KVT (T, or int8 with
// scales (nb, bs, KV) fp32); table (B, nbs); lengths (B,).  n_splits == 1:
// writes out (B, KV, G, hdv); else part (B, KV, n_splits, G, hdv + 2) for
// the live splits.  Grid (n_splits, KV, B), kThreads threads,
// front_bytes + stages x stage_bytes of dynamic shared memory.  vec: 16
// when the K and V rows and both pool addresses are 16-byte aligned (the
// copies are 16-byte cp.async), else 1 (byte copies).
// NP: V dim pairs a lane holds (hdv <= 64 NP).
//
// Warp w takes the row pairs w and w + 4 (rows 2w, 2w + 1, 2w + 8,
// 2w + 9).  For a pair and 16 positions of each block in a pass, half-warp
// j scores row 2pair + j: lane t of the half dots position t's K rows,
// read as 16-byte chunks, with the row's pre-scaled q broadcast from
// shared memory.  The row's max and sum are reductions over the half (xor
// 8, 4, 2, 1); the probabilities go to the warp's slice of shared memory;
// then lane l accumulates dims 2l, 2l + 1 (+ 64c) of p . V for both rows,
// four positions a step.  Both halves run the same instructions: no branch
// on the row.
template <typename T, typename KVT, int NP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const T* __restrict__ q, const KVT* __restrict__ k_pool,
                   const KVT* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ part, int KV, int G, int hd, int hdv,
                   int bs, int nbs, int bps, int n_splits, int vec,
                   int stages, float scale, int window, float softcap) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int kE = Chunk<KVT>::kN;
  constexpr int elem = sizeof(KVT);
  extern __shared__ __align__(16) char smem[];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, tl = lane & 15;
  const long bh = (long)b * KV + h;
  const Span sp = row_span(lengths[b], window, bs, nbs);
  const int jb = max(sp.blk_lo, s * bps);
  const int n = min(sp.blk_hi, (s + 1) * bps) - jb;  // blocks of this CTA
  // the combine (a dependent launch) may start; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  if (n <= 0) {  // nothing valid in this split: read no K/V
    if (n_splits == 1) {
      T* orow = out + bh * G * hdv;
      for (int i = threadIdx.x; i < G * hdv; i += kThreads)
        orow[i] = from_f<T>(0.f);
    }
    return;
  }

  const int ck = k_chunks(hd, elem), ks_ = k_stride(hd, elem);
  const int vs_ = v_stride(hdv, elem), qs_ = q_stride(hd, elem);
  const int kbytes = bs * ks_, vbytes = bs * vs_;
  const int sbytes = stage_bytes(bs, hd, hdv, elem, kQuant);
  float* qsm = reinterpret_cast<float*>(smem);
  // this warp's p: 2 rows x kUnits blocks x 16 positions
  float* pw = qsm + G * qs_ + warp * 32 * kUnits;
  int* tsm = reinterpret_cast<int*>(qsm + G * qs_ + kWarps * 32 * kUnits);
  char* ring = smem + front_bytes(G, hd, elem);
  const int* trow = table + (long)b * nbs;

  // the table entries of the first kThreads blocks and q in one round trip
  // (q pre-scaled, zero past hd); K rows zero between hd and the chunk end,
  // where the copies never write
  const int nt = min(n, kThreads);
  const int blk_t = threadIdx.x < nt ? trow[jb + threadIdx.x] : 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < G * qs_; i += kThreads) {
    const int g = i / qs_, d = i - g * qs_;
    qsm[i] = d < hd ? to_f(q[(bh * G + g) * hd + d]) * scale : 0.f;
  }
  if (threadIdx.x < nt) tsm[threadIdx.x] = blk_t;
  if ((hd * elem) & 15) {
    for (int i = threadIdx.x; i < stages * bs; i += kThreads) {
      char* row = ring + (i / bs) * sbytes + (i % bs) * ks_;
      for (int x = hd * elem; x < 16 * ck; ++x) row[x] = 0;
    }
  }
  __syncthreads();

  const TileCopy kcopy(bs, hd * elem, vec), vcopy(bs, hdv * elem, vec);
  auto stage = [&](int j, int slot) {
    const long blk = j - jb < kThreads ? tsm[j - jb] : trow[j];
    const long row0 = blk * bs * KV + h;  // (blk, 0, h)
    char* base = ring + slot * sbytes;
    kcopy.run(base, reinterpret_cast<const char*>(k_pool + row0 * hd), ks_,
              (long)KV * hd * elem);
    vcopy.run(base + kbytes, reinterpret_cast<const char*>(v_pool + row0 * hdv),
              vs_, (long)KV * hdv * elem);
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(base + kbytes + vbytes);
      for (int t = threadIdx.x; t < 2 * bs; t += kThreads) {
        const int tt = t < bs ? t : t - bs;
        cp_async4(sc + t, (t < bs ? k_scale : v_scale) + row0 + tt * KV);
      }
    }
  };

  for (int p = 0; p < stages - 1; ++p) {
    if (p < n) stage(jb + p, p);
    cp_async_commit();
  }

  // pair k of this warp: rows 2 (warp + 4k) + j; m, l: this half's row
  float acc[kPairs][2][2 * NP], m[kPairs], l[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    m[k] = kNegInf;
    l[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2 * NP; ++c) acc[k][j][c] = 0.f;
  }

  // A split whose blocks all fit in the prologue (n <= stages - 1: the
  // main path's splits) waits once and folds its nu = n blocks in one
  // pass: lane t of a half scores position t of every block, so the dots
  // of the blocks run side by side and the softmax is updated once.  A
  // longer split runs the ring, one block a pass.
  const bool whole = n <= min(stages - 1, kUnits);
  const int nu = whole ? n : 1;
  int slot = 0, refill = stages - 1;
  for (int i = 0; i < n; i += nu) {
    if (whole)
      cp_async_wait<0>();
    else if (stages >= 5)
      cp_async_wait<3>();
    else if (stages == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();  // blocks staged; block i - 1's slot free again
    if (!whole) {
      if (i + stages - 1 < n) stage(jb + i + stages - 1, refill);
      cp_async_commit();
      refill = refill + 1 == stages ? 0 : refill + 1;
    }
    const char* kb0 = ring + slot * sbytes;  // block u: kb0 + u * sbytes
    if (!whole) slot = slot + 1 == stages ? 0 : slot + 1;
    const int pos0 = (jb + i) * bs;          // block u: pos0 + u * bs

#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int g = 2 * (warp + kWarps * k) + half;  // this half's row
      if (2 * (warp + kWarps * k) >= G) break;       // warp-uniform
      const bool row_ok = g < G;
      const float* qrow = qsm + (row_ok ? g : 0) * qs_;
      // positions in chunks of 16: lane tl of each half takes position
      // tl of the chunk in each block u < nu
      for (int t0 = 0; t0 < bs; t0 += 16) {
        int v0[kUnits], v1[kUnits];
        bool mine[kUnits];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const int base = pos0 + u * bs + t0;
          v0[u] = max(sp.lo - base, 0);
          v1[u] = u < nu ? min(min(sp.hi - base, bs - t0), 16) : 0;
          mine[u] = row_ok && tl >= v0[u] && tl < v1[u];
          any |= v0[u] < v1[u];
        }
        if (!any) continue;
        float d0[kUnits], d1[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) d0[u] = d1[u] = 0.f;
        {
          // rows past the block (bs < 16) read row bs - 1: masked below
          const int tk = min(t0 + tl, bs - 1);
          const char* krow = kb0 + tk * ks_;
          float kscale[kUnits];
#pragma unroll
          for (int u = 0; u < kUnits; ++u)
            kscale[u] = kQuant && u < nu
                            ? reinterpret_cast<const float*>(
                                  kb0 + u * sbytes + kbytes + vbytes)[tk]
                            : 1.f;
#pragma unroll 2
          for (int c = 0; c < ck; ++c) {
            const float4* qv = reinterpret_cast<const float4*>(qrow + c * kE);
            float4 qq[kE / 4];
#pragma unroll
            for (int e4 = 0; e4 < kE / 4; ++e4) qq[e4] = qv[e4];
#pragma unroll
            for (int u = 0; u < kUnits; ++u) {
              if (u >= nu) break;
              float kv[kE];
              Chunk<KVT>::load(krow + u * sbytes + 16 * c, kv);
              if constexpr (kQuant) {
#pragma unroll
                for (int e = 0; e < kE; ++e) kv[e] *= kscale[u];
              }
#pragma unroll
              for (int e4 = 0; e4 < kE / 4; ++e4) {
                float& a = (e4 & 1) ? d1[u] : d0[u];
                a = fmaf(qq[e4].x, kv[4 * e4], a);
                a = fmaf(qq[e4].y, kv[4 * e4 + 1], a);
                a = fmaf(qq[e4].z, kv[4 * e4 + 2], a);
                a = fmaf(qq[e4].w, kv[4 * e4 + 3], a);
              }
            }
          }
        }
        float sc[kUnits], mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          sc[u] = d0[u] + d1[u];
          if (softcap > 0.f) sc[u] = tanhf(sc[u] / softcap) * softcap;
          if (!mine[u]) sc[u] = kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float m_new = fmaxf(m[k], half_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const float p = mine[u] ? expf(sc[u] - m_new) : 0.f;
          pw[(half * kUnits + u) * 16 + tl] = p;
          psum += p;
        }
        const float corr = expf(m[k] - m_new);
        l[k] = l[k] * corr + half_sum(psum);
        m[k] = m_new;
        const float corr0 = __shfl_sync(kFull, corr, 0);
        const float corr1 = __shfl_sync(kFull, corr, 16);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          acc[k][0][c] *= corr0;
          acc[k][1][c] *= corr1;
        }
        // four positions a step from v0 rounded down; positions outside
        // [v0, v1) have p = 0 and read row min(t, v1 - 1) of V, which is
        // in the block and holds a written position
        const float4* pw4 = reinterpret_cast<const float4*>(pw);
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          if (u >= nu) break;
          const char* vb = kb0 + u * sbytes + kbytes;
          const float* vsc =
              reinterpret_cast<const float*>(vb + vbytes) + bs;
#pragma unroll 2
          for (int t4 = v0[u] & ~3; t4 < v1[u]; t4 += 4) {
            const float4 pa = pw4[(u * 16 + t4) / 4];
            const float4 pb = pw4[((kUnits + u) * 16 + t4) / 4];
            const float p0[4] = {pa.x, pa.y, pa.z, pa.w};
            const float p1[4] = {pb.x, pb.y, pb.z, pb.w};
            // the four rows' V first, then the FMAs: one load latency a
            // step, not one a position
            float va[4][2 * NP];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int t = t0 + min(t4 + x, v1[u] - 1);
              const char* vrow = vb + t * vs_;
              const float vscale = kQuant ? vsc[t] : 1.f;
#pragma unroll
              for (int c = 0; c < NP; ++c) {
                const int d = 2 * lane + 64 * c;
                va[x][2 * c] = va[x][2 * c + 1] = 0.f;
                if (d < hdv)
                  load_pair<KVT>(vrow + d * elem, va[x][2 * c],
                                 va[x][2 * c + 1]);
                if constexpr (kQuant) {
                  va[x][2 * c] *= vscale;
                  va[x][2 * c + 1] *= vscale;
                }
              }
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int c = 0; c < 2 * NP; ++c) {
                acc[k][0][c] = fmaf(p0[x], va[x][c], acc[k][0][c]);
                acc[k][1][c] = fmaf(p1[x], va[x][c], acc[k][1][c]);
              }
          }
        }
        __syncwarp();  // pw is rewritten by the next chunk
      }
    }
  }
  cp_async_wait<0>();

  // one live split (or one split): write out; else the partial
  const bool direct = n_splits == 1 || live_splits(sp, bps).y == 1;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    if (2 * (warp + kWarps * k) >= G) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = 2 * (warp + kWarps * k) + j;
      const float mj = __shfl_sync(kFull, m[k], 16 * j);
      const float lj = __shfl_sync(kFull, l[k], 16 * j);
      if (g >= G) break;
      if (direct) {
        T* orow = out + (bh * G + g) * hdv;
        const float inv_den = 1.f / fmaxf(lj, 1e-30f);
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          const int d = 2 * lane + 64 * (c / 2) + (c & 1);
          if (d < hdv) orow[d] = from_f<T>(acc[k][j][c] * inv_den);
        }
      } else {
        float* pp = part + ((bh * n_splits + s) * G + g) * (hdv + 2);
#pragma unroll
        for (int c = 0; c < 2 * NP; ++c) {
          const int d = 2 * lane + 64 * (c / 2) + (c & 1);
          if (d < hdv) pp[d] = acc[k][j][c];
        }
        if (lane == 0) {
          pp[hdv] = mj;
          pp[hdv + 1] = lj;
        }
      }
    }
  }
}

constexpr int kCombineThreads = 64;
constexpr int kCombineRegs = 16;  // splits a thread holds in registers

// out[b, h, g] from the live splits' partials, in the order s = 0..S-1:
// M = max m_s, w_s = e^(m_s - M), L = sum l_s w_s, out = sum acc_s w_s /
// max(L, 1e-30).  A row with no live split gets zeros; a row with one was
// written by the split kernel.  Grid (G, KV, B), kCombineThreads threads,
// 2 x n_splits fp32 of dynamic shared memory.  Launched as a programmatic
// dependent of the split kernel, it starts while that kernel runs and
// reads the partials after griddepcontrol.wait, all of them at once (the
// first kCombineRegs splits into registers).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_combine(const float* __restrict__ part,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int KV, int G, int hdv, int bs, int nbs, int bps,
                     int n_splits, int window) {
  extern __shared__ float wsm[];  // m_s, then w_s; l_s
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * KV + h;
  T* orow = out + (bh * G + g) * hdv;
  const int2 live = live_splits(row_span(lengths[b], window, bs, nbs), bps);
  const int n_live = live.y;
  // every CTA waits for the split kernel, so that this grid completes
  // only after it: later work on the stream may read out
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n_live == 0) {
    for (int d = threadIdx.x; d < hdv; d += kCombineThreads)
      orow[d] = from_f<T>(0.f);
    return;
  }
  if (n_live == 1) return;
  const int w = hdv + 2;
  const long sstride = (long)G * w;
  const float* p0 = part + ((bh * n_splits + live.x) * G + g) * w;
  float* ws = wsm;
  float* ls = wsm + n_splits;
  for (int i = threadIdx.x; i < n_live; i += kCombineThreads) {
    ws[i] = p0[i * sstride + hdv];
    ls[i] = p0[i * sstride + hdv + 1];
  }
  const int d0 = threadIdx.x;
  float a[kCombineRegs];
#pragma unroll
  for (int i = 0; i < kCombineRegs; ++i)
    a[i] = (i < n_live && d0 < hdv) ? p0[i * sstride + d0] : 0.f;
  __syncthreads();
  float M = kNegInf;
  for (int i = 0; i < n_live; ++i) M = fmaxf(M, ws[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n_live; i += kCombineThreads)
    ws[i] = expf(ws[i] - M);
  __syncthreads();
  float L = 0.f;
  for (int i = 0; i < n_live; ++i) L += ls[i] * ws[i];
  const float inv_den = 1.f / fmaxf(L, 1e-30f);
  for (int d = d0; d < hdv; d += kCombineThreads) {
    float num = 0.f;
    if (d == d0) {
#pragma unroll
      for (int i = 0; i < kCombineRegs; ++i)
        if (i < n_live) num += a[i] * ws[i];
    } else {
      for (int i = 0; i < min(n_live, kCombineRegs); ++i)
        num += p0[i * sstride + d] * ws[i];
    }
    for (int i = kCombineRegs; i < n_live; ++i)
      num += p0[i * sstride + d] * ws[i];
    orow[d] = from_f<T>(num * inv_den);
  }
}

template <typename T, typename KVT, int NP>
int launch_np(const void* q, const void* k_pool, const void* v_pool,
              const float* k_scale, const float* v_scale, const int* table,
              const int* lengths, void* out, float* part, int B, int KV,
              int G, int hd, int hdv, int bs, int nbs, int bps, int n_splits,
              int vec, int stages, float scale, int window, float softcap,
              cudaStream_t st) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  constexpr int elem = sizeof(KVT);
  const int smem = front_bytes(G, hd, elem) +
                   stages * stage_bytes(bs, hd, hdv, elem, kQuant);
  auto kern = paged_decode_split<T, KVT, NP>;
  if (smem > kSmemOptIn) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(n_splits, KV, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, table, lengths,
      static_cast<T*>(out), part, KV, G, hd, hdv, bs, nbs, bps, n_splits,
      vec, stages, scale, window, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  // a programmatic dependent launch: the combine's CTAs may start while
  // the split kernel runs and wait (griddepcontrol.wait) for its results
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, KV, B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 2 * n_splits * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_decode_combine<T>, static_cast<const float*>(part),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, hdv, bs,
      nbs, bps, n_splits, window));
}

template <typename T, typename KVT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* table,
           const int* lengths, void* out, float* part, int B, int KV, int G,
           int hd, int hdv, int bs, int nbs, int bps, int n_splits, int vec,
           int stages, float scale, int window, float softcap,
           cudaStream_t st) {
#define PD_LAUNCH(NP)                                                       \
  return launch_np<T, KVT, NP>(q, k_pool, v_pool, k_scale, v_scale, table, \
                               lengths, out, part, B, KV, G, hd, hdv, bs,   \
                               nbs, bps, n_splits, vec, stages, scale,      \
                               window, softcap, st)
  if (hdv <= 64) PD_LAUNCH(1);
  if (hdv <= 128) PD_LAUNCH(2);
  if (hdv <= 256) PD_LAUNCH(4);
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1, fp pools of q's type.  dtype: 0 = float32, 1 = bfloat16.  part: fp32
// scratch (B, KV, n_splits, G, hdv + 2), unused when n_splits == 1.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int paged_decode_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const int* table, const int* lengths, void* out, float* part, int B,
    int KV, int G, int hd, int hdv, int bs, int nbs, int bps, int n_splits,
    int vec, int stages, float scale, int window, float softcap,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table,
                                lengths, out, part, B, KV, G, hd, hdv, bs,
                                nbs, bps, n_splits, vec, stages, scale,
                                window, softcap, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, lengths, out, part, B, KV,
      G, hd, hdv, bs, nbs, bps, n_splits, vec, stages, scale, window,
      softcap, st);
}

// K1-int8: int8 pools with fp32 scales (nb, bs, KV); q and out in dtype
// (0 = float32, 1 = bfloat16).  Returns the CUDA error code.
extern "C" int paged_decode_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, void* out, float* part, int B, int KV, int G, int hd,
    int hdv, int bs, int nbs, int bps, int n_splits, int vec, int stages,
    float scale, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table,
                                 lengths, out, part, B, KV, G, hd, hdv, bs,
                                 nbs, bps, n_splits, vec, stages, scale,
                                 window, softcap, st);
  return launch<__nv_bfloat16, int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, part, B, KV,
      G, hd, hdv, bs, nbs, bps, n_splits, vec, stages, scale, window,
      softcap, st);
}
