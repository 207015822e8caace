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
// softcap, a mask pos < len (and (len-1) - pos < window), an online
// softmax (m, l, acc) in fp32 across blocks, and out = acc / max(l, 1e-30).
// With int8 pools each K/V element is dequantized in fp32 as it is
// fetched, float(int8) * scale[position, head], as the Pallas kernel does.
//
// What bounds it on this card: bytes.  Each CTA reads its slot's K and V
// once (len x hd x 2 values per KV head, plus two fp32 scales a position
// for int8) and does O(G) flops per byte, far below the ~295 flop/byte
// ridge of the H100.  At B=8 and 512-token contexts one layer's bf16 K
// and V are 2 MiB, 0.63 us at 3.35 TB/s (int8 with scales: 1.1 MiB); this
// kernel is far from that bound, held by the latency of its serial block
// loop (below).
//
// Design: one CTA per (slot, KV head), so the G query rows are loaded once
// and every K/V block is read once for all G rows.  The TPU grid walks all
// nbs table entries and masks the dead ones; here the CTA loops only over
// the ceil(len / bs) blocks that hold valid positions (and skips blocks
// wholly outside the window), so table entries past len -- the NULL block
// 0 among them -- are never read.  Each K/V block (bs x hd) is staged in
// shared memory as fp32 (int8 dequantized on the way, so the fp32 tile
// never exists in device memory); scores, the softmax state and the
// accumulator stay in shared memory in fp32.  A row with len == 0 reads
// nothing and writes zeros.  The block loop is latency-bound: at the
// decode shape B x KV = 16 CTAs cannot fill the 132 SMs and every block
// costs four barriers (issuing the staging loads in batches measured
// slower on an H100, so they stay one per iteration).  Simple and correct
// first: a split-KV grid with more CTAs than B x KV is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// q (B, KV, G, hd); pools (nb, bs, KV, hd|hdv) in KVT (T, or int8 with
// scales (nb, bs, KV) fp32); table (B, nbs); lengths (B,);
// out (B, KV, G, hdv).  Grid (KV, B), kThreads threads.
template <typename T, typename KVT>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const KVT* __restrict__ k_pool,
             const KVT* __restrict__ v_pool,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ out, int KV,
             int G, int hd, int hdv, int bs, int nbs, float scale, int window,
             float softcap) {
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  extern __shared__ float smem[];
  float* qs = smem;              // G * hd, pre-scaled
  float* ks = qs + G * hd;       // bs * hd
  float* vs = ks + bs * hd;      // bs * hdv
  float* s = vs + bs * hdv;      // G * bs: scores, then probabilities
  float* acc = s + G * bs;       // G * hdv
  float* m = acc + G * hdv;      // G
  float* l = m + G;              // G
  float* corr = l + G;           // G

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int len = lengths[b];

  const T* qrow = q + ((long)b * KV + h) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f(qrow[i]) * scale;
  for (int i = tid; i < G * hdv; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  int nblk = (len + bs - 1) / bs;
  if (nblk > nbs) nblk = nbs;
  int j0 = 0;
  if (window > 0 && len > window) j0 = (len - window) / bs;

  for (int j = j0; j < nblk; ++j) {
    const long blk = table[(long)b * nbs + j];
    const int base = j * bs;
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const long row = (blk * bs + t) * KV + h;
      float kv = to_f(k_pool[row * hd + d]);
      if constexpr (kQuant) kv *= k_scale[row];
      ks[i] = kv;
    }
    for (int i = tid; i < bs * hdv; i += kThreads) {
      const int t = i / hdv, d = i - t * hdv;
      const long row = (blk * bs + t) * KV + h;
      float vv = to_f(v_pool[row * hdv + d]);
      if constexpr (kQuant) vv *= v_scale[row];
      vs[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i - g * bs;
      const int pos = base + t;
      const bool valid =
          pos < len && (window <= 0 || (len - 1) - pos < window);
      float dot = 0.f;
      if (valid) {
        const float* qg = qs + g * hd;
        const float* kt = ks + t * hd;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kt[d], dot);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
      }
      s[i] = valid ? dot : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* sg = s + g * bs;
      const float m_prev = m[g];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, sg[t]);
      float psum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = sg[t] > 0.5f * kNegInf ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        psum += p;
      }
      const float c = expf(m_prev - m_new);
      corr[g] = c;
      l[g] = l[g] * c + psum;
      m[g] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < G * hdv; i += kThreads) {
      const int g = i / hdv, d = i - g * hdv;
      const float* pg = s + g * bs;
      float a = acc[i] * corr[g];
      for (int t = 0; t < bs; ++t) a = fmaf(pg[t], vs[t * hdv + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* orow = out + ((long)b * KV + h) * G * hdv;
  for (int i = tid; i < G * hdv; i += kThreads) {
    const int g = i / hdv;
    orow[i] = from_f<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T, typename KVT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* table,
           const int* lengths, void* out, int B, int KV, int G, int hd,
           int hdv, int bs, int nbs, float scale, int window, float softcap,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)bs * hd + (size_t)bs * hdv +
                       (size_t)G * bs + (size_t)G * hdv + 3 * (size_t)G);
  const dim3 grid(KV, B);
  paged_decode<T, KVT><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, table, lengths,
      static_cast<T*>(out), KV, G, hd, hdv, bs, nbs, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1, fp pools of q's type.  dtype: 0 = float32, 1 = bfloat16.  Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int paged_decode_launch(int dtype, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const int* table, const int* lengths,
                                   void* out, int B, int KV, int G, int hd,
                                   int hdv, int bs, int nbs, float scale,
                                   int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table,
                                lengths, out, B, KV, G, hd, hdv, bs, nbs,
                                scale, window, softcap, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, lengths, out, B, KV, G, hd,
      hdv, bs, nbs, scale, window, softcap, st);
}

// K1-int8: int8 pools with fp32 scales (nb, bs, KV); q and out in dtype
// (0 = float32, 1 = bfloat16).  Returns the CUDA error code of the launch.
extern "C" int paged_decode_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, void* out, int B, int KV, int G, int hd, int hdv,
    int bs, int nbs, float scale, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table,
                                 lengths, out, B, KV, G, hd, hdv, bs, nbs,
                                 scale, window, softcap, st);
  return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                       table, lengths, out, B, KV, G, hd, hdv,
                                       bs, nbs, scale, window, softcap, st);
}
