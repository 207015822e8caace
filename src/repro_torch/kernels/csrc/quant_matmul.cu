// Int8-weight GEMM for Hopper (sm_90a): out = (x . float(w_q)) * scale.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py: quant_matmul
// (body _quant_matmul_kernel), the GTA INT8 serving path.
//
// What it computes: x (M, K) in T (float or bf16) times the int8 weight
// w_q (K, N), each weight upcast exactly to fp32 and every product summed
// in fp32, then the per-output-channel scale (N,) applied once at the
// flush; out (M, N) is fp32.  int8 -> fp32 and bf16 -> fp32 are exact, so
// with bf16 x every product is exact and only the order of the fp32 sums
// differs from the plain version.
//
// What bounds it on this card: bytes at decode (M = 8 rows): every weight
// byte meets only 8 rows, about 16 flop a byte, far below the H100's
// ridge; the (896, 4864) down projection's 4.4 MB of int8 weight is
// 1.3 us at 3.35 TB/s.  At prefill-chunk sizes (M = 256) the work nears
// the ridge and this kernel's CUDA-core FMAs (67 TFLOP/s fp32, no tensor
// cores yet) become the limit.
//
// Design: one owner CTA per (BM, BN) output tile runs the whole K loop, so
// the summation order is fixed and no atomics are used.  K is walked in
// stages of BK rows, STAGES deep: cp.async copies the x tile (16-byte
// chunks) and the raw int8 weight tile (BN-byte row chunks, 16 bytes at
// most) into shared memory while earlier stages are computed, and edges
// are zero-filled in the copy (no padding copies).  Each thread owns a
// TM x TN block of the tile in fp32 registers, converting x and w to fp32
// as it reads them.  The 256 threads form KG = 256 / ((BM/TM)(BN/TN))
// k-groups that take the stage's rows kg, kg + KG, ...; with KG > 1 their
// partial tiles are summed in shared memory in group order at the end.
// Two tile families:
//   wide   (M > 16): 64x64 or 32x32 tiles, KG = 1 -- the chunk GEMMs;
//   narrow (M <= 16): BM = 8 with BN = 16, 8 or 4 and KG = 32 or 64, so
//          that a decode GEMM with N = 896 still puts 224 CTAs in flight
//          (the wrapper picks the widest BN with at least 132 CTAs).
// Shapes whose rows cannot be copied in aligned chunks (K not a multiple
// of 16 bytes of x, N not a multiple of the weight chunk, unaligned
// pointers) take scalar loads instead of cp.async.  Tensor cores (wgmma
// on int8 or bf16), TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copy BYTES (4, 8 or 16) from global to shared memory asynchronously;
// when !valid nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x (M, K) T row-major; w (K, N) int8 row-major; scale (N,) fp32;
// out (M, N) fp32.  Grid (ceil(N / BN), ceil(M / BM)), kThreads threads.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
quant_matmul(const T* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out,
             int M, int N, int K, int vec) {
  constexpr int RT = BM / TM, CT = BN / TN;   // threads along rows, columns
  constexpr int GROUP = RT * CT;              // threads of one k-group
  constexpr int KG = kThreads / GROUP;        // k-groups
  static_assert(KG * GROUP == kThreads && BK % KG == 0, "thread layout");
  constexpr int XC = 16 / sizeof(T);          // x elements per 16-byte chunk
  constexpr int WC = BN < 16 ? BN : 16;       // weight bytes per chunk
  constexpr int X_BYTES = BM * BK * sizeof(T);
  constexpr int W_BYTES = BK * BN;
  static_assert(X_BYTES % 16 == 0 && W_BYTES % 16 == 0, "stage alignment");
  constexpr int STAGE = X_BYTES + W_BYTES;
  constexpr int PIPE = kStages * STAGE;
  constexpr int RED = KG > 1 ? KG * BM * BN * 4 : 0;
  __shared__ __align__(16) unsigned char smem[PIPE > RED ? PIPE : RED];

  const int tid = threadIdx.x;
  const int kg = tid / GROUP;
  const int g = tid - kg * GROUP;
  const int rt = g / CT, ct = g - (g / CT) * CT;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  auto load_stage = [&](int buf, int kt) {
    T* xs = reinterpret_cast<T*>(smem + buf * STAGE);
    int8_t* ws = reinterpret_cast<int8_t*>(smem + buf * STAGE + X_BYTES);
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK / XC; i += kThreads) {
      const int r = i / (BK / XC), c = (i - r * (BK / XC)) * XC;
      const int gm = m0 + r, gk = k0 + c;
      if (vec) {
        const bool ok = gm < M && gk < K;
        cp_async<16>(xs + r * BK + c, ok ? x + (long)gm * K + gk : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < XC; ++e)
          xs[r * BK + c + e] = (gm < M && gk + e < K)
                                   ? x[(long)gm * K + gk + e] : zero_of<T>();
      }
    }
    for (int i = tid; i < BK * BN / WC; i += kThreads) {
      const int r = i / (BN / WC), c = (i - r * (BN / WC)) * WC;
      const int gk = k0 + r, gn = n0 + c;
      if (vec) {
        const bool ok = gk < K && gn < N;
        cp_async<WC>(ws + r * BN + c, ok ? w + (long)gk * N + gn : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < WC; ++e)
          ws[r * BN + c + e] =
              (gk < K && gn + e < N) ? w[(long)gk * N + gn + e] : int8_t(0);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    cp_commit();
    const int buf = kt % kStages;
    const T* xs = reinterpret_cast<const T*>(smem + buf * STAGE);
    const int8_t* ws =
        reinterpret_cast<const int8_t*>(smem + buf * STAGE + X_BYTES);
#pragma unroll 4
    for (int kk = kg; kk < BK; kk += KG) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f(xs[(rt * TM + i) * BK + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = static_cast<float>(ws[kk * BN + ct * TN + j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  if constexpr (KG == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + rt * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + ct * TN + j;
        if (r < M && c < N) out[(long)r * N + c] = acc[i][j] * scale[c];
      }
    }
  } else {
    cp_wait<0>();
    __syncthreads();              // the pipeline buffers become the sums
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[(kg * BM + rt * TM + i) * BN + ct * TN + j] = acc[i][j];
    __syncthreads();
    for (int o = tid; o < BM * BN; o += kThreads) {
      const int r = o / BN, c = o - (o / BN) * BN;
      float s = 0.f;
      for (int q = 0; q < KG; ++q) s += red[q * BM * BN + o];
      const int gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N) out[(long)gr * N + gc] = s * scale[gc];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, const float* scale, float* out,
           int M, int N, int K, cudaStream_t st) {
  constexpr int WC = BN < 16 ? BN : 16;
  const int vec = K % (16 / (int)sizeof(T)) == 0 && N % WC == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, out, M,
      N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(int tile, const void* x, const void* w, const float* scale,
                float* out, int M, int N, int K, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<T, 64, 64, 32, 4, 4>(x, w, scale, out, M, N, K, st);
    case 1: return launch<T, 32, 32, 32, 2, 2>(x, w, scale, out, M, N, K, st);
    case 2: return launch<T, 8, 16, 256, 8, 2>(x, w, scale, out, M, N, K, st);
    case 3: return launch<T, 8, 8, 256, 8, 1>(x, w, scale, out, M, N, K, st);
    case 4: return launch<T, 8, 4, 256, 8, 1>(x, w, scale, out, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x).  tile: index into the wrapper's
// TILES = (64x64, 32x32, 8x16, 8x8, 8x4).  Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int quant_matmul_launch(int dtype, int tile, const void* x,
                                   const void* w, const float* scale,
                                   float* out, int M, int N, int K,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_tile<float>(tile, x, w, scale, out, M, N, K, st);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(tile, x, w, scale, out, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
