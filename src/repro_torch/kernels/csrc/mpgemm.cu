// Dataflow-scheduled GEMM for Hopper (sm_90a): C = A . B, fp32 accumulate.
//
// Replaces the Pallas kernels of repro/kernels/mpgemm.py: mpgemm with the
// fused epilogue (K2) -- _os_kernel (OS), _os_fold_fused_kernel (OS with
// k_fold) and _ws_is_fused_kernel (WS and IS) -- and with the spill
// epilogue (K6) -- _partial_kernel (WS and IS) and _os_fold_spill_kernel
// (OS with k_fold), the partial-plane baseline the fused epilogue is
// measured against (see "Spill epilogue" below).
//
// What it computes: A (M, K) times B (K, N), both in T (float or bf16)
// with arbitrary strides, summed in fp32 over K blocks of bk elements that
// are grouped into f fold bands.  OS casts the resident accumulator to the
// output type once; WS and IS add each (band, k) partial product into an
// fp32 output buffer that the caller allocates and casts.
//
// What bounds it on this card: at decode sizes (M = 8 rows) bytes -- the
// weight matrix is read once and every weight element meets only M rows,
// far below the ~295 flop/byte bf16 ridge (the 151936 x 896 bf16 LM head
// alone is 272 MB, about 81 us at 3.35 TB/s).  At prefill-chunk sizes
// (M = 256) the products approach the ridge, where this kernel's CUDA-core
// FMAs (67 TFLOP/s fp32 peak, no tensor cores yet) become the limit.
//
// Design: 256 threads per CTA, each owning a (BM/16) x (BN/16) block of
// the output tile in registers; operands are staged in shared memory as
// fp32 in KSTEP-wide K slices (rows padded by one float, so the strided
// loads of a transposed operand do not conflict on banks), with loads
// walking each operand's contiguous dimension and issued eight at a time
// per thread before any is stored, so that a slice costs about one memory
// round trip.  Edges are masked with
// zero fill, so any M, N, K is taken without padding copies.  Every output
// tile has exactly one owner CTA and no atomics are used, so the order of
// the fp32 sums is fixed and a run is bit-reproducible.
//   OS: one CTA per (m, n) tile, looping over the f bands and the k steps
//       inside each band with the accumulator in registers.
//   WS: a CTA holds the bk x BN B tile of one (band, k) step in shared
//       memory while it streams its chunk of M tiles past it (loop order:
//       (band, k) outer, m inner), read-modify-writing the fp32 output.
//   IS: the same with the BM x bk A tile stationary and N tiles streamed.
// WS/IS split the streamed dimension into chunks over the grid (the
// caller passes the chunk length), so that about two waves of CTAs are in
// flight even when the stationary dimension is a single tile -- the LM
// head (M = 8, N = 151936) under IS.  fp32 stays true fp32 (FMA on CUDA
// cores, never TF32).  Tensor cores (wgmma), TMA and warp specialisation
// are later work.
//
// Spill epilogue (K6, mpgemm_spill_launch): the same kernels, instantiated
// with kSpill, store partial tiles into an fp32 plane tensor P (planes, M,
// N) instead of reducing them; the caller sums the planes afterwards.
//   WS/IS: one plane per K block (planes = ceil(K / bk); the fold is
//       ignored, as in the reference).  Where the fused kernel adds a
//       (k, tile) partial into C, the spill kernel stores it into plane k:
//       a plain store, no read-modify-write and no zero fill, and every
//       (k, m-tile, n-tile) of every plane has exactly one owner CTA.
//   OS with f > 1 bands: the bands are independent, so they go on the
//       grid, (gn, gm, f): one CTA per (tile, band) accumulates its band's
//       ceil(K / bk) / f steps in registers and stores plane fi.
// What bounds it: bytes.  Every plane is written once, planes x M x N x 4
// bytes (the down projection at 256 rows under WS, bk = 32: 152 planes,
// 139 MB, about 42 us at 3.35 TB/s, against 2.2 GFLOP of products), and
// the reduction reads them back.  Plane offsets are 64-bit: planes x M x
// N passes 2^31 at the LM head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kStep = 32;      // K slice staged per pass (tiling.KSTEP)
constexpr int kBatch = 8;      // loads each thread keeps in flight

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

// Stage the R x C window at (r0, c0) of a strided rows x cols matrix into
// shared memory (leading dimension ld), zero-filling what lies outside.
// Consecutive threads walk the source's contiguous dimension, and each
// thread issues kBatch loads before it stores any, so that many requests
// are in flight at once (the small-M decode GEMMs are latency-bound).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, long s_r,
                                      long s_c, int r0, int c0, int R, int C,
                                      int rows, int cols) {
  const bool c_fast = s_c == 1;
  const int n = R * C;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = c_fast ? i / C : i % R;
      const int c = c_fast ? i % C : i / R;
      const int gr = r0 + r, gc = c0 + c;
      v[u] = (i < n && gr < rows && gc < cols)
                 ? to_f(src[gr * s_r + gc * s_c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = c_fast ? i / C : i % R;
        const int c = c_fast ? i % C : i / R;
        dst[r * ld + c] = v[u];
      }
    }
  }
}

// acc += As[BM x steps] . Bs[steps x BN] for this thread's outputs
// (rows ty + 16 i, columns tx + 16 j).
template <int BM, int BN>
__device__ __forceinline__ void fma_tile(float (&acc)[BM / 16][BN / 16],
                                         const float* As, int lda,
                                         const float* Bs, int ldb,
                                         int steps) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < steps; ++kk) {
    float a[BM / 16], b[BN / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) a[i] = As[(ty + 16 * i) * lda + kk];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) b[j] = Bs[kk * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BM, int BN>
__device__ __forceinline__ void zero(float (&acc)[BM / 16][BN / 16]) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
}

// Add (or, on the first visit, store) a partial tile into the fp32 output.
template <int BM, int BN>
__device__ __forceinline__ void accumulate(float* C, int M, int N, int m0,
                                           int n0, bool first,
                                           const float (&acc)[BM / 16][BN / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        float* p = C + (long)r * N + c;
        *p = first ? acc[i][j] : *p + acc[i][j];
      }
    }
  }
}

// Store a tile into C (M, N) in TO, contiguous (no read: OS's flush and
// every store of the spill epilogue).
template <typename TO, int BM, int BN>
__device__ __forceinline__ void store_tile(TO* C, int M, int N, int m0, int n0,
                                           const float (&acc)[BM / 16][BN / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) C[(long)r * N + c] = from_f<TO>(acc[i][j]);
    }
  }
}

// OS: grid (gn, gm); output C (M, N) in TO, contiguous.  With kSpill
// (grid (gn, gm, f)) the CTA walks only band blockIdx.z and stores it into
// plane blockIdx.z of C (f, M, N), fp32.
template <typename T, typename TO, int BM, int BN, bool kSpill>
__global__ void __launch_bounds__(kThreads)
mpgemm_os(const T* __restrict__ A, long sam, long sak,
          const T* __restrict__ B, long sbk, long sbn, TO* __restrict__ C,
          int M, int N, int K, int bk, int f) {
  __shared__ float As[BM * (kStep + 1)];
  __shared__ float Bs[kStep * (BN + 1)];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gkf = (K + bk - 1) / bk / f;
  const int f0 = kSpill ? blockIdx.z : 0, f1 = kSpill ? f0 + 1 : f;
  float acc[BM / 16][BN / 16];
  zero<BM, BN>(acc);
  for (int fi = f0; fi < f1; ++fi) {
    for (int k = 0; k < gkf; ++k) {
      const int kb = (fi * gkf + k) * bk;
      for (int s = 0; s < bk; s += kStep) {
        stage(As, kStep + 1, A, sam, sak, m0, kb + s, BM, kStep, M, K);
        stage(Bs, BN + 1, B, sbk, sbn, kb + s, n0, kStep, BN, K, N);
        __syncthreads();
        fma_tile<BM, BN>(acc, As, kStep + 1, Bs, BN + 1, kStep);
        __syncthreads();
      }
    }
  }
  store_tile<TO, BM, BN>(C + (kSpill ? (long)f0 * M * N : 0L), M, N, m0, n0,
                         acc);
}

// Hand a (k, tile) partial to the output: added into C (M, N) (stored on
// the first visit), or with kSpill stored into plane kg of C (gk, M, N).
template <int BM, int BN, bool kSpill>
__device__ __forceinline__ void emit(float* C, int M, int N, int m0, int n0,
                                     int kg, const float (&acc)[BM / 16][BN / 16]) {
  if constexpr (kSpill)
    store_tile<float, BM, BN>(C + (long)kg * M * N, M, N, m0, n0, acc);
  else
    accumulate<BM, BN>(C, M, N, m0, n0, kg == 0, acc);
}

// WS: grid (gn, chunks); each CTA owns one column of B tiles and `per`
// consecutive M tiles.  Output C (M, N) fp32, or planes with kSpill.
template <typename T, int BM, int BN, bool kSpill>
__global__ void __launch_bounds__(kThreads)
mpgemm_ws(const T* __restrict__ A, long sam, long sak,
          const T* __restrict__ B, long sbk, long sbn, float* C, int M,
          int N, int K, int bk, int f, int per) {
  extern __shared__ float smem[];
  float* Bs = smem;                    // bk x (BN + 1), stationary
  float* As = smem + bk * (BN + 1);    // BM x (kStep + 1), streamed
  const int n0 = blockIdx.x * BN;
  const int gm = (M + BM - 1) / BM;
  const int t0 = blockIdx.y * per;
  const int t1 = min(gm, t0 + per);
  const int gkf = (K + bk - 1) / bk / f;
  float acc[BM / 16][BN / 16];
  for (int fi = 0; fi < f; ++fi) {
    for (int k = 0; k < gkf; ++k) {
      const int kg = fi * gkf + k, kb = kg * bk;
      stage(Bs, BN + 1, B, sbk, sbn, kb, n0, bk, BN, K, N);
      __syncthreads();
      for (int mt = t0; mt < t1; ++mt) {
        zero<BM, BN>(acc);
        for (int s = 0; s < bk; s += kStep) {
          stage(As, kStep + 1, A, sam, sak, mt * BM, kb + s, BM, kStep, M, K);
          __syncthreads();
          fma_tile<BM, BN>(acc, As, kStep + 1, Bs + s * (BN + 1), BN + 1,
                           kStep);
          __syncthreads();
        }
        emit<BM, BN, kSpill>(C, M, N, mt * BM, n0, kg, acc);
      }
    }
  }
}

// IS: grid (gm, chunks); each CTA owns one row of A tiles and `per`
// consecutive N tiles.  Output C (M, N) fp32, or planes with kSpill.
template <typename T, int BM, int BN, bool kSpill>
__global__ void __launch_bounds__(kThreads)
mpgemm_is(const T* __restrict__ A, long sam, long sak,
          const T* __restrict__ B, long sbk, long sbn, float* C, int M,
          int N, int K, int bk, int f, int per) {
  extern __shared__ float smem[];
  float* As = smem;                    // BM x (bk + 1), stationary
  float* Bs = smem + BM * (bk + 1);    // kStep x (BN + 1), streamed
  const int m0 = blockIdx.x * BM;
  const int gn = (N + BN - 1) / BN;
  const int t0 = blockIdx.y * per;
  const int t1 = min(gn, t0 + per);
  const int gkf = (K + bk - 1) / bk / f;
  float acc[BM / 16][BN / 16];
  for (int fi = 0; fi < f; ++fi) {
    for (int k = 0; k < gkf; ++k) {
      const int kg = fi * gkf + k, kb = kg * bk;
      stage(As, bk + 1, A, sam, sak, m0, kb, BM, bk, M, K);
      __syncthreads();
      for (int nt = t0; nt < t1; ++nt) {
        zero<BM, BN>(acc);
        for (int s = 0; s < bk; s += kStep) {
          stage(Bs, BN + 1, B, sbk, sbn, kb + s, nt * BN, kStep, BN, K, N);
          __syncthreads();
          fma_tile<BM, BN>(acc, As + s, bk + 1, Bs, BN + 1, kStep);
          __syncthreads();
        }
        emit<BM, BN, kSpill>(C, M, N, m0, nt * BN, kg, acc);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// With kSpill, C is the fp32 plane tensor: (f, M, N) for OS, (gk, M, N)
// for WS/IS (which the caller launches with f = 1).
template <typename T, int BM, int BN, bool kSpill>
int launch(int dataflow, int out_f32, const void* A, long sam, long sak,
           const void* B, long sbk, long sbn, void* C, int M, int N, int K,
           int bk, int f, int per, cudaStream_t st) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (dataflow == 0) {
    const dim3 grid(gn, gm, kSpill ? f : 1);
    if (out_f32 || kSpill) {
      mpgemm_os<T, float, BM, BN, kSpill><<<grid, kThreads, 0, st>>>(
          a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f);
    } else {
      mpgemm_os<T, T, BM, BN, false><<<grid, kThreads, 0, st>>>(
          a, sam, sak, b, sbk, sbn, static_cast<T*>(C), M, N, K, bk, f);
    }
  } else if (dataflow == 1) {
    const size_t smem =
        sizeof(float) * ((size_t)bk * (BN + 1) + (size_t)BM * (kStep + 1));
    const cudaError_t e = allow_smem(&mpgemm_ws<T, BM, BN, kSpill>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(gn, (gm + per - 1) / per);
    mpgemm_ws<T, BM, BN, kSpill><<<grid, kThreads, smem, st>>>(
        a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f,
        per);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)BM * (bk + 1) + (size_t)kStep * (BN + 1));
    const cudaError_t e = allow_smem(&mpgemm_is<T, BM, BN, kSpill>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(gm, (gn + per - 1) / per);
    mpgemm_is<T, BM, BN, kSpill><<<grid, kThreads, smem, st>>>(
        a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f,
        per);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kSpill>
int launch_tile(int bm, int bn, int dtype, int dataflow, int out_f32,
                const void* A, long sam, long sak, const void* B, long sbk,
                long sbn, void* C, int M, int N, int K, int bk, int f,
                int per, cudaStream_t st) {
  if (bk % kStep != 0 || f < 1 || ((K + bk - 1) / bk) % f != 0 || per < 1 ||
      dataflow < 0 || dataflow > 2 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MPGEMM_TILE(BM, BN)                                                   \
  if (bm == BM && bn == BN)                                                   \
    return dtype == 0                                                         \
               ? launch<float, BM, BN, kSpill>(dataflow, out_f32, A, sam, sak,  \
                                               B, sbk, sbn, C, M, N, K, bk,    \
                                               f, per, st)                     \
               : launch<__nv_bfloat16, BM, BN, kSpill>(                        \
                     dataflow, out_f32, A, sam, sak, B, sbk, sbn, C, M, N, K,  \
                     bk, f, per, st);
  MPGEMM_TILE(16, 64)
  MPGEMM_TILE(64, 64)
  MPGEMM_TILE(128, 128)
#undef MPGEMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dataflow: 0 = OS, 1 = WS, 2 = IS.  dtype: 0 = float32, 1 = bfloat16.
// OS writes C in the operand type, or in fp32 when out_f32 is set; WS and
// IS always write fp32.  bk must be a multiple of 32 and f must divide
// ceil(K / bk); per is the streamed-tile chunk of a WS/IS CTA.  Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int mpgemm_launch(int dataflow, int dtype, int out_f32, int bm,
                             int bn, const void* A, long sam, long sak,
                             const void* B, long sbk, long sbn, void* C,
                             int M, int N, int K, int bk, int f, int per,
                             void* stream) {
  return launch_tile<false>(bm, bn, dtype, dataflow, out_f32, A, sam, sak, B,
                            sbk, sbn, C, M, N, K, bk, f, per,
                            static_cast<cudaStream_t>(stream));
}

// The spill epilogue (K6): P is the fp32 plane tensor, (f, M, N) for OS
// (f must divide ceil(K / bk)) and (ceil(K / bk), M, N) for WS and IS,
// which ignore f.  Other arguments as mpgemm_launch.
extern "C" int mpgemm_spill_launch(int dataflow, int dtype, int bm, int bn,
                                   const void* A, long sam, long sak,
                                   const void* B, long sbk, long sbn, void* P,
                                   int M, int N, int K, int bk, int f,
                                   int per, void* stream) {
  return launch_tile<true>(bm, bn, dtype, dataflow, 1, A, sam, sak, B, sbk,
                           sbn, P, M, N, K, bk, dataflow == 0 ? f : 1, per,
                           static_cast<cudaStream_t>(stream));
}
