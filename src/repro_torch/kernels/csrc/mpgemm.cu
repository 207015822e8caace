// Dataflow-scheduled GEMM for Hopper (sm_90a): C = A . B, fp32 accumulate.
//
// Replaces the Pallas kernel repro/kernels/mpgemm.py: mpgemm with the fused
// epilogue -- _os_kernel (OS), _os_fold_fused_kernel (OS with k_fold) and
// _ws_is_fused_kernel (WS and IS).
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

// OS: grid (gn, gm); output C (M, N) in TO, contiguous.
template <typename T, typename TO, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mpgemm_os(const T* __restrict__ A, long sam, long sak,
          const T* __restrict__ B, long sbk, long sbn, TO* __restrict__ C,
          int M, int N, int K, int bk, int f) {
  __shared__ float As[BM * (kStep + 1)];
  __shared__ float Bs[kStep * (BN + 1)];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gkf = (K + bk - 1) / bk / f;
  float acc[BM / 16][BN / 16];
  zero<BM, BN>(acc);
  for (int fi = 0; fi < f; ++fi) {
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

// WS: grid (gn, chunks); each CTA owns one column of B tiles and `per`
// consecutive M tiles.  Output C (M, N) fp32.
template <typename T, int BM, int BN>
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
      const int kb = (fi * gkf + k) * bk;
      const bool first = fi == 0 && k == 0;
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
        accumulate<BM, BN>(C, M, N, mt * BM, n0, first, acc);
      }
    }
  }
}

// IS: grid (gm, chunks); each CTA owns one row of A tiles and `per`
// consecutive N tiles.  Output C (M, N) fp32.
template <typename T, int BM, int BN>
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
      const int kb = (fi * gkf + k) * bk;
      const bool first = fi == 0 && k == 0;
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
        accumulate<BM, BN>(C, M, N, m0, nt * BN, first, acc);
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

template <typename T, int BM, int BN>
int launch(int dataflow, int out_f32, const void* A, long sam, long sak,
           const void* B, long sbk, long sbn, void* C, int M, int N, int K,
           int bk, int f, int per, cudaStream_t st) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (dataflow == 0) {
    const dim3 grid(gn, gm);
    if (out_f32) {
      mpgemm_os<T, float, BM, BN><<<grid, kThreads, 0, st>>>(
          a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f);
    } else {
      mpgemm_os<T, T, BM, BN><<<grid, kThreads, 0, st>>>(
          a, sam, sak, b, sbk, sbn, static_cast<T*>(C), M, N, K, bk, f);
    }
  } else if (dataflow == 1) {
    const size_t smem =
        sizeof(float) * ((size_t)bk * (BN + 1) + (size_t)BM * (kStep + 1));
    const cudaError_t e = allow_smem(&mpgemm_ws<T, BM, BN>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(gn, (gm + per - 1) / per);
    mpgemm_ws<T, BM, BN><<<grid, kThreads, smem, st>>>(
        a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f,
        per);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)BM * (bk + 1) + (size_t)kStep * (BN + 1));
    const cudaError_t e = allow_smem(&mpgemm_is<T, BM, BN>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(gm, (gn + per - 1) / per);
    mpgemm_is<T, BM, BN><<<grid, kThreads, smem, st>>>(
        a, sam, sak, b, sbk, sbn, static_cast<float*>(C), M, N, K, bk, f,
        per);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_dtype(int dtype, int dataflow, int out_f32, const void* A,
                 long sam, long sak, const void* B, long sbk, long sbn,
                 void* C, int M, int N, int K, int bk, int f, int per,
                 cudaStream_t st) {
  if (dtype == 0)
    return launch<float, BM, BN>(dataflow, out_f32, A, sam, sak, B, sbk, sbn,
                                 C, M, N, K, bk, f, per, st);
  return launch<__nv_bfloat16, BM, BN>(dataflow, out_f32, A, sam, sak, B,
                                       sbk, sbn, C, M, N, K, bk, f, per, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk % kStep != 0 || f < 1 || ((K + bk - 1) / bk) % f != 0 || per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16 && bn == 64)
    return launch_dtype<16, 64>(dtype, dataflow, out_f32, A, sam, sak, B, sbk,
                                sbn, C, M, N, K, bk, f, per, st);
  if (bm == 64 && bn == 64)
    return launch_dtype<64, 64>(dtype, dataflow, out_f32, A, sam, sak, B, sbk,
                                sbn, C, M, N, K, bk, f, per, st);
  if (bm == 128 && bn == 128)
    return launch_dtype<128, 128>(dtype, dataflow, out_f32, A, sam, sak, B,
                                  sbk, sbn, C, M, N, K, bk, f, per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
