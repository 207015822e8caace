// Dataflow-scheduled GEMM for Hopper (sm_90a): C = A . B, fp32 accumulate.
//
// Replaces the Pallas kernels of repro/kernels/mpgemm.py: mpgemm with the
// fused epilogue (K2) -- _os_kernel (OS), _os_fold_fused_kernel (OS with
// k_fold) and _ws_is_fused_kernel (WS and IS) -- and with the spill
// epilogue (K6) -- _partial_kernel (WS and IS) and _os_fold_spill_kernel
// (OS with k_fold), the partial-plane baseline the fused epilogue is
// measured against.
//
// What it computes: A (M, K) times B (K, N), summed in fp32 over K blocks
// of bk elements that are grouped into f fold bands; the fused epilogue
// writes C once, the spill epilogue (K6) writes fp32 planes instead: one
// per K block under WS/IS ((ceil(K / bk), M, N), the fold ignored, as in
// the reference) and one per fold band under OS with f > 1 ((f, M, N)).
// Plane offsets are 64-bit: planes x M x N passes 2^31 at the LM head.
//
// Two routes, chosen by one rule (kernels/mpgemm.py: mpgemm_route):
//
//  * The Hopper route (mpgemm_hopper_launch) takes bf16 operands that TMA
//    can describe: A with K contiguous, B with K or N contiguous, the other
//    stride x 2 bytes a multiple of 16, bases 16-byte aligned -- and a K
//    block of whole 64-element ring stages (bk a multiple of 64).
//  * The CUDA-core route (mpgemm_launch / mpgemm_spill_launch, below)
//    takes everything else: fp32 operands, which stay IEEE fp32 (FMA on
//    CUDA cores, never TF32), and bf16 operands whose layout TMA refuses.
//
// What bounds each regime on this card, and what the Hopper route does:
//
//  * Decode (M <= 64 rows): bytes.  Every weight element meets only M
//    rows, far below the ~295 flop/byte bf16 ridge (the 151936 x 896 LM
//    head is 272 MB, 81 us at 3.35 TB/s).  The kernel swaps the operands
//    and computes the C^T tile: 64 weight rows (N) fill wgmma's M = 64 and
//    the M activation rows its n = 8..64, so no tensor-core row is padding.
//    TMA keeps up to 8 stages of weight tiles in flight per CTA (a 72 KB
//    ring, so that three CTAs share an SM).  Where the
//    output has few tiles (q/o/down at M = 8: 14 of 64 columns), the K
//    blocks are split over a cluster (below) so that about 132 CTAs read
//    the weight at once.
//  * Prefill chunks (M = 256 .. 2048): operations.  bf16 wgmma
//    (m64n128k16 or m64n256k16, two consumer warpgroups, a 128 x 128 or
//    128 x 256 tile) fed by TMA through a 4-stage ring.
//
// Design of the Hopper kernel (one template, mpgemm_hopper):
//
//   Ring.  One producer warp issues TMA 2-D tiled loads (128-byte swizzle,
//   64 K elements = one 128-byte row a stage) into a ring of shared-memory
//   stages; "full" mbarriers count the bytes in, "empty" mbarriers count
//   the consumer warpgroups out.  Consumers issue wgmma.mma_async from
//   shared memory; the fp32 accumulator stays in registers over the CTA's
//   whole K range.  A K-contiguous operand is a K-major wgmma operand; an
//   N-contiguous weight (K, N), or its transpose under the swap, is an
//   MN-major one (wgmma's transpose bit for 16-bit types), so the tied
//   head's emb.t() (strides (1, 896)) and a (K, N) weight are both read
//   where they lie, without a copy.  TMA zero-fills past the edges, so any
//   M, N, K is taken without padding copies.
//
//   Fold bands on a cluster (OS).  The CTA's K range is a list of units:
//   the f fold bands when f > 1, else c consecutive runs of whole bk
//   blocks, c chosen so the tiles x c CTAs about fill the 132 SMs
//   (tiling.hopper_launch).  Cluster rank r walks units r, r + c, ... in
//   order.  The ranks' accumulators are then summed through distributed
//   shared memory in rank order into rank 0, which casts and stores: no
//   global workspace, no atomics, no second launch -- partial sums never
//   reach device memory (GTA's fused reduction on this card).
//
//   Stationarity (WS / IS).  Every CTA owns its output tile over all of K
//   and writes it once, in the output type: no fp32 read-modify-write and
//   no cast launch.  The stationary operand is shared by a cluster of 2
//   CTAs along the streamed dimension and TMA-multicast to both (WS: the B
//   tile, to CTAs along M; IS: the A tile, to CTAs along N).  When the
//   streamed dimension has one tile (WS at M = 8: one 8-row tile) the
//   cluster along it has size 1.  The grid is padded to a whole number of
//   clusters; a padding CTA repeats the last tile and stores nothing.
//
//   Spill (K6, kSpill).  The same kernel: WS/IS store the accumulator to
//   plane kg after each K block and zero it; OS with f > 1 puts one band
//   on each CTA (no cluster) and stores its sum to plane fi.
//
//   Order.  Every output element's fp32 sum is taken in a fixed order (K
//   order within a unit, units in rank order), with no atomics, so a run
//   is bit-reproducible.  The order differs from the plain version's (one
//   fp32 sum per K block, then the blocks in K order) by rounding only.
//
// The CUDA-core route (unchanged): 256 threads per CTA, each owning a
// (BM/16) x (BN/16) block of the output tile in registers; operands are
// staged in shared memory as fp32 in KSTEP-wide K slices (rows padded by
// one float, so the strided loads of a transposed operand do not conflict
// on banks), with loads walking each operand's contiguous dimension and
// issued eight at a time per thread before any is stored.  Edges are
// masked with zero fill.
//   OS: one CTA per (m, n) tile, looping over the f bands and the k steps
//       inside each band with the accumulator in registers.
//   WS: a CTA holds the bk x BN B tile of one (band, k) step in shared
//       memory while it streams its chunk of M tiles past it, read-modify-
//       writing the fp32 output (the caller casts it).
//   IS: the same with the BM x bk A tile stationary and N tiles streamed.
// WS/IS split the streamed dimension into chunks over the grid (the
// caller passes the chunk length).  Spill: WS/IS store each (k, tile)
// partial into plane k; OS with f bands puts the bands on the grid,
// (gn, gm, f), and stores plane fi.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The Hopper route: bf16 wgmma fed by TMA (helpers in hopper.cuh)
// ---------------------------------------------------------------------------

namespace {
namespace hop {

// Launch geometry, computed by the caller (tiling.hopper_launch).
struct Geo {
  int M, N, K;
  int bk, gk;            // K block and ceil(K / bk)
  int tiles_p, tiles_q;  // real tiles; the grid may be padded to clusters
  int units, zsplit;     // K units (bands / runs / planes) and the ranks
                         // (gridDim.z) walking them: rank z takes units
                         // z, z + zsplit, ...
  int mc, csize;         // multicast cluster: 0 none, 1 along p (the Q
                         // tile shared), 2 along q (the P tile shared)
};

// First K block of unit u: the units cut the gk blocks into runs of whole
// blocks, unit u starting at block u gk / units.
__device__ __forceinline__ int unit_block(int u, const Geo& g) {
  return static_cast<int>(static_cast<long long>(u) * g.gk / g.units);
}

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Store a consumer thread's accumulator fragment of the (64 x
// warpgroups) x TQ tile at (p0, q0) into C (M, N), contiguous; under the
// swap the tile is C^T (p runs over N, q over M).  Fragment of m64nNk16:
// register 4j + 2h + e holds row 16 warp + lane / 4 + 8 h, column 8 j +
// 2 (lane % 4) + e.
template <typename TO, int NR, bool kSwap>
__device__ __forceinline__ void store_acc(TO* __restrict__ C,
                                          const float (&acc)[NR], int p0,
                                          int q0, int M, int N) {
  const int t = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int lane = t & 31, warp = t >> 5;
  const int pr = p0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool pairs = !kSwap && (N % 2 == 0);
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pr + 8 * h;
      const int q = q0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (kSwap) {
        if (p < N) {
          if (q < M) C[static_cast<long>(q) * N + p] = cvt<TO>(v0);
          if (q + 1 < M) C[static_cast<long>(q + 1) * N + p] = cvt<TO>(v1);
        }
      } else if (p < M) {
        TO* row = C + static_cast<long>(p) * N;
        if (pairs && q + 1 < N) {
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(row + q) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(row + q) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (q < N) row[q] = cvt<TO>(v0);
          if (q + 1 < N) row[q + 1] = cvt<TO>(v1);
        }
      }
    }
  }
}

template <int TP, int TQ>
struct Shape {
  static constexpr bool kSwap = TP == 64;    // P = B^T, Q = A^T: C^T tile
  static constexpr int kWG = TP / 64;        // consumer warpgroups
  static constexpr int kConsumers = kWG * 128;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr int kStage = (TP + TQ) * kRowBytes;
  // a 72 KB ring for the swapped tiles (8 stages at n = 8 .. 4 at n = 64,
  // three CTAs an SM), 4 stages for the 128-row tiles
  static constexpr int kRing = 72 * 1024 / kStage;
  static constexpr int kStages =
      !kSwap ? 4 : (kRing < 4 ? 4 : (kRing > 8 ? 8 : kRing));
  static constexpr int kBarOffset = kStages * kStage;
  static constexpr int kRedOffset = kBarOffset + 256;
  // one fp32 tile for the DSMEM reduction, where it fits beside the ring
  // (128 x 256 has no room: the caller never splits its K)
  static constexpr int kRedBytes =
      1024 + kRedOffset + TP * TQ * 4 <= 232448 ? TP * TQ * 4 : 0;
  // dynamic shared memory: 1024 B of alignment slack, the ring, the
  // barriers, and (K split over a cluster) the tile DSMEM reduces
  static constexpr int smem(bool red) {
    return 1024 + kRedOffset + (red ? kRedBytes : 0);
  }
};

// C = A . B on the Hopper route.  P (TP rows) and Q (TQ columns) are the
// wgmma A and B operands: (A, B) normally, (B^T, A^T) under the swap.
// kBK: B has K contiguous.  Grid (grid_p, grid_q, zsplit).
template <int TP, int TQ, bool kBK, bool kSpill, typename TO>
__global__ void __launch_bounds__(Shape<TP, TQ>::kThreads, 1)
mpgemm_hopper(const __grid_constant__ CUtensorMap tmP,
              const __grid_constant__ CUtensorMap tmQ, TO* __restrict__ C,
              const Geo g) {
  using S = Shape<TP, TQ>;
  constexpr bool kSwap = S::kSwap;
  constexpr bool kPK = kSwap ? kBK : true;   // A has K contiguous
  constexpr bool kQK = kSwap ? true : kBK;
  constexpr int NR = TQ / 2;                 // accumulator registers
  constexpr int P_BYTES = TP * kRowBytes;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* empty = full + S::kStages;
  float* red = reinterpret_cast<float*>(smem + S::kRedOffset);

  const int tid = threadIdx.x;
  const bool kcl = !kSpill && g.zsplit > 1;      // K split on a cluster
  const int csize = g.mc ? g.csize : (kcl ? g.zsplit : 1);
  const uint32_t rank = csize > 1 ? cluster_rank() : 0;
  const bool valid = static_cast<int>(blockIdx.x) < g.tiles_p &&
                     static_cast<int>(blockIdx.y) < g.tiles_q;
  const int p0 = min(static_cast<int>(blockIdx.x), g.tiles_p - 1) * TP;
  const int q0 = min(static_cast<int>(blockIdx.y), g.tiles_q - 1) * TQ;
  const int z = blockIdx.z;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kWG * (g.mc ? g.csize : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (csize > 1) cluster_sync(); else __syncthreads();

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  // the role is a function of the warp, made visibly warp-uniform so that
  // ptxas does not serialize the wgmmas of a "divergent" path
  const int warp = __shfl_sync(0xffffffff, tid / 32, 0);
  if (warp >= S::kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (tid == S::kConsumers) {
      const uint16_t mask = static_cast<uint16_t>((1u << g.csize) - 1);
      const bool own_p = g.mc != 2 || rank == 0;
      const bool own_q = g.mc != 1 || rank == 0;
      int stage = 0, phase = 0;
      for (int u = z; u < g.units; u += g.zsplit) {
        const int k0 = unit_block(u, g) * g.bk;
        const int k1 = min(unit_block(u + 1, g) * g.bk, g.K);
        for (int k = k0; k < k1; k += kBoxK) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], S::kStage);
          const uint32_t sp = smem_u32(smem + stage * S::kStage);
          if (own_p)
            load_tile<kPK, TP>(sp, &tmP, &full[stage], k, p0,
                               g.mc == 2 ? mask : 0);
          if (own_q)
            load_tile<kQK, TQ>(sp + P_BYTES, &tmQ, &full[stage], k, q0,
                               g.mc == 1 ? mask : 0);
          if (++stage == S::kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns P rows [64 wg, 64 wg + 64).  Every
    // stage is four whole k16 steps (the route takes bk a multiple of 64,
    // and TMA zero-fills past K), so no wgmma sits on a conditional path
    // (ptxas would serialize them).  One wgmma group stays in flight: a
    // stage is released when the next stage's group has been issued.
    const int wg = warp / 4;
    const bool lead = (tid & 127) == 0;
    int stage = 0, phase = 0, held = -1;
    auto release = [&](int st) {
      if (lead) {
        if (g.mc) {
          for (int r = 0; r < g.csize; ++r) mbar_arrive_remote(&empty[st], r);
        } else {
          mbar_arrive(&empty[st]);
        }
      }
    };
    for (int u = z; u < g.units; u += g.zsplit) {
      const int k0 = unit_block(u, g) * g.bk;
      const int k1 = min(unit_block(u + 1, g) * g.bk, g.K);
      for (int k = k0; k < k1; k += kBoxK) {
        mbar_wait(&full[stage], phase);
        const uint32_t sp = smem_u32(smem + stage * S::kStage) + wg * kAtom;
        const uint32_t sq = smem_u32(smem + stage * S::kStage) + P_BYTES;
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int s = 0; s < kBoxK / 16; ++s)
          Wgmma<TQ>::template mma<kPK ? 0 : 1, kQK ? 0 : 1>(
              acc, gmma_desc<kPK>(sp + kstep_offset<kPK>(s)),
              gmma_desc<kQK>(sq + kstep_offset<kQK>(s)));
        wg_commit();
        wg_wait<1>();
        fence_acc(acc);
        if (held >= 0) release(held);
        held = stage;
        if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      }
      if constexpr (kSpill) {
        wg_wait<0>();
        fence_acc(acc);
        if (held >= 0) release(held);
        held = -1;
        if (valid)
          store_acc<TO, NR, kSwap>(
              C + static_cast<long>(u) * g.M * g.N, acc, p0, q0, g.M, g.N);
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      }
    }
    wg_wait<0>();
    fence_acc(acc);
    if (held >= 0) release(held);
  }

  if constexpr (!kSpill) {
    if (kcl) {
      // the ranks' partial tiles, summed into rank 0 in rank order
      float4* mine = reinterpret_cast<float4*>(red);
      if (tid < S::kConsumers && rank != 0) {
#pragma unroll
        for (int j = 0; j < NR / 4; ++j)
          mine[j * S::kConsumers + tid] = make_float4(
              acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
      cluster_sync();
      if (tid < S::kConsumers && rank == 0) {
        for (int r = 1; r < g.zsplit; ++r) {
#pragma unroll
          for (int j = 0; j < NR / 4; ++j) {
            const float4 v = ld_dsmem_v4(&mine[j * S::kConsumers + tid], r);
            acc[4 * j] += v.x;
            acc[4 * j + 1] += v.y;
            acc[4 * j + 2] += v.z;
            acc[4 * j + 3] += v.w;
          }
        }
        store_acc<TO, NR, kSwap>(C, acc, p0, q0, g.M, g.N);
      }
      cluster_sync();                 // peers stay until rank 0 has read
    } else if (tid < S::kConsumers && valid) {
      store_acc<TO, NR, kSwap>(C, acc, p0, q0, g.M, g.N);
    }
  }
  if (g.mc && csize > 1) cluster_sync();   // peers' remote arrivals land
}

// Tensor map of a rows x K bf16 operand: K contiguous (K-major, box
// {64 K, box_rows}) or rows contiguous (box {64 rows, 64 K}); `stride` is
// the other dimension's stride in elements.
int encode(CUtensorMap* map, const void* ptr, bool kmajor, long rows, long K,
           long stride, int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr,
                   static_cast<uint64_t>(kmajor ? K : rows),
                   static_cast<uint64_t>(kmajor ? rows : K),
                   static_cast<uint64_t>(stride) * 2,
                   static_cast<uint32_t>(kBoxK),
                   static_cast<uint32_t>(kmajor ? box_rows : kBoxK),
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int TP, int TQ, bool kBK, bool kSpill, typename TO>
int launch(const CUtensorMap& mp, const CUtensorMap& mq, void* C, Geo g,
           int grid_p, int grid_q, cudaStream_t st) {
  using S = Shape<TP, TQ>;
  auto kernel = mpgemm_hopper<TP, TQ, kBK, kSpill, TO>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(true));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool kcl = !kSpill && g.zsplit > 1;
  if (kcl && (S::kRedBytes == 0 || g.zsplit > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_p, grid_q, g.zsplit);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::smem(kcl);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = g.mc == 1 ? g.csize : 1;
  at[0].val.clusterDim.y = g.mc == 2 ? g.csize : 1;
  at[0].val.clusterDim.z = kcl ? g.zsplit : 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  TO* c = static_cast<TO*>(C);
  void* args[] = {const_cast<CUtensorMap*>(&mp), const_cast<CUtensorMap*>(&mq),
                  &c, &g};
  const cudaError_t e = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// epi: 0 = fused, C in bf16; 1 = fused, C in fp32; 2 = spill planes (fp32)
template <int TP, int TQ, bool kBK>
int launch_epi(int epi, const CUtensorMap& mp, const CUtensorMap& mq,
               void* C, const Geo& g, int grid_p, int grid_q,
               cudaStream_t st) {
  if (epi == 0)
    return launch<TP, TQ, kBK, false, __nv_bfloat16>(mp, mq, C, g, grid_p,
                                                      grid_q, st);
  if (epi == 1)
    return launch<TP, TQ, kBK, false, float>(mp, mq, C, g, grid_p, grid_q, st);
  return launch<TP, TQ, kBK, true, float>(mp, mq, C, g, grid_p, grid_q, st);
}

}  // namespace hop
}  // namespace

// The Hopper route.  A (M, K) bf16 with K contiguous (row stride sam); B
// (K, N) bf16 with K contiguous (sbk == 1, column stride sbn) or N
// contiguous (sbn == 1, row stride sbk); strides x 2 bytes multiples of
// 16, bases 16-byte aligned, bk a multiple of 64 (kernels/mpgemm.py:
// mpgemm_route).  (bm, bn) is one of tiling.HOPPER_TILES: bm <= 64 swaps
// the operands (tile C^T: 64 rows of N by bm rows of M), bm = 128 is the
// 128 x bn tile.  The
// geometry -- tiles, padded grid, units, zsplit, multicast cluster -- is
// tiling.hopper_launch's.  epi: 0 fused bf16 out, 1 fused fp32 out, 2
// spill planes ((units, M, N) fp32).  Returns 0 when launched, else a
// CUDA error code or 9001 (no tensor-map encoder) / 9100 + CUresult.
extern "C" int mpgemm_hopper_launch(
    int epi, int bm, int bn, const void* A, long sam, const void* B,
    long sbk, long sbn, void* C, int M, int N, int K, int bk, int tiles_p,
    int tiles_q, int grid_p, int grid_q, int units, int zsplit, int mc,
    int csize, void* stream) {
  const bool bkc = sbk == 1;           // B has K contiguous
  const bool swap = bm <= 64;
  const int tp = swap ? bn : bm, tq = swap ? bm : bn;
  if (epi < 0 || epi > 2 || (!bkc && sbn != 1) || bk <= 0 || bk % 64 ||
      units < 1 || zsplit < 1 || csize < 1 || csize > 8 || mc < 0 ||
      mc > 2 || (mc && (mc == 1 ? grid_p : grid_q) % csize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (csize == 1) mc = 0;
  hop::Geo g{M, N, K, bk, (K + bk - 1) / bk, tiles_p, tiles_q,
             units, zsplit, mc, csize};
  CUtensorMap ma, mb;
  int rc = hop::encode(&ma, A, true, M, K, sam, swap ? tq : tp);
  if (rc == 0)
    rc = hop::encode(&mb, B, bkc, N, K, bkc ? sbn : sbk, swap ? tp : tq);
  if (rc != 0) return rc;
  const CUtensorMap& mp = swap ? mb : ma;
  const CUtensorMap& mq = swap ? ma : mb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPGEMM_HOPPER(TP, TQ)                                                 \
  if (tp == TP && tq == TQ)                                                   \
    return bkc ? hop::launch_epi<TP, TQ, true>(epi, mp, mq, C, g, grid_p,     \
                                               grid_q, st)                    \
               : hop::launch_epi<TP, TQ, false>(epi, mp, mq, C, g, grid_p,    \
                                                grid_q, st);
  MPGEMM_HOPPER(64, 8)
  MPGEMM_HOPPER(64, 16)
  MPGEMM_HOPPER(64, 32)
  MPGEMM_HOPPER(64, 64)
  MPGEMM_HOPPER(128, 128)
  MPGEMM_HOPPER(128, 256)
#undef MPGEMM_HOPPER
  return static_cast<int>(cudaErrorInvalidValue);
}
