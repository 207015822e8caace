// Int8-weight GEMM for Hopper (sm_90a): out = (x . float(w_q)) * scale.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py: quant_matmul
// (body _quant_matmul_kernel), the GTA INT8 serving path.
//
// What it computes: x (M, K) in bf16 or fp32 times the int8 weight w_q
// (K, N), row-major, every product summed in fp32, then the per-output-
// channel scale (N,) applied once at the flush; out (M, N) is fp32.
// int8 -> bf16 / fp32 and bf16 -> fp32 are exact, so with bf16 x every
// product is exact and only the order of the fp32 sums differs from the
// plain version.  Each output element has one owner and a fixed summation
// order: no float atomics, repeats are bit-equal.
//
// Two routes, chosen by one rule (kernels/quant_matmul.py:
// quant_matmul_route), with the tile and the K split fixed by the shapes
// (quant_plan):
//
//  * The Hopper route (quant_matmul_hopper_launch): bf16 x that TMA can
//    describe (row stride x 2 bytes a multiple of 16, N a multiple of 16,
//    16-byte-aligned bases).
//  * The CUDA-core route (quant_matmul_launch): fp32 x, which stays IEEE
//    fp32 (FMA on CUDA cores, never TF32), and every other layout.
//
// What bounds each regime on this card, and what the Hopper route does:
//
//  * Decode (M <= 64 rows): bytes.  Every weight byte meets only M rows;
//    the (896, 4864) down projection's 4.36 MB of int8 weight is 1.3 us at
//    3.35 TB/s.  The operands are swapped: the CTA computes the C^T tile,
//    64 weight columns on wgmma's M and the M rows of x on its n (8..64).
//    Where the output has few tiles, whole 64-row K stages are split over
//    a cluster of up to 8 ranks so that the weight is streamed by about
//    two CTAs an SM; the ranks' tiles are summed through distributed
//    shared memory in rank order into rank 0, which scales and stores (no
//    workspace, no second launch).
//  * Chunk rows (M > 64): operations.  The same kernel with 64 x 64 tiles,
//    or 128 weight columns (two consumer warpgroups) by 128 or 256 rows;
//    K is split over a cluster as at decode where the tiles leave SMs
//    idle, over as many ranks as one wave of resident CTAs holds.  Every
//    CTA converts its weight tile again, once per row tile of x.
//
// Design of the Hopper kernel (quant_hopper):
//
//   One producer warp keeps TMA 2-D loads in flight through an mbarrier
//   ring of 4 stages: per stage the int8 weight box(es) {64 N, 64 K}
//   (64-byte rows, unswizzled) and the bf16 x box {64 K, TQ rows}
//   (128-byte swizzle, K-major).  Each consumer warpgroup converts its 64
//   weight columns of the stage to bf16 -- exactly: the byte + 128 goes
//   into the mantissa of 2^23 and 2^23 + 128 is subtracted -- and stores
//   them into a bf16 buffer in the layout TMA would give an MN-major
//   operand (128-byte rows, chunk c of K row r at c ^ (r % 8)), then
//   fences the generic proxy against the async proxy, syncs the
//   warpgroup on a named barrier and issues four wgmma.mma_async m64nNk16
//   (fp32 accumulators).  The bf16 buffers form a ring of three: the one
//   written at stage s was last read by the wgmma group of stage s - 3,
//   which every warp of the warpgroup has waited for (wgmma.wait_group 1
//   after each stage, and the named barrier of stage s - 1).  A ring stage
//   is released when the next stage's group has been issued.  TMA
//   zero-fills past K, N and M, so any shape TMA takes runs without
//   padding copies; stores past M and N are masked.
//
// The CUDA-core route: one owner CTA per (BM, BN) output tile walks its K
// range in stages of BK rows, 3 deep: cp.async copies the x tile and the
// weight tile in 16-byte chunks (every tile is at least 16 columns wide)
// into shared memory, edges zero-filled in the copy.  Each thread owns a
// TM x TN block of the tile in fp32 registers.  The 256 threads form KG
// k-groups that take a stage's rows kg, kg + KG, ...; their partial tiles
// are summed in group order.  Tiles: 64x64 and 32x32 for M > 16, 8x16
// (KG = 32) for decode.  Shapes whose rows cannot be copied in aligned
// 16-byte chunks take scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core route
// ---------------------------------------------------------------------------

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

// Copy 16 bytes from global to shared memory asynchronously; when !valid
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x (M, K) T row-major; w (K, N) int8 row-major; scale (N,) fp32;
// out (M, N) fp32.  Grid (ceil(N / BN), ceil(M / BM)), kThreads threads;
// each CTA walks all of K.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
quant_matmul_core(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int M, int N, int K, int vec) {
  constexpr int RT = BM / TM, CT = BN / TN;   // threads along rows, columns
  constexpr int GROUP = RT * CT;              // threads of one k-group
  constexpr int KG = kThreads / GROUP;        // k-groups
  static_assert(KG * GROUP == kThreads && BK % KG == 0, "thread layout");
  static_assert(BN % 16 == 0, "weight rows are copied in 16-byte chunks");
  constexpr int XC = 16 / sizeof(T);          // x elements per 16-byte chunk
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
        cp_async16(xs + r * BK + c, ok ? x + (long)gm * K + gk : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < XC; ++e)
          xs[r * BK + c + e] = (gm < M && gk + e < K)
                                   ? x[(long)gm * K + gk + e] : zero_of<T>();
      }
    }
    for (int i = tid; i < BK * BN / 16; i += kThreads) {
      const int r = i / (BN / 16), c = (i - r * (BN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      if (vec) {
        const bool ok = gk < K && gn < N;
        cp_async16(ws + r * BN + c, ok ? w + (long)gk * N + gn : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
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
      const int gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N) {
        float s = 0.f;
        for (int q = 0; q < KG; ++q) s += red[q * BM * BN + o];
        out[(long)gr * N + gc] = s * scale[gc];
      }
    }
  }
}

// Launch with the grid's z as a cluster when ranks > 1 (the Hopper
// route's K split).
template <typename Kernel, typename... Args>
int launch_ranks(Kernel kernel, dim3 grid, int threads, size_t smem,
                 int ranks, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = ranks;
  cfg.attrs = at;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_core(const void* x, const void* w, const float* scale, float* out,
                int M, int N, int K, cudaStream_t st) {
  const int vec = K % (16 / (int)sizeof(T)) == 0 && N % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_core<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, out, M,
      N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_core_tile(int bm, int bn, const void* x, const void* w,
                     const float* scale, float* out, int M, int N, int K,
                     cudaStream_t st) {
  if (bm == 64 && bn == 64)
    return launch_core<T, 64, 64, 32, 4, 4>(x, w, scale, out, M, N, K, st);
  if (bm == 32 && bn == 32)
    return launch_core<T, 32, 32, 32, 2, 2>(x, w, scale, out, M, N, K, st);
  if (bm == 8 && bn == 16)
    return launch_core<T, 8, 16, 256, 8, 2>(x, w, scale, out, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The Hopper route: int8 weight by TMA, converted to bf16 in shared
// memory, wgmma
// ---------------------------------------------------------------------------

namespace hq {

using hop::kAtom;
using hop::kBoxK;
using hop::kRowBytes;

constexpr int kW8Box = 64 * kBoxK;   // one int8 box {64 N, 64 K}: 4096 B
constexpr int kMaxRanks = 8;         // largest cluster splitting K

// Launch geometry, computed by the caller (quant_matmul.quant_plan).
struct Geo {
  int M, N, K;
  int gk;       // 64-row K stages, ceil(K / 64)
  int ranks;    // cluster ranks splitting the stages (gridDim.z)
};

// TP weight columns (64 a consumer warpgroup) by TQ rows of x.
template <int TP, int TQ>
struct Shape {
  static constexpr int kWG = TP / 64;
  static constexpr int kConsumers = kWG * 128;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr int kW8 = TP * kBoxK;             // int8 bytes a stage
  static constexpr int kStage = kW8 + TQ * kRowBytes;
  // 4 stages: a decode CTA walks at most ~10 (8 ranks), so 4 in flight
  // keep about the whole weight requested, and a 64 x 64 chunk tile then
  // fits three CTAs an SM (six stages fit two, and measured slower)
  static constexpr int kStages = 4;
  static constexpr int kBf = TP * kRowBytes;         // one bf16 P buffer
  static constexpr int kBufs = 3;
  static constexpr int kBufOffset = kStages * kStage;
  static constexpr int kBarOffset = kBufOffset + kBufs * kBf;
  static constexpr int kRedOffset = kBarOffset + 256;
  // one fp32 tile for the DSMEM reduction, where it fits beside the ring
  static constexpr int kRedBytes =
      1024 + kRedOffset + TP * TQ * 4 <= 232448 ? TP * TQ * 4 : 0;
  static constexpr int smem(bool red) {
    return 1024 + kRedOffset + (red ? kRedBytes : 0);
  }
};

// Two int8 values as a bf16 pair, exactly.  u holds four of them with
// their sign bits flipped (each byte is q + 128); bytes 2h and 2h + 1
// become 2^23 + (q + 128) in the bits of an fp32, 2^23 + 128 is taken
// off, and |q| <= 128 fits bf16's 8 significant bits.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t u, int h) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               h ? 0x7542 : 0x7540)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               h ? 0x7543 : 0x7541)) -
                   8388736.f;
  __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Convert one warpgroup's int8 box (64 K rows x 64 bytes) into the bf16
// MN-major tile wgmma reads (64 K rows x 128 bytes, 128-byte swizzle).
// Thread t takes 16-byte chunks t and t + 128: K row i / 4, columns
// 16 (i % 4) .. + 15, i.e. bf16 chunks 2 (i % 4) and 2 (i % 4) + 1.  A
// quarter-warp reads 128 contiguous bytes and writes two rows whose
// swizzle parities differ: no bank conflict either way.
__device__ __forceinline__ void convert_box(const uint8_t* w8, uint8_t* bf,
                                            int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + 128 * j;
    const int kk = i >> 2, q = i & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(w8 + kk * 64 + q * 16);
    const uint32_t a = v.x ^ 0x80808080u, b = v.y ^ 0x80808080u;
    const uint32_t c = v.z ^ 0x80808080u, d = v.w ^ 0x80808080u;
    const uint4 lo = make_uint4(i8x2_bf16x2(a, 0), i8x2_bf16x2(a, 1),
                                i8x2_bf16x2(b, 0), i8x2_bf16x2(b, 1));
    const uint4 hi = make_uint4(i8x2_bf16x2(c, 0), i8x2_bf16x2(c, 1),
                                i8x2_bf16x2(d, 0), i8x2_bf16x2(d, 1));
    uint8_t* row = bf + kk * kRowBytes;
    const int sw = kk & 7;
    *reinterpret_cast<uint4*>(row + (((2 * q) ^ sw) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ sw) << 4)) = hi;
  }
}

// The weight columns p = pr and pr + 8 of a consumer thread's C^T
// fragment (m64nNk16: register 4j + 2h + e holds p = 16 warp + lane / 4 +
// 8 h, q = 8 j + 2 (lane % 4) + e).
__device__ __forceinline__ int fragment_p(int p0) {
  const int t = threadIdx.x & 127, wg = threadIdx.x >> 7;
  return p0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
}

// Store a consumer thread's C^T fragment (p over N, q over M) times the
// scales sc of its two columns into out (M, N) fp32.
template <int NR>
__device__ __forceinline__ void store_scaled(float* __restrict__ out,
                                             const float (&sc)[2],
                                             const float (&acc)[NR], int p0,
                                             int q0, int M, int N) {
  const int lane = threadIdx.x & 31;
  const int pr = fragment_p(p0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = pr + 8 * h;
    if (p >= N) continue;
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
      const int q = q0 + 8 * j + 2 * (lane & 3);
      if (q < M)
        out[static_cast<long>(q) * N + p] = acc[4 * j + 2 * h] * sc[h];
      if (q + 1 < M)
        out[static_cast<long>(q + 1) * N + p] =
            acc[4 * j + 2 * h + 1] * sc[h];
    }
  }
}

// Grid (ceil(N / TP), ceil(M / TQ), ranks); with ranks > 1 the z ranks
// form a cluster.  tmW: the int8 weight (N inner), box {64, 64}; tmX: x
// (K inner), box {64, TQ}, 128-byte swizzle.
template <int TP, int TQ>
__global__ void __launch_bounds__(Shape<TP, TQ>::kThreads, 1)
quant_hopper(const __grid_constant__ CUtensorMap tmW,
             const __grid_constant__ CUtensorMap tmX,
             const float* __restrict__ scale, float* __restrict__ out,
             const Geo g) {
  using S = Shape<TP, TQ>;
  constexpr int NR = TQ / 2;                 // accumulator registers

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* empty = full + S::kStages;
  float* red = reinterpret_cast<float*>(smem + S::kRedOffset);

  const int tid = threadIdx.x;
  const uint32_t rank = g.ranks > 1 ? hop::cluster_rank() : 0;
  const int p0 = blockIdx.x * TP, q0 = blockIdx.y * TQ;
  const int z = blockIdx.z;
  const int s0 = static_cast<int>(static_cast<long long>(z) * g.gk / g.ranks);
  const int s1 =
      static_cast<int>(static_cast<long long>(z + 1) * g.gk / g.ranks);

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], S::kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a CTA-wide barrier is enough here: no CTA touches another's shared
  // memory before the cluster barrier of the reduction
  __syncthreads();

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  // the scales of this thread's two columns, read now so that their
  // latency hides behind the weight stream and not before the stores
  float sc[2] = {0.f, 0.f};
  if (tid < S::kConsumers) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = fragment_p(p0) + 8 * h;
      if (p < g.N) sc[h] = scale[p];
    }
  }

  // the role is a function of the warp, made visibly warp-uniform so that
  // ptxas does not serialize the wgmmas of a "divergent" path
  const int warp = __shfl_sync(0xffffffff, tid / 32, 0);
  if (warp >= S::kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (tid == S::kConsumers) {
      int stage = 0, phase = 0;
      for (int s = s0; s < s1; ++s) {
        hop::mbar_wait(&empty[stage], phase ^ 1);
        hop::mbar_expect_tx(&full[stage], S::kStage);
        const uint32_t sw = hop::smem_u32(smem + stage * S::kStage);
#pragma unroll
        for (int j = 0; j < TP / 64; ++j)
          hop::tma_box(sw + j * kW8Box, &tmW, &full[stage], p0 + 64 * j,
                       s * kBoxK, 0);
        hop::tma_box(sw + S::kW8, &tmX, &full[stage], s * kBoxK, q0, 0);
        if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // consumers: warpgroup wg owns weight columns [64 wg, 64 wg + 64).
    // Every stage is four whole k16 steps (TMA zero-fills past K), so no
    // wgmma sits on a conditional path.
    const int wg = warp / 4;
    const int t = tid & 127;
    int stage = 0, phase = 0, held = -1, buf = 0;
    for (int s = s0; s < s1; ++s) {
      hop::mbar_wait(&full[stage], phase);
      uint8_t* st = smem + stage * S::kStage;
      uint8_t* bf = smem + S::kBufOffset + buf * S::kBf + wg * kAtom;
      convert_box(st + wg * kW8Box, bf, t);
      hop::fence_proxy_async();
      hop::named_sync(1 + wg, 128);
      const uint32_t sp = hop::smem_u32(bf);
      const uint32_t sq = hop::smem_u32(st + S::kW8);
      hop::fence_acc(acc);
      hop::wg_fence();
#pragma unroll
      for (int k = 0; k < kBoxK / 16; ++k)
        hop::Wgmma<TQ>::template mma<1, 0>(
            acc, hop::gmma_desc<false>(sp + hop::kstep_offset<false>(k)),
            hop::gmma_desc<true>(sq + hop::kstep_offset<true>(k)));
      hop::wg_commit();
      hop::wg_wait<1>();
      hop::fence_acc(acc);
      if (held >= 0 && t == 0) hop::mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == S::kStages) { stage = 0; phase ^= 1; }
      buf = buf == S::kBufs - 1 ? 0 : buf + 1;
    }
    hop::wg_wait<0>();
    hop::fence_acc(acc);
    if (held >= 0 && t == 0) hop::mbar_arrive(&empty[held]);
  }

  if (g.ranks > 1) {
    // the ranks' partial tiles, summed into rank 0 in rank order
    float4* mine = reinterpret_cast<float4*>(red);
    if (tid < S::kConsumers && rank != 0) {
#pragma unroll
      for (int j = 0; j < NR / 4; ++j)
        mine[j * S::kConsumers + tid] = make_float4(
            acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    hop::cluster_sync();
    if (tid < S::kConsumers && rank == 0) {
#pragma unroll
      for (int j = 0; j < NR / 4; ++j) {
        // every rank's partial read before any is added (the reads
        // overlap), then added in rank order
        float4 v[kMaxRanks];
#pragma unroll
        for (int r = 1; r < kMaxRanks; ++r)
          if (r < g.ranks)
            v[r] = hop::ld_dsmem_v4(&mine[j * S::kConsumers + tid], r);
#pragma unroll
        for (int r = 1; r < kMaxRanks; ++r) {
          if (r < g.ranks) {
            acc[4 * j] += v[r].x;
            acc[4 * j + 1] += v[r].y;
            acc[4 * j + 2] += v[r].z;
            acc[4 * j + 3] += v[r].w;
          }
        }
      }
      store_scaled<NR>(out, sc, acc, p0, q0, g.M, g.N);
    }
    hop::cluster_sync();                 // peers stay until rank 0 has read
  } else if (tid < S::kConsumers) {
    store_scaled<NR>(out, sc, acc, p0, q0, g.M, g.N);
  }
}

template <int TP, int TQ>
int launch(const CUtensorMap& mw, const CUtensorMap& mx, const float* scale,
           float* out, const Geo& g, cudaStream_t st) {
  using S = Shape<TP, TQ>;
  auto kernel = quant_hopper<TP, TQ>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(true));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (g.ranks < 1 || g.ranks > kMaxRanks || g.ranks > g.gk ||
      (g.ranks > 1 && S::kRedBytes == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.N + TP - 1) / TP, (g.M + TQ - 1) / TQ, g.ranks);
  return launch_ranks(kernel, grid, S::kThreads, S::smem(g.ranks > 1),
                      g.ranks, st, mw, mx, scale, out, g);
}

}  // namespace hq
}  // namespace

// The CUDA-core route.  dtype: 0 = float32, 1 = bfloat16 (x); (bm, bn)
// one of quant_matmul.CORE_TILES (64x64, 32x32, 8x16).  x, w_q, out
// contiguous.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int quant_matmul_launch(int dtype, int bm, int bn, const void* x,
                                   const void* w, const float* scale,
                                   float* out, int M, int N, int K,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_core_tile<float>(bm, bn, x, w, scale, out, M, N, K, st);
  if (dtype == 1)
    return launch_core_tile<__nv_bfloat16>(bm, bn, x, w, scale, out, M, N, K,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The Hopper route.  x (M, K) bf16, K contiguous, row stride sx elements;
// w (K, N) int8, N contiguous, row stride sw bytes; strides x element
// size multiples of 16 and bases 16-byte aligned
// (quant_matmul.quant_matmul_route).  (bm, bn) is one of
// quant_matmul.QUANT_TILES in the output's orientation (bm rows of x, bn
// weight columns); ranks splits the 64-row K stages over a cluster
// (quant_matmul.quant_plan).  Returns 0 when launched, else a CUDA error
// code or 9001 (no tensor-map encoder) / 9100 + CUresult.
extern "C" int quant_matmul_hopper_launch(int bm, int bn, int ranks,
                                          const void* x, long sx,
                                          const void* w, long sw,
                                          const float* scale, float* out,
                                          int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // w: N inner, box {64 N, 64 K}, unswizzled; x: K inner, box {64 K, bm
  // rows}, 128-byte swizzle.  Both are encoded each call: the encoder is
  // host arithmetic that reads no tensor.
  CUtensorMap mw, mx;
  int rc = hop::encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w,
                          static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                          static_cast<uint64_t>(sw), 64, hq::kBoxK,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  rc = hop::encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                      static_cast<uint64_t>(K), static_cast<uint64_t>(M),
                      static_cast<uint64_t>(sx) * 2, hq::kBoxK,
                      static_cast<uint32_t>(bm), CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const hq::Geo g{M, N, K, (K + hq::kBoxK - 1) / hq::kBoxK, ranks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QUANT_HOPPER(BM, BN)                                                  \
  if (bm == BM && bn == BN) return hq::launch<BN, BM>(mw, mx, scale, out, g, st);
  QUANT_HOPPER(8, 64)
  QUANT_HOPPER(16, 64)
  QUANT_HOPPER(32, 64)
  QUANT_HOPPER(64, 64)
  QUANT_HOPPER(128, 128)
  QUANT_HOPPER(256, 128)
#undef QUANT_HOPPER
  return static_cast<int>(cudaErrorInvalidValue);
}
