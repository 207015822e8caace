// Limb GEMM for Hopper (sm_90a): anti-diagonal sums of int8 limb products.
//
// Replaces the Pallas kernel src/repro/kernels/limb_gemm.py:61,
// limb_gemm_diagonals (body _limb_gemm_kernel), the paper's exact
// multi-precision integer GEMM (§3.1).
//
// What it computes: given the balanced base-128 digits of two integer
// matrices, a_limbs (la, M, K) and b_limbs (lb, K, N), both int8, it writes
// S (la + lb - 1, M, N) int32 with S[d] = sum_{i + j = d} A_i . B_j.  Every
// product and sum is an integer, so any summation order gives the same
// bits; the multi-precision accumulator (kernels/accumulator.py) then
// recombines the planes modulo 2^64.
//
// What bounds it on this card: bytes, at every shape of this port's
// integer workloads.  At the MD trailing update (960 x 960 x 64, int32,
// la = lb = 5) the nine int32 output planes (33 MB) dominate the 0.6 MB of
// limbs: 10.1 us at 3.35 TB/s, against 1.5 us of int8 tensor-core work.
// At AlexNet's fc6 (32 x 4096 x 9216, int8) the 75 MB of B limbs dominate
// (23 us).  This first kernel multiplies on the CUDA cores with __dp4a
// (four int8 products summed into int32 per instruction, a peak about 15x
// below the int8 tensor cores'), so its time is set by the instruction
// rate of dp4a and shared-memory loads, several times the byte bound.
// Fusing the combine into the epilogue (two planes out instead of
// la + lb - 1) and wgmma on int8 are later work.
//
// Design: one owner CTA per (BM, BN) output tile runs the whole K loop and
// holds all la + lb - 1 planes of its tile in registers (each thread TM x
// TN outputs times the planes: at most 72 accumulators).  K is staged 32
// bytes at a time in two shared-memory buffers: while one is multiplied,
// the next step's limbs are loaded into registers and stored into the
// other, one barrier per step.  A's rows are copied as 16-byte chunks; B
// is transposed on the way (four k rows of four columns read as words and
// regrouped with byte permutes), so that each shared-memory word holds
// four consecutive k of one column -- the operand layout of __dp4a.  Rows
// are padded to nine words, so the strided reads of a warp hit distinct
// banks.  Edges are zero-filled (zero limbs add nothing), so any M, N, K
// is taken; shapes whose rows cannot be read as whole words (K not a
// multiple of 16, N not a multiple of 4, unaligned pointers) take byte
// loads instead.  The kernel is compiled for at most 2, 3 and 5 limbs a
// side (int8, int16, int32 operands); fewer limbs on one side (la != lb)
// skip the missing products.  Five tiles: 32x64, 32x32 and 32x16 for
// general shapes (the wrapper takes the first with at least 132 CTAs),
// 128x2 for N <= 2 and 2x128 for M <= 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;              // K bytes staged per step
constexpr int kWords = kBK / 4;      // 32-bit words per staged row
constexpr int kStride = kWords + 1;  // padded row: odd, so no bank conflicts
constexpr int kChunks = kBK / 16;    // 16-byte chunks per staged A row

__device__ __forceinline__ int pack4(int8_t b0, int8_t b1, int8_t b2,
                                     int8_t b3) {
  return (int)(uint8_t)b0 | ((int)(uint8_t)b1 << 8) |
         ((int)(uint8_t)b2 << 16) | ((int)(uint8_t)b3 << 24);
}

// a_limbs (la, M, K), b_limbs (lb, K, N) int8 row-major; out (la+lb-1, M, N)
// int32.  Grid (ceil(N / BN), ceil(M / BM)), kThreads threads.  vec bit 0:
// A rows may be read as 16-byte chunks; bit 1: B rows as 4-byte words.
template <int L, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
limb_gemm(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
          int32_t* __restrict__ out, int la, int lb, int M, int N, int K,
          int vec) {
  constexpr int D = 2 * L - 1;                 // planes held
  constexpr int RT = BM / TM, CT = BN / TN;    // threads along rows, columns
  static_assert(RT * CT == kThreads, "thread layout");
  constexpr int BNU = BN < 4 ? BN : 4;         // columns of one B unit
  constexpr int A_UNITS = L * BM * kChunks;    // 16-byte chunks of A
  constexpr int B_UNITS = L * kWords * (BN / BNU);  // 4 k x BNU n blocks
  constexpr int A_PER = (A_UNITS + kThreads - 1) / kThreads;
  constexpr int B_PER = (B_UNITS + kThreads - 1) / kThreads;
  constexpr int A_ROWS = L * BM;
  constexpr int STAGE = (L * BM + L * BN) * kStride;   // words
  __shared__ int smem[2 * STAGE];

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

  int ra[A_PER][4];     // next step's A words
  int rb[B_PER][BNU];   // next step's B words, already transposed

  auto load = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      ra[p][0] = ra[p][1] = ra[p][2] = ra[p][3] = 0;
      const int u = tid + p * kThreads;
      if (A_UNITS % kThreads != 0 && u >= A_UNITS) continue;
      const int c = u % kChunks, r = (u / kChunks) % BM, i = u / (kChunks * BM);
      const int gm = m0 + r, gk = k0 + c * 16;
      if (i >= la || gm >= M || gk >= K) continue;
      const int8_t* src = a + ((size_t)i * M + gm) * K + gk;
      if (vec & 1) {
        const int4 v = *reinterpret_cast<const int4*>(src);
        ra[p][0] = v.x; ra[p][1] = v.y; ra[p][2] = v.z; ra[p][3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          int8_t e[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e[q] = gk + 4 * w + q < K ? src[4 * w + q] : int8_t(0);
          ra[p][w] = pack4(e[0], e[1], e[2], e[3]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
#pragma unroll
      for (int c = 0; c < BNU; ++c) rb[p][c] = 0;
      const int u = tid + p * kThreads;
      if (B_UNITS % kThreads != 0 && u >= B_UNITS) continue;
      const int cg = u % (BN / BNU), kw = (u / (BN / BNU)) % kWords;
      const int j = u / ((BN / BNU) * kWords);
      const int gn = n0 + cg * BNU, gk = k0 + kw * 4;
      if (j >= lb || gn >= N || gk >= K) continue;
      const int8_t* src = b + ((size_t)j * K + gk) * N + gn;
      if constexpr (BNU == 4) {
        if (vec & 2) {
          // four k rows of four columns, transposed to four columns of
          // four k: rb[p][c] = (r0.c, r1.c, r2.c, r3.c)
          int r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            r[q] = gk + q < K
                       ? *reinterpret_cast<const int*>(src + (size_t)q * N)
                       : 0;
          const int t0 = __byte_perm(r[0], r[1], 0x5140);
          const int t1 = __byte_perm(r[0], r[1], 0x7362);
          const int t2 = __byte_perm(r[2], r[3], 0x5140);
          const int t3 = __byte_perm(r[2], r[3], 0x7362);
          rb[p][0] = __byte_perm(t0, t2, 0x5410);
          rb[p][1] = __byte_perm(t0, t2, 0x7632);
          rb[p][2] = __byte_perm(t1, t3, 0x5410);
          rb[p][3] = __byte_perm(t1, t3, 0x7632);
          continue;
        }
      }
#pragma unroll
      for (int c = 0; c < BNU; ++c) {
        if (gn + c >= N) continue;
        int8_t e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = gk + q < K ? src[(size_t)q * N + c] : int8_t(0);
        rb[p][c] = pack4(e[0], e[1], e[2], e[3]);
      }
    }
  };

  auto store = [&](int buf) {
    int* as = smem + buf * STAGE;
    int* bs = as + A_ROWS * kStride;
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int u = tid + p * kThreads;
      if (A_UNITS % kThreads != 0 && u >= A_UNITS) continue;
      const int c = u % kChunks, r = (u / kChunks) % BM, i = u / (kChunks * BM);
      if (i >= la) continue;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        as[(i * BM + r) * kStride + c * 4 + w] = ra[p][w];
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int u = tid + p * kThreads;
      if (B_UNITS % kThreads != 0 && u >= B_UNITS) continue;
      const int cg = u % (BN / BNU), kw = (u / (BN / BNU)) % kWords;
      const int j = u / ((BN / BNU) * kWords);
      if (j >= lb) continue;
#pragma unroll
      for (int c = 0; c < BNU; ++c)
        bs[(j * BN + cg * BNU + c) * kStride + kw] = rb[p][c];
    }
  };

  int acc[D][TM][TN];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[d][x][y] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1);
    const int* as = smem + (kt & 1) * STAGE;
    const int* bs = as + A_ROWS * kStride;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int av[L][TM], bv[L][TN];
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int x = 0; x < TM; ++x)
          av[i][x] = i < la ? as[(i * BM + ty + x * RT) * kStride + w] : 0;
#pragma unroll
      for (int j = 0; j < L; ++j)
#pragma unroll
        for (int y = 0; y < TN; ++y)
          bv[j][y] = j < lb ? bs[(j * BN + tx + y * CT) * kStride + w] : 0;
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int j = 0; j < L; ++j) {
          if (i >= la || j >= lb) continue;
#pragma unroll
          for (int x = 0; x < TM; ++x)
#pragma unroll
            for (int y = 0; y < TN; ++y)
              acc[i + j][x][y] = __dp4a(av[i][x], bv[j][y], acc[i + j][x][y]);
        }
    }
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  const int planes = la + lb - 1;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d >= planes) break;
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const int row = m0 + ty + x * RT;
#pragma unroll
      for (int y = 0; y < TN; ++y) {
        const int col = n0 + tx + y * CT;
        if (row < M && col < N)
          out[((size_t)d * M + row) * N + col] = acc[d][x][y];
      }
    }
  }
}

template <int L, int BM, int BN, int TM, int TN>
int launch(const int8_t* a, const int8_t* b, int32_t* out, int la, int lb,
           int M, int N, int K, cudaStream_t st) {
  const int vec = (K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0)
                  | ((N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0)
                     << 1);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  limb_gemm<L, BM, BN, TM, TN><<<grid, kThreads, 0, st>>>(a, b, out, la, lb,
                                                          M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_tile(int tile, const int8_t* a, const int8_t* b, int32_t* out,
                int la, int lb, int M, int N, int K, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<L, 32, 64, 2, 4>(a, b, out, la, lb, M, N, K, st);
    case 1: return launch<L, 32, 32, 2, 2>(a, b, out, la, lb, M, N, K, st);
    case 2: return launch<L, 32, 16, 2, 1>(a, b, out, la, lb, M, N, K, st);
    case 3: return launch<L, 128, 2, 1, 1>(a, b, out, la, lb, M, N, K, st);
    case 4: return launch<L, 2, 128, 1, 1>(a, b, out, la, lb, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tile: index into the wrapper's TILES = (32x64, 32x32, 32x16, 128x2,
// 2x128).  la, lb: limbs of a and b, 1..5.  Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int limb_gemm_launch(int tile, const void* a, const void* b,
                                void* out, int la, int lb, int M, int N,
                                int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  int32_t* op = static_cast<int32_t*>(out);
  if (M <= 0 || N <= 0 || K <= 0 || la <= 0 || lb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = la > lb ? la : lb;
  if (l <= 2) return launch_tile<2>(tile, ap, bp, op, la, lb, M, N, K, st);
  if (l <= 3) return launch_tile<3>(tile, ap, bp, op, la, lb, M, N, K, st);
  if (l <= 5) return launch_tile<5>(tile, ap, bp, op, la, lb, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
