// SSD (Mamba2) intra-chunk kernel for Hopper (sm_90a), K5.
//
// Replaces the Pallas kernel repro/kernels/ssd.py: ssd_intra (body
// _ssd_intra_kernel), the intra-chunk term of the chunked SSD algorithm.
//
// What it computes, per flattened (batch, chunk, head) index g, in fp32:
//   y[g, s, p] = sum_{t <= s} (C_s . B_t) * exp(cums_s - cums_t) * dt_t
//                             * x[g, t, p]
// with x (G, Q, P), dt and cums (G, Q), b and c (G, Q, N), y (G, Q, P), all
// contiguous fp32.  Every product and sum is an fp32 FMA (no TF32: the
// reference's tolerance is 2e-4 and fp32 greedy tokens must not move).
//
// What bounds it on this card: operations.  At the full-width prefill
// shape (G = 640, Q = 256, P = 64, N = 128) the causal half of the two
// GEMMs is about 8 GFLOP, 120 us at the 67 TFLOP/s fp32 peak, against 253
// MB of operands and result, 76 us at 3.35 TB/s.
//
// Design: the Pallas kernel holds the whole (Q, Q) score tile in VMEM; at
// Q = 256 that is 256 KB of fp32, more than the 227 KB a CTA may have.
// Here one CTA owns a 64-row block of s (and a 64-wide block of p) for one
// g, keeps its (64, 64) fp32 accumulator in registers (4 x 4 a thread,
// 256 threads), and walks only the 64-row t-blocks at or below the
// diagonal (t > s contributes nothing).  For each t-block it forms the
// (64, 64) score tile C_s . B_t in registers, staging C and B in shared
// memory 32 state columns at a time; applies the decay mask, evaluating
// exp only where t <= s, so the positive exponents above the diagonal
// (which overflow to inf at full width) are never formed; writes the
// masked tile to shared memory; stages the t-block of x and accumulates
// score . x.  Edges (any Q, P, N) are zero-filled while staging.  The
// grid puts the heaviest s-blocks (most t-blocks) first.  Tensor cores
// (3xTF32 or wgmma), TMA and keeping C resident are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBS = 64;        // s rows of a CTA
constexpr int kBT = 64;        // t rows of a step
constexpr int kBP = 64;        // p columns of a CTA
constexpr int kNK = 32;        // state columns staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStage = (kBS + kBT) * (kNK + 1) > kBT * kBP
                         ? (kBS + kBT) * (kNK + 1) : kBT * kBP;

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cums, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ y, int Q,
                 int P, int N) {
  // C and B (score phase) share their space with x (accumulate phase):
  // 33.5 KB in all, under the 48 KB of static shared memory
  __shared__ float cbx[kStage];
  __shared__ float Ss[kBS][kBT + 1];
  __shared__ float cum_s[kBS], cum_t[kBT], dt_t[kBT];
  auto Cs = reinterpret_cast<float (*)[kNK + 1]>(cbx);
  auto Bs = reinterpret_cast<float (*)[kNK + 1]>(cbx + kBS * (kNK + 1));
  auto Xs = reinterpret_cast<float (*)[kBP]>(cbx);

  const int g = blockIdx.x;
  const int n_sblk = (Q + kBS - 1) / kBS;
  const int s0 = (n_sblk - 1 - static_cast<int>(blockIdx.y)) * kBS;
  const int p0 = blockIdx.z * kBP;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t gq = static_cast<size_t>(g) * Q;
  const float* xg = x + gq * P;
  const float* bg = b + gq * N;
  const float* cg = c + gq * N;

  if (tid < kBS) cum_s[tid] = s0 + tid < Q ? cums[gq + s0 + tid] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int s_end = min(s0 + kBS, Q);  // rows s0 .. s_end - 1
  for (int t0 = 0; t0 < s_end; t0 += kBT) {
    if (tid < kBT) {
      const int t = t0 + tid;
      cum_t[tid] = t < Q ? cums[gq + t] : 0.f;
      dt_t[tid] = t < Q ? dt[gq + t] : 0.f;
    }
    // scores C_s . B_t for this (s-block, t-block)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kNK) {
      for (int e = tid; e < kBS * kNK; e += kThreads) {
        const int r = e / kNK, k = e % kNK, n = k0 + k;
        const int s = s0 + r, t = t0 + r;
        Cs[r][k] = s < Q && n < N ? cg[static_cast<size_t>(s) * N + n] : 0.f;
        Bs[r][k] = t < Q && n < N ? bg[static_cast<size_t>(t) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kNK; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
      __syncthreads();
    }
    // causal decay mask times dt_t; exp only where t <= s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = ty + 16 * i, s = s0 + sl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tl = tx + 16 * j, t = t0 + tl;
        float v = 0.f;
        if (t <= s && s < Q)
          v = sc[i][j] * expf(cum_s[sl] - cum_t[tl]) * dt_t[tl];
        Ss[sl][tl] = v;
      }
    }
    for (int e = tid; e < kBT * kBP; e += kThreads) {
      const int r = e / kBP, col = e % kBP, t = t0 + r, p = p0 + col;
      Xs[r][col] = t < Q && p < P ? xg[static_cast<size_t>(t) * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBT; ++t) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[t][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sv = Ss[ty + 16 * i][t];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv, xv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* yg = y + gq * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < P) yg[static_cast<size_t>(s) * P + p] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int ssd_intra_launch(const float* x, const float* dt,
                                const float* cums, const float* b,
                                const float* c, float* y, int G, int Q, int P,
                                int N, void* stream) {
  if (G <= 0 || Q <= 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, (Q + kBS - 1) / kBS, (P + kBP - 1) / kBP);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_intra_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dt, cums, b, c, y, Q, P, N);
  return static_cast<int>(cudaGetLastError());
}
