// SSD (Mamba2) intra-chunk kernel for Hopper (sm_90a), K5.
//
// Replaces the Pallas kernel repro/kernels/ssd.py: ssd_intra (body
// _ssd_intra_kernel), the intra-chunk term of the chunked SSD algorithm.
//
// What it computes, for batch b, chunk c and head h of group
// g = h / (H / G), in fp32:
//   y[b,c,s,h,p] = sum_{t <= s} (C[b,c,s,g,:] . B[b,c,t,g,:])
//                  * exp(cums[b,c,s,h] - cums[b,c,t,h]) * dt[b,c,t,h]
//                  * x[b,c,t,h,p]
// on the operands in their stored layout: x (B, nc, Q, H, P), dt and cums
// (B, nc, Q, H), B and C per group (B, nc, Q, G, N), each with its own
// element strides (the innermost dimension of x, B and C contiguous), and
// y (B, nc, Q, H, P) written in place.  The reference's per-head form
// (G', Q, .) is the case batch G', nc = H = G = 1.
//
// What bounds it on this card: bytes.  At mamba2-2.7b's chunk (B 8, nc 1,
// Q 256, H 80, G 1, P 64, N 128) x and y are 83.9 MB, dt and cums 1.3 MB,
// B and C 2.1 MB: 26.1 us at 3.35 TB/s.  The work is the score product once
// a group (0.067 GFLOP, causal pairs) and the S.X product once a head
// (2.695 GFLOP): in 3xTF32 (three tensor-core products a product) 16.7 us
// at 495 TFLOP/s; on fp32 FMAs it would be 41.2 us at 67 TFLOP/s.
//
// Design:
//   * One CTA (8 warps) a (head block, batch-chunk, 64-row s-block); the
//     grid's z runs the s-blocks heaviest first.  A head block is up to 16
//     heads of one group, fixed with the grid by the wrapper's ssd_plan
//     from the shapes alone.  Warp w owns rows s0 + 16 (w % 4) .. + 15; in
//     phase 1 half w / 4 of each t-block's columns, in phase 2 the heads of
//     parity w / 4, all 64 p columns.  Two CTAs (16 warps) fit an SM.
//   * Phase 1, once a CTA: the group's score rows R = C_s . B_t^T for every
//     64-column t-block at or below the diagonal, kept in shared memory
//     (64 x (Q + 4) fp32: 66.5 KB at Q = 256, dynamic shared memory).  C
//     and B stream through a two-stage cp.async ring 32 state columns at a
//     time; the product runs on the tensor cores in 3xTF32.
//   * Phase 2, for each pair of heads of the block (and each 64-wide p
//     block): y_h = S_h . X_h over 32-row t-chunks.  Both heads' X chunks
//     (t rows x 64 p, read in place at their row stride), dt_t, cums_t
//     and the block's cums_s come through a two-stage cp.async ring
//     (16-byte copies where rows are 16-byte aligned, 4-byte ones
//     otherwise), so the next chunk loads while this one computes.  S_h is
//     made from R in registers, once a head (not once a p column block),
//     as mma.sync's A fragment: exp only where t <= s (the exponent
//     cums_s - cums_t is positive above the diagonal and overflows at full
//     width; it is never formed), times dt_t.  A chunk wholly above a
//     warp's rows is skipped; inside one the mask is per element and
//     branch-free (a masked exponent is -inf, and 2^-inf = 0), so the
//     k-steps' loads and products interleave.  The decay is ex2 of
//     (cums_s - cums_t) log2(e): a few ulp where it is not negligible.
//     No integer division in the loops: items are counted, not decoded.
//     y_h is written once from the registers.
//   * 3xTF32: each operand a is split into hi = tf32(a) and lo = a - hi,
//     and hi.lo + lo.hi + hi.hi is summed in fp32 by mma.sync.m16n8k8
//     (wgmma's tf32 form takes only K-major shared operands, and X_h is
//     MN-major for it).  Plain TF32 keeps about three digits and fails the
//     reference's 2e-4.
//   * Shared-memory rows are padded (36, 72 and Q + 4 floats) so that
//     every fragment load of a warp hits 32 distinct banks.
//   * No float atomics: each output element has one owner and a fixed
//     summation order, so two calls give bit-equal results.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 row blocks x 2 halves
constexpr int kBS = 64;        // s rows a CTA
constexpr int kBT = 64;        // t columns a score block (phase 1)
constexpr int kNK = 32;        // state columns a phase-1 stage
constexpr int kLdCB = kNK + 4;  // padded C / B row (floats)
constexpr int kTC = 32;        // t rows a phase-2 stage
constexpr int kBP = 64;        // p columns a pass
constexpr int kLdX = kBP + 8;  // padded X row (floats)
constexpr int kStages1 = 2;
constexpr int kStages2 = 2;
constexpr int kStage1 = 2 * kBS * kLdCB;  // C rows then B rows
// a head's part of a phase-2 stage: X rows, then cums_t, dt_t (kTC each)
// and the block's cums_s (kBS; with a head's first chunk only)
constexpr int kHead2 = kTC * kLdX + 2 * kTC + kBS;
constexpr int kStage2 = 2 * kHead2;       // two heads
constexpr int kRing = kStages1 * kStage1 > kStages2 * kStage2
                          ? kStages1 * kStage1 : kStages2 * kStage2;
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on the H100

struct Args {
  const float* x;
  const float* dt;
  const float* cums;
  const float* b;
  const float* c;
  float* y;
  // element strides (batch, chunk, row, head or group) of each operand
  long long sx[4], sdt[4], scu[4], sb[4], sc[4], sy[4];
  int nc, Q, H, G, P, N, hb, nhb;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (L2 only) or 4 bytes; with ok false nothing is read
// and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo: hi is a rounded to tf32 (10 mantissa bits, ties away from
// zero: add half a tf32 ulp and clear the 13 low bits), lo = a - hi exactly
// (|lo| <= 2^-11 |a|), passed as its fp32 bits: the tensor core reads the
// top 19 bits of a tf32 operand, so lo loses at most 2^-21 |a|.  Three
// integer and float instructions (cvt.rna.tf32 expands to about five).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// 2^x (MUFU.EX2; denormal results flushed to zero, 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: the two cross terms first, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Fragment layout of m16n8k8 (g = lane / 4, q = lane % 4): A holds (row,
// col) = (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (k, n) =
// (q, g), (q + 4, g); D holds (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* R = ring + kRing;
  const int ldr = (a.Q + kBT - 1) / kBT * kBT + 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, qd = lane % 4;
  const int rep = a.H / a.G;
  const int grp = blockIdx.x / a.nhb, hbi = blockIdx.x % a.nhb;
  const int h0 = grp * rep + hbi * a.hb;
  const int nh = min(a.hb, rep - hbi * a.hb);
  const int bi = blockIdx.y / a.nc, ci = blockIdx.y % a.nc;
  const int n_sblk = (a.Q + kBS - 1) / kBS;
  const int s0 = (n_sblk - 1 - static_cast<int>(blockIdx.z)) * kBS;
  const int s_end = min(s0 + kBS, a.Q);
  const int r0 = 16 * (warp % 4);           // the warp's rows s0 + r0 ..
  const int half = warp / 4;                // its half of t (1) or p (2)
  const bool live = s0 + r0 < a.Q;          // warp-uniform
  const int s_last = s0 + r0 + 15;          // the warp's last row
  if (nh <= 0) return;                      // CTA-uniform

  // ---- phase 1: R = C_s . B_t^T for the t-blocks at or below the diagonal
  // items (t-block, state chunk), the state chunk fastest
  const float* cg = a.c + bi * a.sc[0] + ci * a.sc[1] + grp * a.sc[3];
  const float* bg = a.b + bi * a.sb[0] + ci * a.sb[1] + grp * a.sb[3];
  const int n_tb = (s_end + kBT - 1) / kBT;
  const int n_kc = (a.N + kNK - 1) / kNK;
  const int n1 = n_tb * n_kc;

  // thread tid copies rows tid / 8 + 16 k (k < 4) of C (tid < 128) or of
  // B (tid >= 128), 4 state columns at 4 * (tid % 8)
  const int c1_row = (tid % 128) / (kNK / 4), c1_col = 4 * (tid % (kNK / 4));
  const bool c1_isb = tid >= 128;
  const float* c1_src = c1_isb ? bg : cg + s0 * a.sc[2];
  const long long c1_ld = c1_isb ? a.sb[2] : a.sc[2];
  auto load1 = [&](int slot, int tb, int kc) {
    const int n0 = kc * kNK;
    float* Cs = ring + slot * kStage1;
    float* Bs = Cs + kBS * kLdCB;
    if constexpr (kVec) {
      const int row0 = c1_isb ? tb * kBT : s0;
      const float* src = c1_src + (c1_isb ? tb * kBT * c1_ld : 0) + n0
                         + c1_col;
      float* dst = (c1_isb ? Bs : Cs) + c1_row * kLdCB + c1_col;
      const bool n_ok = n0 + c1_col < a.N;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = c1_row + 16 * k;
        const bool ok = n_ok && row0 + r < a.Q;
        cp_async16(dst + 16 * k * kLdCB, ok ? src + r * c1_ld : cg, ok);
      }
    } else {
      for (int e = tid; e < 2 * kBS * kNK; e += kThreads) {
        const int isb = e / (kBS * kNK);
        const int r = (e / kNK) % kBS, k = e % kNK;
        const int n = n0 + k;
        const int row = isb ? tb * kBT + r : s0 + r;
        const bool ok = row < a.Q && n < a.N;
        const float* src = isb ? bg + row * a.sb[2] + n
                               : cg + row * a.sc[2] + n;
        cp_async4((isb ? Bs : Cs) + r * kLdCB + k, ok ? src : cg, ok);
      }
    }
  };

  // warp w: rows r0 .. r0 + 15, t columns 32 * half .. + 31 of each block
  float acc[4][4];
  load1(0, 0, 0);
  cp_async_commit();
  int l_tb = n_kc > 1 ? 0 : 1, l_kc = n_kc > 1 ? 1 : 0;  // the next load
  int tb = 0, kc = 0;                                     // this item
  for (int i = 0; i < n1; ++i) {
    cp_async_wait<kStages1 - 2>();
    __syncthreads();
    if (i + 1 < n1) {
      load1((i + 1) % kStages1, l_tb, l_kc);
      if (++l_kc == n_kc) {
        l_kc = 0;
        ++l_tb;
      }
    }
    cp_async_commit();
    const int tc0 = tb * kBT + 32 * half;   // the warp's first column
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    // columns wholly right of the warp's last row are never read
    if (live && tc0 <= s_last) {
      const float* Cs = ring + (i % kStages1) * kStage1;
      const float* Bs = Cs + kBS * kLdCB + 32 * half * kLdCB;
#pragma unroll
      for (int ks = 0; ks < kNK / 8; ++ks) {
        const int k = 8 * ks + qd;
        const float* ca = Cs + (r0 + gq) * kLdCB + k;
        uint32_t ah[4], al[4];
        split_tf32(ca[0], ah[0], al[0]);
        split_tf32(ca[8 * kLdCB], ah[1], al[1]);
        split_tf32(ca[4], ah[2], al[2]);
        split_tf32(ca[8 * kLdCB + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bb = Bs + (8 * j + gq) * kLdCB + k;
          mma_3xtf32(acc[j], ah, al, bb[0], bb[4]);
        }
      }
      if (kc == n_kc - 1) {
        float* ra = R + (r0 + gq) * ldr + tc0 + 2 * qd;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ra[8 * j] = acc[j][0];
          ra[8 * j + 1] = acc[j][1];
          ra[8 * ldr + 8 * j] = acc[j][2];
          ra[8 * ldr + 8 * j + 1] = acc[j][3];
        }
      }
    }
    if (++kc == n_kc) {
      kc = 0;
      ++tb;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is phase 2's now, and R is whole

  // ---- phase 2: y_h = S_h . X_h for each head (and p block) of the block
  // items (head pair, p block, t-chunk), the t-chunk fastest; warps of
  // parity q = warp / 4 take head 2 j + q of pair j, all 64 p columns
  const int n_pb = (a.P + kBP - 1) / kBP;
  const int n_tc = (s_end + kTC - 1) / kTC;
  const int n_pairs = (nh + 1) / 2;
  const int n2 = n_pairs * n_pb * n_tc;

  // thread tid copies, for head parity q = tid / 128, X rows
  // (tid % 128) / 16 + 8 k (k < 4), 4 columns at 4 * (tid % 16); and one of
  // cums_t, dt_t (idx < 64) or the block's cums_s (64 <= idx < 128, with
  // a head's first chunk only), idx = tid % 128
  const int c2_q = tid / 128, c2_i = tid % 128;
  const int c2_row = c2_i / (kBP / 4), c2_col = 4 * (c2_i % (kBP / 4));
  const float* x_bc = a.x + bi * a.sx[0] + ci * a.sx[1];
  const float* cu_bc = a.cums + bi * a.scu[0] + ci * a.scu[1];
  const float* dt_bc = a.dt + bi * a.sdt[0] + ci * a.sdt[1];
  auto load2 = [&](int slot, int pair, int pb, int tc) {
    const int hl = 2 * pair + c2_q, h = h0 + hl;
    const bool h_ok = hl < nh;
    const int p0 = pb * kBP, t0 = tc * kTC;
    float* st = ring + slot * kStage2 + c2_q * kHead2;
    const float* xh = x_bc + h * a.sx[3];
    if constexpr (kVec) {
      const float* src = xh + (t0 + c2_row) * a.sx[2] + p0 + c2_col;
      float* dst = st + c2_row * kLdX + c2_col;
      const bool p_ok = h_ok && p0 + c2_col < a.P;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool ok = p_ok && t0 + c2_row + 8 * k < a.Q;
        cp_async16(dst + 8 * k * kLdX, ok ? src + 8 * k * a.sx[2] : a.x, ok);
      }
    } else {
      for (int e = c2_i; e < kTC * kBP; e += kThreads / 2) {
        const int r = e / kBP, col = e % kBP;
        const int t = t0 + r, p = p0 + col;
        const bool ok = h_ok && t < a.Q && p < a.P;
        cp_async4(st + r * kLdX + col, ok ? xh + t * a.sx[2] + p : a.x, ok);
      }
    }
    const float* cuh = cu_bc + h * a.scu[3];
    if (c2_i < 2 * kTC) {
      const int t = t0 + c2_i % kTC;
      const bool ok = h_ok && t < a.Q;
      const float* src = c2_i < kTC ? cuh + t * a.scu[2]
                                    : dt_bc + h * a.sdt[3] + t * a.sdt[2];
      cp_async4(st + kTC * kLdX + c2_i, ok ? src : a.cums, ok);
    } else if (tc == 0) {
      const int s = s0 + c2_i - 2 * kTC;
      const bool ok = h_ok && s < a.Q;
      cp_async4(st + kTC * kLdX + c2_i, ok ? cuh + s * a.scu[2] : a.cums,
                ok);
    }
  };

  int l_pair = 0, l_pb = 0, l_tc = 0;  // the next item to load
  auto load_next = [&](int slot) {
    load2(slot, l_pair, l_pb, l_tc);
    if (++l_tc == n_tc) {
      l_tc = 0;
      if (++l_pb == n_pb) {
        l_pb = 0;
        ++l_pair;
      }
    }
  };
#pragma unroll
  for (int k = 0; k < kStages2 - 1; ++k) {
    if (k < n2) load_next(k);
    cp_async_commit();
  }
  // warp w: rows r0 .. r0 + 15 of head 2 j + half, every p of the block
  constexpr float kLog2e = 1.4426950408889634f;
  const float kNegInf = -__int_as_float(0x7f800000);
  const int sa = s0 + r0 + gq, sb = sa + 8;  // the thread's two rows
  const bool va = sa < a.Q, vb = sb < a.Q;
  const float* Ra = R + (r0 + gq) * ldr;
  const float* Rb = Ra + 8 * ldr;
  float acc2[8][4];
  int pair = 0, pb = 0, tc = 0;              // this item
  float csa = 0.f, csb = 0.f;                // cums of the thread's rows
  for (int i = 0; i < n2; ++i) {
    cp_async_wait<kStages2 - 2>();
    __syncthreads();
    if (i + kStages2 - 1 < n2) load_next((i + kStages2 - 1) % kStages2);
    cp_async_commit();
    const int t0 = tc * kTC, hl = 2 * pair + half;
    const float* Xs = ring + (i % kStages2) * kStage2 + half * kHead2;
    const float* ct = Xs + kTC * kLdX;
    const float* dtt = ct + kTC;
    if (tc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;
      csa = dtt[kTC + r0 + gq];
      csb = dtt[kTC + r0 + gq + 8];
    }
    // a chunk wholly above the warp's rows adds nothing; inside one, S is
    // masked element by element without a branch: the exponent of an
    // element with t > s (or s past Q) is -inf, whose 2^. is 0, so the
    // positive exponent above the diagonal is never exponentiated.  Every
    // score read here was written by phase 1 (finite).
    if (live && hl < nh && t0 <= s_last) {
#pragma unroll
      for (int ks = 0; ks < kTC / 8; ++ks) {
        const int tl = 8 * ks + qd, ta = t0 + tl, tb = ta + 4;
        const float cta = ct[tl], ctb = ct[tl + 4];
        const float dta = dtt[tl], dtb = dtt[tl + 4];
        float v[4];
        v[0] = Ra[ta] * ex2((va && ta <= sa ? csa - cta : kNegInf) * kLog2e)
               * dta;
        v[1] = Rb[ta] * ex2((vb && ta <= sb ? csb - cta : kNegInf) * kLog2e)
               * dta;
        v[2] = Ra[tb] * ex2((va && tb <= sa ? csa - ctb : kNegInf) * kLog2e)
               * dtb;
        v[3] = Rb[tb] * ex2((vb && tb <= sb ? csb - ctb : kNegInf) * kLog2e)
               * dtb;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[e], al[e]);
        const float* xb = Xs + tl * kLdX + gq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_3xtf32(acc2[j], ah, al, xb[8 * j], xb[4 * kLdX + 8 * j]);
      }
    }
    if (tc == n_tc - 1 && live && hl < nh) {
      const int p0 = pb * kBP;
      float* yh = a.y + bi * a.sy[0] + ci * a.sy[1] + (h0 + hl) * a.sy[3];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 8 * j + 2 * qd;
        if (kVec) {      // P % 4 == 0 and y rows 8-byte aligned
          if (p < a.P) {
            if (va)
              *reinterpret_cast<float2*>(yh + sa * a.sy[2] + p) =
                  make_float2(acc2[j][0], acc2[j][1]);
            if (vb)
              *reinterpret_cast<float2*>(yh + sb * a.sy[2] + p) =
                  make_float2(acc2[j][2], acc2[j][3]);
          }
        } else {
          if (va && p < a.P) yh[sa * a.sy[2] + p] = acc2[j][0];
          if (va && p + 1 < a.P) yh[sa * a.sy[2] + p + 1] = acc2[j][1];
          if (vb && p < a.P) yh[sb * a.sy[2] + p] = acc2[j][2];
          if (vb && p + 1 < a.P) yh[sb * a.sy[2] + p + 1] = acc2[j][3];
        }
      }
    }
    if (++tc == n_tc) {
      tc = 0;
      if (++pb == n_pb) {
        pb = 0;
        ++pair;
      }
    }
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of a launch: the ring and the 64 score rows.
int smem_bytes(int Q) {
  const int ldr = (Q + kBT - 1) / kBT * kBT + 4;
  return static_cast<int>(sizeof(float)) * (kRing + kBS * ldr);
}

template <bool kVec>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static int opted = 0;   // dynamic shared memory already allowed
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    // all of L1 as shared memory: two CTAs of ~103 KB an SM at Q = 256
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_intra_kernel<kVec>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  ssd_intra_kernel<kVec><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 24 element strides, (batch, chunk, row, head or group) of x, dt,
// cums, b, c and y in that order.  head_block: heads a CTA (ssd_plan);
// vec: x, b and c rows 16-byte aligned with P and N multiples of 4.
extern "C" int ssd_intra_launch(const float* x, const float* dt,
                                const float* cums, const float* b,
                                const float* c, float* y,
                                const long long* strides, int batch, int nc,
                                int Q, int H, int G, int P, int N,
                                int head_block, int vec, void* stream) {
  if (batch <= 0 || nc <= 0 || Q <= 0 || H <= 0 || G <= 0 || P <= 0 ||
      N <= 0 || H % G != 0 || head_block <= 0 || head_block > H / G)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, dt, cums, b, c, y};
  long long* dst[6] = {a.sx, a.sdt, a.scu, a.sb, a.sc, a.sy};
  for (int k = 0; k < 6; ++k)
    for (int d = 0; d < 4; ++d) dst[k][d] = strides[4 * k + d];
  a.nc = nc;
  a.Q = Q;
  a.H = H;
  a.G = G;
  a.P = P;
  a.N = N;
  a.hb = head_block;
  a.nhb = (H / G + head_block - 1) / head_block;
  const dim3 grid(G * a.nhb, batch * nc, (Q + kBS - 1) / kBS);
  const int smem = smem_bytes(Q);
  if (grid.y > 65535 || grid.z > 65535 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(a, grid, smem, st)
             : launch<false>(a, grid, smem, st);
}
