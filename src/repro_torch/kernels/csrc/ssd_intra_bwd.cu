// SSD (Mamba2) intra-chunk backward for Hopper (sm_90a), K5-bwd.
//
// The gradient of K5 (ssd_intra.cu).  The reference has no Pallas backward:
// it differentiates its plain jnp SSD, so this kernel replaces no TPU
// kernel; it is what lets the port's mamba2 and zamba2 train through K5.
//
// The forward, for batch b, chunk c and head h of group g = h / (H / G):
//   R[s,t] = C[s,g,:] . B[t,g,:]                        (once a group)
//   L[s,t] = exp(cums[s,h] - cums[t,h]) for t <= s, else 0
//   M[s,t] = R[s,t] L[s,t] dt[t,h]
//   y[s,h,p] = sum_t M[s,t] x[t,h,p]
// and, given dy, this kernel writes in fp32
//   dM[s,t]   = sum_p dy[s,h,p] x[t,h,p]                (t <= s)
//   dx[t,h,p] = sum_s M[s,t] dy[s,h,p]
//   ddt[t,h]  = sum_s dM[s,t] R[s,t] L[s,t]
//   W[s,t]    = sum over the group's heads of dM[s,t] L[s,t] dt[t,h]
//   dC[s,g,:] = sum_t W[s,t] B[t,g,:],   dB[t,g,:] = sum_s W[s,t] C[s,g,:]
//   dcums[s,h] = sum_t Z[s,t] - sum_s' Z[s',s],   Z = dM * M
// on operands in any element strides (x, dy (B, nc, Q, H, P); dt, cums
// (B, nc, Q, H); B, C (B, nc, Q, G, N)); the outputs are contiguous in the
// same shapes.  The decay exponent is formed only where t <= s (above the
// diagonal it is positive and overflows exp at full width).
//
// Design (a simple kernel; every product in true fp32 on the CUDA cores,
// expf for the decay):
//   * Kernel 1 (main): one CTA (8 warps) a (head block of one group, batch
//     x chunk, 64-column t-block).  It first computes the group's score
//     slab R[s, t-block] for every s >= the block's first t into shared
//     memory (up to Q x 64 fp32), then for each head of the block walks
//     the s-blocks at or below the diagonal: dM (64 x 64 over P), the
//     elementwise terms, and dx (64 x P, summed over the walk's s-blocks
//     in registers).  It owns dx, ddt and
//     the column half of dcums of its t-block and head outright; it writes
//     the row sums of Z a t-block at a time (`rowpart`) and its head
//     block's share of W for its t-block columns (`wpart`), each element
//     written once.
//   * Kernel 2 (reduce): one CTA a (group, batch x chunk, 64-row block,
//     role).  Role dC sums W over the head blocks (in order) and multiplies
//     by B over the t-blocks at or below its s-block; role dB the same with
//     C over the s-blocks at or above its t-block; the dC CTAs also finish
//     dcums: the row sums over the t-blocks (in order) minus the column
//     sums kernel 1 left in dcums.
//   * 4 x 4 register tiles a thread (16 x 16 threads over a 64 x 64 tile),
//     float4 reads of shared rows padded to 68 floats.
//   * No float atomics: every output and scratch element has one owner and
//     each sum a fixed order, so two calls give bit-equal results.
//   * Limits: P <= 64; Q <= 256 (the score and W slabs are 2 x Q x 64
//     fp32 of shared memory; 210 KB at Q = 256).  The wrapper refuses the
//     rest.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kB = 64;         // s rows of an s-block, t columns of a t-block
constexpr int kLd = 68;        // padded row of a 64-wide tile (floats)
constexpr int kNK = 32;        // state columns a score stage
constexpr int kMaxP = 64;
constexpr int kMaxQ = 256;
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on the H100

struct Args {
  const float* x;
  const float* dt;
  const float* cums;
  const float* b;
  const float* c;
  const float* dy;
  float* dx;
  float* ddt;
  float* dcums;
  float* db;
  float* dc;
  float* wpart;    // (B nc, G nhb, Q, Q): a head block's W
  float* rowpart;  // (B nc, H, ntb, Q): row sums of Z a t-block
  // element strides: (batch, chunk, row, head, p) of x and dy, (batch,
  // chunk, row, head) of dt and cums, (batch, chunk, row, group, n) of B, C
  long long sx[5], sdt[4], scu[4], sb[5], sc[5], sdy[5];
  int nc, Q, H, G, P, N, hb, nhb, ntb;
};

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 u,
                                       const float4 v) {
  const float a[4] = {u.x, u.y, u.z, u.w};
  const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Floats of kernel 1's dynamic shared memory: the R and W slabs (Qp x 64
// each), four 64 x kLd tiles, cums of the slab's rows (Qp), cums_t and
// dt_t (64 each), and the column-sum buffer (2 x 16 x 64).
__host__ __device__ int main_smem_floats(int Qp) {
  return 2 * Qp * kB + 4 * kB * kLd + Qp + 2 * kB + 2 * 16 * kB;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_main(const Args a) {
  extern __shared__ float4 smem4[];
  const int Qp = (a.Q + kB - 1) / kB * kB;
  float* Rs = reinterpret_cast<float*>(smem4);  // R[s][t], s from T0
  float* Ws = Rs + Qp * kB;                     // W[s][t], s from T0
  float* XtT = Ws + Qp * kB;                    // x[t][p] as [p][t]
  float* YsT = XtT + kB * kLd;                  // dy[s][p] as [p][s]
  float* Ys = YsT + kB * kLd;                   // dy[s][p]
  float* Ms = Ys + kB * kLd;                    // M[s][t]
  float* cs = Ms + kB * kLd;                    // cums_s, s from T0
  float* ct = cs + Qp;                          // cums_t
  float* dtt = ct + kB;                         // dt_t
  float* red = dtt + kB;                        // column sums, 2 x 16 x 64

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;  // the thread's row and column group
  const int rep = a.H / a.G;
  const int grp = blockIdx.x / a.nhb, hbi = blockIdx.x % a.nhb;
  const int h0 = grp * rep + hbi * a.hb;
  const int nh = min(a.hb, rep - hbi * a.hb);
  const int bc = blockIdx.y;
  const int bi = bc / a.nc, ci = bc % a.nc;
  const int tb = blockIdx.z;  // z = 0, the longest walk, is scheduled first
  const int T0 = tb * kB;
  const int nsb = Qp / kB;
  if (nh <= 0) return;  // CTA-uniform

  // ---- the group's scores R[s][t] for s >= T0 and the t-block's columns
  {
    const float* cgp = a.c + bi * a.sc[0] + ci * a.sc[1] + grp * a.sc[3];
    const float* bgp = a.b + bi * a.sb[0] + ci * a.sb[1] + grp * a.sb[3];
    float* CsT = XtT;  // staging: C[s][n] as [n][s], B[t][n] as [n][t]
    float* BsT = YsT;
    for (int sb = tb; sb < nsb; ++sb) {
      const int S0 = sb * kB;
      float acc[4][4] = {};
      for (int n0 = 0; n0 < a.N; n0 += kNK) {
        __syncthreads();
        for (int e = tid; e < kB * kNK; e += kThreads) {
          const int r = e / kNK, k = e % kNK, n = n0 + k;
          const int s = S0 + r, t = T0 + r;
          CsT[k * kLd + r] = (s < a.Q && n < a.N)
                                 ? cgp[s * a.sc[2] + n * a.sc[4]] : 0.f;
          BsT[k * kLd + r] = (t < a.Q && n < a.N)
                                 ? bgp[t * a.sb[2] + n * a.sb[4]] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kNK; ++k)
          fma4x4(acc, ld4(CsT + k * kLd + 4 * rg), ld4(BsT + k * kLd + 4 * cg));
      }
      float* rr = Rs + (S0 - T0 + 4 * rg) * kB + 4 * cg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(rr + i * kB) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    for (int e = tid; e < (Qp - T0) * kB; e += kThreads) Ws[e] = 0.f;
  }

  // ---- each head of the block: walk the s-blocks at or below the diagonal
  const float* xb = a.x + bi * a.sx[0] + ci * a.sx[1];
  const float* dyb = a.dy + bi * a.sdy[0] + ci * a.sdy[1];
  const float* cub = a.cums + bi * a.scu[0] + ci * a.scu[1];
  const float* dtb = a.dt + bi * a.sdt[0] + ci * a.sdt[1];
  for (int hl = 0; hl < nh; ++hl) {
    const int h = h0 + hl;
    const float* xh = xb + h * a.sx[3];
    const float* dyh = dyb + h * a.sdy[3];
    __syncthreads();  // the previous head's readers are done
    for (int e = tid; e < kB * kMaxP; e += kThreads) {
      const int r = e / kMaxP, p = e % kMaxP, t = T0 + r;
      XtT[p * kLd + r] = (t < a.Q && p < a.P)
                             ? xh[t * a.sx[2] + p * a.sx[4]] : 0.f;
    }
    if (tid < kB) {
      const int t = T0 + tid;
      ct[tid] = t < a.Q ? cub[t * a.scu[2] + h * a.scu[3]] : 0.f;
      dtt[tid] = t < a.Q ? dtb[t * a.sdt[2] + h * a.sdt[3]] : 0.f;
    }
    for (int e = tid; e < Qp - T0; e += kThreads) {
      const int s = T0 + e;
      cs[e] = s < a.Q ? cub[s * a.scu[2] + h * a.scu[3]] : 0.f;
    }
    float dxa[4][4] = {};   // dx[T0 + 4 rg + i][4 cg + j]
    float cola[4] = {}, ddta[4] = {};  // column sums over the thread's rows
    for (int sb = tb; sb < nsb; ++sb) {
      const int S0 = sb * kB;
      __syncthreads();  // Ys, YsT and Ms are free; the head's rows are in
      for (int e = tid; e < kB * kMaxP; e += kThreads) {
        const int r = e / kMaxP, p = e % kMaxP, s = S0 + r;
        const float v = (s < a.Q && p < a.P)
                            ? dyh[s * a.sdy[2] + p * a.sdy[4]] : 0.f;
        Ys[r * kLd + p] = v;
        YsT[p * kLd + r] = v;
      }
      __syncthreads();
      // dM[s][t], s = S0 + 4 rg + i, t = T0 + 4 cg + j
      float dm[4][4] = {};
      for (int p = 0; p < a.P; ++p)
        fma4x4(dm, ld4(YsT + p * kLd + 4 * rg), ld4(XtT + p * kLd + 4 * cg));
      const float4 ct4 = ld4(ct + 4 * cg), dt4 = ld4(dtt + 4 * cg);
      const float ctj[4] = {ct4.x, ct4.y, ct4.z, ct4.w};
      const float dtj[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sl = S0 - T0 + 4 * rg + i, s = S0 + 4 * rg + i;
        float* rrow = Rs + sl * kB + 4 * cg;
        float* wrow = Ws + sl * kB + 4 * cg;
        const float4 r4 = ld4(rrow);
        const float4 w4 = ld4(wrow);
        const float rj[4] = {r4.x, r4.y, r4.z, r4.w};
        float wj[4] = {w4.x, w4.y, w4.z, w4.w};
        float mj[4];
        float rowz = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = T0 + 4 * cg + j;
          const bool valid = t <= s && s < a.Q;
          const float L = valid ? expf(cs[sl] - ctj[j]) : 0.f;
          const float dmv = valid ? dm[i][j] : 0.f;
          const float rl = rj[j] * L;
          const float mv = rl * dtj[j];
          const float z = dmv * mv;
          rowz += z;
          cola[j] += z;
          ddta[j] = fmaf(dmv, rl, ddta[j]);
          wj[j] = fmaf(dmv * L, dtj[j], wj[j]);
          mj[j] = mv;
        }
        *reinterpret_cast<float4*>(wrow) = make_float4(wj[0], wj[1], wj[2],
                                                       wj[3]);
        *reinterpret_cast<float4*>(Ms + (4 * rg + i) * kLd + 4 * cg) =
            make_float4(mj[0], mj[1], mj[2], mj[3]);
        // the row's sum over the t-block: the 16 lanes of a half-warp
        // hold its 16 column groups (a fixed butterfly)
        rowz += __shfl_xor_sync(0xffffffffu, rowz, 8);
        rowz += __shfl_xor_sync(0xffffffffu, rowz, 4);
        rowz += __shfl_xor_sync(0xffffffffu, rowz, 2);
        rowz += __shfl_xor_sync(0xffffffffu, rowz, 1);
        if (cg == 0 && s < a.Q)
          a.rowpart[((static_cast<long long>(bc) * a.H + h) * a.ntb + tb) *
                        a.Q + s] = rowz;
      }
      __syncthreads();  // M of the s-block is whole
      // dx[t][p] += sum_s M[s][t] dy[s][p], t = T0 + 4 rg + i, p = 4 cg + j
#pragma unroll 8
      for (int s = 0; s < kB; ++s)
        fma4x4(dxa, ld4(Ms + s * kLd + 4 * rg), ld4(Ys + s * kLd + 4 * cg));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = T0 + 4 * rg + i;
      if (t >= a.Q) continue;
      float* dxr = a.dx + ((static_cast<long long>(bc) * a.Q + t) * a.H + h) *
                              a.P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * cg + j < a.P) dxr[4 * cg + j] = dxa[i][j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[rg * kB + 4 * cg + j] = cola[j];
      red[16 * kB + rg * kB + 4 * cg + j] = ddta[j];
    }
    __syncthreads();
    if (tid < kB && T0 + tid < a.Q) {
      float zc = 0.f, dd = 0.f;
      for (int r = 0; r < 16; ++r) {
        zc += red[r * kB + tid];
        dd += red[16 * kB + r * kB + tid];
      }
      const long long o = (static_cast<long long>(bc) * a.Q + T0 + tid) * a.H
                          + h;
      a.ddt[o] = dd;
      a.dcums[o] = zc;  // the column half; kernel 2 subtracts it
    }
  }

  // ---- this head block's W for the t-block's columns, rows s >= T0
  __syncthreads();
  float* wp = a.wpart + (static_cast<long long>(bc) * a.G * a.nhb +
                         blockIdx.x) * a.Q * a.Q;
  for (int e = tid; e < (Qp - T0) * kB; e += kThreads) {
    const int s = T0 + e / kB, t = T0 + e % kB;
    if (s < a.Q && t < a.Q) wp[static_cast<long long>(s) * a.Q + t] = Ws[e];
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const Args a) {
  __shared__ float4 smem4[2 * kB * kLd / 4];
  float* Wt = reinterpret_cast<float*>(smem4);
  float* Vs = Wt + kB * kLd;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int grp = blockIdx.x, bc = blockIdx.y;
  const int bi = bc / a.nc, ci = bc % a.nc;
  const int nsb = a.ntb;
  const bool role_db = static_cast<int>(blockIdx.z) >= nsb;
  const int blk = blockIdx.z % nsb;
  const int R0 = blk * kB;  // the CTA's rows: s (dC) or t (dB)
  const float* wbase = a.wpart + (static_cast<long long>(bc) * a.G * a.nhb +
                                  grp * a.nhb) * a.Q * a.Q;
  const long long wstride = static_cast<long long>(a.Q) * a.Q;
  // dC multiplies by B over t, dB by C over s
  const float* vg = role_db
      ? a.c + bi * a.sc[0] + ci * a.sc[1] + grp * a.sc[3]
      : a.b + bi * a.sb[0] + ci * a.sb[1] + grp * a.sb[3];
  const long long vrow = role_db ? a.sc[2] : a.sb[2];
  const long long vcol = role_db ? a.sc[4] : a.sb[4];
  const int ob0 = role_db ? blk : 0, ob1 = role_db ? nsb : blk + 1;
  for (int n0 = 0; n0 < a.N; n0 += kB) {
    float acc[4][4] = {};
    for (int ob = ob0; ob < ob1; ++ob) {
      const int O0 = ob * kB;
      __syncthreads();
      for (int e = tid; e < kB * kB; e += kThreads) {
        const int r = e / kB, q = e % kB;
        // dC: W[R0 + r][O0 + q] stored as [t][s]; dB: W[O0 + r][R0 + q]
        // stored as [s][t]: row k of Wt is the summed-over index
        const int s = role_db ? O0 + r : R0 + r;
        const int t = role_db ? R0 + q : O0 + q;
        float w = 0.f;
        if (s < a.Q && t < a.Q) {
          const float* src = wbase + static_cast<long long>(s) * a.Q + t;
          for (int k = 0; k < a.nhb; ++k) w += src[k * wstride];
        }
        if (role_db)
          Wt[r * kLd + q] = w;
        else
          Wt[q * kLd + r] = w;
        const int o = O0 + r, n = n0 + q;
        Vs[r * kLd + q] = (o < a.Q && n < a.N) ? vg[o * vrow + n * vcol]
                                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kB; ++k)
        fma4x4(acc, ld4(Wt + k * kLd + 4 * rg), ld4(Vs + k * kLd + 4 * cg));
    }
    float* out = role_db ? a.db : a.dc;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = R0 + 4 * rg + i;
      if (row >= a.Q) continue;
      float* orow = out + ((static_cast<long long>(bc) * a.Q + row) * a.G +
                           grp) * a.N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + 4 * cg + j < a.N) orow[n0 + 4 * cg + j] = acc[i][j];
    }
  }
  if (role_db) return;
  // dcums[s][h] = the row sums of Z over the t-blocks <= this s-block, in
  // order, minus the column sum kernel 1 left there
  const int rep = a.H / a.G;
  for (int e = tid; e < rep * kB; e += kThreads) {
    const int s = R0 + e % kB, h = grp * rep + e / kB;
    if (s >= a.Q) continue;
    const float* rp = a.rowpart + (static_cast<long long>(bc) * a.H + h) *
                                      a.ntb * a.Q + s;
    float rs = 0.f;
    for (int k = 0; k <= blk; ++k) rs += rp[static_cast<long long>(k) * a.Q];
    const long long o = (static_cast<long long>(bc) * a.Q + s) * a.H + h;
    a.dcums[o] = rs - a.dcums[o];
  }
}

}  // namespace

// Dynamic shared memory (bytes) of kernel 1 at chunk length Q.
extern "C" int ssd_intra_bwd_smem_bytes(int Q) {
  const int Qp = (Q + kB - 1) / kB * kB;
  return static_cast<int>(sizeof(float)) * main_smem_floats(Qp);
}

// strides: 28 element strides: x (5), dt (4), cums (4), b (5), c (5),
// dy (5).  Outputs dx, ddt, dcums, db, dc contiguous in the inputs' shapes;
// wpart (batch nc, G nhb, Q, Q) and rowpart (batch nc, H, ceil(Q / 64), Q)
// fp32 scratch, nhb = ceil((H / G) / head_block).
extern "C" int ssd_intra_bwd_launch(
    const float* x, const float* dt, const float* cums, const float* b,
    const float* c, const float* dy, float* dx, float* ddt, float* dcums,
    float* db, float* dc, float* wpart, float* rowpart,
    const long long* strides, int batch, int nc, int Q, int H, int G, int P,
    int N, int head_block, void* stream) {
  if (batch <= 0 || nc <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || G <= 0 ||
      P <= 0 || P > kMaxP || N <= 0 || H % G != 0 || head_block <= 0 ||
      head_block > H / G)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, dt, cums, b, c, dy, dx, ddt, dcums, db, dc, wpart, rowpart};
  const int counts[6] = {5, 4, 4, 5, 5, 5};
  long long* dst[6] = {a.sx, a.sdt, a.scu, a.sb, a.sc, a.sdy};
  int k = 0;
  for (int o = 0; o < 6; ++o)
    for (int d = 0; d < counts[o]; ++d) dst[o][d] = strides[k++];
  a.nc = nc;
  a.Q = Q;
  a.H = H;
  a.G = G;
  a.P = P;
  a.N = N;
  a.hb = head_block;
  a.nhb = (H / G + head_block - 1) / head_block;
  a.ntb = (Q + kB - 1) / kB;
  const long long bcn = static_cast<long long>(batch) * nc;
  if (bcn > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ssd_intra_bwd_smem_bytes(Q);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int opted = 0;  // dynamic shared memory already allowed
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_main, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  ssd_bwd_main<<<dim3(G * a.nhb, static_cast<unsigned>(bcn), a.ntb),
                 kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_reduce<<<dim3(G, static_cast<unsigned>(bcn), 2 * a.ntb), kThreads,
                   0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
