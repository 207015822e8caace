// Limb GEMM for Hopper (sm_90a): exact integer GEMM by int8 digit products
// on the tensor cores.
//
// Replaces the Pallas kernel src/repro/kernels/limb_gemm.py:61,
// limb_gemm_diagonals (body _limb_gemm_kernel), the paper's exact
// multi-precision integer GEMM (§3.1).
//
// What it computes: the balanced base-128 digits of two integer matrices,
// A_i (M, K) and B_j (K, N), give the anti-diagonal sums S_d = sum_{i+j=d}
// A_i . B_j, exact in int32 for K <= 2^17.  One mainloop, two entries
// (kernels/limb_gemm.py):
//
//  * planes (limb_gemm_diagonals): the digits come in as int8 limb planes
//    (la, M, K) and (lb, K, N); out (la + lb - 1, M, N) int32 = S.
//  * fused (limb_matmul_fused, ops.limb_matmul on the card): the raw int8,
//    int16 or int32 operands come in, each its own type, and are cut into
//    digits in shared memory; the epilogue folds the planes in registers,
//    sum_d S_d << 7d in int64 (wrapping mod 2^64), and stores the (hi, lo)
//    int32 pair.  Neither the digits nor the planes reach device memory:
//    one launch reads the operands once and writes 8 bytes an output.
//
// Every product and sum is an integer, so any order gives the same bits;
// repeats are bit-equal.
//
// What bounds it on this card: bytes at every shape of the port's integer
// workloads.  md.update960 (960 x 960 x 64, int32): 0.49 MB in, 7.37 MB
// of (hi, lo) out, 2.35 us at 3.35 TB/s (the planes entry writes nine
// planes, 33 MB, 10.1 us); alexnet.fc6 (32 x 4096 x 9216, int8): B's
// 37.7 MB, 11.7 us.  The int8 tensor-core work is below the bytes: 1.5
// and 4.9 us at 1,979 TOP/s with the reference's digit counts (an int8
// value is its own digit here, a quarter of that at fc6).
//
// Design (one CTA per tile of TP = 64 WG rows on wgmma's M by TQ on its n;
// P is A's rows, or B's columns when `swap`, for M < 64, puts A's rows on
// the n side):
//
//   1. Staging.  The raw tiles of a K stage (BK = 32 KS values of K) go
//      into a ring of `stages` slots.  All threads copy with cp.async:
//      16-byte chunks where rows allow, else 8 or 4 bytes, else element
//      loads (rows that are not whole 4-byte chunks, unaligned bases).
//      B's rows (k) keep their 16-byte chunks XOR-swizzled by k / 4, so the
//      transposing reads below hit two banks at most (four for 64-byte
//      rows).  Where B is int8 and its tile is 128 columns by 128 k
//      (alexnet's swapped tiles), one thread asks TMA for the whole 16 KB
//      box a plane instead (128-byte
//      swizzle, an mbarrier a slot): there the threads' cp.async copies
//      stall on the copies an SM may have in flight and stream B slower.
//      Edges are zero-filled: zero digits add nothing.
//   2. Digits.  The threads cut the stage into balanced base-128 digits
//      and write each digit plane K-major with the 128-byte swizzle wgmma
//      reads: A's rows as they are, B transposed (4 x 4 byte blocks
//      regrouped with byte permutes), since 8-bit wgmma takes K-major
//      operands only.  A digit is a 7-bit field of x + 64 (128^n - 1) / 127
//      less 64 -- the same digits as limb_gemm.limb_decompose's recurrence,
//      four a word in a few instructions; a value wider than its digits
//      loses the remainder in both.  An int8 limb, or an int8 value that
//      its digits hold exactly, is its own digit (the latter only for K
//      below 2^17: |a b| <= 2^14, so 2^17 such products could reach 2^31).
//      Then fence.proxy.async and a CTA barrier.
//   3. wgmma.mma_async m64nTQk32 s32.s8.s8: every digit pair (i, j) adds
//      into plane i + j, L x L pairs of KS k-steps a stage, unconditionally
//      (digits past an operand's count are zero planes), then a wait.  The
//      2L - 1 planes stay in registers over the CTA's K range: 9 planes of
//      TQ / 2 = 8 registers at L = 5.  Where K is one stage and the tiles
//      are many (the MD updates), a CTA walks `qs` sub-tiles of TQ with
//      one set of planes at a time, cutting its P side into digits once.
//   4. K split.  Where the tiles leave SMs idle (alexnet's M = 32) the K
//      stages of a tile are split over a cluster of up to 8 ranks; the
//      ranks' int64 sums (fused) or int32 planes are added into rank 0
//      through distributed shared memory in rank order.  Each split, and K
//      itself, is at most 2^17, so every plane stays exact.
//   5. Epilogue.  Fused: the int64 fold (32 x 32 -> 64 multiply-adds for
//      the planes below bit 32, the high word alone above) and 16-byte
//      stores of hi and lo (lane pairs swap halves of their fragments, so
//      each lane holds four consecutive columns of one row).  Planes:
//      each plane's tile written into one of two staging tiles in the dead
//      ring and stored by TMA (whole row segments, where the fragments'
//      stores came in 8-byte pieces from every lane), where the rows allow
//      it; else 8-byte stores.
//
// Shared memory stays addressed through the dynamic shared array (aligned
// by an offset), so its loads and stores compile to LDS / STS: aligning an
// integer cast of the pointer made them generic, at several times the
// instructions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace lg {

constexpr int kRow = 128;       // bytes of a digit row: 128 k, one swizzle span
constexpr int kMaxRanks = 8;    // largest cluster splitting K

// One operand as the kernel reads it.  A is (planes, M, K) and B (planes,
// K, N), row-major; raw operands have one plane.
struct Opnd {
  const uint8_t* p;
  long long row;     // bytes between rows
  long long plane;   // bytes between planes
  int es;            // bytes of an element: 1, 2 or 4
  int planes;        // input planes (limbs: la or lb; raw: 1)
  int digits;        // digits cut from each element (limbs: 1)
  int ident;         // 1: an int8 element is its own digit
  int vec;           // bytes a copy: 16, 8, 4, or es (element loads)
};

struct Geo {
  Opnd a, b;
  int32_t* out0;     // fused: hi (M, N); planes: (nplanes, M, N)
  int32_t* out1;     // fused: lo (M, N)
  int M, N, K;
  int swap, fused, nplanes;
  int nk;            // K stages
  int ranks, stages;
  int qs;            // TQ sub-tiles a CTA walks (one K stage, no split)
  int ra_row;        // bytes of an A row in a ring slot
  int rb_row;        // bytes of a B row (k) in a ring slot
  int raw_a;         // A bytes of a slot, B follows; 0: A's limbs are
                     // copied straight into the digit planes (one stage)
  int stage;         // bytes of a slot
  int off_raw;       // the ring's offset; digit planes at 0
  int wide;          // fused: N % 4 == 0 (16-byte stores); planes: N even
  int tma_b;         // B's stage by TMA (int8, swapped, 128 x 128 boxes)
  int tma_out;       // planes stored by TMA from two staging tiles
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int n,
                                         bool valid) {
  const uint32_t s = hop::smem_u32(dst);
  const int sz = valid ? n : 0;
  if (n == 16)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(sz));
  else if (n == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(s), "l"(src), "r"(sz));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(src), "r"(sz));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n copy groups are pending (n < 4).
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// Chunk c of B's row k sits at c ^ (k / 4), the XOR cut to the row's
// chunks by `mask` (0x70 for rows of 128 bytes or more, 0x30 for 64, ...).
__device__ __forceinline__ int swz(int mask, int k, int byte) {
  return byte ^ ((k << 2) & mask);
}

// A digit plane is K-major with the 128-byte swizzle wgmma reads: row r
// (128 k) at r * 128, its 16-byte chunk c at c ^ (r % 8); word kw (k = 4 kw
// .. 4 kw + 3) of row r sits at r * 128 + (4 kw ^ 16 (r % 8)).

// Balanced base-128 digits by a bias: y = x + 64 (128^nd - 1) / 127 holds
// d_i + 64 in its 7-bit field i < nd, where d_i are the nd digits that
// limb_decompose's recurrence gives (a value wider than nd digits loses
// the remainder in both).  `w` carries four such fields, one a byte (bit 7
// stray): each becomes the byte of d_i = v - 64, i.e. v ^ 0x40 when v >= 64
// and v + 192 = v ^ 0xC0 when v < 64.
__device__ __forceinline__ uint32_t digit_bytes(uint32_t w) {
  w &= 0x7F7F7F7Fu;
  return w ^ 0x40404040u ^ ((~w & 0x40404040u) << 1);
}

// The low bytes of four words, in order.
__device__ __forceinline__ uint32_t pack_low(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Bits 7 i .. 7 i + 7 of x + bias, from y = the low 32 bits of that sum
// (the fields below bit 28 need no more); the fifth field (bits 28 .. 35,
// five digits) from the 64-bit sum, x recovered as y - bias.
__device__ __forceinline__ uint32_t field(uint32_t y, int i,
                                          unsigned long long bias) {
  if (i < 4) return y >> (7 * i);
  const long long x = static_cast<int>(y - static_cast<uint32_t>(bias));
  return static_cast<uint32_t>((static_cast<unsigned long long>(x) + bias) >>
                               28);
}

// Four consecutive elements of a raw row, biased (low 32 bits).
__device__ __forceinline__ void load4(const uint8_t* src, int es,
                                      unsigned long long bias,
                                      uint32_t (&y)[4]) {
  int x[4];
  if (es == 4) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if (es == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    x[0] = static_cast<int16_t>(v.x & 0xFFFF);
    x[1] = static_cast<int16_t>(v.x >> 16);
    x[2] = static_cast<int16_t>(v.y & 0xFFFF);
    x[3] = static_cast<int16_t>(v.y >> 16);
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = static_cast<int8_t>((v >> (8 * e)) & 0xFF);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y[e] = static_cast<uint32_t>(x[e]) + static_cast<uint32_t>(bias);
}

// 64 (128^nd - 1) / 127: the bias of nd digits.
__device__ __forceinline__ unsigned long long digit_bias(int nd) {
  unsigned long long b = 0;
  for (int i = 0; i < nd; ++i) b = (b << 7) | 64;
  return b;
}

__device__ __forceinline__ int log2i(int x) { return __ffs(x) - 1; }

template <int L, int WG, int TQ, int KS>
__global__ void __launch_bounds__(WG * 128,
                                   L >= 3 && (2 * L - 1) * TQ / 2 > 20 ? 1
                                   : L == 1 ? 3 : 2)
limb_kernel(const Geo g, const __grid_constant__ CUtensorMap tmB,
            const __grid_constant__ CUtensorMap tmO) {
  constexpr int TP = 64 * WG;          // rows on wgmma's M
  constexpr int NT = WG * 128;         // threads: the consumer warpgroups
  constexpr int BK = 32 * KS;          // K values a stage
  constexpr int SW = KS == 2 ? 4 : 5;  // log2(BK / 4): words of a row
  static_assert(KS == 2 || KS == 4, "K stages of 64 or 128");
  constexpr int D = 2 * L - 1;         // planes
  constexpr int NR = TQ / 2;           // registers a plane

  // aligned by an offset from the shared array itself, so that every
  // pointer below stays in the shared window (LDS/STS, 32-bit addresses)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const int tq_all = g.qs * TQ;                // Q rows: qs sub-tiles
  uint8_t* dig_p = smem;                       // L planes of TP rows
  uint8_t* dig_q = smem + L * TP * kRow;       // L planes of tq_all rows
  uint8_t* ring = smem + g.off_raw;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffff, tid >> 5, 0);
  const uint32_t rank = g.ranks > 1 ? hop::cluster_rank() : 0;
  const int p0 = blockIdx.x * TP, q00 = blockIdx.y * tq_all;
  const int s0 =
      static_cast<int>(static_cast<long long>(blockIdx.z) * g.nk / g.ranks);
  const int s1 = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * g.nk / g.ranks);

  // A's tile: rows_a rows from row a0; B's: cols_b columns from column b0.
  // Every extent is a power of two: indices are cut by shifts.
  const int rows_a = g.swap ? tq_all : TP, cols_b = g.swap ? TP : tq_all;
  const int a0 = g.swap ? q00 : p0, b0 = g.swap ? p0 : q00;
  uint8_t* dig_a = g.swap ? dig_q : dig_p;
  uint8_t* dig_b = g.swap ? dig_p : dig_q;
  const int sh_rows = log2i(rows_a);
  const int sh_pa = log2i(g.ra_row / g.a.vec);     // copies a row of A
  const int sh_pb = log2i(cols_b * g.b.es / g.b.vec);
  const int sh_gq = log2i(cols_b) - 3;             // column octets of B
  const int sh_ea = log2i(g.a.es), sh_eb = log2i(g.b.es);
  const bool a_direct = g.raw_a == 0;   // limbs, one stage: no raw copy of A
  const int da = g.a.planes * g.a.digits, db = g.b.planes * g.b.digits;
  const unsigned long long bias_a = digit_bias(g.a.digits);
  const unsigned long long bias_b = digit_bias(g.b.digits);
  // B's rows keep their 16-byte chunks XOR-ed with k / 4 over as many
  // chunks as a row has, up to eight
  const int swz_b = (((g.rb_row < 128 ? g.rb_row : 128) >> 4) - 1) << 4;

  // digit planes past an operand's count stay zero
  for (int i = da * rows_a * kRow / 16 + tid; i < L * rows_a * kRow / 16;
       i += NT)
    reinterpret_cast<uint4*>(dig_a)[i] = make_uint4(0, 0, 0, 0);
  for (int i = db * cols_b * kRow / 16 + tid; i < L * cols_b * kRow / 16;
       i += NT)
    reinterpret_cast<uint4*>(dig_b)[i] = make_uint4(0, 0, 0, 0);
  // the TMA route's ring barriers, one a slot, after the ring
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + g.stages * g.stage);
  if (g.tma_b) {
    if (tid == 0) {
      for (int i = 0; i < g.stages; ++i) hop::mbar_init(&full[i], 1);
      hop::fence_mbar_init();
    }
    __syncthreads();
  }

  // `units` chunks of `vec` bytes, `unit(u, src, dst, ok)` placing chunk u:
  // cp.async where a chunk is a 4-, 8- or 16-byte piece; element loads
  // otherwise (rows that are not whole words), eight issued ahead of their
  // stores so that their latencies overlap
  auto copy_units = [&](int units, int vec, auto&& unit) {
    const uint8_t* src;
    uint8_t* dst;
    bool ok;
    if (vec >= 4) {
      for (int u = tid; u < units; u += NT) {
        unit(u, src, dst, ok);
        cp_async(dst, src, vec, ok);
      }
      return;
    }
    for (int u0 = tid; u0 < units; u0 += 8 * NT) {
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = 0;
        if (u0 + i * NT >= units) continue;
        unit(u0 + i * NT, src, dst, ok);
        if (ok)
          v[i] = vec == 2 ? *reinterpret_cast<const uint16_t*>(src) : *src;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (u0 + i * NT >= units) continue;
        unit(u0 + i * NT, src, dst, ok);
        if (vec == 2)
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v[i]);
        else
          *dst = static_cast<uint8_t>(v[i]);
      }
    }
  };

  auto load_stage = [&](int s, int slot) {
    const int k0 = s * BK;
    uint8_t* ra = ring + slot * g.stage;
    uint8_t* rb = ra + g.raw_a;
    // a_direct: A's limbs of the CTA's one stage go straight into its
    // digit planes (they are their own digits)
    copy_units(g.a.planes << (sh_rows + sh_pa), g.a.vec,
               [&](int u, const uint8_t*& src, uint8_t*& dst, bool& ok) {
      const Opnd& o = g.a;
      const int row = u >> sh_pa;                    // plane * rows_a + r
      const int cb = (u & ((1 << sh_pa) - 1)) * o.vec;
      const int gm = a0 + (row & (rows_a - 1)), gk = k0 + (cb >> sh_ea);
      ok = gm < g.M && gk < g.K;
      src = ok ? o.p + (row >> sh_rows) * o.plane + gm * o.row +
                     static_cast<long long>(k0) * o.es + cb
               : o.p;
      dst = a_direct ? dig_a + row * kRow + (cb ^ ((row & 7) << 4))
                     : ra + row * g.ra_row + cb;
    });
    if (g.tma_b) {
      // one 128 x 128 box a plane (128-byte swizzle: chunk c of row k at
      // c ^ (k % 8)), zero past K and N
      if (tid == 0) {
        hop::mbar_expect_tx(&full[slot], g.b.planes * BK * kRow);
        for (int pl = 0; pl < g.b.planes; ++pl)
          hop::tma_box3(hop::smem_u32(rb + pl * BK * kRow), &tmB, &full[slot],
                        b0, k0, pl);
      }
      return;
    }
    copy_units(g.b.planes << (SW + 2 + sh_pb), g.b.vec,
               [&](int u, const uint8_t*& src, uint8_t*& dst, bool& ok) {
      const Opnd& o = g.b;
      const int row = u >> sh_pb;                    // plane * BK + k
      const int k = row & (BK - 1);
      const int cb = (u & ((1 << sh_pb) - 1)) * o.vec;
      const int gk = k0 + k, gn = b0 + (cb >> sh_eb);
      ok = gk < g.K && gn < g.N;
      src = ok ? o.p + (row >> (SW + 2)) * o.plane + gk * o.row +
                     static_cast<long long>(b0) * o.es + cb
               : o.p;
      dst = rb + row * g.rb_row + swz(swz_b, k, cb);
    });
  };

  // A's stage -> its digit planes: word kw (k = 4 kw .. 4 kw + 3) of each
  // row.  A thread keeps one word kw and steps over rows, so only the row
  // moves: its digit word sits at row * 128 + (4 kw ^ 16 (row % 8)).
  auto digits_a = [&](const uint8_t* ra) {
    const Opnd& o = g.a;
    constexpr int RSTEP = NT >> SW;
    const int kw = tid & ((1 << SW) - 1);
    const int nrows = o.planes << sh_rows;
    const uint8_t* src = ra + (tid >> SW) * g.ra_row + kw * 4 * o.es;
    const int src_step = RSTEP * g.ra_row;
    if (o.ident) {
      for (int row = tid >> SW; row < nrows; row += RSTEP, src += src_step)
        *reinterpret_cast<uint32_t*>(dig_a + row * kRow +
                                     ((kw << 2) ^ ((row & 7) << 4))) =
            *reinterpret_cast<const uint32_t*>(src);
      return;
    }
    const int plane = rows_a * kRow;
    for (int row = tid >> SW; row < nrows; row += RSTEP, src += src_step) {
      uint8_t* dst = dig_a + row * kRow + ((kw << 2) ^ ((row & 7) << 4));
      uint32_t y[4];
      load4(src, o.es, bias_a, y);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i >= o.digits) continue;
        *reinterpret_cast<uint32_t*>(dst + i * plane) = digit_bytes(
            pack_low(field(y[0], i, bias_a), field(y[1], i, bias_a),
                     field(y[2], i, bias_a), field(y[3], i, bias_a)));
      }
    }
  };

  // B's stage -> its digit planes, transposed: a lane takes four k rows of
  // four columns and writes one word (four k) to each of the four columns'
  // rows.  Lanes: b = lane % 4 and C = lane / 8 pick the word (kw = 4 C +
  // b, + 16 a K half), bit 2 the column quad (n % 8 = 4 bit + e), so each
  // store of a warp covers eight rows (r % 8 distinct) by four words: no
  // bank conflict.  The four rows k share one swizzle (k / 4 = kw), and
  // the store offsets within an octet of rows are lane constants.
  auto digits_b = [&](const uint8_t* rb) {
    const Opnd& o = g.b;
    if (g.tma_b) {
      // the TMA box's swizzle (chunk c of row k at c ^ (k % 8)): lane l
      // takes word kw = l and, in step j, the column quad nq = j ^ l, so
      // that both the reads (rows 4 l + q) and the stores (rows 4 nq + e)
      // of a warp hit 32 distinct banks
      const int kw = lane;
      for (int it = warp; it < o.planes * 32; it += NT / 32) {
        const int nq = (it & 31) ^ lane, pl = it >> 5;
        const uint8_t* src = rb + pl * BK * kRow + 4 * kw * kRow;
        uint8_t* dst = dig_b + pl * cols_b * kRow + 4 * nq * kRow;
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q] = *reinterpret_cast<const uint32_t*>(
              src + q * kRow +
              ((((nq >> 2) ^ (4 * (kw & 1) + q)) << 4) | ((nq & 3) << 2)));
        int so[4];                             // rows 4 nq + e, word kw
#pragma unroll
        for (int e = 0; e < 4; ++e)
          so[e] = e * kRow + ((kw << 2) ^ ((4 * (nq & 1) + e) << 4));
        if (o.ident) {
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          const uint32_t w[4] = {
              __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
              __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint32_t*>(dst + so[e]) = w[e];
          continue;
        }
        uint32_t y[4][4];                      // [k][column]
#pragma unroll
        for (int q = 0; q < 4; ++q)
          load4(reinterpret_cast<const uint8_t*>(&r[q]), 1, bias_b, y[q]);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          if (i >= o.digits) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint32_t*>(dst + i * cols_b * kRow + so[e]) =
                digit_bytes(pack_low(
                    field(y[0][e], i, bias_b), field(y[1][e], i, bias_b),
                    field(y[2][e], i, bias_b), field(y[3][e], i, bias_b)));
        }
      }
      return;
    }
    const int iters = o.planes << (SW - 4 + sh_gq);
    const int kwl = 4 * (lane >> 3) + (lane & 3), nl = 4 * ((lane >> 2) & 1);
    int co[4];                                  // rows nl + e of an octet
#pragma unroll
    for (int e = 0; e < 4; ++e)
      co[e] = (nl + e) * kRow + ((kwl << 2) ^ ((nl + e) << 4));
    const int plane = cols_b * kRow;
    for (int it = warp; it < iters; it += NT / 32) {
      const int g8 = it & ((1 << sh_gq) - 1);
      const int kh = (it >> sh_gq) & ((1 << (SW - 4)) - 1);
      const int pl = it >> (sh_gq + SW - 4);
      const int kw = 16 * kh + kwl, n = 8 * g8 + nl;
      const uint8_t* src = rb + (pl * BK + 4 * kw) * g.rb_row +
                           ((n * o.es) ^ ((kw << 4) & swz_b));
      uint8_t* dst = dig_b + pl * plane + 8 * g8 * kRow;
      const int kx = kh << 6;                   // 16 kh words: chunk bit 2
      if (o.ident) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q] = *reinterpret_cast<const uint32_t*>(src + q * g.rb_row);
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        *reinterpret_cast<uint32_t*>(dst + (co[0] ^ kx)) =
            __byte_perm(t0, t2, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + (co[1] ^ kx)) =
            __byte_perm(t0, t2, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + (co[2] ^ kx)) =
            __byte_perm(t1, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + (co[3] ^ kx)) =
            __byte_perm(t1, t3, 0x7632);
        continue;
      }
      uint32_t y[4][4];                        // [k][column]
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(src + q * g.rb_row, o.es, bias_b, y[q]);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i >= o.digits) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(dst + i * plane + (co[e] ^ kx)) =
              digit_bytes(pack_low(
                  field(y[0][e], i, bias_b), field(y[1][e], i, bias_b),
                  field(y[2][e], i, bias_b), field(y[3][e], i, bias_b)));
      }
    }
  };

  const int wg = warp / 4;
  const int ring_n = g.stages;
  for (int i = 0; i < ring_n - 1; ++i) {
    if (s0 + i < s1) load_stage(s0 + i, i);
    cp_commit();
  }
  // fragment of m64nTQ: register 4 j + 2 h + e holds row p (wgmma's M) =
  // 64 wg + 16 (warp % 4) + lane / 4 + 8 h, column q = 8 j + 2 (lane % 4) + e
  const int pr = p0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  auto out_index = [&](int p, int q) -> long long {
    return g.swap ? static_cast<long long>(q) * g.N + p
                  : static_cast<long long>(p) * g.N + q;
  };
  auto in_bounds = [&](int p, int q) {
    return g.swap ? (q < g.M && p < g.N) : (p < g.M && q < g.N);
  };

  int stores = 0;                    // planes stored by TMA so far
  // qs > 1 (one K stage, no split): the stage's digits stay in shared
  // memory while the CTA walks its qs sub-tiles of TQ, one set of planes
  // at a time
  for (int t = 0; t < g.qs; ++t) {
    int acc[D][NR];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[d][r] = 0;
    const uint32_t sp = hop::smem_u32(dig_p + wg * 64 * kRow);
    const uint32_t sq = hop::smem_u32(dig_q + t * TQ * kRow);
    for (int s = s0; s < s1; ++s) {
      if (t == 0) {
        const int it = s - s0;
        const int nxt = s + ring_n - 1;
        // the slot of stage nxt was read by the digits of stage s - 1,
        // which every thread finished before the barrier ahead of that
        // stage's wgmma
        if (nxt < s1) load_stage(nxt, (it + ring_n - 1) % ring_n);
        cp_commit();
        cp_wait(ring_n - 1);
        if (g.tma_b) hop::mbar_wait(&full[it % ring_n], (it / ring_n) & 1);
        __syncthreads();
        const uint8_t* ra = ring + (it % ring_n) * g.stage;
        if (!a_direct) digits_a(ra);
        digits_b(ra + g.raw_a);
        hop::fence_proxy_async();
        __syncthreads();
      }
#pragma unroll
      for (int d = 0; d < D; ++d) hop::fence_acc(acc[d]);
      hop::wg_fence();
      // consecutive products go to different planes (i + j), so the
      // tensor cores pipeline them
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int i = 0; i < L; ++i)
#pragma unroll
          for (int j = 0; j < L; ++j)
            hop::WgmmaS8<TQ>::mma(
                acc[i + j],
                hop::gmma_desc<true>(sp + i * TP * kRow + 32 * k),
                hop::gmma_desc<true>(sq + j * tq_all * kRow + 32 * k));
      hop::wg_commit();
      hop::wg_wait<0>();
#pragma unroll
      for (int d = 0; d < D; ++d) hop::fence_acc(acc[d]);
    }
    const int q0 = q00 + t * TQ;
    const int qc = q0 + 2 * (lane & 3);

    if (g.fused) {
      // sum_d S_d 2^(7 d) in unsigned 64-bit arithmetic: it wraps mod 2^64
      // (planes with 7 d < 32 as 32 x 32 -> 64 multiply-adds, the rest
      // into the high word alone)
      unsigned long long tot[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        long long v = acc[0][r];
#pragma unroll
        for (int d = 1; d < D && 7 * d < 32; ++d)
          v += static_cast<long long>(acc[d][r]) * (1 << (7 * d));
        uint32_t hi =
            static_cast<uint32_t>(static_cast<unsigned long long>(v) >> 32);
#pragma unroll
        for (int d = 5; d < D; ++d)
          hi += static_cast<uint32_t>(acc[d][r]) << (7 * d - 32);
        tot[r] = (static_cast<unsigned long long>(hi) << 32) |
                 static_cast<uint32_t>(v);
      }
      if (g.ranks > 1) {
        // the ranks' sums, added into rank 0 in rank order
        __syncthreads();                 // the ring and digits become scratch
        uint4* mine = reinterpret_cast<uint4*>(smem);
        if (rank != 0) {
#pragma unroll
          for (int r = 0; r < NR; r += 2)
            mine[(r / 2) * NT + tid] = make_uint4(
                static_cast<uint32_t>(tot[r]),
                static_cast<uint32_t>(tot[r] >> 32),
                static_cast<uint32_t>(tot[r + 1]),
                static_cast<uint32_t>(tot[r + 1] >> 32));
        }
        hop::cluster_sync();
        if (rank == 0) {
#pragma unroll
          for (int r = 0; r < NR; r += 2) {
            for (int z = 1; z < g.ranks; ++z) {
              const uint4 v = hop::ld_dsmem_u4(&mine[(r / 2) * NT + tid], z);
              tot[r] += (static_cast<unsigned long long>(v.y) << 32) | v.x;
              tot[r + 1] += (static_cast<unsigned long long>(v.w) << 32) | v.z;
            }
          }
        }
        hop::cluster_sync();             // peers stay until rank 0 has read
        if (rank != 0) return;
      }
#pragma unroll
      for (int j = 0; j < NR / 4; ++j) {
        int hi[4], lo[4];                // [2 h + e]
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          hi[x] = static_cast<int>(static_cast<uint32_t>(tot[4 * j + x] >> 32));
          lo[x] = static_cast<int>(static_cast<uint32_t>(tot[4 * j + x]));
        }
        if (!g.swap && g.wide) {
          // lane pairs swap halves: the even lane keeps row h = 0, columns
          // 2 c .. 2 c + 3, the odd lane row h = 1 of the same columns
          const bool even = (lane & 1) == 0;
          int gv[4];
          gv[0] = __shfl_xor_sync(0xffffffff, even ? hi[2] : hi[0], 1);
          gv[1] = __shfl_xor_sync(0xffffffff, even ? hi[3] : hi[1], 1);
          gv[2] = __shfl_xor_sync(0xffffffff, even ? lo[2] : lo[0], 1);
          gv[3] = __shfl_xor_sync(0xffffffff, even ? lo[3] : lo[1], 1);
          const int row = pr + (even ? 0 : 8);
          const int col = q0 + 8 * j + 4 * ((lane & 3) >> 1);
          if (row < g.M && col < g.N) {
            const int4 h = even ? make_int4(hi[0], hi[1], gv[0], gv[1])
                                : make_int4(gv[0], gv[1], hi[2], hi[3]);
            const int4 l = even ? make_int4(lo[0], lo[1], gv[2], gv[3])
                                : make_int4(gv[2], gv[3], lo[2], lo[3]);
            const long long o = static_cast<long long>(row) * g.N + col;
            *reinterpret_cast<int4*>(g.out0 + o) = h;
            *reinterpret_cast<int4*>(g.out1 + o) = l;
          }
          continue;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int p = pr + 8 * (x >> 1), q = qc + 8 * j + (x & 1);
          if (in_bounds(p, q)) {
            g.out0[out_index(p, q)] = hi[x];
            g.out1[out_index(p, q)] = lo[x];
          }
        }
      }
      continue;
    }

    if (g.ranks > 1) {
      // the ranks' planes, added into rank 0 in rank order
      __syncthreads();
      uint4* mine = reinterpret_cast<uint4*>(smem);
      if (rank != 0) {
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int r = 0; r < NR; r += 4)
            mine[((d * NR + r) / 4) * NT + tid] =
                make_uint4(acc[d][r], acc[d][r + 1], acc[d][r + 2],
                           acc[d][r + 3]);
      }
      hop::cluster_sync();
      if (rank == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int r = 0; r < NR; r += 4)
            for (int z = 1; z < g.ranks; ++z) {
              const uint4 v =
                  hop::ld_dsmem_u4(&mine[((d * NR + r) / 4) * NT + tid], z);
              acc[d][r] += static_cast<int>(v.x);
              acc[d][r + 1] += static_cast<int>(v.y);
              acc[d][r + 2] += static_cast<int>(v.z);
              acc[d][r + 3] += static_cast<int>(v.w);
            }
      }
      hop::cluster_sync();
      if (rank != 0) return;
    }
    // every loop below unrolls (constant plane and register indices): a
    // plane loop that can stop early compiled to a loop over planes that
    // picked its registers at run time, several times the stores' cost
    if (g.tma_out) {
      // each plane's TP x TQ tile through one of two staging tiles in the
      // dead ring, stored by TMA: whole 4*TQ-byte row segments, not the
      // fragments' 8-byte pairs
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d >= g.nplanes) continue;
        int32_t* stg =
            reinterpret_cast<int32_t*>(ring + (stores++ & 1) * (TP * TQ * 4));
        if (tid == 0) hop::bulk_wait<1, true>();  // its last store has read it
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NR / 4; ++j)
            *reinterpret_cast<int2*>(
                stg + (pr - p0 + 8 * h) * TQ + (qc - q0) + 8 * j) =
                make_int2(acc[d][4 * j + 2 * h], acc[d][4 * j + 2 * h + 1]);
        hop::fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          hop::tma_store3(&tmO, hop::smem_u32(stg), q0, p0, d);
          hop::bulk_commit();
        }
      }
      continue;
    }
    const long long plane = static_cast<long long>(g.M) * g.N;
    if (!g.swap && g.wide) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pr + 8 * h;
        int32_t* row = g.out0 + static_cast<long long>(p) * g.N;
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          const int q = qc + 8 * j;
          if (p >= g.M || q >= g.N) continue;
#pragma unroll
          for (int d = 0; d < D; ++d)
            if (d < g.nplanes)
              *reinterpret_cast<int2*>(row + d * plane + q) =
                  make_int2(acc[d][4 * j + 2 * h], acc[d][4 * j + 2 * h + 1]);
        }
      }
      continue;
    }
#pragma unroll
    for (int x = 0; x < NR; ++x) {
      const int p = pr + 8 * ((x >> 1) & 1), q = qc + 8 * (x >> 2) + (x & 1);
      if (!in_bounds(p, q)) continue;
      const long long o = out_index(p, q);
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < g.nplanes) g.out0[d * plane + o] = acc[d][x];
    }
  }
  if (g.tma_out && tid == 0) hop::bulk_wait<0, false>();
  cp_wait(0);
}

// Launch with the grid's z as a cluster when ranks > 1.
template <typename Kernel>
int launch_ranks(Kernel kernel, dim3 grid, int threads, size_t smem,
                 int ranks, cudaStream_t st, const Geo& g,
                 const CUtensorMap& tmB, const CUtensorMap& tmO) {
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, g, tmB, tmO);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int WG, int TQ, int KS>
int launch(Geo g, const CUtensorMap& tmB, int smem, cudaStream_t st,
           const void* out0, int nplanes) {
  auto kernel = limb_kernel<L, WG, TQ, KS>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int TP = 64 * WG;
  const int plen = g.swap ? g.N : g.M, qlen = g.swap ? g.M : g.N;
  const int tq_all = TQ * g.qs;
  const dim3 grid((plen + TP - 1) / TP, (qlen + tq_all - 1) / tq_all,
                  g.ranks);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the planes by TMA where the staging tiles fit the ring and the rows
  // are whole 16-byte chunks
  CUtensorMap tmO = {};
  g.tma_out = !g.fused && !g.swap && g.ranks == 1 && g.N % 4 == 0 &&
              reinterpret_cast<uintptr_t>(out0) % 16 == 0 &&
              2 * TP * TQ * 4 <= g.stages * g.stage;
  if (g.tma_out) {
    const uint64_t dims[3] = {static_cast<uint64_t>(g.N),
                              static_cast<uint64_t>(g.M),
                              static_cast<uint64_t>(nplanes)};
    const uint64_t strides[2] = {static_cast<uint64_t>(g.N) * 4,
                                 static_cast<uint64_t>(g.M) * g.N * 4};
    const uint32_t box[3] = {TQ, TP, 1};
    const int rc = hop::encode_3d(&tmO, CU_TENSOR_MAP_DATA_TYPE_INT32, out0,
                                  dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  return launch_ranks(kernel, grid, WG * 128, smem, g.ranks, st, g, tmB,
                      tmO);
}

// Widest copy of a row of `row_bytes` from `p`: 16, 8 or 4 bytes when
// the row and the base allow it and it fits `cap`, else an element.
int copy_width(const void* p, long long row_bytes, int es, int cap) {
  for (int v = 16; v >= 4; v /= 2)
    if (v <= cap && row_bytes % v == 0 &&
        reinterpret_cast<uintptr_t>(p) % v == 0)
      return v;
  return es;
}

}  // namespace lg
}  // namespace

// One launch of K4 (kernels/limb_gemm.py: limb_plan fixes every argument
// from the shapes).  (L, wg, tq, ks): one of limb_gemm.CONFIGS; qs: TQ
// sub-tiles a CTA walks when K is one stage.  fused: 1
// = (hi, lo) into out0, out1; 0 = nplanes int32 planes into out0.  a (M,
// K) and b (K, N) row-major, a_planes / b_planes of them (limbs), elements
// of a_es / b_es bytes, each cut into a_digits / b_digits digits or (ident)
// its own digit.  Returns 0 when launched, else a CUDA error code.
extern "C" int limb_gemm_launch(int L, int wg, int tq, int ks, int ranks,
                                int stages, int qs, int swap, int fused,
                                int nplanes,
                                const void* a, const void* b, void* out0,
                                void* out1, int M, int N, int K, int a_es,
                                int a_planes, int a_digits, int a_ident,
                                int b_es, int b_planes, int b_digits,
                                int b_ident, int ra_row, int rb_row, int raw_a,
                                int stage, int off_raw, int smem,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > (1 << 17) || ranks < 1 ||
      ranks > lg::kMaxRanks || stages < 1 || stages > 4 || smem > 232448 ||
      1024 + off_raw + stages * stage > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  lg::Geo g;
  const int tp = 64 * wg;
  const int cols_b = swap ? tp : tq;
  g.a = {static_cast<const uint8_t*>(a), static_cast<long long>(K) * a_es,
         static_cast<long long>(M) * K * a_es, a_es, a_planes, a_digits,
         a_ident, 0};
  g.a.vec = lg::copy_width(a, g.a.row, a_es, 16);
  g.b = {static_cast<const uint8_t*>(b), static_cast<long long>(N) * b_es,
         static_cast<long long>(K) * N * b_es, b_es, b_planes, b_digits,
         b_ident, 0};
  g.b.vec = lg::copy_width(b, g.b.row, b_es, cols_b * b_es);
  g.out0 = static_cast<int32_t*>(out0);
  g.out1 = static_cast<int32_t*>(out1);
  g.M = M; g.N = N; g.K = K;
  g.swap = swap; g.fused = fused; g.nplanes = nplanes;
  g.nk = (K + 32 * ks - 1) / (32 * ks);
  g.ranks = ranks; g.stages = stages; g.qs = qs;
  g.ra_row = ra_row; g.rb_row = rb_row; g.raw_a = raw_a; g.stage = stage;
  g.off_raw = off_raw;
  g.wide = fused ? N % 4 == 0 : N % 2 == 0;
  if (ranks > g.nk || (qs != 1 && qs != 2 && qs != 4) ||
      (qs > 1 && (g.nk > 1 || ranks > 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // B by TMA where its stage is whole 128 x 128 int8 boxes the tensor map
  // can describe (rows of a 16-byte multiple, a 16-byte-aligned base)
  CUtensorMap tmB = {};
  g.tma_b = swap && wg == 2 && ks == 4 && b_es == 1 && N % 16 == 0 &&
            reinterpret_cast<uintptr_t>(b) % 16 == 0 && rb_row == 128 &&
            raw_a % 1024 == 0 && stage % 1024 == 0 && off_raw % 1024 == 0 &&
            1024 + off_raw + stages * stage + 64 <= smem;
  if (g.tma_b) {
    const uint64_t dims[3] = {static_cast<uint64_t>(N),
                              static_cast<uint64_t>(K),
                              static_cast<uint64_t>(b_planes)};
    const uint64_t strides[2] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(K) * N};
    const uint32_t box[3] = {128, 128, 1};
    const int rc = hop::encode_3d(&tmB, CU_TENSOR_MAP_DATA_TYPE_UINT8, b,
                                  dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LIMB_KERNEL(L_, WG_, TQ_, KS_)                                        \
  if (L == L_ && wg == WG_ && tq == TQ_ && ks == KS_)                         \
    return lg::launch<L_, WG_, TQ_, KS_>(g, tmB, smem, st, out0, nplanes);
  LIMB_KERNEL(1, 2, 8, 4)
  LIMB_KERNEL(1, 2, 32, 4)
  LIMB_KERNEL(2, 2, 8, 4)
  LIMB_KERNEL(2, 2, 32, 4)
  LIMB_KERNEL(3, 2, 8, 4)
  LIMB_KERNEL(3, 2, 32, 4)
  LIMB_KERNEL(5, 2, 8, 4)
  LIMB_KERNEL(5, 2, 16, 4)
  LIMB_KERNEL(5, 1, 16, 2)
#undef LIMB_KERNEL
  return static_cast<int>(cudaErrorInvalidValue);
}
