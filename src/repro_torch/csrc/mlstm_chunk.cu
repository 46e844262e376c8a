// Chunked mLSTM / SSD readout with the matrix state carried across chunks,
// its products on the tensor cores at f32 accuracy.
//
// Replaces the TPU kernel `mlstm_chunk_bhsd` (src/repro/kernels/
// mlstm_chunk/kernel.py, the Pallas call over `_mlstm_kernel`).  For every
// head bh and every chunk of `c` rows (S = nC * c), with cum the in-chunk
// cumulative sum of the log forget gate la (la <= 0):
//
//   y[t] = sum_{s<=t in chunk} exp(cum[t]-cum[s]) ig[s] (q[t].k[s]) v[s]
//          + exp(cum[t]) q[t] @ state
//   state' = exp(cum[c-1]) state
//          + sum_s exp(cum[c-1]-cum[s]) ig[s] k[s] v[s]^T
//
// with q, k (BH, S, P), v and y (BH, S, Pv), ig and la (BH, S), all float32,
// and the state (P, Pv) float32, zero at the first chunk.
//
// What bounds it on an H100: operations.  Per (head, chunk) the work is
// c(c+1)(P + Pv) FLOPs for the two masked products over the pairs s <= t
// and 4 c P Pv for the carried state's readout and update, about 1.1 GFLOP
// at c 256, P 1024, Pv 1025, against q, k, v, y read or written once:
// ~160 FLOPs per byte, past the card's TF32 ridge, so the bound is those
// FLOPs at the dense TF32 tensor-core rate (495 TFLOP/s).
//
// Precision.  Every product runs on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulate) at f32 accuracy: each f32 operand x is
// split into a bf16 high part h = bf16(x) and a bf16 low part
// l = bf16(x - h), so that x - h - l is within 2^-17 |x|, and a product
// a.b is taken as ah.bh + ah.bl + al.bh (the dropped al.bl is within
// 2^-16 |a||b|).  That costs three bf16 products, 3x the FLOPs above at
// twice the TF32 rate; one bf16 product (2^-9) or TF32 (2^-11) would not
// hold the f32 result to 2e-4 of its scale.  The carried state stays f32
// in shared memory and is split only in registers, as an operand copy for
// one product: it is never rounded to 16 bits between chunks.
//
// Design.  The TPU kernel keeps the whole [P, Pv] state in VMEM and walks
// the chunks in grid order.  At xlstm-1.3b's widths (P 1024, Pv 1025, the
// normaliser column appended to v) that state is 4.2 MB per head, and an
// SM holds 227 KB of shared memory and 256 KB of registers, so the state
// is split by columns: one block (8 warps) owns (head, kW = 32 columns of
// Pv), keeps state^T[32, P] f32 in its warps' accumulator registers (128
// a thread at P 1024: warp j holds the 16-column k-tiles j, j + 8, .. of
// P) and walks the chunks in order.  The column tiles never talk to each
// other.  Four kernels, in order on one stream, one call:
//
//   1. chunk_cumsum: cum, one thread per (head, chunk);
//   2. split_operands: the operands that every column tile streams, formed
//      once per (head, chunk): q~ = q exp(cum[t]) and kd = k exp(cum[c-1] -
//      cum[s]) ig[s], split into bf16 high/low parts (the same bytes as
//      f32) and stored as the contiguous blocks that the recurrence
//      copies, rows and columns zero-padded;
//   3. chunk_scores: sc[t, s] = (q[t].k[s]) exp(cum[t]-cum[s]) ig[s] for
//      s <= t, else 0, on the tensor cores (split q and k), one block per
//      64 x 64 tile, stored split in the same block layout; tiles above
//      the diagonal are zeros without a product.  The mask is applied
//      before the exp (the reference exponentiates the whole tile and then
//      masks, which can overflow to +inf where s > t): every kept exponent
//      is <= 0;
//   4. chunk_recurrent: per (head, column tile), per chunk in order,
//        y^T     = v^T sc^T + state^T q~^T      (q~ holds exp(cum[t]))
//        state^T = exp(cum[c-1]) state^T + v^T kd.
//      The products are taken transposed, so that the 32 state columns are
//      the mma's m (two 16-row tiles) and the operands that are the same
//      for every column tile (sc, q~, kd) are its B operand, streamed from
//      L2 by cp.async through a ring of three shared-memory stages, one
//      barrier a step.  The carry state^T q~^T: for every 32-row block of
//      the chunk, each warp multiplies its own k-tiles (the A fragments
//      are its state accumulators, split in registers) and the 8 partial
//      sums are added in shared memory.  The score steps: each warp owns
//      32 rows t, A = v^T from the block's v tile (split once per chunk,
//      ldmatrix.trans).  The update accumulates v^T kd straight into the
//      state registers, two k-tiles a warp a step.  The three products of
//      a k-step are issued product by product, so that consecutive mma
//      write different accumulators.  Chunk 0 reads a zero state and the
//      state after the last chunk is not needed: both are skipped, as the
//      bound counts them.
//
// What the first (f32 FMA) form of this kernel lost time to, and what is
// done about it: (1) f32 FMA only: every product is on the tensor cores;
// (2) one 8-warp block an SM: still so (the state takes 128 registers a
// thread), but a step now carries 48 mma a warp and a chunk 80 steps, not
// 144 of 24; (3) the A operands staged again by every column tile, k * ds
// recomputed: q~, kd and the split scores are formed once per (head,
// chunk) by kernels 2 and 3, but every column tile still streams them
// (2.25 MB a chunk at xlstm-1.3b's shape) -- a block cannot own more state
// columns; (4) the score tiles through device memory: still so, as bf16
// pairs (256 KB a (head, chunk)), a small part of the time.  What bounds
// this schedule now (mlstm_ablation.py): the steps' own cost -- each B
// byte is written to shared memory by cp.async and read back by ldmatrix,
// a barrier a step at 8 warps an SM -- then the products; the copies'
// latency is hidden.  Ragged edges (rows past a chunk, P, Pv, c not a
// multiple of 16) are zero-filled.  Any S and Pv; c up to 624 (the v tile
// and two ring stages fill shared memory); P up to 1024.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kW = 32;                 // Pv columns per recurrent block
constexpr int kTB = 256;               // rows t per y pass (8 warps x 32)
constexpr int kSlab = 256;             // columns p per kd slab
constexpr int kK = 16;                 // depth of one mma k-step (a k-tile)
constexpr int kMaxP = kWarps * 8 * kK; // the state registers: 8 k-tiles a warp
constexpr int kLDY = 2 * kK + 8;       // score tile row: hi 16 | lo 16 | pad
constexpr int kLDC = 16 * 2 * kK + 8;  // carry tile row: 16 k-tiles | pad
constexpr int kLDU = 4 * kSlab + 8;    // update tile row: 2 slabs | pad
constexpr int kLDV = 2 * kW + 8;       // v tile row: hi 32 | lo 32 | pad
constexpr int kLDS = kTB + 8;          // csum row (f32): 8 mod 32 words
constexpr int kLDR = 32 + 8;           // carry slot row (f32)
constexpr int kStage = 32 * kLDC;      // bf16 elements of one ring stage
static_assert(kTB * kLDY <= kStage && kK * kLDU <= kStage,
              "every tile fits a stage");
constexpr int kMaxSmem = 232448;
constexpr int kST = 64;                // score tile edge
constexpr int kSK = 32;                // score kernel: depth per staged tile
constexpr int kLDQ = 2 * kSK + 8;      // score operand row: hi | lo | pad
constexpr int kScoreThreads = 128;     // 4 warps x 16 rows t

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one 16x8 tile: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16x2 high and low parts (x0 in the low half of each)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------------------------------------- workspace
// Every B tile that a column tile streams, stored in the contiguous blocks
// it is copied from (2 KB a k-tile of a 32-row block of q~, 16 KB a score
// step or a kd slab), bf16 high and low parts side by side (the same bytes
// as f32).  Chunk z = bh * nC + n, its rows padded to cp and its
// columns to Pk (q~) or Pu = Pk rounded up to 256 (kd), with zeros:
//   qt [z][p / 16][t < cp][hi 16 | lo 16]          q~ = q exp(cum[t])
//   sc [z][s / 16][t < cp][hi 16 | lo 16]          masked scores
//   kd [z][s / 16][p / 256][s % 16][hi 256 | lo 256]
//                                      kd = k exp(cum[c-1] - cum[s]) ig[s]
// and cum f32 [BH, S]; each region aligned to 256 bytes.
struct Workspace {
  float* cum;
  bf16 *qt, *sc, *kd;
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

size_t carve(char* base, int BH, int S, int P, int c, Workspace* ws) {
  const size_t chunks = (size_t)BH * (S / c);
  const size_t cp = round_up(c, kK), Pk = round_up(P, kK);
  const size_t Pu = round_up(P, kSlab);
  const size_t cum = align256((size_t)BH * S * sizeof(float));
  const size_t qt = align256(chunks * cp * Pk * 2 * sizeof(bf16));
  const size_t sc = align256(chunks * cp * cp * 2 * sizeof(bf16));
  const size_t kd = align256(chunks * cp * Pu * 2 * sizeof(bf16));
  if (ws) {
    ws->cum = (float*)base;
    ws->qt = (bf16*)(base + cum);
    ws->sc = (bf16*)(base + cum + qt);
    ws->kd = (bf16*)(base + cum + qt + sc);
  }
  return cum + qt + sc + kd;
}

// ------------------------------------------------------------ 1. cumsum
// cum[bh, n*c + i] = la[bh, n*c] + ... + la[bh, n*c + i].
__global__ void chunk_cumsum(const float* __restrict__ la,
                             float* __restrict__ cum, int n_chunks, int S,
                             int c, int nC) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_chunks) return;
  const int64_t base = (int64_t)(w / nC) * S + (int64_t)(w % nC) * c;
  float acc = 0.f;
  for (int i = 0; i < c; ++i) {
    acc += la[base + i];
    cum[base + i] = acc;
  }
}

// ---------------------------------------------------- 2. split operands
// One thread per (chunk z, row t < cp, column pair p < Pu) of q~ and kd,
// written as bf16 high and low parts into their tile layouts; rows t >= c
// and columns p >= P are zeros.
__global__ void split_operands(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ ig,
                               const float* __restrict__ cum, bf16* qt,
                               bf16* kd, int64_t chunks, int S, int P, int Pk,
                               int Pu, int c, int cp, int nC) {
  const int per_row = Pu / 2;
  const int64_t total = chunks * cp * per_row;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t zt = e / per_row;             // z * cp + t
    const int p = 2 * (int)(e - zt * per_row);
    const int64_t z = zt / cp;
    const int t = (int)(zt - z * cp);
    const int64_t first = (z / nC) * S + (z % nC) * c;   // the chunk's row 0
    float q0 = 0.f, q1 = 0.f, k0 = 0.f, k1 = 0.f;
    if (t < c) {
      const int64_t row = first + t;
      const float ct = cum[row];
      const float sq = expf(ct);
      const float sk = expf(cum[first + c - 1] - ct) * ig[row];
      const float* qr = q + row * P;
      const float* kr = k + row * P;
      if (p < P) q0 = qr[p] * sq, k0 = kr[p] * sk;
      if (p + 1 < P) q1 = qr[p + 1] * sq, k1 = kr[p + 1] * sk;
    }
    uint32_t h, l;
    if (p < Pk) {
      bf16* at = qt + ((z * (Pk / kK) + p / kK) * cp + t) * (2 * kK) + p % kK;
      split2(q0, q1, h, l);
      *reinterpret_cast<uint32_t*>(at) = h;
      *reinterpret_cast<uint32_t*>(at + kK) = l;
    }
    bf16* at = kd + (((z * (cp / kK) + t / kK) * (Pu / kSlab) + p / kSlab) *
                         kK + t % kK) * (2 * kSlab) + p % kSlab;
    split2(k0, k1, h, l);
    *reinterpret_cast<uint32_t*>(at) = h;
    *reinterpret_cast<uint32_t*>(at + kSlab) = l;
  }
}

// ------------------------------------------------------------ 3. scores
// One 64 x 64 tile (t rows, s columns) of one (head, chunk)'s masked
// scores, written as bf16 high/low parts into [cp, cp] (zeros at t >= c or
// s >= c).  Warp w owns rows t0 + 16 w .. + 15 and all 64 columns.
__global__ void __launch_bounds__(kScoreThreads)
chunk_scores(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ ig, const float* __restrict__ cum,
             bf16* __restrict__ sc, int S, int P, int c, int cp, int nC) {
  __shared__ __align__(16) bf16 Qs[kST * kLDQ];   // [t][hi 32 | lo 32 | pad]
  __shared__ __align__(16) bf16 Ks[kST * kLDQ];   // [s][hi 32 | lo 32 | pad]
  const int z = blockIdx.z;                       // bh * nC + n
  const int64_t row0 = (int64_t)(z / nC) * S + (int64_t)(z % nC) * c;
  const int t0 = blockIdx.y * kST, s0 = blockIdx.x * kST;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  // element (t, s) of this chunk's high part; the low part is 16 further
  bf16* out = sc + (int64_t)z * cp * cp * 2;
  auto at = [&](int t, int s) {
    return out + ((int64_t)(s / kK) * cp + t) * (2 * kK) + s % kK;
  };

  if (s0 > t0 + kST - 1) {           // wholly above the diagonal
    for (int e = tid; e < kST * kST / 2; e += kScoreThreads) {
      const int t = t0 + e / (kST / 2), s = s0 + 2 * (e % (kST / 2));
      if (t < cp && s < cp) {
        *reinterpret_cast<uint32_t*>(at(t, s)) = 0u;
        *reinterpret_cast<uint32_t*>(at(t, s) + kK) = 0u;
      }
    }
    return;
  }

  float acc[kST / 8][4];
#pragma unroll
  for (int j = 0; j < kST / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ldmatrix row addresses: A (q, rows t) takes rows lane % 16 and column
  // half lane / 16; B (k, rows s) takes rows lane % 8 + 8 (lane / 16) and
  // column half (lane / 8) % 2
  const bf16* qa = Qs + (warp * 16 + lane % 16) * kLDQ + (lane / 16) * 8;
  const bf16* kb = Ks + (lane % 8 + 8 * (lane / 16)) * kLDQ +
                   ((lane / 8) % 2) * 8;
  for (int p0 = 0; p0 < P; p0 += kSK) {
    __syncthreads();                 // the previous tiles are consumed
    for (int e = tid; e < kST * kSK / 2; e += kScoreThreads) {
      const int r = e / (kSK / 2), pp = 2 * (e % (kSK / 2));
      const int p = p0 + pp;
      const int t = t0 + r, s = s0 + r;
      const float* qr = q + (row0 + t) * P;
      const float* kr = k + (row0 + s) * P;
      const bool tin = t < c, sin = s < c;
      uint32_t h, l;
      split2(tin && p < P ? qr[p] : 0.f, tin && p + 1 < P ? qr[p + 1] : 0.f,
             h, l);
      *reinterpret_cast<uint32_t*>(Qs + r * kLDQ + pp) = h;
      *reinterpret_cast<uint32_t*>(Qs + r * kLDQ + kSK + pp) = l;
      split2(sin && p < P ? kr[p] : 0.f, sin && p + 1 < P ? kr[p + 1] : 0.f,
             h, l);
      *reinterpret_cast<uint32_t*>(Ks + r * kLDQ + pp) = h;
      *reinterpret_cast<uint32_t*>(Ks + r * kLDQ + kSK + pp) = l;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSK / 16; ++ks) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, smem_addr(qa + ks * 16));
      ldsm_x4(al, smem_addr(qa + kSK + ks * 16));
      uint32_t bh[kST / 16][4], bl[kST / 16][4];
#pragma unroll
      for (int jp = 0; jp < kST / 16; ++jp) {
        ldsm_x4(bh[jp], smem_addr(kb + jp * 16 * kLDQ + ks * 16));
        ldsm_x4(bl[jp], smem_addr(kb + jp * 16 * kLDQ + kSK + ks * 16));
      }
      // product by product: consecutive mma write different accumulators
#pragma unroll
      for (int pr = 0; pr < 3; ++pr)
#pragma unroll
        for (int j = 0; j < kST / 8; ++j) {
          const uint32_t* b = pr == 1 ? bl[j / 2] : bh[j / 2];
          if (pr == 0)
            mma_bf16(acc[j], al, b[2 * (j % 2)], b[2 * (j % 2) + 1]);
          else
            mma_bf16(acc[j], ah, b[2 * (j % 2)], b[2 * (j % 2) + 1]);
        }
    }
  }

  const float* cm = cum + row0;
  const float* gi = ig + row0;
#pragma unroll
  for (int j = 0; j < kST / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + warp * 16 + g + 8 * r;
      const int s = s0 + j * 8 + 2 * tg;
      if (t >= cp || s >= cp) continue;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // mask first: for s <= t the exponent cum[t] - cum[s] is <= 0
        x[e] = (t < c && s + e <= t)
                   ? acc[j][2 * r + e] * expf(cm[t] - cm[s + e]) * gi[s + e]
                   : 0.f;
      }
      uint32_t h, l;
      split2(x[0], x[1], h, l);
      *reinterpret_cast<uint32_t*>(at(t, s)) = h;
      *reinterpret_cast<uint32_t*>(at(t, s) + kK) = l;
    }
}

// --------------------------------------------------------- 4. recurrence
struct Dims {
  int S, P, Pk, Pu, Pv, c, cp, nC, ntb, nq, nh;
};

__device__ __forceinline__ int score_steps(const Dims& d, int tb) {
  return min(d.cp, (tb + 1) * kTB) / kK;
}

// 32-row blocks of y pass tb
__device__ __forceinline__ int row_blocks(const Dims& d, int tb) {
  return (min(d.cp - tb * kTB, kTB) + 31) / 32;
}

// The recurrent block's sequence of steps, one B tile each: per chunk n,
// for each y pass tb (rows 256 tb ..), the carry steps (phase 0; none in
// chunk 0): per 32-row block b, q~ of k-tiles 16 q .. 16 q + 15, q < nq;
// then the score steps (phase 1, s0 = 16 i, up to the pass's last row);
// after the last pass, the state update (phase 2; none in the last
// chunk): per s-step i, kd of slabs 2 h, 2 h + 1, h < nh.  Phase 3: done.
// The loads run ahead of the products through this cursor; the products
// walk the same sequence as nested loops.
struct Cursor {
  int n, phase, tb, b, q, i, h;
};

__device__ void settle(Cursor& u, const Dims& d) {
  for (;;) {
    if (u.n >= d.nC) {
      u.phase = 3;
      return;
    }
    if (u.phase == 0) {
      if (u.n > 0) {
        if (u.q >= d.nq) {
          u.q = 0;
          ++u.b;
        }
        if (u.b < row_blocks(d, u.tb)) return;
      }
      u.phase = 1;
      u.i = 0;
    } else if (u.phase == 1) {
      if (u.i < score_steps(d, u.tb)) return;
      u.i = u.b = u.q = 0;
      if (++u.tb < d.ntb) {
        u.phase = 0;
      } else {
        u.phase = 2;
        u.h = 0;
      }
    } else {
      if (u.n < d.nC - 1) {
        if (u.h >= d.nh) {
          u.h = 0;
          ++u.i;
        }
        if (u.i < d.cp / kK) return;
      }
      ++u.n;
      u.phase = u.tb = u.b = u.q = u.i = u.h = 0;
    }
  }
}

__device__ __forceinline__ void advance(Cursor& u, const Dims& d) {
  if (u.phase == 0)
    ++u.q;
  else if (u.phase == 1)
    ++u.i;
  else
    ++u.h;
  settle(u, d);
}

// Issue the cp.async copies of step u's B tile into a ring stage; chunks
// out of range are zero-filled without a read.
//   carry  [32 t][16 k-tiles][hi 16 | lo 16] (row kLDC): 16 blocks of
//          2 KB, 8 copies a thread;
//   score  [256 t][hi 16 | lo 16] (row kLDY): one 16 KB block, 4 copies a
//          thread; rows t < s0 are zero (s > t) and are not read;
//   update [16 s][2 slabs][hi 256 | lo 256] (row kLDU): one 32 KB block,
//          8 copies a thread.
__device__ __forceinline__ void load_step(const Cursor& u, const Dims& d,
                                          const Workspace& ws, int bh,
                                          int tid, bf16* dst) {
  const uint32_t at = smem_addr(dst);
  const int64_t z = (int64_t)bh * d.nC + u.n;
  if (u.phase == 0) {
    const int r = (tid % 128) / 4, part = tid % 4;
    const int t = u.tb * kTB + 32 * u.b + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = tid / 128 + 2 * j, kt = 16 * u.q + kk;
      const bool in = kt < d.Pk / kK && t < d.cp;
      const bf16* src =
          in ? ws.qt + ((z * (d.Pk / kK) + kt) * d.cp + t) * (2 * kK) +
                   8 * part
             : ws.qt;
      cp_async16(at + 2 * (r * kLDC + kk * 2 * kK + 8 * part), src, in);
    }
  } else if (u.phase == 1) {
    const bf16* src =
        ws.sc + ((z * (d.cp / kK) + u.i) * d.cp + u.tb * kTB) * (2 * kK) +
        8 * tid;
    const int t = u.tb * kTB + tid / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = t + 64 * j;
      const bool in = r < d.cp && r >= u.i * kK;
      cp_async16(at + 2 * ((tid / 4 + 64 * j) * kLDY + 8 * (tid % 4)),
                 in ? src + 2048 * j : ws.sc, in);
    }
  } else {
    const int col = 8 * (tid % 64);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = j / 4, r = tid / 64 + 4 * (j % 4), sl = 2 * u.h + b;
      const bool in = sl < d.Pu / kSlab;
      const bf16* src =
          in ? ws.kd + (((z * (d.cp / kK) + u.i) * (d.Pu / kSlab) + sl) * kK +
                        r) * (2 * kSlab) + col
             : ws.kd;
      cp_async16(at + 2 * (r * kLDU + b * 2 * kSlab + col), src, in);
    }
  }
}

// The three products of one k-step: acc[mi][ni] += A[mi] . B[ni] with
// A = ah + al and B = bh + bl, dropping al . bl; issued product by product
// so that consecutive mma write different accumulators
__device__ __forceinline__ void mma3(float (&acc)[2][4][4],
                                     const uint32_t (&ah)[2][4],
                                     const uint32_t (&al)[2][4],
                                     const uint32_t (&bh)[4][2],
                                     const uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
}

// A fragments of v^T (m = column w, k = row s) for the k-step at s0, from
// the v tile [s][hi 32 | lo 32 | pad] by ldmatrix.trans: matrix j of lane
// group j = lane / 8 is rows s0 + 8 (j / 2) .., columns 8 (j % 2) ..
__device__ __forceinline__ void load_vt(uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4], const bf16* vs,
                                        int s0, int lane) {
  const bf16* base = vs + (s0 + lane % 8 + 8 * (lane / 16)) * kLDV +
                     8 * ((lane / 8) % 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    ldsm_x4_trans(ah[mi], smem_addr(base + 16 * mi));
    ldsm_x4_trans(al[mi], smem_addr(base + kW + 16 * mi));
  }
}

// B fragments (k, n = row t) of 4 n-tiles, rows t_l .. t_l + 31, of a tile
// whose rows are [.. hi 16 | lo 16 ..] at column `col` (ldmatrix: rows
// lane % 8 + 8 (lane / 16), column half (lane / 8) % 2)
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&bh)[4][2],
                                        uint32_t (&bl)[4][2], const bf16* tile,
                                        int t_l, int col, int lane) {
  const bf16* base = tile + (t_l + lane % 8 + 8 * (lane / 16)) * LD + col +
                     8 * ((lane / 8) % 2);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldsm_x4(r, smem_addr(base + 16 * np * LD));
    bh[2 * np][0] = r[0], bh[2 * np][1] = r[1];
    bh[2 * np + 1][0] = r[2], bh[2 * np + 1][1] = r[3];
    ldsm_x4(r, smem_addr(base + 16 * np * LD + kK));
    bl[2 * np][0] = r[0], bl[2 * np][1] = r[1];
    bl[2 * np + 1][0] = r[2], bl[2 * np + 1][1] = r[3];
  }
}

// Carry step Q of a 32-row block: acc += state^T[:, kt] q~[rows, kt]^T over
// this warp's k-tiles kt = warp + 8 (2 Q + r), r = 0, 1 (columns kk = warp
// + 8 r of the carry tile).  The A fragments of a k-tile are the state
// accumulators of its two n-tiles, split (row g: c0 c1, row g + 8: c2 c3)
template <int Q>
__device__ __forceinline__ void carry_step(float (&acc)[2][4][4],
                                           const float (&st)[2][16][4],
                                           const bf16* tile, int warp,
                                           int lane, int n_kt) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 2 * Q + r;         // the warp's k-tile index
    if (warp + 8 * i >= n_kt) continue;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2(st[mi][2 * i + e / 2][2 * (e % 2)],
               st[mi][2 * i + e / 2][2 * (e % 2) + 1], ah[mi][e], al[mi][e]);
    load_bt<kLDC>(bh, bl, tile, 0, (warp + 8 * r) * 2 * kK, lane);
    mma3(acc, ah, al, bh, bl);
  }
}

// Update step H: state^T[:, kt] += v^T kd[:, kt] for this warp's k-tiles
// kt = warp + 8 (4 H + r), r < 4, of slabs 2 H, 2 H + 1 (ldmatrix.trans:
// rows lane % 8 + 8 ((lane / 8) % 2), n-tile lane / 16)
template <int H>
__device__ __forceinline__ void update_step(float (&st)[2][16][4],
                                            const uint32_t (&ah)[2][4],
                                            const uint32_t (&al)[2][4],
                                            const bf16* tile, int warp,
                                            int lane, int n_kt) {
  // two k-tiles at a time: their B fragments, then 12 mma product by
  // product (the state is already 128 registers a thread)
#pragma unroll
  for (int r0 = 0; r0 < 4; r0 += 2) {
    uint32_t bh[2][4], bl[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pl = 16 * (warp + 8 * (r0 + r));   // column in the slabs
      if (warp + 8 * (4 * H + r0 + r) >= n_kt) continue;
      const bf16* base = tile + (lane % 8 + 8 * ((lane / 8) % 2)) * kLDU +
                         (pl / kSlab) * 2 * kSlab + pl % kSlab +
                         8 * (lane / 16);
      ldsm_x4_trans(bh[r], smem_addr(base));
      ldsm_x4_trans(bl[r], smem_addr(base + kSlab));
    }
#pragma unroll
    for (int pr = 0; pr < 3; ++pr)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * H + r0 + r;
        if (warp + 8 * i >= n_kt) continue;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t* b = pr == 1 ? bl[r] : bh[r];
            if (pr == 0)
              mma_bf16(st[mi][2 * i + x], al[mi], b[2 * x], b[2 * x + 1]);
            else
              mma_bf16(st[mi][2 * i + x], ah[mi], b[2 * x], b[2 * x + 1]);
          }
      }
  }
}

size_t recurrent_smem(const Dims& d, int stages) {
  return sizeof(float) * ((size_t)kW * kLDS + (size_t)kWarps * kW * kLDR) +
         sizeof(bf16) * ((size_t)d.cp * kLDV + (size_t)stages * kStage);
}

// One (head, column tile): all chunks in order.  The f32 state^T tile
// [32, Pk] lives in the warps' accumulator registers: warp j holds the
// 16-column k-tiles j, j + 8, .. of P (st[mi][2 i + x]: k-tile j + 8 i,
// its n-tile x).  Per chunk and y pass: the carry state^T q~^T, each warp
// over its own k-tiles for every 32-row block, summed across the warps in
// shared memory (csum); the score steps, each warp owning 32 rows t; y =
// v^T sc^T + csum stored.  Then the update into the registers.  B tiles
// stream through a ring of NST stages, one barrier a step.
template <int NST>
__global__ void __launch_bounds__(kThreads, 1)
chunk_recurrent(const float* __restrict__ v, Workspace ws,
                float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* csum = reinterpret_cast<float*>(smem_raw);          // [kW][kLDS]
  float* slots = csum + kW * kLDS;                 // [kWarps][kW][kLDR]
  bf16* vs = reinterpret_cast<bf16*>(slots + kWarps * kW * kLDR);
  bf16* ring = vs + d.cp * kLDV;                   // [NST][kStage]

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kW;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n_kt = d.Pk / kK;

  float st[2][16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mi][ni][e] = 0.f;
  // the carry's and the score steps' accumulator, zeroed where each use
  // begins (so that it is dead, not zeros, during the state update)
  float acc[2][4][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  };

  Cursor prod = {0, 0, 0, 0, 0, 0, 0};
  settle(prod, d);
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (prod.phase != 3) {
      load_step(prod, d, ws, bh, tid, ring + s * kStage);
      advance(prod, d);
    }
    cp_async_commit();
  }
  int it = 0;
  // wait for step it's tile, free the stage of step it - 1, issue the load
  // NST - 1 steps ahead; returns step it's tile
  auto step = [&]() -> const bf16* {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (prod.phase != 3) {
      load_step(prod, d, ws, bh, tid, ring + ((it + NST - 1) % NST) * kStage);
      advance(prod, d);
    }
    cp_async_commit();
    return ring + (it++ % NST) * kStage;
  };

  for (int n = 0; n < d.nC; ++n) {
    const int64_t row0 = (int64_t)bh * d.S + (int64_t)n * d.c;
    __syncthreads();                 // the previous chunk's reads of vs
#pragma unroll 4
    for (int e = tid; e < d.cp * kW; e += kThreads) {
      const int s = e / kW, w = e % kW;
      const float x = (s < d.c && col0 + w < d.Pv)
                          ? v[(row0 + s) * d.Pv + col0 + w]
                          : 0.f;
      const bf16 h = __float2bfloat16_rn(x);
      vs[s * kLDV + w] = h;
      vs[s * kLDV + kW + w] = __float2bfloat16_rn(x - __bfloat162float(h));
    }

    for (int tb = 0; tb < d.ntb; ++tb) {
      if (n > 0) {                   // carry: csum = state^T q~^T
        for (int b = 0; b < row_blocks(d, tb); ++b) {
          zero_acc();
          if (0 < d.nq) carry_step<0>(acc, st, step(), warp, lane, n_kt);
          if (1 < d.nq) carry_step<1>(acc, st, step(), warp, lane, n_kt);
          if (2 < d.nq) carry_step<2>(acc, st, step(), warp, lane, n_kt);
          if (3 < d.nq) carry_step<3>(acc, st, step(), warp, lane, n_kt);
          // this warp's partial sums into its slot; then every thread sums
          // 4 of the block's 32 x 32 outputs over the 8 slots
          float* slot = slots + warp * kW * kLDR;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                *reinterpret_cast<float2*>(
                    slot + (16 * mi + g + 8 * r) * kLDR + 8 * ni + 2 * tg) =
                    make_float2(acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
          __syncthreads();
          const int w = tid / 8, t4 = 4 * (tid % 8);
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < kWarps; ++k) {
            const float4 x = *reinterpret_cast<const float4*>(
                slots + (k * kW + w) * kLDR + t4);
            sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
          }
          *reinterpret_cast<float4*>(csum + w * kLDS + 32 * b + t4) = sum;
        }
      }
      // score steps: acc = v^T sc^T, 32 rows t a warp
      const int tw = tb * kTB + 32 * warp;
      zero_acc();
      for (int i = 0; i < score_steps(d, tb); ++i) {
        const bf16* tile = step();
        if (tw < d.c && i * kK <= tw + 31) {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
          load_vt(ah, al, vs, i * kK, lane);
          load_bt<kLDY>(bh, bl, tile, 32 * warp, 0, lane);
          mma3(acc, ah, al, bh, bl);
        }
      }
      // y[t][col0 + w] = acc + csum (row w of the accumulator is a column
      // of y; its columns 2 tg, 2 tg + 1 are rows t); csum was summed
      // before the score steps' barriers
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int w = 16 * mi + g + 8 * (e / 2);
            const int tl = 32 * warp + 8 * ni + 2 * tg + e % 2;
            const int t = tb * kTB + tl;
            if (col0 + w < d.Pv && t < d.c)
              y[(row0 + t) * d.Pv + col0 + w] =
                  acc[mi][ni][e] + (n > 0 ? csum[w * kLDS + tl] : 0.f);
          }
    }

    if (n < d.nC - 1) {              // state^T = decay state^T + v^T kd
      const float decay = expf(ws.cum[row0 + d.c - 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mi][ni][e] *= decay;
      for (int i = 0; i < d.cp / kK; ++i) {
        uint32_t ah[2][4], al[2][4];
        load_vt(ah, al, vs, i * kK, lane);
        if (0 < d.nh) update_step<0>(st, ah, al, step(), warp, lane, n_kt);
        if (1 < d.nh) update_step<1>(st, ah, al, step(), warp, lane, n_kt);
      }
    }
  }
  cp_async_wait<0>();
}

// The shared-memory limit is a per-device attribute of a kernel: set it on
// the first launch of each kernel instance on each device, not on every.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int NST>
cudaError_t launch_recurrent(const float* v, const Workspace& ws, float* y,
                             const Dims& d, int BH, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(chunk_recurrent<NST>, done);
  if (err != cudaSuccess) return err;
  chunk_recurrent<NST><<<dim3((d.Pv + kW - 1) / kW, BH), kThreads,
                         recurrent_smem(d, NST), st>>>(v, ws, y, d);
  return cudaGetLastError();
}

Dims dims_of(int S, int P, int Pv, int c) {
  Dims d;
  d.S = S;
  d.P = P;
  d.Pk = round_up(P, kK);
  d.Pu = round_up(P, kSlab);
  d.Pv = Pv;
  d.c = c;
  d.cp = round_up(c, kK);
  d.nC = S / c;
  d.ntb = (c + kTB - 1) / kTB;
  d.nq = (d.Pk + kSlab - 1) / kSlab;        // carry steps of a row block
  d.nh = (d.Pk + 2 * kSlab - 1) / (2 * kSlab);   // update steps of an s-step
  return d;
}

}  // namespace

extern "C" {

// The bytes of scratch that `mlstm_chunk_fwd` needs for these sizes.
int mlstm_chunk_workspace(int BH, int S, int P, int c, long long* bytes) {
  if (c <= 0 || S % c || P <= 0 || BH <= 0) return (int)cudaErrorInvalidValue;
  *bytes = (long long)carve(nullptr, BH, S, P, c, nullptr);
  return 0;
}

// One forward pass on `stream`.  Device pointers, contiguous float32:
// q, k (BH, S, P); v, y (BH, S, Pv); ig, la (BH, S); `ws` scratch of
// `ws_bytes` (at least `mlstm_chunk_workspace`'s).  S must be a multiple of
// c.  Returns the CUDA error (0 = none): cudaErrorInvalidValue where P
// exceeds the state registers' 1024 columns, the v tile and two ring
// stages do not fit one block's shared memory (c above 624), BH * S / c
// exceeds a grid's 65535, or the scratch is too small.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const void* ig, const void* la, void* y, void* ws,
                    long long ws_bytes, int BH, int S, int P, int Pv, int c,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (c <= 0 || S % c || P <= 0 || Pv <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(S, P, Pv, c);
  // grid y of chunk_recurrent is BH, grid z of chunk_scores is BH * nC
  if (BH > 65535 || (long long)BH * d.nC > 65535)
    return (int)cudaErrorInvalidValue;
  if (P > kMaxP || recurrent_smem(d, 2) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Workspace w;
  if ((long long)carve((char*)ws, BH, S, P, c, &w) > ws_bytes)
    return (int)cudaErrorInvalidValue;

  const int n_chunks = BH * d.nC;
  chunk_cumsum<<<(n_chunks + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)la, w.cum, n_chunks, S, c, d.nC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t pairs = (int64_t)n_chunks * d.cp * (d.Pu / 2);
  const int64_t want = (pairs + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  split_operands<<<blocks, kThreads, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)ig, w.cum, w.qt, w.kd,
      n_chunks, S, P, d.Pk, d.Pu, c, d.cp, d.nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nT = (d.cp + kST - 1) / kST;
  chunk_scores<<<dim3(nT, nT, n_chunks), kScoreThreads, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)ig, w.cum, w.sc, S, P,
      c, d.cp, d.nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (recurrent_smem(d, 3) <= (size_t)kMaxSmem)
    err = launch_recurrent<3>((const float*)v, w, (float*)y, d, BH, st);
  else
    err = launch_recurrent<2>((const float*)v, w, (float*)y, d, BH, st);
  return (int)err;
}

const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
