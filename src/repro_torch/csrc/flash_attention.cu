// Causal GQA flash attention, forward only, with an online softmax.
//
// Replaces the TPU kernel `flash_attention_bhsd` (src/repro/kernels/
// flash_attention/kernel.py, the Pallas call over `_fa_kernel`).  For
// every query row q of head bh it computes
//
//   s[k] = softcap((q . k_k) / sqrt(hd)),  kept where k <= q (causal),
//          k > q - window (window > 0) and k < S
//   o[q] = sum_k softmax(s)[k] v_k      (0 where no key is kept)
//
// with query head bh reading K/V head bh / group_size in place, the running
// max, denominator and accumulator in f32, and the output in the input
// dtype.  Two routes, picked by the dtype:
//
//   bf16  `flash_tc_kernel`: both products on the tensor cores
//         (mma.sync m16n8k16, bf16 operands, f32 accumulate);
//   f32   `flash_fma_kernel`: both products in exact f32 FMA, the port's
//         first kernel, kept because a bf16 or TF32 product cannot meet
//         the f32 tolerance.
//
// Shared design.  The TPU grid walks the k-blocks of one q-block in order
// and carries the softmax state in VMEM scratch between grid steps; CUDA
// blocks run in no order, so here one block (4 warps) owns one (bh, 64-row
// q tile) and loops over the k tiles itself, carrying the state in
// registers.  Blocks start with the last q tiles, whose causal rows visit
// the most k tiles.  A block visits only the k tiles that the causal and
// window bounds keep (the reference executes the fully masked blocks too),
// and takes S at run time, masking the ragged edge.
//
// What bounds it on an H100: operations.  The work is 4 hd FLOPs per kept
// (q, k) pair (q.k and p.v), about S^2/2 pairs per head for causal
// attention, against q, k, v and o each read or written once: at
// smollm-135m's shape (hd 64, S 4096, bf16) some 1 500 FLOPs per byte, far
// past the card's ridge of ~295, so the tensor cores' 989 TFLOP/s (bf16)
// bound it.
//
// The tensor-core route (FlashAttention-2's schedule on mma.sync):
//   * each warp owns 16 query rows.  For hd <= 128 its Q tile stays in
//     registers as mma A-fragments for the whole loop; at hd 256 those
//     would take 64 registers beside a 128-register accumulator, so Q stays
//     in shared memory and is read again with ldmatrix at every k-step;
//   * K and V tiles are bf16 in shared memory, in a ring of two stages
//     filled by 16-byte cp.async: the next tile's copy is in flight while
//     this tile's products run.  Rows are padded by 16 bytes, which puts
//     the 8 rows that one ldmatrix reads on 8 different bank groups (no
//     conflicts; the padding is the swizzle).  Rows past S are zero-filled;
//   * S = Q.K^T with K read by ldmatrix, O += P.V with V read by
//     ldmatrix.trans; the online softmax runs on the accumulator fragments
//     (each thread holds 2 rows, reduced over its quad with shuffles) in
//     base 2, log2(e) folded into the scale, one FMA and one exp2 a score;
//   * P goes from the S accumulators to bf16 A-fragments in registers,
//     never through shared memory; the denominator sums P in f32.  The
//     rounding perturbs each weight of P.V by at most 2^-9 relative, and a
//     row over n keys by ~2^-9 / sqrt(n / e) of its v rows' spread.  The
//     accumulator is rescaled only where a row's max moved;
//   * masks are evaluated only on the k tiles that cross the diagonal, the
//     window edge or S.  On those tiles, and on every tile of a block whose
//     rows keep fewer than kSplitKeys keys, P is split into a bf16 high
//     part and a bf16 low part (two P.V products), which takes P to
//     ~2^-17: rows with few keys, whose one rounding of P would not average
//     out, are then exact to the f32 sums.

// The f32 route reads its operands from shared memory one word at a time
// and does both products in f32 FMA (67 TFLOP/s peak): it is exact to
// summation order, and runs far above the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;   // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory limit is a per-device attribute of a kernel: set it on
// the first launch of each kernel instance on each device, not on every.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// k tiles of width BK that the bounds keep for rows [q0, q0 + kBQ)
template <int BK>
__device__ __forceinline__ void kept_tiles(int q0, int S, int causal,
                                           int window, int& t_lo,
                                           int& t_hi) {
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;                  // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;  // inclusive
  t_lo = k_lo / BK;
  t_hi = (k_hi + BK - 1) / BK;
}

// ======================================================== tensor cores, bf16
template <int HD>
struct Tc {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // key rows per tile
  static constexpr int kLD = HD + 8;               // padded row, elements
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kStages = 2;
  // 4 blocks an SM caps a thread at 128 registers (a few bytes spill at
  // hd 64); the 16 warps hide more of the exp2 and ldmatrix latency than
  // 12 warps without the cap
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 1;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kStages * kBK) * kLD;
};

// A block whose rows keep fewer keys than this splits P into bf16 high
// and low parts on every tile: a row over n keys moves by ~2^-9 /
// sqrt(n / e) relative to its v rows when P is rounded once, which stays
// far inside phase 8's bf16 bound only from a few hundred keys on.
constexpr int kSplitKeys = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 2^x as one ex2.approx.ftz instruction (faster than exp2f on the card);
// a result below 2^-126 flushes to 0, an addend no f32 sum of P keeps
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// two floats as one bf16x2 register (lo in the low half); `back` gets the
// rounded values as floats
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& back_lo,
                                              float& back_hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  back_lo = __low2float(v);
  back_hi = __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a [S, HD] bf16 matrix into a padded tile
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int tid) {
  constexpr int kChunks = HD / 8;                   // 16-byte chunks a row
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool in = gr < S;
    cp_async16(smem_addr(dst + r * Tc<HD>::kLD + col),
               src + (int64_t)(in ? gr : 0) * HD + col, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tc<HD>::kMinBlocks)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int group_size,
                int causal, int window, float softcap, float scale) {
  using C = Tc<HD>;
  constexpr int BK = C::kBK, LD = C::kLD;
  constexpr int KS = HD / 16;      // k-steps of Q.K^T
  constexpr int NT = BK / 8;       // 8-key column tiles of S
  constexpr int PK = BK / 16;      // k-steps of P.V
  constexpr int DT = HD / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;                // [stage][BK][LD]
  __nv_bfloat16* Vs = Ks + C::kStages * BK * LD;   // [stage][BK][LD]

  // grid (heads, q tiles): the blocks of the last q tiles, whose causal
  // rows visit the most k tiles, are scheduled first for every head
  const int bh = blockIdx.x;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const __nv_bfloat16* qg = q + (int64_t)bh * S * HD;
  const int64_t kv_off = (int64_t)(bh / group_size) * S * HD;
  const __nv_bfloat16* kg = k + kv_off;
  const __nv_bfloat16* vg = v + kv_off;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;   // fragment row, column pair
  const int wrow = warp * 16;              // the warp's first row

  int t_lo, t_hi;
  kept_tiles<BK>(q0, S, causal, window, t_lo, t_hi);
  // the fewest keys any row of the block keeps
  int min_keys = causal ? q0 + 1 : S;
  if (window > 0) min_keys = min(min_keys, window);
  const bool few_keys = min_keys < kSplitKeys;
  load_tile<HD, kBQ>(Qs, qg, q0, S, tid);
  load_tile<HD, BK>(Ks, kg, t_lo * BK, S, tid);
  load_tile<HD, BK>(Vs, vg, t_lo * BK, S, tid);
  cp_async_commit();

  // ldmatrix row addresses, per lane: A fragments (Q) take rows lane % 16
  // and column half lane / 16; B fragments from K take key rows
  // lane % 8 + 8 (lane / 16) and column half (lane / 8) % 2; B fragments
  // from V (transposed) take key rows lane % 8 + 8 ((lane / 8) % 2) and
  // column half lane / 16
  const uint32_t q_addr =
      smem_addr(Qs + (wrow + lane % 16) * LD + (lane / 16) * 8);
  const int k_row = lane % 8 + 8 * (lane / 16), k_col = ((lane / 8) % 2) * 8;
  const int v_row = lane % 8 + 8 * ((lane / 8) % 2), v_col = (lane / 16) * 8;

  uint32_t qf[C::kQInRegs ? KS : 1][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, base-2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum
  // p = exp2(x * mul - max): x is the raw score times scale * log2(e), or
  // with a softcap, the capped score in base 2 already
  const float mul = softcap > 0.f ? 1.f : scale * kLog2e;
  const float cap2 = softcap * kLog2e, cap_inv = scale / softcap;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % C::kStages;
    if (t + 1 < t_hi) {
      const int nx = (t + 1 - t_lo) % C::kStages;
      load_tile<HD, BK>(Ks + nx * BK * LD, kg, (t + 1) * BK, S, tid);
      load_tile<HD, BK>(Vs + nx * BK * LD, vg, (t + 1) * BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (C::kQInRegs) {
      if (t == t_lo) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], q_addr + ks * 16 * sizeof(__nv_bfloat16));
      }
    }
    const __nv_bfloat16* Kt = Ks + st * BK * LD;
    const __nv_bfloat16* Vt = Vs + st * BK * LD;

    // S = Q . K^T for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldsm_x4(a, q_addr + ks * 16 * sizeof(__nv_bfloat16));
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(Kt + (jp * 16 + k_row) * LD + ks * 16 + k_col));
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // softcap (in base 2), then mask (only tiles that cross a bound)
    const int kb = t * BK;
    const bool masked = kb + BK > S || (causal && kb + BK - 1 > q0) ||
                        (window > 0 && kb <= q0 + kBQ - 1 - window);
    const bool split = masked || few_keys;
    if (softcap > 0.f || masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[j][e];
          if (softcap > 0.f) x = cap2 * tanhf(x * cap_inv);
          if (masked) {
            const int ki = kb + j * 8 + 2 * tg + (e & 1);
            const int qi = q0 + wrow + g + 8 * (e >> 1);
            bool keep = ki < S;
            if (causal) keep = keep && ki <= qi;
            if (window > 0) keep = keep && ki > qi - window;
            if (!keep) x = -INFINITY;
          }
        }
    }

    // online softmax on the fragments: row g holds e = 0, 1; row g + 8
    // holds e = 2, 3; the 4 threads of a quad share each row.  P becomes
    // bf16 A-fragments: S tile j (keys 8j..8j+7) is half of k-step j / 2,
    // and where P is split, the bf16 remainder p - hi goes beside it
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * mul);
      // fully masked so far: exp2(-inf - -inf) would be NaN, so use 0
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base[r]);
      m[r] = m_new;
      if (alpha != 1.f) {              // the row's max moved
        l[r] *= alpha;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          acc[d][2 * r] *= alpha;
          acc[d][2 * r + 1] *= alpha;
        }
      }
    }
    uint32_t ph[PK][4], pl[PK][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2_fast(fmaf(s[j][2 * r], mul, -base[r]));
        const float p1 = exp2_fast(fmaf(s[j][2 * r + 1], mul, -base[r]));
        float h0, h1, r0, r1;
        ph[j / 2][(j % 2) * 2 + r] = pack_bf16(p0, p1, h0, h1);
        if (split)
          pl[j / 2][(j % 2) * 2 + r] = pack_bf16(p0 - h0, p1 - h1, r0, r1);
        l[r] += p0 + p1;
      }

    // O += P . V
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(Vt + (kk * 16 + v_row) * LD + dp * 16 +
                                   v_col));
        mma_bf16(acc[2 * dp], ph[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], ph[kk], b[2], b[3]);
        if (split) {
          mma_bf16(acc[2 * dp], pl[kk], b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], pl[kk], b[2], b[3]);
        }
      }
    __syncthreads();                 // stage st is free for tile t + 2
  }

  __nv_bfloat16* og = o + (int64_t)bh * S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int qi = q0 + wrow + g + 8 * r;
    if (qi >= S) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float lo, hi;
      const uint32_t w =
          pack_bf16(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv, lo, hi);
      *reinterpret_cast<uint32_t*>(og + (int64_t)qi * HD + d * 8 + 2 * tg) =
          w;
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int S, int group_size, int causal, int window, float softcap,
              cudaStream_t stream) {
  static bool smem_set[64] = {};
  cudaError_t err = allow_smem(flash_tc_kernel<HD>, Tc<HD>::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BH, (unsigned)((S + kBQ - 1) / kBQ));
  flash_tc_kernel<HD><<<grid, kThreads, Tc<HD>::kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, group_size, causal,
      window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ============================================================ f32 FMA route
// Per k tile: the K and V tiles (64 rows) are staged in shared memory; each
// warp owns 16 query rows, each lane 4 rows by 8 key columns of the scores
// (columns strided by 8 so that the lanes of a warp hit different banks)
// and 4 rows by hd/8 output columns; the row max and sum are reduced over
// the 8 lanes that share a row with warp shuffles; P goes through shared
// memory (per warp) into P.V.  Rows are padded by one word in shared
// memory against bank conflicts.
constexpr int kBK = 64;            // key rows per tile
constexpr int kR = 4;              // query rows per lane
constexpr int kCG = 8;             // lanes sharing a row
constexpr int kSC = kBK / kCG;     // score columns per lane

template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (HD + 1) + (size_t)kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int group_size, int causal, int window, float softcap,
                 float scale) {
  constexpr int LD = HD + 1;         // padded row stride of Q, K, V
  constexpr int PLD = kBK + 1;       // padded row stride of P
  constexpr int OC = HD / kCG;       // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][LD], pre-scaled
  float* Ks = Qs + kBQ * LD;         // [kBK][LD]
  float* Vs = Ks + kBK * LD;         // [kBK][LD]
  float* Ps = Vs + kBK * LD;         // [kBQ][PLD]

  const int bh = blockIdx.y;
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const float* qg = q + (int64_t)bh * S * HD;
  const int64_t kv_off = (int64_t)(bh / group_size) * S * HD;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / kCG, cg = lane % kCG;
  const int row0 = warp * 16 + rg * kR;     // first of this lane's rows

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * LD + d] = qi < S ? qg[(int64_t)qi * HD + d] * scale : 0.f;
  }

  int t_lo, t_hi;
  kept_tiles<kBK>(q0, S, causal, window, t_lo, t_hi);

  float m[kR], l[kR], acc[kR][OC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kb = t * kBK;
    __syncthreads();                 // previous tile's K, V, P consumed
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int ki = kb + r;
      const bool in = ki < S;
      Ks[r * LD + d] = in ? kg[(int64_t)ki * HD + d] : 0.f;
      Vs[r * LD + d] = in ? vg[(int64_t)ki * HD + d] : 0.f;
    }
    __syncthreads();

    float s[kR][kSC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kR], kv[kSC];
#pragma unroll
      for (int i = 0; i < kR; ++i) qv[i] = Qs[(row0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kSC; ++j) kv[j] = Ks[(cg + kCG * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kSC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + row0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const int ki = kb + cg + kCG * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = ki < S;
        if (causal) keep = keep && ki <= qi;
        if (window > 0) keep = keep && ki > qi - window;
        s[i][j] = keep ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kCG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // fully masked so far: exp(-inf - -inf) would be NaN, so use 0
      const float safe = isinf(m_new) ? 0.f : m_new;
      const float alpha = isinf(m[i]) ? 0.f : expf(m[i] - safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const float p = isinf(s[i][j]) ? 0.f : expf(s[i][j] - safe);
        sum += p;
        Ps[(row0 + i) * PLD + cg + kCG * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kCG; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                    // this warp's P rows are written

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float pv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) pv[i] = Ps[(row0 + i) * PLD + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = Vs[j * LD + cg + kCG * c];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* og = o + (int64_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c)
      og[(int64_t)qi * HD + cg + kCG * c] = acc[i][c] * inv;
  }
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* o, int BH,
               int S, int group_size, int causal, int window, float softcap,
               cudaStream_t stream) {
  static bool smem_set[64] = {};
  const size_t smem = fma_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_fma_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)BH);
  flash_fma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S,
      group_size, causal, window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int group_size, int causal, int window, float softcap,
           int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch_fma<HD>(q, k, v, o, BH, S, group_size, causal, window,
                          softcap, s);
  if (dtype == 1)
    return launch_tc<HD>(q, k, v, o, BH, S, group_size, causal, window,
                         softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One forward pass on `stream`.  Device pointers: q and o (BH, S, hd),
// k and v (BH / group_size, S, hd), all contiguous and of one dtype:
// dtype 0 = float32 (the f32 FMA kernel), 1 = bfloat16 (the tensor-core
// kernel; every pointer 16-byte aligned).  hd is 32, 64, 128 or 256.
// window 0 means no sliding window; softcap 0 means none.  Returns the
// CUDA error (0 = none).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int hd, int group_size, int causal,
                        int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, BH, S, group_size, causal, window,
                        softcap, dtype, s);
    case 64:
      return launch<64>(q, k, v, o, BH, S, group_size, causal, window,
                        softcap, dtype, s);
    case 128:
      return launch<128>(q, k, v, o, BH, S, group_size, causal, window,
                         softcap, dtype, s);
    case 256:
      return launch<256>(q, k, v, o, BH, S, group_size, causal, window,
                         softcap, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
