// Chunked mLSTM / SSD readout with the matrix state carried across chunks.
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
// Design.  The TPU kernel keeps the whole [P, Pv] state in VMEM scratch and
// walks the chunks in grid order.  At xlstm-1.3b's widths (P 1024, Pv 1025:
// the normaliser column is appended to v) that state is 4.2 MB per head, and
// an H100 SM has 227 KB of shared memory.  So the state is split by columns:
// one block of the recurrent kernel owns (head bh, a tile of kW = 32 of the
// Pv columns), keeps state[:, tile] (P x 32 f32, 128 KB at P 1024) in shared
// memory and walks the chunks in order.  Every output column of y and of the
// state depends only on the same column of v, so the column tiles never
// talk to each other.  The one piece that needs the whole P contraction and
// no column of v, the [c, c] decay-masked score tile, is computed once per
// (head, chunk) by a separate kernel into a scratch buffer, and not once per
// column tile.  Three kernels, launched in order on one stream by one call:
//
//   1. chunk_cumsum: cum, one thread per (head, chunk);
//   2. chunk_scores: sc[t, s] = (q[t].k[s]) exp(cum[t]-cum[s]) ig[s] for
//      s <= t, else 0; one block per 64 x 64 tile; tiles above the diagonal
//      are written as zeros without a product.  The mask is applied before
//      the exp (the reference exponentiates the whole tile and then masks,
//      which can overflow to +inf where s > t): every kept exponent is <= 0;
//   3. chunk_recurrent: per (head, column tile), per chunk in order,
//      y = sc @ v + exp(cum) * (q @ state), then
//      state = exp(cum[c-1]) state + (k * exp(cum[c-1]-cum) ig)^T @ v.
//
// The arithmetic is f32 FMA on register tiles of 4 x 4 outputs per thread,
// with the operand tiles staged in shared memory (rows padded against bank
// conflicts); in the recurrent kernel the next operand tile is loaded into
// registers while the current one is multiplied, which hides the loads'
// latency at one block (8 warps) per SM.  Any S (a multiple of c), c, P up to the shared-memory limit
// (P 1024 with c 256 needs 182 400 bytes) and any Pv; ragged tile edges are
// zero-filled.
//
// What bounds it on an H100: operations.  Per (head, chunk) the work is
// 2c^2 P (scores) + 2c^2 Pv (y local) + 4 c P Pv (carry and state update)
// FLOPs, about 1.34 GFLOP at c 256, P 1024, Pv 1025, against q, k, v, y read
// or written once: ~160 FLOPs per byte, past the card's TF32 ridge, so its
// bound is the FLOPs at the dense TF32 tensor-core rate.  This first kernel
// computes in f32 FMA (67 TFLOP/s peak) and re-reads q and k from L2 once
// per column tile, so it runs well above that bound; parallelism is
// BH x ceil(Pv / 32) blocks (528 at B 4, 132 at B 1), one wave per 132.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kW = 32;         // Pv columns per recurrent block
constexpr int kR = 128;        // output rows per register pass (t or p)
constexpr int kK = 32;         // depth of a staged operand tile
constexpr int kLDA = kR + 1;   // padded row stride of the staged tile
constexpr int kST = 64;        // score tile edge
constexpr int kLDS = kST + 1;  // padded row stride of the score operands
constexpr int kMaxSmem = 232448;

// 1. cum[bh, n*c + i] = la[bh, n*c] + ... + la[bh, n*c + i].
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

// 2. One 64 x 64 tile (t rows, s columns) of one (head, chunk)'s scores.
__global__ void __launch_bounds__(kThreads)
chunk_scores(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ ig, const float* __restrict__ cum,
             float* __restrict__ sc, int S, int P, int c, int nC) {
  __shared__ float Qs[kK * kLDS];    // [p][t]
  __shared__ float Ks[kK * kLDS];    // [p][s]
  const int z = blockIdx.z;          // bh * nC + n
  const int64_t row0 = (int64_t)(z / nC) * S + (int64_t)(z % nC) * c;
  const int t0 = blockIdx.y * kST, s0 = blockIdx.x * kST;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty + 16 i, cols tx + 16 j
  float* out = sc + (int64_t)z * c * c;

  if (s0 > t0 + kST - 1) {           // wholly above the diagonal
    for (int e = tid; e < kST * kST; e += kThreads) {
      const int t = t0 + e / kST, s = s0 + e % kST;
      if (t < c && s < c) out[(int64_t)t * c + s] = 0.f;
    }
    return;
  }

  float acc[4][4] = {};
  for (int p0 = 0; p0 < P; p0 += kK) {
    __syncthreads();                 // previous tiles consumed
    for (int e = tid; e < kK * kST; e += kThreads) {
      const int r = e / kK, pp = e % kK;    // consecutive threads: along p
      const int p = p0 + pp;
      const int t = t0 + r, s = s0 + r;
      Qs[pp * kLDS + r] =
          (t < c && p < P) ? q[(row0 + t) * P + p] : 0.f;
      Ks[pp * kLDS + r] =
          (s < c && p < P) ? k[(row0 + s) * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < kK; ++pp) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[pp * kLDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[pp * kLDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const float* cm = cum + row0;
  const float* g = ig + row0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      if (s >= c) continue;
      // mask first: for s <= t the exponent cum[t] - cum[s] is <= 0
      out[(int64_t)t * c + s] =
          s <= t ? acc[i][j] * expf(cm[t] - cm[s]) * g[s] : 0.f;
    }
  }
}

// The register pass of the recurrent kernel: acc[i][j] (rows ty + 32 i,
// columns 4 tx + j) += sum over kk < kn of As[kk][row] * B[kk][col], with B
// a [kn][kW] block of shared memory.  Full tiles are unrolled.
__device__ __forceinline__ void fma_rows(float (&acc)[4][4],
                                         const float* As, const float* B,
                                         int kk, int ty, int tx) {
  const float4 b = *(const float4*)&B[kk * kW + 4 * tx];
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = As[kk * kLDA + ty + 32 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
  }
}

__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float* As,
                                         const float* B, int kn, int ty,
                                         int tx) {
  if (kn == kK) {
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) fma_rows(acc, As, B, kk, ty, tx);
  } else {
    for (int kk = 0; kk < kn; ++kk) fma_rows(acc, As, B, kk, ty, tx);
  }
}

constexpr int kPer = kK * kR / kThreads;  // staged elements per thread

// acc += A @ B over k in [0, k_end): A's [kK][kR] tiles are staged into As
// by `load(k0, e, &kk, &r)` (element e of the tile at depth k0: its value,
// and where it goes), B is [k_end][kW] in shared memory.  The next tile is
// loaded into registers while the current one is multiplied.
template <typename Load>
__device__ __forceinline__ void staged_product(float (&acc)[4][4], float* As,
                                               const float* B, int k_end,
                                               Load load, int tid, int ty,
                                               int tx) {
  float pre[kPer];
  int slot[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) pre[j] = load(0, tid + j * kThreads, slot[j]);
  for (int k0 = 0; k0 < k_end; k0 += kK) {
    __syncthreads();                 // the previous tile is consumed
#pragma unroll
    for (int j = 0; j < kPer; ++j) As[slot[j]] = pre[j];
    __syncthreads();
    if (k0 + kK < k_end) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        pre[j] = load(k0 + kK, tid + j * kThreads, slot[j]);
    }
    fma_tile(acc, As, B + k0 * kW, min(kK, k_end - k0), ty, tx);
  }
}

// 3. One (head, column tile): all chunks in order, the state tile carried in
// shared memory.  Thread (ty, tx) owns rows ty + 32 i (i < 4) and columns
// 4 tx .. 4 tx + 3 of each 128 x 32 output pass.
__global__ void __launch_bounds__(kThreads)
chunk_recurrent(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ ig,
                const float* __restrict__ cum, const float* __restrict__ sc,
                float* __restrict__ y, int S, int P, int Pv, int c, int nC) {
  extern __shared__ float4 smem4[];
  float* state = (float*)smem4;      // [P][kW]
  float* vs = state + P * kW;        // [c][kW], this chunk's v tile
  float* As = vs + c * kW;           // [kK][kLDA], staged operand
  float* cs = As + kK * kLDA;        // [c], cum of this chunk
  float* ds = cs + c;                // [c], exp(cum[c-1] - cum[s]) ig[s]

  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kW;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;

  for (int e = tid; e < P * kW; e += kThreads) state[e] = 0.f;

  for (int n = 0; n < nC; ++n) {
    const int64_t row0 = (int64_t)bh * S + (int64_t)n * c;
    const float* sc_n = sc + ((int64_t)bh * nC + n) * c * c;
    const float* q_n = q + row0 * P;
    const float* k_n = k + row0 * P;
    __syncthreads();                 // previous chunk done with vs, cs, ds
    for (int e = tid; e < c * kW; e += kThreads) {
      const int s = e / kW, j = e % kW;
      vs[e] = col0 + j < Pv ? v[(row0 + s) * Pv + col0 + j] : 0.f;
    }
    for (int s = tid; s < c; s += kThreads) cs[s] = cum[row0 + s];
    __syncthreads();
    const float last = cs[c - 1];
    for (int s = tid; s < c; s += kThreads)
      ds[s] = expf(last - cs[s]) * ig[row0 + s];
    // (ds is first read after the syncs of the passes below)

    // y = sc @ v + exp(cum) * (q @ state), 128 rows at a time; tiles of A
    // are [kK][kR]: element e is (row e / kK, depth e % kK), so that
    // consecutive threads read consecutive addresses of a row
    for (int t0 = 0; t0 < c; t0 += kR) {
      float loc[4][4] = {}, car[4][4] = {};
      // sc is 0 for s > t: the local product stops at the pass's last row
      staged_product(loc, As, vs, min(c, t0 + kR),
                     [&](int k0, int e, int& at) {
                       const int r = e / kK, kk = e % kK;
                       const int t = t0 + r, s = k0 + kk;
                       at = kk * kLDA + r;
                       return (t < c && s < c) ? sc_n[(int64_t)t * c + s]
                                               : 0.f;
                     }, tid, ty, tx);
      staged_product(car, As, state, P,
                     [&](int k0, int e, int& at) {
                       const int r = e / kK, kk = e % kK;
                       const int t = t0 + r, p = k0 + kk;
                       at = kk * kLDA + r;
                       return (t < c && p < P) ? q_n[(int64_t)t * P + p]
                                               : 0.f;
                     }, tid, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 32 * i;
        if (t >= c) continue;
        const float et = expf(cs[t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + 4 * tx + j;
          if (col < Pv) y[(row0 + t) * Pv + col] = loc[i][j] + et * car[i][j];
        }
      }
    }

    // state = exp(cum[c-1]) state + (k * ds)^T @ v, 128 rows of P at a
    // time; A = (k * ds)^T: element e is (depth e / kR, row e % kR), so
    // that consecutive threads read consecutive p
    const float decay = expf(last);
    for (int p0 = 0; p0 < P; p0 += kR) {
      float acc[4][4] = {};
      // (its first sync also ends every read of the old state above)
      staged_product(acc, As, vs, c,
                     [&](int k0, int e, int& at) {
                       const int kk = e / kR, r = e % kR;
                       const int p = p0 + r, s = k0 + kk;
                       at = kk * kLDA + r;
                       return (p < P && s < c)
                                  ? k_n[(int64_t)s * P + p] * ds[s]
                                  : 0.f;
                     }, tid, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty + 32 * i;
        if (p >= P) continue;
        float* st = &state[p * kW + 4 * tx];
#pragma unroll
        for (int j = 0; j < 4; ++j) st[j] = decay * st[j] + acc[i][j];
      }
    }
  }
}

size_t recurrent_smem(int P, int c) {
  return sizeof(float) *
         ((size_t)P * kW + (size_t)c * kW + (size_t)kK * kLDA + 2 * (size_t)c);
}

}  // namespace

extern "C" {

// One forward pass on `stream`.  Device pointers, contiguous float32:
// q, k (BH, S, P); v, y (BH, S, Pv); ig, la (BH, S); scratch cum (BH, S)
// and sc (BH, S / c, c, c).  S must be a multiple of c.  Returns the CUDA
// error (0 = none): cudaErrorInvalidValue where the [P, kW] state tile does
// not fit one block's shared memory or BH * S / c exceeds a grid's 65535.
int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                    const void* ig, const void* la, void* y, void* cum,
                    void* sc, int BH, int S, int P, int Pv, int c,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (c <= 0 || S % c || P <= 0 || Pv <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const int nC = S / c;
  // grid y of chunk_recurrent is BH, grid z of chunk_scores is BH * nC
  if (BH > 65535 || (long long)BH * nC > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = recurrent_smem(P, c);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // The shared-memory limit is a per-device attribute of the function: set
  // it to the most a block may have on the first launch on each device.
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    err = cudaFuncSetAttribute(chunk_recurrent,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const int n_chunks = BH * nC;
  chunk_cumsum<<<(n_chunks + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)la, (float*)cum, n_chunks, S, c, nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nT = (c + kST - 1) / kST;
  chunk_scores<<<dim3(nT, nT, n_chunks), kThreads, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)ig,
      (const float*)cum, (float*)sc, S, P, c, nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_recurrent<<<dim3((Pv + kW - 1) / kW, BH), kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)ig,
      (const float*)cum, (const float*)sc, (float*)y, S, P, Pv, c, nC);
  return (int)cudaGetLastError();
}

const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
