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
// max, denominator and accumulator in f32 for bf16 and f32 inputs, and the
// output in the input dtype.
//
// Design.  The TPU grid walks the k-blocks of one q-block in order and
// carries the softmax state in VMEM scratch between grid steps; CUDA blocks
// run in no order, so here one block (4 warps) owns one (bh, 64-row q tile)
// and loops over the k tiles itself, carrying the state in registers.  It
// visits only the k tiles that the causal and window bounds keep (the
// reference executes the fully masked blocks too), and takes S at run time,
// masking the ragged edge.  Per k tile: the K and V tiles (64 rows) are
// staged in shared memory as f32; each warp owns 16 query rows, each lane 4
// rows by 8 key columns of the scores (columns strided by 8 so that the
// lanes of a warp hit different banks) and 4 rows by hd/8 output columns;
// the row max and sum are reduced over the 8 lanes that share a row with
// warp shuffles; P goes through shared memory (per warp) into P.V.  Rows are
// padded by one word in shared memory against bank conflicts.
//
// What bounds it on an H100: operations.  The work is 4 hd FLOPs per kept
// (q, k) pair (q.k and p.v), about S^2/2 pairs per head for causal
// attention, against q, k, v and o each read or written once: at
// smollm-135m's shape (hd 64, S 4096, bf16) some 1 500 FLOPs per byte, far
// past the card's ridge of ~295, so the tensor cores' 989 TFLOP/s (bf16)
// bound it.  This first kernel does its arithmetic in f32 FMA (67 TFLOP/s
// peak), not on the tensor cores (mma.sync / wgmma), and reads its operands
// from shared memory one word at a time, so it runs well above that bound:
// it is the simple, exact baseline that a tensor-core kernel must beat.
// What the design does about the bound: it skips every k tile that the
// causal and window masks drop, so it does about half the work of the
// unmasked product, and it keeps S x S scores out of device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;   // query rows per block
constexpr int kBK = 64;            // key rows per tile
constexpr int kR = 4;              // query rows per lane
constexpr int kCG = 8;             // lanes sharing a row
constexpr int kSC = kBK / kCG;     // score columns per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (HD + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S,
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
  // longest causal rows first: the last q tiles visit the most k tiles
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const T* qg = q + (int64_t)bh * S * HD;
  const int64_t kv_off = (int64_t)(bh / group_size) * S * HD;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / kCG, cg = lane % kCG;
  const int row0 = warp * 16 + rg * kR;     // first of this lane's rows

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * LD + d] =
        qi < S ? to_f32(qg[(int64_t)qi * HD + d]) * scale : 0.f;
  }

  // k tiles the bounds keep for rows [q0, q0 + kBQ)
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_hi = causal ? q_last + 1 : S;                   // exclusive
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;  // inclusive
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

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
      Ks[r * LD + d] = in ? to_f32(kg[(int64_t)ki * HD + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vg[(int64_t)ki * HD + d]) : 0.f;
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

  T* og = o + (int64_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c)
      og[(int64_t)qi * HD + cg + kCG * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int group_size, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  // The shared-memory limit is a per-device attribute of the function: set
  // it on the first launch of this instance on each device, not on every.
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)BH);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, group_size, causal,
      window, softcap, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int hd, int group_size, int causal, int window,
                float softcap, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, BH, S, group_size, causal, window,
                           softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, BH, S, group_size, causal, window,
                           softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, S, group_size, causal, window,
                            softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, BH, S, group_size, causal, window,
                            softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One forward pass on `stream`.  Device pointers: q and o (BH, S, hd),
// k and v (BH / group_size, S, hd), all contiguous and of one dtype:
// dtype 0 = float32, 1 = bfloat16.  hd is 32, 64, 128 or 256.  window 0
// means no sliding window; softcap 0 means none.  Returns the CUDA error
// (0 = none).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int hd, int group_size, int causal,
                        int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, BH, S, hd, group_size, causal,
                              window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, S, hd, group_size,
                                      causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
