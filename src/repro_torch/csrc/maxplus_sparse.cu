// Sparse chain-structured batched max-plus fixpoint: one round.
//
// Replaces the TPU kernel `segmented_cummax` (src/repro/kernels/maxplus/
// sparse.py, the Pallas call driven by `_fixpoint`) together with the XLA
// scatter-max of its cross pass.  One call of `maxplus_sparse_round` runs
// one fixpoint round for K depth configs at once:
//
//   chain pass   t = cw + cummax_within_chain(c - cw)     (one thread per
//                (chain, config) walks its chain in order)
//   cross pass   c[dst] = max(c[dst], t[src] + w)  over the static RAW
//                edges, and over the WAR edges regenerated on the device
//                from the depth block: write `wseq` of FIFO `f` under depth
//                S waits on read `wseq - S - 1` (weight 1), valid iff
//                0 <= tgt < nr                     (one thread per
//                (edge, config))
//
// State is node-major, (n, K) int32 with the configs fastest, so the
// threads of a warp touch consecutive configs of one node: every load and
// store of the chain pass, and of the RAW half of the cross pass, is
// coalesced.  Destinations are unique (one RAW in-edge per read node, at
// most one WAR in-edge per write node, the two node sets disjoint), so the
// scatter-max needs no atomics.
//
// What bounds it on an H100: int32 bytes.  A round reads c and writes t
// (2 n K words) and touches 3 words per cross edge and config; it does one
// integer max and add per word and uses no tensor cores, so it sits far
// below the card's operations-per-byte ridge.  The design keeps every
// access coalesced and fuses the whole chain pass into one sequential walk
// per thread (the TPU's log-step doubling scan re-reads the row log2(n)
// times); the walk loads 8 nodes ahead of the running max so the loads of
// one thread overlap.
//
// Row bookkeeping, as in the reference's `_fixpoint`:
//   * `diverged[k]`: the chain pass saw a time past the acyclic `bound` (a
//     WAR cycle).  The row is frozen from that round on: the cross pass of
//     the same round already skips it (freeze before cross).
//   * `changed[k]`: the cross pass raised some contribution of row k this
//     round; reset by the chain pass at the start of every round.
//   * `*any_changed`: OR of `changed` over rows, the one word the host reads
//     to stop the loop.
// Times are int32 with -INF = -2^29; the caller refuses graphs whose bound
// reaches 2^28, so no sum below can overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;

__global__ void chain_pass_kernel(const int* __restrict__ c,
                                  int* __restrict__ t,
                                  const int* __restrict__ cw,
                                  const int* __restrict__ chain_lo,
                                  const int* __restrict__ chain_hi,
                                  int nchains, int K, int bound,
                                  int* __restrict__ diverged,
                                  int* __restrict__ changed,
                                  int* __restrict__ any_changed) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)nchains * K) return;
  const int k = (int)(tid % K);
  const int ch = (int)(tid / K);
  if (ch == 0) {
    changed[k] = 0;
    if (k == 0) *any_changed = 0;
  }
  if (diverged[k]) return;                 // frozen row: times are moot
  const int lo = chain_lo[ch];
  const int hi = chain_hi[ch];
  int run = INT32_MIN;                     // running max of c - cw
  bool over = false;
  int i = lo;
  for (; i + kAhead <= hi; i += kAhead) {
    int cv[kAhead], wv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cv[u] = c[(int64_t)(i + u) * K + k];
      wv[u] = __ldg(cw + i + u);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      run = max(run, cv[u] - wv[u]);
      const int ti = run + wv[u];
      t[(int64_t)(i + u) * K + k] = ti;
      over |= ti > bound;
    }
  }
  for (; i < hi; ++i) {
    const int w = __ldg(cw + i);
    run = max(run, c[(int64_t)i * K + k] - w);
    const int ti = run + w;
    t[(int64_t)i * K + k] = ti;
    over |= ti > bound;
  }
  if (over) diverged[k] = 1;
}

__global__ void cross_pass_kernel(int* __restrict__ c,
                                  const int* __restrict__ t,
                                  const int* __restrict__ raw_dst,
                                  const int* __restrict__ raw_src,
                                  const int* __restrict__ raw_w, int E,
                                  const int* __restrict__ war_dst,
                                  const int* __restrict__ war_wseq,
                                  const int* __restrict__ war_fid,
                                  const int* __restrict__ war_nr,
                                  const int* __restrict__ war_roff,
                                  const int* __restrict__ war_rcols, int m,
                                  const int* __restrict__ depth_t, int K,
                                  const int* __restrict__ diverged,
                                  int* __restrict__ changed,
                                  int* __restrict__ any_changed) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)(E + m) * K) return;
  const int k = (int)(tid % K);
  const int e = (int)(tid / K);
  if (diverged[k]) return;
  int dst, cand;
  if (e < E) {
    dst = raw_dst[e];
    cand = t[(int64_t)raw_src[e] * K + k] + raw_w[e];
  } else {
    const int j = e - E;
    const int S = depth_t[(int64_t)war_fid[j] * K + k];
    const int tgt = war_wseq[j] - S - 1;
    if (tgt < 0 || tgt >= war_nr[j]) return;   // no WAR edge under depth S
    dst = war_dst[j];
    cand = t[(int64_t)war_rcols[war_roff[j] + tgt] * K + k] + 1;
  }
  const int64_t di = (int64_t)dst * K + k;
  if (cand > c[di]) {
    c[di] = cand;
    changed[k] = 1;
    *any_changed = 1;
  }
}

unsigned blocks_for(int64_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// One fixpoint round on `stream`.  All pointers are device pointers:
//   c, t        (n, K) int32, node-major; c is updated in place, t written
//   cw          (n,)   cumulative SEQ weight of each column
//   chain_lo/hi (nchains,) column range of each chain
//   raw_*       (E,)   static RAW edges
//   war_*       (m,)   WAR tables, war_rcols (R,)
//   depth_t     (F, K) depth block, transposed (FIFO-major)
//   diverged, changed (K,) int32 row flags; any_changed one int32
// Returns the CUDA error of the launches (0 = none).
int maxplus_sparse_round(int* c, int* t, const int* cw, const int* chain_lo,
                         const int* chain_hi, int nchains,
                         const int* raw_dst, const int* raw_src,
                         const int* raw_w, int E, const int* war_dst,
                         const int* war_wseq, const int* war_fid,
                         const int* war_nr, const int* war_roff,
                         const int* war_rcols, int m, const int* depth_t,
                         int K, int bound, int* diverged, int* changed,
                         int* any_changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t chain_work = (int64_t)nchains * K;
  if (chain_work > 0) {
    chain_pass_kernel<<<blocks_for(chain_work), kThreads, 0, s>>>(
        c, t, cw, chain_lo, chain_hi, nchains, K, bound, diverged, changed,
        any_changed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t cross_work = (int64_t)(E + m) * K;
  if (cross_work > 0) {
    cross_pass_kernel<<<blocks_for(cross_work), kThreads, 0, s>>>(
        c, t, raw_dst, raw_src, raw_w, E, war_dst, war_wseq, war_fid, war_nr,
        war_roff, war_rcols, m, depth_t, K, diverged, changed, any_changed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* maxplus_sparse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
