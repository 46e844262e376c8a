// Sparse chain-structured batched max-plus fixpoint: one round.
//
// Replaces the TPU kernel `segmented_cummax` (src/repro/kernels/maxplus/
// sparse.py, the Pallas call driven by `_fixpoint`) together with the XLA
// scatter-max of its cross pass.  One call of `maxplus_sparse_round` runs
// one fixpoint round for K depth configs at once:
//
//   chain pass   t = cw + cummax_within_chain(c - cw), in two launches
//                over (segment, config), every chain cut into segments of
//                at most L nodes (the host's segment table):
//                  1. segment maxima  m[s] = max_{i in s} (c[i] - cw[i]);
//                  2. walk            carry = max of m over the earlier
//                     segments of the same chain, then t[i] = cw[i] +
//                     max(carry, c[lo..i] - cw[lo..i]) along the segment
//   cross pass   c[dst] = max(c[dst], t[src] + w)  over the static RAW
//                edges, and over the WAR edges regenerated on the device
//                from the depth block: write `wseq` of FIFO `f` under depth
//                S waits on read `wseq - S - 1` (weight 1), valid iff
//                0 <= tgt < nr                     (one thread per
//                (edge, config), or per (edge, 4 configs))
//
// State is node-major, (n, K) int32 with the configs fastest, so the
// threads of a warp touch consecutive configs of one node: every load and
// store of the chain pass, and of the RAW half of the cross pass, is
// coalesced.  Where K is a multiple of 4 a thread of either pass owns 4
// neighbouring configs and moves them as one 16-byte int4.  Destinations
// are unique (one RAW in-edge per read node, at most one WAR in-edge per
// write node, the two node sets disjoint), so the scatter-max needs no
// atomics.
//
// What bounds it on an H100: int32 bytes.  A round reads c and writes t
// (2 n K words) and touches 3 words per cross edge and config; it does one
// integer max and add per word and uses no tensor cores, so it sits far
// below the card's operations-per-byte ridge.  The first version ran one
// thread per (chain, config), each walking its whole chain: a design with
// 4 chains and K = 1024 gave 4096 threads, about one warp an SM walking
// thousands of dependent nodes, so the round was latency-bound.  Segments
// make the parallelism (segment, config): L ~ sqrt(longest chain / 2)
// keeps both a thread's walk (L nodes) and its carry (the maxima of the
// earlier segments, a small (G, K) array that stays in L2) short, at the
// price of reading c twice.  Each walk loads 8 nodes ahead of the running
// max so the loads of one thread overlap.  That leaves the cross pass the
// larger share of a round where WAR edges are many: a WAR edge's source
// node depends on each config's depth, so its t loads are gathers, one
// row per config; the walk and the cross pass read c evict-first, which
// keeps more of t in L2 for them.
//
// Row bookkeeping, as in the reference's `_fixpoint`:
//   * `diverged[k]`: the chain pass saw a time past the acyclic `bound` (a
//     WAR cycle).  The row is frozen from that round on: the cross pass of
//     the same round already skips it (freeze before cross).  The walk
//     marks a new divergence 2 and pass 1 of the next round turns it into
//     1; the walk skips only rows marked 1, frozen before this round, so
//     every segment of a row that diverges in this round is still walked
//     and t stays independent of the order in which threads run.  A frozen
//     row's c no longer changes, so walking it again would write the same
//     t.
//   * `changed[k]`: the cross pass raised some contribution of row k this
//     round; reset by pass 1 at the start of every round.
//   * `*any_changed`: OR of `changed` over rows, the one word the host reads
//     to stop the loop.
// Times are int32 with -INF = -2^29; the caller refuses graphs whose bound
// reaches 2^28, so no sum below can overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;

// V consecutive int32 words, moved as one int4 when V == 4 (16-byte
// aligned: K % 4 == 0 and the tensors come from the caching allocator).
template <int V>
struct Words {
  int w[V];
  __device__ __forceinline__ void load(const int* p) {
    if constexpr (V == 4) {
      const int4 x = *reinterpret_cast<const int4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) w[v] = p[v];
    }
  }
  // evict-first: for words read once in a round (c in the walk and the
  // cross pass), so that L2 keeps t for the cross pass's gathers
  __device__ __forceinline__ void load_once(const int* p) {
    if constexpr (V == 4) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) w[v] = __ldcs(p + v);
    }
  }
  __device__ __forceinline__ void store(int* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(p) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) p[v] = w[v];
    }
  }
};

// Pass 1: one thread per (segment, V configs).  Writes the segment's max
// of c - cw, which only later segments of the same chain read (so the last
// segment of a chain skips its walk), and resets the round's flags.
template <int V>
__global__ void __launch_bounds__(kThreads)
segment_max_kernel(const int* __restrict__ c, const int* __restrict__ cw,
                   const int* __restrict__ seg_lo,
                   const int* __restrict__ seg_hi,
                   const int* __restrict__ seg_first, int nseg, int K,
                   int* __restrict__ segmax, int* __restrict__ diverged,
                   int* __restrict__ changed, int* __restrict__ any_changed) {
  const int KV = K / V;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)nseg * KV) return;
  const int k = (int)(tid % KV) * V;
  const int s = (int)(tid / KV);
  bool frozen = true;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = diverged[k + v];
    frozen = frozen && d != 0;
    if (s == 0) {
      changed[k + v] = 0;
      if (d) diverged[k + v] = 1;       // frozen before the next walk
    }
  }
  if (s == 0 && k == 0) *any_changed = 0;
  const bool last = s + 1 == nseg || seg_first[s + 1] != seg_first[s];
  if (last || frozen) return;
  const int lo = seg_lo[s], hi = seg_hi[s];
  Words<V> run;
#pragma unroll
  for (int v = 0; v < V; ++v) run.w[v] = INT32_MIN;
  int i = lo;
  for (; i + kAhead <= hi; i += kAhead) {
    Words<V> cv[kAhead];
    int wv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cv[u].load(c + (int64_t)(i + u) * K + k);
      wv[u] = __ldg(cw + i + u);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v)
        run.w[v] = max(run.w[v], cv[u].w[v] - wv[u]);
  }
  for (; i < hi; ++i) {
    Words<V> cv;
    cv.load(c + (int64_t)i * K + k);
    const int w = __ldg(cw + i);
#pragma unroll
    for (int v = 0; v < V; ++v) run.w[v] = max(run.w[v], cv.w[v] - w);
  }
  run.store(segmax + (int64_t)s * K + k);
}

// Pass 2: one thread per (segment, V configs).  Carries the max of the
// earlier segments of its chain in, walks its own segment, writes t and
// marks rows whose times pass the bound.
template <int V>
__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const int* __restrict__ c, int* __restrict__ t,
                    const int* __restrict__ cw,
                    const int* __restrict__ seg_lo,
                    const int* __restrict__ seg_hi,
                    const int* __restrict__ seg_first, int nseg, int K,
                    int bound, const int* __restrict__ segmax,
                    int* __restrict__ diverged) {
  const int KV = K / V;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)nseg * KV) return;
  const int k = (int)(tid % KV) * V;
  const int s = (int)(tid / KV);
  int d0[V];
  bool frozen = true;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    d0[v] = diverged[k + v];
    frozen = frozen && d0[v] == 1;
  }
  if (frozen) return;                   // t of frozen rows is already set
  Words<V> run;
#pragma unroll
  for (int v = 0; v < V; ++v) run.w[v] = INT32_MIN;
  int j = seg_first[s];
  for (; j + 4 <= s; j += 4) {
    Words<V> m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) m[u].load(segmax + (int64_t)(j + u) * K + k);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) run.w[v] = max(run.w[v], m[u].w[v]);
  }
  for (; j < s; ++j) {
    Words<V> m;
    m.load(segmax + (int64_t)j * K + k);
#pragma unroll
    for (int v = 0; v < V; ++v) run.w[v] = max(run.w[v], m.w[v]);
  }
  const int lo = seg_lo[s], hi = seg_hi[s];
  bool over[V];
#pragma unroll
  for (int v = 0; v < V; ++v) over[v] = false;
  int i = lo;
  for (; i + kAhead <= hi; i += kAhead) {
    Words<V> cv[kAhead];
    int wv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cv[u].load_once(c + (int64_t)(i + u) * K + k);
      wv[u] = __ldg(cw + i + u);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      Words<V> tv;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        run.w[v] = max(run.w[v], cv[u].w[v] - wv[u]);
        tv.w[v] = run.w[v] + wv[u];
        over[v] |= tv.w[v] > bound;
      }
      tv.store(t + (int64_t)(i + u) * K + k);
    }
  }
  for (; i < hi; ++i) {
    Words<V> cv, tv;
    cv.load_once(c + (int64_t)i * K + k);
    const int w = __ldg(cw + i);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      run.w[v] = max(run.w[v], cv.w[v] - w);
      tv.w[v] = run.w[v] + w;
      over[v] |= tv.w[v] > bound;
    }
    tv.store(t + (int64_t)i * K + k);
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (over[v] && d0[v] != 1) diverged[k + v] = 2;
}

// Cross pass: one thread per (edge, V configs).  A WAR edge's source
// read depends on each config's depth, so its t loads are gathers; with V
// configs a thread keeps V of those dependent load chains in flight.
template <int V>
__global__ void __launch_bounds__(kThreads)
cross_pass_kernel(int* __restrict__ c, const int* __restrict__ t,
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
  const int KV = K / V;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)(E + m) * KV) return;
  const int k = (int)(tid % KV) * V;
  const int e = (int)(tid / KV);
  Words<V> dv;
  dv.load(diverged + k);
  bool live = false;
#pragma unroll
  for (int v = 0; v < V; ++v) live = live || !dv.w[v];
  if (!live) return;
  int dst;
  Words<V> cand;
  if (e < E) {
    dst = raw_dst[e];
    const int w = raw_w[e];
    cand.load(t + (int64_t)raw_src[e] * K + k);
#pragma unroll
    for (int v = 0; v < V; ++v) cand.w[v] += w;
  } else {
    const int j = e - E;
    dst = war_dst[j];
    const int wseq = war_wseq[j], nr = war_nr[j];
    const int* rcols = war_rcols + war_roff[j];
    Words<V> S;
    S.load(depth_t + (int64_t)war_fid[j] * K + k);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int tgt = wseq - S.w[v] - 1;
      // no WAR edge under depth S: nothing to raise
      cand.w[v] = tgt < 0 || tgt >= nr
                      ? INT32_MIN
                      : t[(int64_t)rcols[tgt] * K + k + v] + 1;
    }
  }
  int* cd = c + (int64_t)dst * K + k;
  Words<V> cv;
  cv.load_once(cd);
  bool raised = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!dv.w[v] && cand.w[v] > cv.w[v]) {
      cv.w[v] = cand.w[v];
      changed[k + v] = 1;
      raised = true;
    }
  }
  if (raised) {
    cv.store(cd);                  // unique destination: no other writer
    *any_changed = 1;
  }
}

unsigned blocks_for(int64_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <int V>
cudaError_t chain_pass(const int* c, int* t, const int* cw,
                       const int* seg_lo, const int* seg_hi,
                       const int* seg_first, int nseg, int K, int bound,
                       int* segmax, int* diverged, int* changed,
                       int* any_changed, cudaStream_t s) {
  const unsigned blocks = blocks_for((int64_t)nseg * (K / V));
  segment_max_kernel<V><<<blocks, kThreads, 0, s>>>(
      c, cw, seg_lo, seg_hi, seg_first, nseg, K, segmax, diverged, changed,
      any_changed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_walk_kernel<V><<<blocks, kThreads, 0, s>>>(
      c, t, cw, seg_lo, seg_hi, seg_first, nseg, K, bound, segmax, diverged);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fixpoint round on `stream`.  All pointers are device pointers:
//   c, t        (n, K) int32, node-major; c is updated in place, t written
//   cw          (n,)   cumulative SEQ weight of each column
//   seg_lo/hi   (nseg,) column range of each chain segment, chain-major;
//   seg_first   (nseg,) index of the first segment of its chain
//   segmax      (nseg, K) scratch: each segment's max of c - cw
//   raw_*       (E,)   static RAW edges
//   war_*       (m,)   WAR tables, war_rcols (R,)
//   depth_t     (F, K) depth block, transposed (FIFO-major)
//   diverged, changed (K,) int32 row flags; any_changed one int32
// Every row flag must be reset to 0 before the first round, and nseg >= 1.
// Returns the CUDA error of the launches (0 = none).
int maxplus_sparse_round(int* c, int* t, const int* cw, const int* seg_lo,
                         const int* seg_hi, const int* seg_first, int nseg,
                         int* segmax, const int* raw_dst, const int* raw_src,
                         const int* raw_w, int E, const int* war_dst,
                         const int* war_wseq, const int* war_fid,
                         const int* war_nr, const int* war_roff,
                         const int* war_rcols, int m, const int* depth_t,
                         int K, int bound, int* diverged, int* changed,
                         int* any_changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nseg < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      K % 4 == 0
          ? chain_pass<4>(c, t, cw, seg_lo, seg_hi, seg_first, nseg, K, bound,
                          segmax, diverged, changed, any_changed, s)
          : chain_pass<1>(c, t, cw, seg_lo, seg_hi, seg_first, nseg, K, bound,
                          segmax, diverged, changed, any_changed, s);
  if (err != cudaSuccess) return (int)err;
  if (E + m == 0) return 0;
  if (K % 4 == 0)
    cross_pass_kernel<4><<<blocks_for((int64_t)(E + m) * (K / 4)), kThreads,
                           0, s>>>(
        c, t, raw_dst, raw_src, raw_w, E, war_dst, war_wseq, war_fid, war_nr,
        war_roff, war_rcols, m, depth_t, K, diverged, changed, any_changed);
  else
    cross_pass_kernel<1><<<blocks_for((int64_t)(E + m) * K), kThreads, 0,
                           s>>>(
        c, t, raw_dst, raw_src, raw_w, E, war_dst, war_wseq, war_fid, war_nr,
        war_roff, war_rcols, m, depth_t, K, diverged, changed, any_changed);
  return (int)cudaGetLastError();
}

const char* maxplus_sparse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
