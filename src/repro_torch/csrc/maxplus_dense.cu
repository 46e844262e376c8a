// Dense batched max-plus relaxation sweep.
//
// Replaces the TPU kernel `maxplus_sweep` (src/repro/kernels/maxplus/
// kernel.py, the Pallas call over 128x128 int32 tiles of `_sweep_kernel`).
// One launch computes, for every config k of a batch and every node i,
//
//   t'[k, i] = max(base[k, i], max_j A[k, i, j] + t[k, j])
//
// and raises one flag word where t' differs from t, so the host loop
// (`ops.longest_path`) iterates to the fixpoint reading that word.
//
// Layout: one warp per output row i, eight rows per block, grid.y = k.
// The block stages t[k] in shared memory a tile of 1024 columns at a time;
// each lane of a warp walks row i of A with a 32-lane stride (16-byte
// loads when N is a multiple of 4), so a warp's loads of A are contiguous,
// and reduces its maximum with warp shuffles.
//
// What bounds it on an H100: int32 bytes.  A sweep reads A once (K N^2
// words) and t and base (2 K N words) and writes t' (K N words); it does
// one integer add and max per word of A and uses no tensor cores (there is
// no max-plus mode), so the bound is K N^2 * 4 bytes over the card's
// memory bandwidth.
//
// -INF is -2^30, so -INF + -INF is exactly INT32_MIN.  Sums are taken in
// unsigned arithmetic and cast back, which wraps like the reference's int32
// arithmetic without the undefined behaviour of signed overflow in C++.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 1024;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void maxplus_sweep_kernel(const int* __restrict__ A,
                                     const int* __restrict__ t,
                                     const int* __restrict__ base,
                                     int base_stride, int* __restrict__ out,
                                     int N, int* __restrict__ any_changed) {
  __shared__ __align__(16) int ts[kTile];
  const int k = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const int* tk = t + (int64_t)k * N;
  const int* row = A + ((int64_t)k * N + (i < N ? i : 0)) * N;
  const bool vec = (N % 4) == 0 && ((uintptr_t)A % 16) == 0;
  int best = INT32_MIN;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int len = min(kTile, N - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) ts[j] = tk[j0 + j];
    __syncthreads();
    if (i >= N) continue;
    if (vec) {                       // len is a multiple of 4 as well
      const int4* a4 = reinterpret_cast<const int4*>(row + j0);
      const int4* t4 = reinterpret_cast<const int4*>(ts);
      for (int q = lane; q < len / 4; q += 32) {
        const int4 a = __ldg(a4 + q);
        const int4 b = t4[q];
        best = max(best, max(max(wrap_add(a.x, b.x), wrap_add(a.y, b.y)),
                             max(wrap_add(a.z, b.z), wrap_add(a.w, b.w))));
      }
    } else {
      for (int j = lane; j < len; j += 32)
        best = max(best, wrap_add(__ldg(row + j0 + j), ts[j]));
    }
  }
  if (i >= N) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) {
    const int v = max(base[(int64_t)k * base_stride + i], best);
    out[(int64_t)k * N + i] = v;
    if (v != tk[i]) *any_changed = 1;
  }
}

}  // namespace

extern "C" {

// One sweep on `stream`.  Device pointers: A (K, N, N), t and out (K, N),
// base (K, N) with base_stride N or (N,) shared with base_stride 0, and
// any_changed, one int32 flag that this call clears before the sweep.
// out must not alias t.  Returns the CUDA error (0 = none).
int maxplus_dense_sweep(const int* A, const int* t, const int* base,
                        int base_stride, int* out, int N, int K,
                        int* any_changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(any_changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + kWarps - 1) / kWarps), (unsigned)K);
  maxplus_sweep_kernel<<<grid, kWarps * 32, 0, s>>>(A, t, base, base_stride,
                                                    out, N, any_changed);
  return (int)cudaGetLastError();
}

const char* maxplus_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
