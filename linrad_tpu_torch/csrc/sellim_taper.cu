// Sellim's edge taper, all of its passes in one launch, for sm_90a.
//
// Replaces the jax.lax.fori_loop of linrad_tpu/ops/sellim.py:150
// (taper_body, :137-148, inside update_liminfo), which XLA runs as one
// loop on the device; the port's plain version is
// _sellim_taper_reference in linrad_tpu_torch/ops/sellim.py.  Each pass
// gives every weak bin (lim == 0) beside a strong one with budget left the
// strong one's gain to the power 0.9 and one bin less of budget; the
// shifts are edge-replicated, as JAX's concatenate makes them.
//
// What bounds it: up to 64 passes, each reading what the pass before
// wrote, over n = fft1_size bins (512 to 16,384): a chain of dependent
// steps of a few operations a bin, whose time is the latency of a
// block-wide barrier per pass, not bytes (8 n in, 4 n out) or operations.
//
// The design: one block per stream (one per stream under torch.func.vmap)
// holds lim and budget in shared memory (128 KB at 16,384 bins, above the
// 48 KB default and so set with cudaFuncSetAttribute) and runs every pass
// there: each thread reads its bins' neighbours into registers, the block
// waits, each thread writes the bins that changed, and a block-wide vote
// ends the loop after a pass that changed no bin, since every later pass
// would change none either.  Past 16,384 bins the two arrays no longer fit
// beside each other, and the same passes run on two copies in global
// memory (L2), one read and one written per pass.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPerThread = 16;                  // bins a thread keeps
constexpr int kSharedMaxN = kMaxThreads * kPerThread;

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// One pass at bin i over (L, B): the new lim and budget of bin i and
// whether it changed.
__device__ __forceinline__ bool taper_bin(const float* L, const float* B,
                                          int i, int n, float& nl,
                                          float& nb) {
  const int il = i > 0 ? i - 1 : 0;
  const int ir = i < n - 1 ? i + 1 : n - 1;
  const float bl = B[il], br = B[ir];
  const float cand = max_nan(bl >= 1.f ? L[il] : 0.f,
                             br >= 1.f ? L[ir] : 0.f);
  const bool is_new = L[i] == 0.f && cand > 0.f;
  nl = is_new ? powf(cand, 0.9f) : L[i];
  nb = is_new ? max_nan(bl - 1.f, br - 1.f) : B[i];
  return is_new;
}

__global__ void __launch_bounds__(kMaxThreads)
taper_shared(const float* __restrict__ lim, const float* __restrict__ budget,
             float* __restrict__ out, long long lim_stride,
             long long budget_stride, int n, int steps) {
  extern __shared__ float smem[];
  float* L = smem;
  float* B = smem + n;
  const int r = blockIdx.x;
  lim += r * lim_stride;
  budget += r * budget_stride;
  out += static_cast<long long>(r) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    L[i] = lim[i];
    B[i] = budget[i];
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    float nl[kPerThread], nb[kPerThread];
    unsigned changed = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n && taper_bin(L, B, i, n, nl[k], nb[k])) changed |= 1u << k;
    }
    __syncthreads();                    // every read of the pass is done
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (changed & (1u << k)) {
        const int i = threadIdx.x + k * blockDim.x;
        L[i] = nl[k];
        B[i] = nb[k];
      }
    }
    // the writes are visible after the vote; a pass that changed nothing
    // leaves every later pass nothing to change
    if (!__syncthreads_or(changed != 0)) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = L[i];
}

// Past kSharedMaxN bins: scratch holds 4 n floats per stream, (L, B) read
// and (L, B) written, swapped after each pass.
__global__ void __launch_bounds__(kMaxThreads)
taper_global(const float* __restrict__ lim, const float* __restrict__ budget,
             float* __restrict__ out, float* scratch, long long lim_stride,
             long long budget_stride, int n, int steps) {
  const int r = blockIdx.x;
  lim += r * lim_stride;
  budget += r * budget_stride;
  out += static_cast<long long>(r) * n;
  float* L = scratch + 4LL * r * n;
  float* B = L + n;
  float* L2 = B + n;
  float* B2 = L2 + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    L[i] = lim[i];
    B[i] = budget[i];
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    bool changed = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float nl, nb;
      changed |= taper_bin(L, B, i, n, nl, nb);
      L2[i] = nl;
      B2[i] = nb;
    }
    const bool any = __syncthreads_or(changed);
    float* t = L; L = L2; L2 = t;
    t = B; B = B2; B2 = t;
    if (!any) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = L[i];
}

int shared_bytes_set[64];               // per device: the attribute set

}  // namespace

// steps: TAPER_STEPS, always.  It is an argument and not a constant
// because the loop with its trip count fixed at compile time ran about a
// tenth slower at 8,192-16,384 bins on an H100.
extern "C" int lrt_sellim_taper(const void* lim, const void* budget,
                                void* out, void* scratch,
                                long long lim_stride,
                                long long budget_stride, int n, int steps,
                                int streams, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32;
  if (n > kSharedMaxN) {
    taper_global<<<streams, threads, 0, st>>>(
        static_cast<const float*>(lim), static_cast<const float*>(budget),
        static_cast<float*>(out), static_cast<float*>(scratch), lim_stride,
        budget_stride, n, steps);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(2 * sizeof(float) * n);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (shared_bytes_set[dev] < smem) {
      e = cudaFuncSetAttribute(taper_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      shared_bytes_set[dev] = smem;
    }
  }
  taper_shared<<<streams, threads, smem, st>>>(
      static_cast<const float*>(lim), static_cast<const float*>(budget),
      static_cast<float*>(out), lim_stride, budget_stride, n, steps);
  return static_cast<int>(cudaGetLastError());
}
