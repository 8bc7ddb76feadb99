// Fused first FFT for Hopper (sm_90a): window -> FFT -> calibration
// multiply -> per-bin power sum over frames.
//
// Replaces linrad_tpu/ops/pallas_fft.py:_fft1_kernel (the TPU kernel,
// launched by _fused_fft1_2d and entered through fused_fft1).  It computes
// what that kernel computes, not how: the TPU kernel took the DFT as four
// O(N^2) real matmuls because that suited the matrix unit.  Here each
// (frame, channel) is one thread block running a radix-2 Stockham FFT in
// shared memory.
//
// What bounds it on an H100: memory traffic.  At N = 2048 an FFT does about
// 5 N log2 N = 113 kflop per 16 KB frame, about 2 flop per byte moved,
// far below the card's fp32 balance point (about 20 flop per byte).  The
// design therefore touches device memory once per frame in each
// direction: the window multiply is fused into the load, the filtercorr
// multiply into the store, and the windowed frame and the uncalibrated
// spectrum never leave shared memory.
//
// The power sum is deterministic: each block writes its frame's |Y|^2 row
// to scratch, and a second kernel sums the rows over frames in a fixed
// order with compensated (Kahan) addition.  Atomics would change the
// sum's rounding from run to run, and the sum feeds the selective
// limiter's thresholds, whose per-bin classification must be exact.
//
// Domain: N a power of two, 128 <= N <= 4096 (every size derive_geometry
// produces), any number of frames B and channels C.  That is narrower than
// the Pallas kernel, which also took non-power-of-two multiples of 128;
// no geometry produces those.  Twiddles come from a table the host builds
// in float64 and stores as float32 (no __sinf, no fast math).
//
// Plain C interface for ctypes; launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFftThreads = 256;
constexpr int kSumCols = 32;   // output columns (bin, channel) per block
constexpr int kSumRows = 32;   // frame lanes per block; fixed assignment

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// One block per (frame, channel).  Layouts are those of the wrapper:
// frames/spec/pow_rows (B, N, C), window (N,), filtercorr (N, C),
// twiddle (N/2,) with twiddle[m] = exp(-2 pi i m / N).
__global__ void __launch_bounds__(kFftThreads)
fft1_frames_kernel(const float2* __restrict__ frames,
                   const float* __restrict__ window,
                   const float2* __restrict__ filtercorr,
                   const float2* __restrict__ twiddle,
                   float2* __restrict__ spec,
                   float* __restrict__ pow_rows,
                   int n, int log2n, int c) {
  extern __shared__ float2 smem[];
  float2* src = smem;
  float2* dst = smem + n;
  const int frame = blockIdx.x / c;
  const int ch = blockIdx.x - frame * c;
  const size_t base = (size_t)frame * n * c + ch;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 x = frames[base + (size_t)i * c];
    const float w = window[i];
    src[i] = make_float2(x.x * w, x.y * w);
  }
  __syncthreads();

  // Stockham autosort, radix 2: stage s combines sub-transforms of
  // length ns = 2^s; the output is in natural order after log2n stages.
  const int half = n >> 1;
  for (int s = 0; s < log2n; ++s) {
    const int ns = 1 << s;
    const int tw_shift = log2n - 1 - s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int k = j & (ns - 1);
      const float2 a = src[j];
      const float2 b = cmul(src[j + half], twiddle[k << tw_shift]);
      const int out = ((j - k) << 1) + k;
      dst[out] = make_float2(a.x + b.x, a.y + b.y);
      dst[out + ns] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t o = base + (size_t)i * c;
    const float2 z = cmul(src[i], filtercorr[(size_t)i * c + ch]);
    spec[o] = z;
    pow_rows[o] = z.x * z.x + z.y * z.y;
  }
}

// pow_sum[t] = sum over frames f of pow_rows[f, t], t = bin * C + channel.
// Lane y of a block sums frames y, y + kSumRows, ... in order; lane 0 then
// adds the kSumRows partials in order.  Same inputs, same bits.
__global__ void __launch_bounds__(kSumCols * kSumRows)
power_sum_kernel(const float* __restrict__ pow_rows,
                 float* __restrict__ pow_sum, int b, int nc) {
  __shared__ float part[kSumRows][kSumCols + 1];
  const int t = blockIdx.x * kSumCols + threadIdx.x;
  float sum = 0.0f;
  float comp = 0.0f;
  if (t < nc) {
    for (int f = threadIdx.y; f < b; f += kSumRows) {
      kahan_add(sum, comp, pow_rows[(size_t)f * nc + t]);
    }
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && t < nc) {
    float total = 0.0f;
    float tcomp = 0.0f;
    for (int y = 0; y < kSumRows; ++y) kahan_add(total, tcomp, part[y][threadIdx.x]);
    pow_sum[t] = total;
  }
}

}  // namespace

extern "C" int lrt_fused_fft1(const void* frames, const void* window,
                              const void* filtercorr, const void* twiddle,
                              void* spec, void* pow_rows, void* pow_sum,
                              int b, int n, int c, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t smem = 2 * (size_t)n * sizeof(float2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fft1_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (n / 2 < kFftThreads) ? n / 2 : kFftThreads;
  fft1_frames_kernel<<<b * c, threads, smem, st>>>(
      static_cast<const float2*>(frames), static_cast<const float*>(window),
      static_cast<const float2*>(filtercorr),
      static_cast<const float2*>(twiddle), static_cast<float2*>(spec),
      static_cast<float*>(pow_rows), n, log2n, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nc = n * c;
  const dim3 sum_block(kSumCols, kSumRows);
  power_sum_kernel<<<(nc + kSumCols - 1) / kSumCols, sum_block, 0, st>>>(
      static_cast<const float*>(pow_rows), static_cast<float*>(pow_sum), b,
      nc);
  return (int)cudaGetLastError();
}
