// The radar front's per-frame pulse statistics for sm_90a: each frame's peak
// bin, the bounded two-neighbour skirt walks on both sides of it
// (radar.c:206-216), the mean power outside the skirt and the S/N, one
// block a frame, all frames in one launch.
//
// Replaces the JAX package's fori_loop in frame_pulse_stats
// (linrad_tpu/weak/radar.py:84), which the port ran as PyTorch operations:
// argmax, a gather, walk_steps iterations a side of about 15 operations
// each (three gathers, clamps, compares, a where) and a masked sum, some
// 970 launches a step at 32 steps, every one over the whole (F,) index
// vector.  The plain version, _frame_pulse_stats_reference in
// linrad_tpu_torch/weak/radar.py, is that loop unchanged.
//
// What bounds it: the frames are read once, 4 bytes a bin (64 x 2,048 at
// the radar preset: 512 KiB, 0.16 us at the card's memory rate), and three
// numbers a frame are written.  What is left is latency: one launch, a
// load, two block reductions and a few dependent loads of the walk.
//
// The walk in closed form.  An iteration whose step fails leaves the
// index where it is, so every later iteration tests the same bin again and
// fails again: the bounded walk is the count of steps that pass in a row
// from the peak, capped at walk_steps.  One warp tests 32 positions at
// once: lane j tests bin k - d - j (the left walk; k + d + j the right)
// d steps on, each test the loop's own strict float compares, and
// __ballot_sync collects them; the trailing ones of the ballot are the
// steps that pass in a row.  While all 32 pass and walk_steps remains, the
// warp tests the next 32.  Warps 0 and 1 walk left and right at the same
// time.  The indices equal the loop's bit for bit.
//
// - Peak: the first bin of the row's maximum, as torch.argmax takes it: a
//   NaN above every number, ties to the lowest bin.  Each thread's best
//   (value, bin) under that order, then the warps' by shuffles, then the
//   block's.
// - Floor: the sum of the row outside [ia, ib), each bin tested and added,
//   never the total less the inside (the peak can be 1e4 times the noise),
//   in float32, each thread's bins then the warps' then the block's in a
//   fixed order, so that two runs give the same bits; over max(n - (ib -
//   ia), 1) bins; S/N the peak over max(floor, 1e-30).  The order of the
//   sum is not PyTorch's: the floor and the S/N agree with the plain
//   version to float32 rounding of a sum, not bit for bit.
// - Geometry: a block of 256 threads a frame.  The row is read in 16-byte
//   loads from its first 16-byte boundary (rows n bins apart, n any, are
//   aligned differently; the bins before it and after the last whole
//   float4 are read one a thread), 2 float4s a thread at 2,048 bins; the
//   walks and the floor's pass read it again from L1.  64 frames make 64
//   blocks, one wave on the card's 132 SMs; more frames (R streams of F
//   under vmap) make more blocks.  No shared memory beyond the reductions'
//   3 words a warp, so any n works.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (a, ia) before (b, ib) in torch.argmax's order
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// f(bin, value) for each of this thread's bins of the row
template <class F>
__device__ __forceinline__ void for_each_bin(const float* __restrict__ row,
                                             int n, F&& f) {
  const int t = threadIdx.x;
  const auto addr = reinterpret_cast<std::uintptr_t>(row);
  const int head = min(static_cast<int>(((16u - (addr & 15u)) & 15u) >> 2),
                       n);
  const int vecs = (n - head) >> 2;
  if (t < head) f(t, __ldg(row + t));
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (int q = t; q < vecs; q += kThreads) {
    const float4 v = __ldg(body + q);
    const int i = head + 4 * q;
    f(i, v.x);
    f(i + 1, v.y);
    f(i + 2, v.z);
    f(i + 3, v.w);
  }
  const int tail = head + 4 * vecs + t;
  if (tail < n) f(tail, __ldg(row + tail));
}

// Steps of one walk from k (kDir -1 left, +1 right), at most walk_steps:
// one warp, 32 positions a ballot.
template <int kDir>
__device__ int walk(const float* __restrict__ row, int n, int k,
                    int walk_steps) {
  const int lane = threadIdx.x & 31;
  int steps = 0;
  while (steps < walk_steps) {
    const int m = k + kDir * (steps + lane);
    const int m2 = m + 2 * kDir;
    bool pass = false;
    if (m2 >= 0 && m2 <= n - 1) {
      const float cur = __ldg(row + m);
      pass = cur > __ldg(row + m + kDir) && cur > __ldg(row + m2);
    }
    const unsigned ok = __ballot_sync(kFull, pass);
    const int run = ok == kFull ? 32 : __ffs(~ok) - 1;
    steps += run;
    if (run < 32) break;
  }
  return min(steps, walk_steps);
}

__global__ void __launch_bounds__(kThreads)
radar_stats_kernel(const float* __restrict__ power,
                   long long* __restrict__ k_out, float* __restrict__ ston_out,
                   float* __restrict__ floor_out, long long row_stride, int n,
                   int walk_steps) {
  __shared__ float best_v[kWarps], sums[kWarps];
  __shared__ int best_i[kWarps];
  __shared__ int s_k, s_ia, s_ib;
  __shared__ float s_peak;
  const long long r = blockIdx.x;
  const float* row = power + r * row_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float v = -INFINITY;
  int i = INT_MAX;                         // loses to every bin
  for_each_bin(row, n, [&](int b, float x) {
    if (better(x, b, v, i)) {
      v = x;
      i = b;
    }
  });
  for (int d = 16; d; d >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, d);
    const int oi = __shfl_xor_sync(kFull, i, d);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    best_v[warp] = v;
    best_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? best_v[lane] : -INFINITY;
    i = lane < kWarps ? best_i[lane] : INT_MAX;
    for (int d = 16; d; d >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, d);
      const int oi = __shfl_xor_sync(kFull, i, d);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      s_k = i;
      s_peak = v;
    }
  }
  __syncthreads();
  const int k = s_k;
  if (warp == 0) {
    const int steps = walk<-1>(row, n, k, walk_steps);
    if (lane == 0) s_ia = k - steps;
  } else if (warp == 1) {
    const int steps = walk<+1>(row, n, k, walk_steps);
    if (lane == 0) s_ib = k + steps + 1;  // radar.c:216 "ib++"
  }
  __syncthreads();
  const int ia = s_ia, ib = s_ib;
  float s = 0.f;
  for_each_bin(row, n, [&](int b, float x) {
    if (b < ia || b >= ib) s += x;
  });
  for (int d = 16; d; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  if (lane == 0) sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f;
    for (int w = 0; w < kWarps; ++w) t1 += sums[w];
    const int cnt = max(n - (ib - ia), 1);
    const float nf = __fdiv_rn(t1, static_cast<float>(cnt));
    // clamp(min=1e-30): a NaN floor stays NaN
    const float den = nf < 1e-30f ? 1e-30f : nf;
    k_out[r] = k;
    floor_out[r] = nf;
    ston_out[r] = __fdiv_rn(s_peak, den);
  }
}

}  // namespace

// power: rows (frames) of n float32 bins, each row dense, rows row_stride
// elements apart; 0 <= walk_steps <= n (a walk never takes more than n - 3
// steps).  k_out (rows,) int64, ston_out and floor_out (rows,) float32.
extern "C" int lrt_radar_stats(const void* power, void* k_out, void* ston_out,
                               void* floor_out, long long row_stride,
                               int rows, int n, int walk_steps,
                               void* stream) {
  if (rows < 1 || n < 1 || walk_steps < 0 || walk_steps > n)
    return static_cast<int>(cudaErrorInvalidValue);
  radar_stats_kernel<<<rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(power), static_cast<long long*>(k_out),
      static_cast<float*>(ston_out), static_cast<float*>(floor_out),
      row_stride, n, walk_steps);
  return static_cast<int>(cudaGetLastError());
}
