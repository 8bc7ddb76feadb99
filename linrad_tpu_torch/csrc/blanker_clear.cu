// The stupid blanker for sm_90a: hard-clear every run of samples above the
// threshold, widened by the sqrt(peak/noise)/100 rule (blank1.c:1013-1083),
// in two launches over tiles of the stream, with no scan and no scatter.
//
// Replaces nothing written for the TPU: the JAX package runs this step as
// XLA's ops (linrad_tpu/ops/blanker.py:428-454, lax.cummin and lax.cummax
// over the stream, the run maxima by utils/segments.py's associative
// scan).  The port's plain version, _blanker_clear_reference in
// linrad_tpu_torch/ops/blanker.py, is those operations in PyTorch: about
// 58 launches, among them two scans with indices over one row of 65,536
// (131,072 at EME) that PyTorch runs serially in one thread block (0.16 ms
// each on an H100) and a scatter_reduce that sends every sample under the
// threshold to one slot with an atomic max (0.12-0.24 ms).
//
// What bounds it: the step moves 24 bytes a sample at one channel (the
// stream and its power read and written once), 1.6 MB at the flagship's
// 65,536 samples: 0.00047 ms at the card's memory rate, under one launch.
// What is left is latency: two launches, each a load, a few dozen
// dependent instructions and a store.
//
// The design rests on one bound.  t = sqrt(clamp(runmax / nf, 0, 1e4)) /
// 100 is at most sqrt(1e4) / 100 = 1, exactly, so a widened sample j
// reaches at most k + 0.5 samples before it (k = (pw + 1) / 2) and pw + 1
// + 0.5 after it.  The plain version's suffix minimum of j - before_j and
// prefix maximum of j + after_j over the whole stream are therefore a
// stencil: sample i is cleared where it is flagged, or where some j in
// (i, i + k] has j - before_j <= i, or some j in [i - pw - 1, i) has
// j + after_j >= i.  The halos are those reaches, made from pw and the
// clamp's bound here; the wrapper refuses a pw whose halos pass a tile.
//
// - clear_runs_kernel, a block per tile of kTile samples and stream: the
//   flags (pwr > nf * limit^2, the threshold made from the noise floor on
//   the device, so a CUDA graph replays it with each step's floor), and
//   each flagged sample's maximum over its run's part inside the tile, by
//   a segmented max scan forwards and backwards (warp shuffles, then the
//   warps' totals).  It writes those maxima and a summary of the tile: the
//   maxima of its leading and trailing runs and where they end and start
//   (the whole tile where nothing is under the threshold).  Block 0 of a
//   stream zeroes its count.
// - clear_stencil_kernel, a block per tile and stream: six warps resolve
//   the runs that cross the edges of the tile and of its neighbours from
//   the summaries (each walks 32 tiles at a time while they are flagged
//   throughout, so a run of any length, up to the whole stream, gets its
//   exact maximum); then each sample of the tile and its halos gets its
//   run maximum, widen, before and after, and each sample of the tile
//   reads its halos in shared memory and writes its stream, power and
//   cleared flag; the count is one integer atomic add a block.
// - Exactness.  Every float step is the plain version's, one rounding per
//   PyTorch operation as PyTorch runs it on the card: runmax / max(nf,
//   1e-20) a true division; the clamp; sqrt; "/ 100.0", which PyTorch's
//   CUDA division by a Python scalar computes as a product with the
//   float reciprocal; k * t; + 0.5; pos - before and pos + after.  Each is
//   an explicit _rn intrinsic, so that nvcc's contraction (--fmad is on)
//   cannot fuse k * t + 0.5 and move a decision at the edge of a clear.
//   Maxima are exact in any order.  The outputs equal the plain version's
//   bit for bit: weak', pwr' and the count.
//
// Shared memory: the halo'd window's two reaches (8 bytes a sample), the
// tile's cleared flags, the six run extensions: 7,704 bytes.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 512;                 // samples a block writes
constexpr int kThreads = 512;              // one sample a thread
constexpr int kWarps = kThreads / 32;
constexpr float kClampMax = 1e4f;          // clamp(runmax / nf, 0, 1e4)
// t's largest value, sqrt(kClampMax) / 100, is 1: the reaches' bound
constexpr float kTMax = 1.f;
static_assert(kTMax * 100.f * kTMax * 100.f == kClampMax, "t's bound");
constexpr int kMaxPw = 255;                // the largest pw a tile takes
constexpr int kMaxLeft = kMaxPw + 1;       // (pw + 1) * kTMax
constexpr int kMaxRight = (kMaxPw + 1) / 2;
constexpr int kWindow = kTile + kMaxLeft + kMaxRight;
constexpr unsigned kFull = 0xffffffffu;

// A tile's summary: the maxima of the run its first sample starts (its
// leading run) and of the run its last sample ends (its trailing run),
// -inf where that sample is under the threshold; the offset of its first
// sample under the threshold (the tile's length where none is) and one
// past its last (0 where none is).
struct Summary {
  float lead_max, trail_max;
  int lead_end, trail_start;
};

// A segmented max scan's element: reset where the segment starts anew (a
// sample under the threshold, value -inf) within what the element covers.
struct Seg {
  bool reset;
  float v;
};

// a then b, in the scan's direction
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return b.reset ? b : Seg{a.reset, fmaxf(a.v, b.v)};
}

// The inclusive segmented max scan of one element a thread over the block,
// forwards (sample order) or backwards.  Flagged values are never NaN
// (NaN > thr is false), so fmaxf is torch's maximum on them.
template <bool kBackward>
__device__ Seg block_seg_scan(Seg x, Seg* totals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const float ov = kBackward ? __shfl_down_sync(kFull, x.v, d)
                               : __shfl_up_sync(kFull, x.v, d);
    const int reset = x.reset;
    const bool orr = kBackward ? __shfl_down_sync(kFull, reset, d)
                               : __shfl_up_sync(kFull, reset, d);
    const bool in = kBackward ? lane + d < 32 : lane >= d;
    if (in && !x.reset) x = Seg{orr, fmaxf(x.v, ov)};
  }
  if (lane == (kBackward ? 0 : 31)) totals[warp] = x;
  __syncthreads();
  Seg pre{false, -INFINITY};
  if (kBackward) {
    for (int w = kWarps - 1; w > warp; --w) pre = combine(pre, totals[w]);
  } else {
    for (int w = 0; w < warp; ++w) pre = combine(pre, totals[w]);
  }
  __syncthreads();                        // totals is used again
  return combine(pre, x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int d = 16; d; d >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The maximum of the run that continues from tile u across its edge to the
// left (kRight false: the trailing runs of tiles u - 1, u - 2, ... while
// each is flagged throughout) or to the right (the leading runs of u + 1,
// ...); -inf where the neighbour's edge sample is under the threshold.
// One warp, 32 tiles at a time.
template <bool kRight>
__device__ float run_beyond(const Summary* summ, int u, int tiles) {
  const int lane = threadIdx.x & 31;
  float acc = -INFINITY;
  for (int base = kRight ? u + 1 : u - 1; kRight ? base < tiles : base >= 0;
       base += kRight ? 32 : -32) {
    const int v = kRight ? base + lane : base - lane;
    const bool ok = v >= 0 && v < tiles;
    const Summary s = ok ? summ[v] : Summary{-INFINITY, -INFINITY, 0, 1};
    const bool through = ok && s.trail_start == 0;   // flagged throughout
    const unsigned stops = __ballot_sync(kFull, !through);
    const int first = stops ? __ffs(stops) - 1 : 32;
    const float m = lane <= first ? (kRight ? s.lead_max : s.trail_max)
                                  : -INFINITY;
    acc = fmaxf(acc, warp_max(m));
    if (stops) break;
  }
  return acc;
}

__device__ __forceinline__ float threshold(const float* nf, long long r,
                                           long long nf_stride, float l2) {
  return __fmul_rn(nf[r * nf_stride], l2);
}

__global__ void __launch_bounds__(kThreads)
clear_runs_kernel(const float* __restrict__ pwr, const float* __restrict__ nf,
                  float* __restrict__ local, Summary* __restrict__ summ,
                  int* __restrict__ count, long long pwr_stride,
                  long long nf_stride, float l2, int S) {
  __shared__ Seg totals[kWarps];
  __shared__ int lead_end, trail_start;
  __shared__ float trail_max;
  const long long r = blockIdx.y;
  const int tiles = gridDim.x, u = blockIdx.x, i = threadIdx.x;
  const int t0 = u * kTile, len = min(kTile, S - t0);
  pwr += r * pwr_stride;
  local += r * S;
  const float thr = threshold(nf, r, nf_stride, l2);
  if (i == 0) {
    lead_end = len;
    trail_start = 0;
    if (u == 0) count[r] = 0;
  }
  const bool real = i < len;
  const float p = real ? pwr[t0 + i] : 0.f;
  const bool f = real && p > thr;
  __syncthreads();
  if (real && !f) {
    atomicMin(&lead_end, i);
    atomicMax(&trail_start, i + 1);
  }
  const Seg x{!f, f ? p : -INFINITY};
  const Seg fwd = block_seg_scan<false>(x, totals);
  const Seg bwd = block_seg_scan<true>(x, totals);
  if (real) local[t0 + i] = f ? fmaxf(fwd.v, bwd.v) : -INFINITY;
  if (i == len - 1) trail_max = fwd.v;
  __syncthreads();
  if (i == 0)
    summ[r * tiles + u] = Summary{lead_end > 0 ? bwd.v : -INFINITY,
                                  trail_start < len ? trail_max : -INFINITY,
                                  lead_end, trail_start};
}

__global__ void __launch_bounds__(kThreads)
clear_stencil_kernel(const float2* __restrict__ weak,
                     const float* __restrict__ pwr,
                     const float* __restrict__ nf,
                     const float* __restrict__ local,
                     const Summary* __restrict__ summ, float2* __restrict__ wout,
                     float* __restrict__ pout, int* __restrict__ count,
                     long long weak_stride, long long pwr_stride,
                     long long nf_stride, float l2, int S, int C, int pw) {
  __shared__ float RL[kWindow], RR[kWindow];
  __shared__ float beyond[3][2];           // tiles u - 1, u, u + 1; left, right
  __shared__ bool cleared[kTile];
  const long long r = blockIdx.y;
  const int tiles = gridDim.x, u = blockIdx.x;
  const int t0 = u * kTile, len = min(kTile, S - t0);
  const int warp = threadIdx.x >> 5;
  weak += r * weak_stride;
  pwr += r * pwr_stride;
  local += r * S;
  summ += r * tiles;
  const float nfv = nf[r * nf_stride];
  const float thr = threshold(nf, r, nf_stride, l2);
  const float four_nf = __fmul_rn(4.f, nfv);
  const float denom = isnan(nfv) ? nfv : fmaxf(nfv, 1e-20f);
  // the reaches, from pw and t's bound
  const int kb = (pw + 1) / 2, ka = pw + 1;
  const int left = static_cast<int>(ka * kTMax), right =
      static_cast<int>(kb * kTMax);
  const int w0 = max(0, t0 - left), w1 = min(S, t0 + len + right);
  if (warp < 6) {
    const int v = u - 1 + (warp >> 1);
    if (v >= 0 && v < tiles) {
      const float m = warp & 1 ? run_beyond<true>(summ, v, tiles)
                               : run_beyond<false>(summ, v, tiles);
      if ((threadIdx.x & 31) == 0) beyond[warp >> 1][warp & 1] = m;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w1 - w0; j += kThreads) {
    const int g = w0 + j;
    const float p = pwr[g];
    float rl = INFINITY, rr = -INFINITY;
    if (p > thr) {
      const int v = g / kTile, off = g - v * kTile;
      const Summary s = summ[v];
      float rm = local[g];
      if (off < s.lead_end) rm = fmaxf(rm, beyond[v - u + 1][0]);
      if (off >= s.trail_start) rm = fmaxf(rm, beyond[v - u + 1][1]);
      if (rm > four_nf) {                  // widen
        const float q = fminf(fmaxf(__fdiv_rn(rm, denom), 0.f), kClampMax);
        const float t = __fmul_rn(__fsqrt_rn(q), 1.f / 100.f);
        const float before = __fadd_rn(__fmul_rn(static_cast<float>(kb), t),
                                       0.5f);
        const float after = __fadd_rn(__fmul_rn(static_cast<float>(ka), t),
                                      0.5f);
        const float pos = static_cast<float>(g);
        rl = __fsub_rn(pos, before);
        rr = __fadd_rn(pos, after);
      }
    }
    RL[j] = rl;
    RR[j] = rr;
  }
  __syncthreads();
  const int i = threadIdx.x;
  bool c = false;
  float p = 0.f;
  if (i < len) {
    const int g = t0 + i, j = g - w0;
    const float pos = static_cast<float>(g);
    p = pwr[g];
    c = p > thr;
    for (int k = 1; !c && k <= right && j + k < w1 - w0; ++k)
      c = RL[j + k] <= pos;
    for (int k = 1; !c && k <= left && j - k >= 0; ++k) c = RR[j - k] >= pos;
    cleared[i] = c;
    pout[r * S + g] = c ? 0.f : p;
  }
  const int n = __syncthreads_count(c);
  if (threadIdx.x == 0 && n) atomicAdd(count + r, n);
  float2* wo = wout + r * S * static_cast<long long>(C) +
               static_cast<long long>(t0) * C;
  const float2* wi = weak + static_cast<long long>(t0) * C;
  for (int e = threadIdx.x; e < len * C; e += kThreads)
    wo[e] = cleared[e / C] ? make_float2(0.f, 0.f) : wi[e];
}

}  // namespace

extern "C" int lrt_blanker_clear_tile() { return kTile; }

extern "C" int lrt_blanker_clear_max_pw() { return kMaxPw; }

// weak (R, S, C) complex64 and pwr (R, S), each stream dense, streams
// weak_stride / pwr_stride elements apart; nf: a noise floor per stream,
// nf_stride apart (0: one for all); l2: limit^2 in float32.  wout (R, S, C),
// pout (R, S), count (R,): the outputs; local (R, S) floats and summ (R,
// tiles) x 4 words: scratch.
extern "C" int lrt_blanker_clear(const void* weak, const void* pwr,
                                 const void* nf, void* wout, void* pout,
                                 void* count, void* local, void* summ,
                                 long long weak_stride, long long pwr_stride,
                                 long long nf_stride, float l2, int S, int C,
                                 int pw, int streams, void* stream) {
  if (pw < 0 || pw > kMaxPw || S < 1 || C < 1) return
      static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kTile - 1) / kTile, streams);
  clear_runs_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(pwr), static_cast<const float*>(nf),
      static_cast<float*>(local), static_cast<Summary*>(summ),
      static_cast<int*>(count), pwr_stride, nf_stride, l2, S);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  clear_stencil_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float2*>(weak), static_cast<const float*>(pwr),
      static_cast<const float*>(nf), static_cast<const float*>(local),
      static_cast<const Summary*>(summ), static_cast<float2*>(wout),
      static_cast<float*>(pout), static_cast<int*>(count), weak_stride,
      pwr_stride, nf_stride, l2, S, C, pw);
  return static_cast<int>(cudaGetLastError());
}
