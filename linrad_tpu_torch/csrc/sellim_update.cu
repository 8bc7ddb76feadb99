// Sellim's liminfo update for sm_90a (update_liminfo's steps 1-7 but the
// edge taper): two kernels around sellim_taper's, three launches a call
// for every stream.
//
// Replaces, on the card, the PyTorch operations that the port ran for
// linrad_tpu/ops/sellim.py:update_liminfo: its two associative_scans
// (_chain_reach, :47) as four cummax, its three segment reductions
// (linrad_tpu/utils/segments.py:26) as cumsum and scatter_reduce, the
// noise floor's top_k and means, the four SFAC rounds and the wait
// counters, about 215 kernels over 2,048 bins (8 KiB) in all.  The plain
// version, _update_liminfo_reference in linrad_tpu_torch/ops/sellim.py, is
// those operations unchanged; the front kernel ends where it calls
// sellim_taper and the back kernel starts where that returns.
//
// What bounds it: the bytes are a few times 4 n (the power, the old
// liminfo and counters read, liminfo and counters written): 0.00005 ms at
// 2,048 bins at the card's memory rate.  What is left is latency: two
// launches, a handful of block-wide barriers, and each thread's short
// serial walks.
//
// The front kernel: one block of kThreads a stream (R streams under
// torch.func.vmap make R blocks).  Thread t owns the band-ordered bins
// [t k, t k + k), k = ceil(n / kThreads): 2 at fft1 2,048, 16 at 16,384;
// any n works, the per-bin state between walks going to the scratch
// `work` (the same thread writes and reads a bin, so no barrier).  The
// band order (bin n/2 first for IQ) is an index, never a copy.
//
// - The skirt chains.  r[j] = strong[j] | (q[j] & r[j - 1]) holds where
//   the last strong bin at or before j comes at or after the last bin
//   where q fails: a max-scan of 2 j + 1 at a strong bin and 2 j at a
//   break, r = the scan is odd.  The backward chain is the same scan from
//   the other end.  Each thread's chunk maximum, then one block-wide scan
//   (warp shuffles and one pass through shared memory) in both directions
//   at once, then a walk up the chunk and one down it.
// - The segments (the strong runs).  Every member needs its run's maximum
//   of p, minimum of the old positive gains, and width.  A segmented scan
//   whose state is (the last non-member index, the maximum, the minimum
//   over the members after it) runs forward, and its mirror backward; a
//   member's full run is the union of the two (maximum and minimum are
//   idempotent), its start and end the two resets.  No atomics: widths are
//   end - start + 1, exact.
// - The floor (step 5): warp g takes group g (at most 32 groups, each of
//   at least 3 bins), the three smallest of its bins (a NaN above every
//   number, as torch.topk orders it) by shuffles, then warp 0 takes the
//   means in the order PyTorch's CUDA reduction takes them (below).
//
// The back kernel: a grid of 256-bin tiles by streams; each thread one
// band bin, the SFAC growth from the power and the tapered gains of the 4
// bins on each side (after 4 rounds a bin depends on no bin further
// away) as 9-bit masks, then the counters, the release cap, the band's
// edges and the protected passband, written in DC-at-0 order.
//
// Exactness: each float step is one correctly rounded operation, the one
// PyTorch's CUDA kernel performs for the plain version's expression, with
// __f*_rn intrinsics so that nvcc contracts nothing into an FMA: 0.3 * p,
// a true division and a square root for the gain, 0.8 old + 0.2 g as two
// products and a sum, width / 4 + 1 exact, 1.15 old, a Python scalar as
// its float.  PyTorch's CUDA mean multiplies the sum by the float of
// outputs / inputs (1/3 of a group's three smallest, 1/G of the groups'
// means) where its CPU mean divides; its sums over a row of up to 32
// follow the reduction kernel's layout: a row of 3 is (x0 + x2) + x1 (two
// threads, the first holding x0 and x2), a row of G <= 32 puts G into
// 2^floor(log2 G) lanes (lane x holds x and x + that) and adds them by
// shfl_down at halving offsets (probed on the card, torch 2.11: every one
// of 512 random rows of 3, 16, 20, 24 and 32).  The masked sum is that
// tree over the selected means and 0 elsewhere; the floor a true division
// by their count.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 1024;       // the front kernel's block: a stream
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;           // the back kernel's bins a block
constexpr int kReach = 4;            // SFAC rounds: the stencil's radius
constexpr int kMaxGroups = 32;       // a warp a group
constexpr unsigned kFull = 0xffffffffu;

// (the last reset index, maximum of p, minimum of old gains) over a span
struct Seg {
  int r;
  float mx, mn;
};

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ int shfl_down(int v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ Seg shfl_up(Seg s, int d) {
  return {__shfl_up_sync(kFull, s.r, d), __shfl_up_sync(kFull, s.mx, d),
          __shfl_up_sync(kFull, s.mn, d)};
}
__device__ __forceinline__ Seg shfl_down(Seg s, int d) {
  return {__shfl_down_sync(kFull, s.r, d), __shfl_down_sync(kFull, s.mx, d),
          __shfl_down_sync(kFull, s.mn, d)};
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// a then b along the scan: a reset in b wins, else both spans' members
struct SegOp {
  int none;  // no reset: -1 forward, n backward
  __device__ Seg operator()(const Seg& a, const Seg& b) const {
    if (b.r != none) return b;
    return {a.r, fmaxf(a.mx, b.mx), fminf(a.mn, b.mn)};
  }
};

// Exclusive scans over the block's threads, f from thread 0 up and b from
// the last thread down, op(earlier, later): each thread gets the
// combination of the threads before it in that direction (the identity
// for the first).  ft, bt: a word a warp in shared memory.
template <class F, class B, class OpF, class OpB>
__device__ void scan_both(F& f, B& b, F fid, B bid, OpF opf, OpB opb, F* ft,
                          B* bt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const F yf = shfl_up(f, d);
    const B yb = shfl_down(b, d);
    if (lane >= d) f = opf(yf, f);
    if (31 - lane >= d) b = opb(yb, b);
  }
  __syncthreads();  // the previous scan's readers are done with ft and bt
  if (lane == 31) ft[warp] = f;
  if (lane == 0) bt[warp] = b;
  __syncthreads();
  if (warp == 0) {
    F tf = ft[lane];
    B tb = bt[kWarps - 1 - lane];
    for (int d = 1; d < 32; d <<= 1) {
      const F yf = shfl_up(tf, d);
      const B yb = shfl_up(tb, d);
      if (lane >= d) {
        tf = opf(yf, tf);
        tb = opb(yb, tb);
      }
    }
    ft[lane] = tf;                  // through warp lane, from the first
    bt[kWarps - 1 - lane] = tb;     // through warp kWarps-1-lane, from the last
  }
  __syncthreads();
  F ef = shfl_up(f, 1);
  B eb = shfl_down(b, 1);
  if (lane == 0) ef = fid;
  if (lane == 31) eb = bid;
  f = warp > 0 ? opf(ft[warp - 1], ef) : ef;
  b = warp < kWarps - 1 ? opb(bt[warp + 1], eb) : eb;
}

// torch.clamp(x, min=1e-30): a NaN stays NaN
__device__ __forceinline__ float clamp_floor(float x) {
  return x < 1e-30f ? 1e-30f : x;
}

// the band-ordered bin j's index in DC-at-0 order (torch.roll by half)
__device__ __forceinline__ int dc_bin(int j, int n, int half) {
  const int i = j - half;
  return i < 0 ? i + n : i;
}

// a before b as torch.topk(largest=False) orders them: a NaN above all
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

// the three smallest of a set, ascending; c of them held
struct Three {
  float v[3];
  int c;
  __device__ void add(float x) {
    int k = c < 3 ? c : 2;
    if (c == 3 && !before(x, v[2])) return;
    while (k > 0 && before(x, v[k - 1])) {
      v[k] = v[k - 1];
      --k;
    }
    v[k] = x;
    c = c < 3 ? c + 1 : 3;
  }
};

__device__ Three merge(const Three& a, const Three& b) {
  Three m{{0.f, 0.f, 0.f}, 0};
  int i = 0, j = 0;
  while (m.c < 3 && (i < a.c || j < b.c)) {
    const bool take_a = j >= b.c || (i < a.c && !before(b.v[j], a.v[i]));
    m.v[m.c++] = take_a ? a.v[i++] : b.v[j++];
  }
  return m;
}

// PyTorch's CUDA sum of g[0..G), G <= 32, as its reduction kernel takes
// it: bw = 2^floor(log2 G) lanes, lane x holding g[x] + g[x + bw], then
// shfl_down at offsets bw/2, ..., 1.  Lane 0 returns it
__device__ float torch_row_sum(const float* g, int G) {
  const int lane = threadIdx.x & 31;
  int bw = 1;
  while (2 * bw <= G) bw *= 2;
  float v = 0.f;
  if (lane < bw) {
    v = __fadd_rn(0.f, g[lane]);
    if (lane + bw < G) v = __fadd_rn(v, g[lane + bw]);
  }
  for (int d = bw / 2; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, d));
  return v;
}

__global__ void __launch_bounds__(kThreads)
sellim_front_kernel(const float* __restrict__ avg, long long avg_stride,
                    const float* __restrict__ old_lim, long long lim_stride,
                    float* __restrict__ lim_out, float* __restrict__ bud_out,
                    int* __restrict__ work, float* __restrict__ thr_out,
                    int n, int half, float limit, float ston, int groups) {
  __shared__ int ft_i[kWarps], bt_i[kWarps];
  __shared__ Seg ft_s[kWarps], bt_s[kWarps];
  __shared__ float gmean[kMaxGroups], picked[kMaxGroups];
  const long long row = blockIdx.x;
  avg += row * avg_stride;
  old_lim += row * lim_stride;
  lim_out += row * n;
  bud_out += row * n;
  work += row * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = (n + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * k, n);
  const int hi = min(lo + k, n);
  auto p_at = [&](int j) { return clamp_floor(__ldg(avg + dc_bin(j, n, half))); };
  // roll(where(old > 0, old, inf)): the old positive gains
  auto old_at = [&](int j) {
    const float o = __ldg(old_lim + dc_bin(j, n, half));
    return o > 0.f ? o : INFINITY;
  };

  // step 5's groups: the three smallest of each, their mean
  if (warp < groups) {
    const int m = n / groups;
    Three t{{0.f, 0.f, 0.f}, 0};
    for (int b = lane; b < m; b += 32) t.add(p_at(warp * m + b));
    for (int d = 16; d; d >>= 1) {
      Three o{{0.f, 0.f, 0.f}, __shfl_xor_sync(kFull, t.c, d)};
      for (int s = 0; s < 3; ++s) o.v[s] = __shfl_xor_sync(kFull, t.v[s], d);
      t = merge(t, o);
    }
    if (lane == 0) {
      const float third = __fdiv_rn(static_cast<float>(groups),
                                    static_cast<float>(3 * groups));
      gmean[warp] = __fmul_rn(__fadd_rn(__fadd_rn(t.v[0], t.v[2]), t.v[1]),
                              third);
    }
  }

  // 1-2. the threshold and the two skirt chains.  code: bit 0 strong, bit
  // 1 the backward-facing break (q_dn false), bit 2 the forward one
  int cf = -1, cb = -1;
  for (int j = lo; j < hi; ++j) {
    const float p = p_at(j);
    const float pl = p_at(j > 0 ? j - 1 : 0);
    const float pr = p_at(j < n - 1 ? j + 1 : n - 1);
    const int code = (p > limit) | (!(p < __fmul_rn(0.3f, pl)) << 1)
                     | (!(p < __fmul_rn(0.3f, pr)) << 2);
    work[j] = code;
    const int kf = code & 1 ? 2 * j + 1 : code & 2 ? 2 * j : -1;
    const int kb = code & 1 ? 2 * (n - 1 - j) + 1 : code & 4 ? 2 * (n - 1 - j) : -1;
    cf = max(cf, kf);
    cb = max(cb, kb);
  }
  scan_both(cf, cb, -1, -1, MaxOp(), MaxOp(), ft_i, bt_i);
  for (int j = lo; j < hi; ++j) {
    const int code = work[j];
    cf = max(cf, code & 1 ? 2 * j + 1 : code & 2 ? 2 * j : -1);
    work[j] = code | ((cf >= 0 && (cf & 1)) << 3);
  }
  // down the chunk: the backward chain, then each direction's segment
  // state of the chunk
  const Seg none_f{-1, -INFINITY, INFINITY}, none_b{n, -INFINITY, INFINITY};
  Seg sf = none_f, sb = none_b;
  bool reset_seen = false;
  for (int j = hi - 1; j >= lo; --j) {
    const int code = work[j];
    cb = max(cb, code & 1 ? 2 * (n - 1 - j) + 1 : code & 4 ? 2 * (n - 1 - j) : -1);
    const bool strong = (code >> 3 & 1) || (cb >= 0 && (cb & 1));
    work[j] = strong;
    if (strong) {
      const float p = p_at(j), o = old_at(j);
      if (!reset_seen) {
        sf.mx = fmaxf(sf.mx, p);
        sf.mn = fminf(sf.mn, o);
      }
      sb.mx = fmaxf(sb.mx, p);
      sb.mn = fminf(sb.mn, o);
    } else {
      if (!reset_seen) sf.r = j;
      reset_seen = true;
      sb = {j, -INFINITY, INFINITY};
    }
  }
  scan_both(sf, sb, none_f, none_b, SegOp{-1}, SegOp{n}, ft_s,
            bt_s);

  // 3. up the chunk: each member's run so far from its start
  for (int j = lo; j < hi; ++j) {
    if (work[j]) {
      sf = {sf.r, fmaxf(sf.mx, p_at(j)), fminf(sf.mn, old_at(j))};
      lim_out[j] = sf.mx;
      bud_out[j] = sf.mn;
      work[j] = sf.r + 1;
    } else {
      sf = {j, -INFINITY, INFINITY};
      work[j] = -1;
    }
  }
  // down the chunk: the run's rest, then the gain, its smoothing, lim and
  // 4.'s budget
  for (int j = hi - 1; j >= lo; --j) {
    const int start = work[j];
    if (start < 0) {
      sb = {j, -INFINITY, INFINITY};
      lim_out[j] = 0.f;
      bud_out[j] = 0.f;
      continue;
    }
    sb = {sb.r, fmaxf(sb.mx, p_at(j)), fminf(sb.mn, old_at(j))};
    const float maxval = fmaxf(lim_out[j], sb.mx);
    const float old_gain = fminf(bud_out[j], sb.mn);
    float gain = __fsqrt_rn(__fdiv_rn(limit, maxval < limit ? limit : maxval));
    const float ratio = __fdiv_rn(old_gain, gain < 1e-20f ? 1e-20f : gain);
    if (ratio > 0.1f && ratio < 10.f && isfinite(old_gain))
      gain = __fadd_rn(__fmul_rn(old_gain, 0.8f), __fmul_rn(gain, 0.2f));
    const int width = sb.r - 1 - start + 1;
    lim_out[j] = gain;
    bud_out[j] = __fadd_rn(__fmul_rn(static_cast<float>(width), 0.25f), 1.f);
  }

  // 5. the floor from the groups' means (gmean was written before the
  // scans' barriers)
  if (warp == 0) {
    const float total = torch_row_sum(gmean, groups);
    const float gavg = __fmul_rn(__shfl_sync(kFull, total, 0),
                                 __fdiv_rn(1.f, static_cast<float>(groups)));
    const bool sel = lane < groups && gmean[lane] < __fmul_rn(2.f, gavg);
    if (lane < groups) picked[lane] = sel ? gmean[lane] : 0.f;
    __syncwarp();
    const float sum = torch_row_sum(picked, groups);
    const int count = __popc(__ballot_sync(kFull, sel));
    if (lane == 0)
      thr_out[row] = __fmul_rn(
          __fdiv_rn(sum, static_cast<float>(count > 0 ? count : 1)), ston);
  }
}

__global__ void __launch_bounds__(kTile)
sellim_back_kernel(const float* __restrict__ avg, long long avg_stride,
                   const float* __restrict__ old_lim, long long lim_stride,
                   const int* __restrict__ old_wait, long long wait_stride,
                   const float* __restrict__ tapered,
                   const float* __restrict__ thr_in,
                   const long long* __restrict__ sel_lo,
                   const long long* __restrict__ sel_hi, long long sel_stride,
                   float* __restrict__ lim_out, int* __restrict__ wait_out,
                   int n, int half, int wait_n) {
  __shared__ float sp[kTile + 2 * kReach], sl[kTile + 2 * kReach];
  const long long row = blockIdx.y;
  avg += row * avg_stride;
  old_lim += row * lim_stride;
  old_wait += row * wait_stride;
  tapered += row * n;
  lim_out += row * n;
  wait_out += row * n;
  const int j0 = blockIdx.x * kTile;
  // a bin past the band's ends: power NaN (no compare holds), gain 1 (not
  // weak), so it neither starts, passes on nor takes a carrier
  for (int x = threadIdx.x; x < kTile + 2 * kReach; x += kTile) {
    const int j = j0 - kReach + x;
    const bool in = j >= 0 && j < n;
    sp[x] = in ? clamp_floor(__ldg(avg + dc_bin(j, n, half))) : NAN;
    sl[x] = in ? __ldg(tapered + j) : 1.f;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= n) return;
  const float thr = __ldg(thr_in + row);
  // bit w: band bin j - kReach + w
  unsigned weak = 0, car = 0, from_l = 0, from_r = 0;
  const int x0 = threadIdx.x;  // sp[x0 + w] is bin j - kReach + w
  for (int w = 0; w <= 2 * kReach; ++w) {
    const float p = sp[x0 + w];
    const bool z = sl[x0 + w] == 0.f;
    weak |= z << w;
    car |= (z && p > thr) << w;
    if (w > 0 && w < 2 * kReach) {
      const float twice = __fmul_rn(2.f, p);
      from_l |= (twice < sp[x0 + w - 1]) << w;
      from_r |= (twice < sp[x0 + w + 1]) << w;
    }
  }
  for (int round = 0; round < kReach; ++round)
    car |= (((car << 1) & from_l) | ((car >> 1) & from_r)) & weak;

  // 5.-7.: carriers, counters, the release cap, the band's edges
  const int i = dc_bin(j, n, half);
  float lim = sl[x0 + kReach];
  if (car >> kReach & 1) lim = -1.f;          // car implies weak
  const bool strong = lim != 0.f;
  const int ow = __ldg(old_wait + i);
  int wait = strong ? wait_n : (ow - 1 > 0 ? ow - 1 : 0);
  if (!strong && wait > 0) lim = -1.f;
  const float ol = __ldg(old_lim + i);
  const float cap = ol > 0.f ? __fmul_rn(ol, 1.15f) : INFINITY;
  if (lim > 0.f && lim > cap && cap < 1.f) lim = cap;
  if (j < 2 || j >= n - 2) lim = 0.f;
  // the protected passband, in DC-at-0 bins
  if (sel_lo != nullptr && i >= __ldg(sel_lo + row * sel_stride)
      && i <= __ldg(sel_hi + row * sel_stride)) {
    lim = 0.f;
    wait = 0;
  }
  lim_out[i] = lim;
  wait_out[i] = wait;
}

}  // namespace

extern "C" int lrt_sellim_update_threads() { return kThreads; }

// avg, old_lim: rows of n float32 (power, the old liminfo), each dense,
// rows *_stride elements apart (0: one row for every stream); lim_out,
// bud_out, work: (rows, n) dense scratch the taper then reads (lim_out,
// bud_out in band order); thr_out: (rows,).  1 <= groups <= 32, n a
// multiple of groups with at least 3 bins a group; half 0 or n / 2.
extern "C" int lrt_sellim_front(const void* avg, long long avg_stride,
                                const void* old_lim, long long lim_stride,
                                void* lim_out, void* bud_out, void* work,
                                void* thr_out, int n, int half, float limit,
                                float ston, int groups, int rows,
                                void* stream) {
  if (rows < 1 || n < 3 || groups < 1 || groups > kMaxGroups
      || n % groups != 0 || n / groups < 3 || (half != 0 && half != n / 2)
      || n >= (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  sellim_front_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float*>(avg), avg_stride,
                 static_cast<const float*>(old_lim), lim_stride,
                 static_cast<float*>(lim_out), static_cast<float*>(bud_out),
                 static_cast<int*>(work), static_cast<float*>(thr_out), n,
                 half, limit, ston, groups);
  return static_cast<int>(cudaGetLastError());
}

// tapered: (rows, n) dense, band order; thr: (rows,); old_wait int32 rows
// as old_lim; sel_lo, sel_hi: int64, an element a stream sel_stride apart
// (0: one for every stream), or both null (no passband); lim_out
// (float32) and wait_out (int32): (rows, n) dense, DC-at-0 order.
extern "C" int lrt_sellim_back(const void* avg, long long avg_stride,
                               const void* old_lim, long long lim_stride,
                               const void* old_wait, long long wait_stride,
                               const void* tapered, const void* thr,
                               const void* sel_lo, const void* sel_hi,
                               long long sel_stride, void* lim_out,
                               void* wait_out, int n, int half, int wait_n,
                               int rows, void* stream) {
  if (rows < 1 || n < 1 || (half != 0 && half != n / 2)
      || (sel_lo == nullptr) != (sel_hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTile - 1) / kTile, rows);
  sellim_back_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(avg), avg_stride,
      static_cast<const float*>(old_lim), lim_stride,
      static_cast<const int*>(old_wait), wait_stride,
      static_cast<const float*>(tapered), static_cast<const float*>(thr),
      static_cast<const long long*>(sel_lo),
      static_cast<const long long*>(sel_hi), sel_stride,
      static_cast<float*>(lim_out), static_cast<int*>(wait_out), n, half,
      wait_n);
  return static_cast<int>(cudaGetLastError());
}
