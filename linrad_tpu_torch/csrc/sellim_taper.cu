// Sellim's edge taper for sm_90a: one launch over tiles of the band, each
// computed in one step, with no loop over passes on its common path.
//
// Replaces the jax.lax.fori_loop of linrad_tpu/ops/sellim.py:137-151
// (taper_body, inside update_liminfo), which XLA runs as 64 passes on the
// device; the port's plain version, _sellim_taper_reference in
// linrad_tpu_torch/ops/sellim.py, is those passes.  Each pass gives every
// weak bin (lim == 0) beside a strong one with budget left the strong
// one's gain to the power 0.9 and one bin less of budget; the shifts are
// edge-replicated, as JAX's concatenate makes them.
//
// What bounds it: the function moves 12 bytes a bin (lim and budget read,
// lim written once), 24,576 bytes at the flagship's 2,048 bins and 0.8 MB
// at 65,536: 0.000007-0.00023 ms at the card's memory rate, far under a
// launch (about 0.001 ms).  What is left is latency: the launch, one round
// trip to memory, and the dependent chain of powf that a bin lit d bins
// from its source needs (d <= 64, since 64 passes move a gain 64 bins).
// The kernel it replaces ran the passes one after another, a block-wide
// barrier each, on one SM per stream: 1.5-1.8 us a pass on an H100.
//
// The design:
//
// - A pass moves information one bin, so after 64 passes a bin depends
//   only on the 64 bins on each side of it.  A block takes a tile of
//   kTile = 384 bins and its two halos of 64, kThreads = 512 slots, one a
//   thread, loaded once (coalesced, padded with lim = budget = 0 past the
//   band's ends) into shared memory.  The grid is (tiles, streams): every
//   n and every stream, under torch.func.vmap too (a budget shared by the
//   streams has stride 0), runs in this one launch, with no scratch.
// - The closed form.  Where every weak bin has budget < 1 (the
//   precondition below), a weak bin is lit by the nearest nonzero bin on
//   each side, at distance d <= 64, when that bin's gain is positive and
//   its budget is at least d (the budgets of the bins a front lights fall
//   by one a bin, exactly in float32 below 2^24); the nearer side wins;
//   on a tie the bin takes powf(max of the two chains at d - 1, 0.9), as
//   the pass does.  The value is powf(., 0.9f) applied d times to the
//   source's gain, the same call, in the same order, as the passes make
//   it: never powf(g, 0.9^d).  A NaN gain lights nothing; with budget >=
//   1 it keeps the bin next to it dark, since every pass's candidate
//   there is NaN, and that bin then stops the other side's front.  A
//   negative gain lights and blocks nothing.  Zero padding past the band's
//   ends gives what the edge replication gives, since a replicated weak
//   bin has budget < 1.
// - Each warp writes a ballot of lim != 0 into a word in shared memory;
//   a bin finds its nearest nonzero bin on each side in at most three
//   words (__clz, __ffs).  Each source with budget >= 1 and a positive
//   gain runs its chain once (its two fronts carry the same values),
//   writing the values its fronts would give into CL (lit from the left)
//   and CR (from the right), so a chain is computed once per source, not
//   once per bin.  Two block-wide barriers in all: after the loads (with
//   the precondition's vote) and after the chains.  The longest chain,
//   64 dependent powf, then bounds the call: about 0.14 us a powf on an
//   H100 (chip_smoke.py phase 3b: 0.0029-0.0031 ms at 3 deep, 0.0117 at
//   64).
// - The window loop.  update_liminfo breaks the precondition where a
//   strong segment's gain is 0, so that a bin with lim == 0 carries a
//   budget >= 1: a +inf power bin (clamp(min=1e-30) keeps it, maxval is
//   inf) or maxlevel = 0 (limit 0).  A block whose window (tile and
//   halos) holds such a bin runs the passes themselves over the window in
//   shared memory, each ending in a barrier, and stops after a pass that
//   changes no bin (every later pass would change none).  Its tile is
//   exact, since the 64 passes reach no further than the halos; the
//   window's edges replicate, which is the JAX shift at the band's true
//   ends and does not matter elsewhere.
//
// Shared memory: 4 arrays of 512 floats and 16 words, 8,256 bytes.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kHalo = 64;                       // TAPER_STEPS
constexpr int kThreads = 512;                   // window slots, one a thread
constexpr int kTile = kThreads - 2 * kHalo;     // the bins a block writes
constexpr int kWords = kThreads / 32;
constexpr int kNever = 1 << 30;

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// The distance from slot j to the nearest set slot of M in [j - 64, j - 1],
// or 0 where there is none.
__device__ __forceinline__ int nearest_left(const unsigned* M, int j) {
  int d = 1;
  for (int p = j - 1; p >= 0 && d <= kHalo;) {
    const int b = p & 31;
    const unsigned m = M[p >> 5] & (0xffffffffu >> (31 - b));
    if (m) {
      d += b - (31 - __clz(m));
      return d <= kHalo ? d : 0;
    }
    d += b + 1;
    p -= b + 1;
  }
  return 0;
}

// The distance from slot j to the nearest set slot of M in [j + 1, j + 64],
// or 0 where there is none.
__device__ __forceinline__ int nearest_right(const unsigned* M, int j) {
  int d = 1;
  for (int p = j + 1; p < kThreads && d <= kHalo;) {
    const int b = p & 31;
    const unsigned m = M[p >> 5] & (0xffffffffu << b);
    if (m) {
      d += __ffs(m) - 1 - b;
      return d <= kHalo ? d : 0;
    }
    d += 32 - b;
    p += 32 - b;
  }
  return 0;
}

// The bins a source's front can reach on one side: at most 64, at most its
// budget, and up to the bin before the next nonzero one (gap: the distance
// to it, 0 for none within 64).
__device__ __forceinline__ int reach(float b, int gap) {
  const int by_budget = b >= kHalo ? kHalo : static_cast<int>(b);
  return gap ? min(by_budget, gap - 1) : by_budget;
}

__global__ void __launch_bounds__(kThreads)
sellim_taper_kernel(const float* __restrict__ lim,
                    const float* __restrict__ budget,
                    float* __restrict__ out, long long lim_stride,
                    long long budget_stride, int n, int* __restrict__ paths) {
  __shared__ float L[kThreads], B[kThreads], CL[kThreads], CR[kThreads];
  __shared__ unsigned M[kWords];
  const int j = threadIdx.x;
  const long long r = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int bin = t0 - kHalo + j;
  lim += r * lim_stride;
  budget += r * budget_stride;
  out += r * n;
  // the window's real slots [lo, hi) and the tile's [kHalo, core_end)
  const int lo = max(0, kHalo - t0);
  const int hi = min(kThreads, n - t0 + kHalo);
  const int core_end = min(kHalo + kTile, hi);
  const bool real = j >= lo && j < hi;
  const float l = real ? lim[bin] : 0.f;
  const float b = real ? budget[bin] : 0.f;
  L[j] = l;
  B[j] = b;
  CL[j] = l;
  CR[j] = l;
  const unsigned m = __ballot_sync(0xffffffffu, l != 0.f);
  if ((j & 31) == 0) M[j >> 5] = m;
  const bool looped = __syncthreads_or(real && l == 0.f && !(b < 1.f));
  if (paths != nullptr && j == 0) paths[r * gridDim.x + blockIdx.x] = looped;
  float v = l;
  if (!looped) {
    if (l > 0.f && b >= 1.f) {
      const int kr = j + 1 < core_end
          ? min(reach(b, nearest_right(M, j)), core_end - 1 - j) : 0;
      const int kl = j - 1 >= kHalo
          ? min(reach(b, nearest_left(M, j)), j - kHalo) : 0;
      float c = l;                      // both fronts carry one chain
      for (int k = 1; k <= max(kr, kl); ++k) {
        c = powf(c, 0.9f);
        if (k <= kr) CL[j + k] = c;
        if (k <= kl) CR[j - k] = c;
      }
    }
    __syncthreads();
    if (j >= kHalo && j < core_end && l == 0.f) {
      const int dl = nearest_left(M, j), dr = nearest_right(M, j);
      int tl = kNever, tr = kNever;
      bool dark = false;
      if (dl) {
        const float sl = L[j - dl], sb = B[j - dl];
        if (sl > 0.f && sb >= static_cast<float>(dl)) tl = dl;
        dark |= dl == 1 && isnan(sl) && sb >= 1.f;
      }
      if (dr) {
        const float sl = L[j + dr], sb = B[j + dr];
        if (sl > 0.f && sb >= static_cast<float>(dr)) tr = dr;
        dark |= dr == 1 && isnan(sl) && sb >= 1.f;
      }
      if (!dark && tl < tr) v = CL[j];
      if (!dark && tr < tl) v = CR[j];
      if (!dark && tl == tr && tl != kNever)
        v = powf(max_nan(CL[j - 1], CR[j + 1]), 0.9f);
    }
  } else {
    for (int s = 0; s < kHalo; ++s) {
      bool is_new = false;
      float nl = 0.f, nb = 0.f;
      if (real) {
        const int il = j > lo ? j - 1 : lo;
        const int ir = j < hi - 1 ? j + 1 : hi - 1;
        const float bl = B[il], br = B[ir];
        const float cand = max_nan(bl >= 1.f ? L[il] : 0.f,
                                   br >= 1.f ? L[ir] : 0.f);
        is_new = L[j] == 0.f && cand > 0.f;
        if (is_new) {
          nl = powf(cand, 0.9f);
          nb = max_nan(bl - 1.f, br - 1.f);
        }
      }
      __syncthreads();                  // every read of the pass is done
      if (is_new) {
        L[j] = nl;
        B[j] = nb;
      }
      // the writes are visible after the vote; a pass that changed
      // nothing leaves every later pass nothing to change
      if (!__syncthreads_or(is_new)) break;
    }
    v = L[j];
  }
  if (j >= kHalo && j < core_end) out[bin] = v;
}

}  // namespace

extern "C" int lrt_sellim_taper_tile() { return kTile; }

// paths: nullptr, or one int per (stream, tile), set to 1 where the block
// ran the window loop and 0 where it took the closed form.
extern "C" int lrt_sellim_taper(const void* lim, const void* budget,
                                void* out, void* paths,
                                long long lim_stride,
                                long long budget_stride, int n,
                                int streams, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, streams);
  sellim_taper_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const float*>(lim),
                 static_cast<const float*>(budget), static_cast<float*>(out),
                 lim_stride, budget_stride, n, static_cast<int*>(paths));
  return static_cast<int>(cudaGetLastError());
}
