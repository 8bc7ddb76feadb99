// The clever blanker's sequential fit-and-subtract loop, one launch per
// call, for sm_90a.
//
// Replaces the jax.lax.fori_loop of linrad_tpu/ops/blanker.py:322
// (_clever_blanker_blocked, :269-324, with the fit of _fit_subtract,
// :229-266), which XLA runs as one loop on the device; the port's plain
// version is _blanker_fits_reference in linrad_tpu_torch/ops/blanker.py.
//
// What bounds it: each fit depends on the one before (a subtraction
// changes the data under the next search), so the work is a chain of up
// to max_pulses dependent steps of a few hundred operations each, and its
// time is the latency of that chain: block-wide barriers and round trips
// to L2, not bytes or operations.  The arrays it touches (the padded
// stream, its power and candidate power: under 2 MB at 262,144 samples)
// stay in L2 after the first fit.
//
// The design: one block of 256 threads per stream loops over the fits
// inside the kernel, so a fit costs no kernel launch.  The block maxima of
// the candidate power (T / block floats: 257 at the flagship, 1,025 at
// 262,144 samples) and the window of pul x C samples live in shared
// memory; the two argmaxes, the phase, the I/Q powers, the parabolic fit
// and the power sums are block reductions.  The argmaxes return the lowest
// index on ties, as torch.argmax does.  The loop stops at the first fit
// whose candidate is at or under the threshold: from there every
// iteration of the JAX loop is a masked no-op that writes back what it
// read (the candidate power equals the power wherever it is active), so
// the result is the same.  Under torch.func.vmap over R streams the grid
// is R blocks, one per stream.
//
// The wrapper hands the kernel copies of the padded stream, its power and
// the candidate power, which the kernel updates in place, and reads the
// threshold from the device.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Scratch {
  float v[kWarps + 1];
  float w[kWarps + 1];
  int i[kWarps + 1];
};

// torch.argmax's order: the larger value wins, NaN above every number, and
// of two equal values the lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// The block's argmax of (v, i); every thread gets the result.
__device__ void block_argmax(float& v, int& i, Scratch& s) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s.v[warp] = v; s.i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s.v[lane] : -INFINITY;
    i = lane < kWarps ? s.i[lane] : INT_MAX;
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (beats(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { s.v[kWarps] = v; s.i[kWarps] = i; }
  }
  __syncthreads();
  v = s.v[kWarps];
  i = s.i[kWarps];
}

// The block's sums of a and b; every thread gets them.
__device__ void block_sum2(float& a, float& b, Scratch& s) {
  for (int off = 16; off; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s.v[warp] = a; s.w[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s.v[lane] : 0.f;
    b = lane < kWarps ? s.w[lane] : 0.f;
    for (int off = 16; off; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) { s.v[kWarps] = a; s.w[kWarps] = b; }
  }
  __syncthreads();
  a = s.v[kWarps];
  b = s.w[kWarps];
}

// torch.amax's order: NaN wins over every number.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// The block's maxima of a and b (NaN propagating); every thread gets them.
__device__ void block_max2(float& a, float& b, Scratch& s) {
  for (int off = 16; off; off >>= 1) {
    a = max_nan(a, __shfl_down_sync(0xffffffffu, a, off));
    b = max_nan(b, __shfl_down_sync(0xffffffffu, b, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s.v[warp] = a; s.w[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s.v[lane] : -INFINITY;
    b = lane < kWarps ? s.w[lane] : -INFINITY;
    for (int off = 16; off; off >>= 1) {
      a = max_nan(a, __shfl_down_sync(0xffffffffu, a, off));
      b = max_nan(b, __shfl_down_sync(0xffffffffu, b, off));
    }
    if (lane == 0) { s.v[kWarps] = a; s.w[kWarps] = b; }
  }
  __syncthreads();
  a = s.v[kWarps];
  b = s.w[kWarps];
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float cabs(float2 a) { return hypotf(a.x, a.y); }

// Stream r = blockIdx.x.  wk (T, C), pk (T,), cand (T,): the working
// copies, updated in place; bmax0 (nblk,): the initial block maxima of
// cand; refbank (nref, pul), phasefunc (pul,); thr: the threshold; nfit:
// the count of successful fits.  Each pointer advances by its stride per
// stream (0: shared by every stream).
__global__ void __launch_bounds__(kThreads)
blanker_fits_kernel(float2* wk, float* pk, float* cand,
                    const float* __restrict__ bmax0,
                    const float2* __restrict__ refbank,
                    const float2* __restrict__ phasefunc,
                    const float* __restrict__ thr, int* __restrict__ nfit,
                    long long bmax_stride, long long ref_stride,
                    long long pf_stride, long long thr_stride, int T, int C,
                    int nblk, int pul, int nref, int pw, int max_pulses) {
  extern __shared__ float4 smem_f4[];
  __shared__ Scratch red;
  __shared__ int s_j;
  __shared__ float2 s_coef[kThreads];   // per channel (C <= kThreads)
  __shared__ float2 s_unit[kThreads];
  float* bmax = reinterpret_cast<float*>(smem_f4);                // nblk
  float2* pf = reinterpret_cast<float2*>(bmax + ((nblk + 1) & ~1));  // pul
  float2* win = pf + pul;                                         // pul C
  float2* der = win + pul * C;                                    // pul C
  float* oldp = reinterpret_cast<float*>(der + pul * C);          // pul

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  wk += static_cast<long long>(r) * T * C;
  pk += static_cast<long long>(r) * T;
  cand += static_cast<long long>(r) * T;
  bmax0 += r * bmax_stride;
  refbank += r * ref_stride;
  phasefunc += r * pf_stride;
  const float threshold = thr[r * thr_stride];
  const int blk = T / nblk;
  const int half = pul / 2;
  const int E = pul * C;

  for (int k = tid; k < nblk; k += kThreads) bmax[k] = bmax0[k];
  for (int k = tid; k < pul; k += kThreads) pf[k] = phasefunc[k];
  __syncthreads();

  int fitted = 0;
  for (int it = 0; it < max_pulses; ++it) {
    // the block with the largest candidate, and its value
    float bv = -INFINITY;
    int b = INT_MAX;
    for (int k = tid; k < nblk; k += kThreads) {
      if (beats(bmax[k], k, bv, b)) { bv = bmax[k]; b = k; }
    }
    block_argmax(bv, b, red);
    // at or under the threshold: this and every later iteration would
    // write back what it read
    if (!(bv > threshold)) break;
    // the candidate inside that block
    float cv = -INFINITY;
    int ci = INT_MAX;
    const float* cb = cand + static_cast<long long>(b) * blk;
    for (int k = tid; k < blk; k += kThreads) {
      const float v = cb[k];
      if (beats(v, k, cv, ci)) { cv = v; ci = k; }
    }
    block_argmax(cv, ci, red);
    const int p = b * blk + ci;

    // the fit window, derotated by the phase function
    const int start = min(max(p - half, 0), T - pul);
    if (tid < E) {
      const int k = tid / C;
      const float2 w = wk[static_cast<long long>(start) * C + tid];
      win[tid] = w;
      der[tid] = cmul(w, pf[k]);
    }
    if (tid < pul) oldp[tid] = pk[start + tid];
    __syncthreads();
    // the power-weighted phase of the three centre points, per channel
    if (tid < C) {
      float2 ph = make_float2(0.f, 0.f);
      for (int m = -1; m <= 1; ++m) {
        const float2 d = der[(half + m) * C + tid];
        const float a = cabs(d);
        ph.x = __fadd_rn(ph.x, __fmul_rn(a, d.x));
        ph.y = __fadd_rn(ph.y, __fmul_rn(a, d.y));
      }
      // ph / max(|ph|, 1e-20), as a complex over a real divisor: the
      // reciprocal times each part
      const float scl = 1.0f / fmaxf(cabs(ph), 1e-20f);
      s_unit[tid] = make_float2(ph.x * scl, ph.y * scl);
    }
    __syncthreads();
    // rotate onto the real axis; I and Q power over the centre +-pw
    float ip = 0.f, qp = 0.f;
    float2 rot = make_float2(0.f, 0.f);
    if (tid < E) {
      const int k = tid / C;
      rot = cmulc(der[tid], s_unit[tid % C]);
      if (k >= half - pw && k <= half + pw) {
        ip = __fmul_rn(rot.x, rot.x);
        qp = __fmul_rn(rot.y, rot.y);
      }
    }
    __syncthreads();                    // every read of der is done
    if (tid < E) der[tid] = rot;        // der holds rot from here
    block_sum2(ip, qp, red);
    const bool shape_ok = qp <= 0.25f * ip;   // blank1.c:121
    if (tid == 0) {
      // the parabolic fit of the summed real parts around the centre
      float a[3];
      for (int m = 0; m < 3; ++m) {
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += der[(half - 1 + m) * C + c].x;
        a[m] = acc;
      }
      const float t3 = 2.0f * (__fadd_rn(a[0], a[2]) - 2.0f * a[1]);
      const float t4 = fabsf(t3) > 1e-20f ? (a[0] - a[2]) / t3 : 0.f;
      const float sign = t4 > 0.f ? 1.f : (t4 < 0.f ? -1.f : 0.f);
      const float frac = sign * sqrtf(0.5f * fabsf(t4));
      // clamped before the truncation, as XLA's conversion saturates
      float jf = __fadd_rn(__fmul_rn(static_cast<float>(nref),
                                     __fadd_rn(frac, 0.5f)), 0.5f);
      jf = fminf(fmaxf(jf, 0.f), static_cast<float>(nref - 1));
      s_j = static_cast<int>(jf);
      for (int c = 0; c < C; ++c) {
        const float re = der[half * C + c].x;
        s_coef[c] = make_float2(s_unit[c].x * re, s_unit[c].y * re);
      }
    }
    __syncthreads();
    // subtract coef * bank[j] (blank1.c:157-162); the new window's power
    if (tid < E) {
      const int k = tid / C;
      const float2 ref = refbank[static_cast<long long>(s_j) * pul + k];
      const float2 sub = cmul(ref, s_coef[tid % C]);
      const float2 w = win[tid];
      win[tid] = make_float2(w.x - sub.x, w.y - sub.y);
    }
    __syncthreads();
    float newp = 0.f, sn = 0.f, so = 0.f;
    if (tid < pul) {
      for (int c = 0; c < C; ++c) {
        const float2 w = win[tid * C + c];
        newp += __fadd_rn(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y));
      }
      sn = newp;
      so = oldp[tid];
    }
    block_sum2(sn, so, red);
    const bool success =
        shape_ok && sn / fmaxf(so, 1e-20f) <= 0.5f;   // blank1.c:188
    if (success) {
      if (tid < E) wk[static_cast<long long>(start) * C + tid] = win[tid];
      if (tid < pul) pk[start + tid] = newp;
    }
    fitted += success ? 1 : 0;
    __syncthreads();                    // the new powers are visible
    // retire +-pw around the candidate, refresh the candidate power of
    // the two blocks the window touches, and their maxima
    int b0 = p - half - pw;
    b0 = (b0 >= 0 ? b0 : b0 - blk + 1) / blk;   // floor division
    b0 = min(max(b0, 0), nblk - 2);
    const long long w0 = static_cast<long long>(b0) * blk;
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int q = tid; q < 2 * blk; q += kThreads) {
      const long long pos = w0 + q;
      const bool active = cand[pos] >= 0.f && llabs(pos - p) > pw;
      const float v = active ? pk[pos] : -1.0f;
      cand[pos] = v;
      if (q < blk) m0 = max_nan(m0, v); else m1 = max_nan(m1, v);
    }
    block_max2(m0, m1, red);
    if (tid == 0) { bmax[b0] = m0; bmax[b0 + 1] = m1; }
    __syncthreads();
  }
  if (tid == 0) nfit[r] = fitted;
}

}  // namespace

extern "C" int lrt_blanker_fits(void* wk, void* pk, void* cand,
                                const void* bmax0, const void* refbank,
                                const void* phasefunc, const void* thr,
                                void* nfit, long long bmax_stride,
                                long long ref_stride, long long pf_stride,
                                long long thr_stride, int T, int C, int nblk,
                                int pul, int nref, int pw, int max_pulses,
                                int streams, void* stream) {
  const int floats = ((nblk + 1) & ~1) + 2 * pul + 4 * pul * C + pul;
  const size_t smem = sizeof(float) * floats;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blanker_fits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  blanker_fits_kernel<<<streams, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(wk), static_cast<float*>(pk),
      static_cast<float*>(cand), static_cast<const float*>(bmax0),
      static_cast<const float2*>(refbank),
      static_cast<const float2*>(phasefunc), static_cast<const float*>(thr),
      static_cast<int*>(nfit), bmax_stride, ref_stride, pf_stride,
      thr_stride, T, C, nblk, pul, nref, pw, max_pulses);
  return static_cast<int>(cudaGetLastError());
}
