// mix1's fractional-bin ramp for sm_90a: the residual-frequency phase ramp
// of set_mix1_phases (mix1.c:141-234) on the timf3 output, and the phase it
// carries to the next step, one block a row, all rows in one launch.
//
// It replaces no TPU kernel.  The JAX package forms the ramp with
// jnp.cumsum and jnp.sum, which XLA's CPU backend takes in a blocked order;
// the port takes the same order (linrad_tpu_torch/utils/fporder.py) because
// mix2 amplifies the ramp's rounding at the band edges.  As PyTorch
// operations that order costs about 130 launches a step: a Python loop of
// single additions on strided columns, blocks of 16 for the prefix sum and
// of 32 for the sum, and the stacks, repeat, remainder, cos, sin and
// complex around them.  The plain version, _frac_ramp_reference in
// linrad_tpu_torch/ops/mix1.py, is those operations unchanged.
//
// What bounds it: a row reads its fraction (one a frame on the AFC path)
// and writes 8 bytes a sample and one phase: 32 KiB at 4,096 samples,
// 0.00001 ms at the card's memory rate.  The rest is latency: one launch,
// the dependent additions of the sums' levels, a barrier a level, and the
// cosines and sines.  So the serial chains run side by side, each on a
// thread of its own (the prefix's blocks from thread 0 up, the sum's from
// the last thread down), every level above the first stays in shared
// memory (404 words at 4,096 samples), and the angles, cosines and sines,
// which need no order, run on every thread of the block: the first pass
// parks each sample's block prefix and increment in the sample's place of
// the output (read back by the same block after a barrier), and the last
// pass turns them into the ramp, neighbouring threads on neighbouring
// samples.
//
// The order, for a row of L samples x[i] (each frame's fraction over m,
// repeated hop times; with a slope formed in float64 and rounded once):
//
// - Prefix sum (ordered_cumsum): level 0 is x in blocks of 16, zero-padded
//   at the end; each block's sequential prefix, and its total into level 1.
//   Level k (more than 16 values) is scanned the same way into level k + 1;
//   the last level (at most 16 values) is a sequential prefix.  Then, from
//   the top down, each block of a level adds the inclusive prefix of the
//   level above at the block before it (0 for the first block).  A row of
//   at most 16 samples is one sequential prefix with nothing added.
// - Sum (ordered_sum): while more than 32 values are left, they are
//   zero-padded to a multiple of 32, the smaller half of the padding in
//   front, and each block of 32 summed in sequence; then the last values in
//   sequence.
//
// Threads: ceil(L / 4) rounded up to a warp, 32 to 1,024 a block; thread
// t owns the prefix blocks t, t + threads, ... of every level (at L =
// 4,096, 256 threads a run of 16 each), and the sum's blocks are taken
// from the last thread down (128 threads a run of 32), so that both
// levels' chains run side by side.  One thread scans the prefix's last
// level and another sums the sum's.  The last pass gives each thread the
// samples t, t + threads, ... (4 at 4,096).
//
// Exactness: each float step is the one correctly rounded operation that
// PyTorch's CUDA kernel performs for the plain version's expression, with
// __f*_rn intrinsics so that nvcc contracts nothing into an FMA.  A Python
// scalar divisor is its reciprocal's product on the card (torch's
// div_true_kernel_cuda), so the wrapper hands 1/m and 1/hop as floats;
// remainder is torch's for floats (fmodf, then + 1 where the result is
// negative and not 0); -2 pi is the float of the double; cosf and sinf
// without fast math are torch's cos and sin.  chip_smoke.py's phase 3b
// probes each of these against torch on the card.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kPrefix = 16;                 // utils/fporder.PREFIX_BLOCK
constexpr int kSum = 32;                    // utils/fporder.SUM_BLOCK
constexpr int kMaxLen = 1 << 19;            // samples a row
constexpr int kLevels = 8;                  // enough levels for kMaxLen
constexpr int kMaxThreads = 1024;
constexpr int kSharedDefault = 48 * 1024;   // without an opt-in
constexpr float kMinusTwoPi = static_cast<float>(-6.283185307179586);

// The levels of a row of len samples and their offsets in shared memory.
struct Plan {
  int np;              // prefix levels above level 0: 1 .. np
  int n[kLevels];      // n[0] = len, n[k + 1] = ceil(n[k] / 16)
  int off[kLevels];    // level k's first word (k >= 1)
  int ns;              // sum levels above level 0: 1 .. ns
  int s[kLevels];      // s[0] = len, s[k + 1] = ceil(s[k] / 32)
  int soff[kLevels];
  int words;
};

__host__ __device__ Plan make_plan(int len) {
  Plan p{};
  int w = 0;
  p.n[0] = len;
  while (p.n[p.np] > kPrefix) {
    p.n[p.np + 1] = (p.n[p.np] + kPrefix - 1) / kPrefix;
    p.off[++p.np] = w;
    w += p.n[p.np];
  }
  p.s[0] = len;
  while (p.s[p.ns] > kSum) {
    p.s[p.ns + 1] = (p.s[p.ns] + kSum - 1) / kSum;
    p.soff[++p.ns] = w;
    w += p.s[p.ns];
  }
  p.words = w;
  return p;
}

int threads_for(int len) {
  const int t = ((len + 3) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

struct Args {
  const float* fp;        // the rows' phases, fp_r apart
  long long fp_r;
  const float* fr;        // fractions (rows, frames), fr_r and fr_f apart
  long long fr_r, fr_f;
  const float* sl;        // slopes likewise, or nullptr
  long long sl_r, sl_f;
  float2* ramp;           // (rows, len) complex64
  float* phase;           // (rows,)
  int hop;
  float inv_m, inv_hop;   // the float reciprocals of m and hop
};

// A sample's frame f and place j in it, stepped along the row.
struct Cursor {
  int f, j;
  __device__ Cursor(int i, int hop) : f(i / hop), j(i - i / hop * hop) {}
  __device__ void next(int hop) {
    if (++j == hop) {
      j = 0;
      ++f;
    }
  }
};

// x[i]: frame f's fraction over m; with a slope, the fraction plus the
// slope over m times the sample's place j in the frame, (j + 0.5) / hop -
// 0.5, formed in float64 and rounded once.
__device__ __forceinline__ float per_sample(const Args& a, const float* fr,
                                            const float* sl, Cursor c) {
  const int f = c.f, j = c.j;
  const float frac = __fmul_rn(__ldg(fr + f * a.fr_f), a.inv_m);
  if (sl == nullptr) return frac;
  const float slope = __fmul_rn(__ldg(sl + f * a.sl_f), a.inv_m);
  const float pos = __fsub_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(j), 0.5f), a.inv_hop), 0.5f);
  return __double2float_rn(__dadd_rn(
      static_cast<double>(frac),
      __dmul_rn(static_cast<double>(slope), static_cast<double>(pos))));
}

// torch.remainder(x, 1.0) for a float
__device__ __forceinline__ float wrap(float x) {
  float mod = fmodf(x, 1.0f);
  if (mod != 0.0f && mod < 0.0f) mod = __fadd_rn(mod, 1.0f);
  return mod;
}

// inclusive prefix of v[16 b ..] in place, the values past n as 0; returns
// the block's total
__device__ __forceinline__ float block_prefix(float* v, int b, int n) {
  const int i0 = b * kPrefix;
  float acc = v[i0];
  for (int q = 1; q < kPrefix; ++q) {
    const int i = i0 + q;
    acc = __fadd_rn(acc, i < n ? v[i] : 0.0f);
    if (i < n) v[i] = acc;
  }
  return acc;
}

// the sequential sum of block j of 32 of v[0 .. n), padded lo in front
__device__ __forceinline__ float block_sum(const float* v, int j, int n,
                                           int lo) {
  float acc = 0.0f;
  for (int q = 0; q < kSum; ++q) {
    const int p = j * kSum + q - lo;
    const float x = p >= 0 && p < n ? v[p] : 0.0f;
    acc = q == 0 ? x : __fadd_rn(acc, x);
  }
  return acc;
}

__device__ __forceinline__ int pad_front(int n) {
  return (kSum - n % kSum) % kSum / 2;
}

__global__ void __launch_bounds__(kMaxThreads)
mix1_ramp_kernel(Args a, Plan p) {
  extern __shared__ float sh[];
  const int t = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x;
  const float* fr = a.fr + row * a.fr_r;
  const float* sl = a.sl == nullptr ? nullptr : a.sl + row * a.sl_r;
  const int len = p.n[0];
  float2* out = a.ramp + row * len;
  const int last = nt - 1 - t;          // the sum's blocks from the top down

  // level 0: each prefix block's sequential prefix and increments parked
  // in the output, its total (the padding added as 0) to level 1; the
  // sum's blocks
  const int blocks = p.np > 0 ? p.n[1] : 1;
  for (int b = t; b < blocks; b += nt) {
    const int i0 = b * kPrefix;
    Cursor c(i0, a.hop);
    float acc = 0.0f;
    for (int q = 0; q < kPrefix; ++q) {
      const int i = i0 + q;
      if (i < len) {
        const float x = per_sample(a, fr, sl, c);
        c.next(a.hop);
        acc = q == 0 ? x : __fadd_rn(acc, x);
        out[i] = make_float2(acc, x);
      } else {
        acc = __fadd_rn(acc, 0.0f);
      }
    }
    if (p.np > 0) sh[p.off[1] + b] = acc;
  }
  if (p.ns > 0) {
    const int lo = pad_front(len);
    for (int j = last; j < p.s[1]; j += nt) {
      const int i0 = j * kSum - lo;
      Cursor c(i0 > 0 ? i0 : 0, a.hop);
      float acc = 0.0f;
      for (int q = 0; q < kSum; ++q) {
        const int i = i0 + q;
        float x = 0.0f;
        if (i >= 0 && i < len) {
          x = per_sample(a, fr, sl, c);
          c.next(a.hop);
        }
        acc = q == 0 ? x : __fadd_rn(acc, x);
      }
      sh[p.soff[1] + j] = acc;
    }
  }
  __syncthreads();

  // levels 1 and up: prefix level k's blocks in place, totals to k + 1;
  // sum level k's blocks to k + 1
  const int up = p.np > p.ns ? p.np : p.ns;
  for (int k = 1; k < up; ++k) {
    if (k < p.np) {
      float* v = sh + p.off[k];
      for (int b = t; b < p.n[k + 1]; b += nt)
        sh[p.off[k + 1] + b] = block_prefix(v, b, p.n[k]);
    }
    if (k < p.ns) {
      const int lo = pad_front(p.s[k]);
      for (int j = last; j < p.s[k + 1]; j += nt)
        sh[p.soff[k + 1] + j] = block_sum(sh + p.soff[k], j, p.s[k], lo);
    }
    __syncthreads();
  }

  // the prefix's last level in sequence; the sum's last values in
  // sequence, and the new phase
  if (t == 0 && p.np > 0) {
    float* v = sh + p.off[p.np];
    for (int i = 1; i < p.n[p.np]; ++i) v[i] = __fadd_rn(v[i - 1], v[i]);
  }
  const float fp = __ldg(a.fp + row * a.fp_r);
  if (t == nt - 1) {
    float acc = 0.0f;
    if (p.ns > 0) {
      const float* v = sh + p.soff[p.ns];
      acc = v[0];
      for (int i = 1; i < p.s[p.ns]; ++i) acc = __fadd_rn(acc, v[i]);
    } else {
      Cursor c(0, a.hop);
      for (int i = 0; i < len; ++i) {
        const float x = per_sample(a, fr, sl, c);
        c.next(a.hop);
        acc = i == 0 ? x : __fadd_rn(acc, x);
      }
    }
    a.phase[row] = wrap(__fadd_rn(fp, acc));
  }
  __syncthreads();

  // from the top down: each block adds the prefix of the level above at
  // the block before it
  for (int k = p.np - 1; k >= 1; --k) {
    float* v = sh + p.off[k];
    const float* u = sh + p.off[k + 1];
    for (int i = t; i < p.n[k]; i += nt) {
      const int b = i / kPrefix;
      v[i] = __fadd_rn(v[i], b > 0 ? u[b - 1] : 0.0f);
    }
    __syncthreads();
  }

  // every sample: its block prefix plus the prefix before its block (a row
  // of one block adds nothing), cum = (phase + prefix) - x, the wrapped
  // angle, its cosine and sine
  for (int i = t; i < len; i += nt) {
    const float2 parked = out[i];
    const int b = i / kPrefix;
    const float pre = p.np > 0
        ? __fadd_rn(parked.x, b > 0 ? sh[p.off[1] + b - 1] : 0.0f)
        : parked.x;
    const float theta = __fmul_rn(
        kMinusTwoPi, wrap(__fsub_rn(__fadd_rn(fp, pre), parked.y)));
    out[i] = make_float2(cosf(theta), sinf(theta));
  }
}

// torch's float operations as the ramp takes them, one value a thread:
// remainder(x, 1), -2 pi times x, cos x, sin x
__global__ void mix1_ramp_probe_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  out[4 * i] = wrap(v);
  out[4 * i + 1] = __fmul_rn(kMinusTwoPi, v);
  out[4 * i + 2] = cosf(v);
  out[4 * i + 3] = sinf(v);
}

}  // namespace

extern "C" int lrt_mix1_ramp_max_len() { return kMaxLen; }

// The shared words a row of len samples takes (the wrapper's plan checks
// its own against it).
extern "C" int lrt_mix1_ramp_words(int len) { return make_plan(len).words; }

// rows rows of len = frames * hop samples: fp (rows,) float32 fp_r apart;
// fr and sl (rows, frames) float32 at (row, frame) strides, sl nullptr
// without a slope; ramp (rows, len) complex64 and phase (rows,) written.
extern "C" int lrt_mix1_ramp(const void* fp, long long fp_r, const void* fr,
                             long long fr_r, long long fr_f, const void* sl,
                             long long sl_r, long long sl_f, void* ramp,
                             void* phase, int rows, int frames, int hop,
                             float inv_m, float inv_hop, void* stream) {
  if (rows < 1 || frames < 1 || hop < 1 ||
      static_cast<long long>(frames) * hop > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const int len = frames * hop;
  const Plan p = make_plan(len);
  const size_t bytes = sizeof(float) * p.words;
  if (bytes > kSharedDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        mix1_ramp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{static_cast<const float*>(fp), fp_r,
               static_cast<const float*>(fr), fr_r, fr_f,
               static_cast<const float*>(sl), sl_r, sl_f,
               static_cast<float2*>(ramp), static_cast<float*>(phase), hop,
               inv_m, inv_hop};
  mix1_ramp_kernel<<<rows, threads_for(len), bytes,
                     static_cast<cudaStream_t>(stream)>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// out (n, 4) float32: wrap, -2 pi x, cos and sin of each x as the ramp's
// kernel computes them
extern "C" int lrt_mix1_ramp_probe(const void* x, void* out, int n,
                                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  mix1_ramp_probe_kernel<<<(n + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
