// Fused first FFT for Hopper (sm_90a): window -> FFT -> calibration
// multiply -> per-bin power sum over frames, in one launch.
//
// Replaces linrad_tpu/ops/pallas_fft.py:_fft1_kernel (the TPU kernel,
// launched by _fused_fft1_2d and entered through fused_fft1).  It computes
// what that kernel computes, not how: the TPU kernel took the DFT as four
// O(N^2) real matmuls because that suited the matrix unit, and carried the
// power sum across a sequential grid axis.
//
// What bounds it on an H100: memory traffic.  An FFT does about
// 5 N log2 N flop per frame, 2 to 3 flop per byte moved, far below the
// card's fp32 balance point (about 20 flop per byte).  Reading every input
// byte once and writing every output byte once at 3.35 TB/s takes
//     (64, 2048, 1)    2,129,920 bytes    0.64 us
//     (64, 4096, 2)    8,503,296 bytes    2.54 us
//     (2048, 2048, 1) 67,141,632 bytes   20.0  us
// and the first two lie under the cost of any kernel launch.
//
// The design:
//
// * One block takes whole frames.  A frame with its channels is one
//   contiguous run of N*C*8 bytes; a block reads it with 16-byte loads
//   (neighbouring threads on neighbouring addresses), multiplies by the
//   window on the way into shared memory, and writes the calibrated row
//   back with 16-byte stores.  Two channels go to two planes of shared
//   memory, so the transform itself never strides over channels.  (More
//   than two channels are cut into pairs, or single channels when C is
//   odd, along blockIdx.y; those read with a stride.)
// * Radix 8 in registers, radix 4 for what is left of log2 N: a thread
//   holds 8 points, and shared memory is touched only between passes.
//   128 = 8*4*4, 256 = 8*8*4, 512 = 8*8*8, 1024 = 8*8*4*4, 2048 = 8*8*8*4,
//   4096 = 8*8*8*8: three or four Stockham passes between two buffers, one
//   barrier each.  Twiddles come from float32 tables built in float64
//   (no __sinf, no fast math), one table per pass laid out so that a warp
//   reads neighbouring entries; the first pass needs none.
// * At 64 frames the kernel is a chain of waits, not a stream of bytes,
//   so what a phase needs from device memory is asked for before the
//   barrier in front of it: up to four 16-byte loads of the frame in
//   flight per thread, the next pass's twiddles fetched while the last
//   pass's stores settle, the calibration fetched before the last barrier,
//   the block's next frame asked into L2 by one bulk prefetch.
// * The exchange buffers are padded by one point in 16 (pad below): every
//   float2 access of every pass is then free of bank conflicts, but for
//   the second pass's stores (2-way).  A padded index is one shift and one
//   add, and a butterfly's other seven addresses follow by constants.
// * The kernel is compiled once per (N, channels per block), so every
//   stride, shift, table offset and trip count is a constant and the
//   passes are unrolled: at 2048 frames the kernel was bound by the
//   instructions it spent on addresses, not by memory.
// * The power sum needs no (B, N, C) scratch and no floating-point
//   atomics.  A block walks its frames_per_block frames in a loop (the
//   loop stands where the TPU had its sequential grid axis) and keeps the
//   running |Y|^2 row in shared memory with compensated (Kahan) addition.
//   Blocks are launched in clusters of 8: over distributed shared memory,
//   block r of a cluster adds the r-th eighth of the eight rows in rank
//   order.  One cluster writes the result straight away; more clusters
//   write one row each to scratch (B / (8 frames_per_block) rows instead
//   of B), an eighth per block; each block takes an integer ticket of its
//   rank, and of the blocks of one rank the one that draws the last
//   ticket adds that eighth of the rows in index order.  The
//   order of every addition is fixed by indices, never by which block ran
//   first, so the same input gives the same bits on every run; sellim's
//   per-bin classification downstream depends on that.
//
// Domain: N a power of two, 128 <= N <= 4096 (every size derive_geometry
// produces), any number of frames B and channels C.  frames, filtercorr
// and spec must be 16-byte aligned.  The host side (ops/fused_fft1.py)
// chooses channels per block, threads, frames per block and the grid, and
// owns the scratch rows and the ticket counters (zero before the first
// launch; the kernel leaves them zero).
//
// Plain C interface for ctypes; launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks per cluster, along x
constexpr int kMinLog2N = 7;
constexpr int kMaxLog2N = 12;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * (-i)
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// Index of point i inside a channel's plane of an exchange buffer.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }

// Forward 4-point DFT in place, natural order out.
__device__ __forceinline__ void dft4(float2& b0, float2& b1, float2& b2,
                                     float2& b3) {
  const float2 s0 = cadd(b0, b2);
  const float2 s1 = csub(b0, b2);
  const float2 s2 = cadd(b1, b3);
  const float2 s3 = mul_neg_i(csub(b1, b3));
  b0 = cadd(s0, s2);
  b1 = cadd(s1, s3);
  b2 = csub(s0, s2);
  b3 = csub(s1, s3);
}

// Forward 8-point DFT in place, natural order out: two 4-point DFTs of
// the even and odd points, then y[m] = E[m] + w8^m O[m], y[m+4] = E[m] -
// w8^m O[m] with w8 = exp(-2 pi i / 8).
__device__ __forceinline__ void dft8(float2 (&a)[8]) {
  dft4(a[0], a[2], a[4], a[6]);
  dft4(a[1], a[3], a[5], a[7]);
  const float h = 0.70710678118654752440f;
  const float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6];
  const float2 o0 = a[1];
  const float2 o1 = make_float2(h * (a[3].x + a[3].y), h * (a[3].y - a[3].x));
  const float2 o2 = mul_neg_i(a[5]);
  const float2 o3 = make_float2(h * (a[7].y - a[7].x),
                                -h * (a[7].x + a[7].y));
  a[0] = cadd(e0, o0);
  a[1] = cadd(e1, o1);
  a[2] = cadd(e2, o2);
  a[3] = cadd(e3, o3);
  a[4] = csub(e0, o0);
  a[5] = csub(e1, o1);
  a[6] = csub(e2, o2);
  a[7] = csub(e3, o3);
}

// What is fixed by the transform size N = 2^LOG2N and the channels CH a
// block takes (1 or 2): a thread does one radix-8 butterfly of a pass, or
// two of radix 4, and moves kVecs 16-byte vectors of a frame.
template <int LOG2N, int CH>
struct Cfg {
  static constexpr int kLog2N = LOG2N;
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kRow = kN * CH;
  static constexpr int kThreads = (kRow / 8 < 32) ? 32 : kRow / 8;
  static constexpr int kMinBlocks = 1024 / kThreads;  // 64 registers each
  static constexpr int kVecs = kRow / 2;
  static constexpr int kVecsPerThread = (kVecs + kThreads - 1) / kThreads;
  static constexpr int kRem = LOG2N % 3;
  static constexpr int kNum8 = LOG2N / 3 - (kRem == 1 ? 1 : 0);
  static constexpr int kPasses =
      kNum8 + (kRem == 0 ? 0 : (kRem == 2 ? 1 : 2));
  static constexpr int kPlane = pad(kN);  // float2 per channel plane
  static constexpr int kSmemBytes = 2 * CH * kPlane * 8 + 2 * kRow * 4;

  __host__ __device__ static constexpr int radix(int s) {
    return s < kNum8 ? 8 : 4;
  }
  // log2 of the product of the radices before pass s
  __host__ __device__ static constexpr int log2p(int s) {
    return s < kNum8 ? 3 * s : 3 * kNum8 + 2 * (s - kNum8);
  }
  // Where pass s's twiddle table starts.  The table of pass s >= 1, of
  // radix R after passes of product p, holds exp(-2 pi i r k / (p R)) at
  // [k (R - 1) + r - 1] for k < p, r = 1..R-1.
  __host__ __device__ static constexpr int table(int s) {
    int off = 0;
    for (int t = 1; t < s; ++t) off += (radix(t) - 1) << log2p(t);
    return off;
  }
};

// Twiddles of one pass, for the butterflies this thread does in it: one
// of radix 8 (7 factors) or two of radix 4 (3 factors each).
struct PassTwiddles {
  float2 w[7];
};

// A thread fetches its factors before the barrier in front of the pass.
template <class C, int S>
__device__ __forceinline__ void load_twiddles(
    PassTwiddles& t, const float2* __restrict__ twiddle) {
  constexpr int R = C::radix(S);
  constexpr int kMask = (1 << C::log2p(S)) - 1;
  constexpr int kItems = C::kRow / R;
  constexpr bool kFull = (kItems == (8 / R) * C::kThreads);
  const float2* tab = twiddle + C::table(S);
#pragma unroll
  for (int i = 0; i < 8 / R; ++i) {
    const int it = threadIdx.x + i * C::kThreads;
    if (kFull || it < kItems) {
      const float2* row = tab + (it & kMask) * (R - 1);
#pragma unroll
      for (int r = 0; r < R - 1; ++r) t.w[(R - 1) * i + r] = __ldg(row + r);
    }
  }
}

// Pass S of the Stockham transform over the channel planes of src into
// dst.  p is the product of the radices of the passes before it.
// Butterfly j of a plane reads points j + r n/R, multiplies point r by
// exp(-2 pi i r k / (p R)) with k = j mod p (the first pass has p = 1 and
// multiplies nothing), and writes its outputs to (j - k) R + k + r p.
template <class C, int S>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ src,
                                         float2* __restrict__ dst,
                                         const PassTwiddles& t) {
  constexpr int R = C::radix(S);
  constexpr int kLogR = (R == 8) ? 3 : 2;
  constexpr int kLogP = C::log2p(S);
  constexpr int P = 1 << kLogP;
  constexpr int kLogQ = C::kLog2N - kLogR;
  constexpr int Q = 1 << kLogQ;
  constexpr int kItems = C::kRow / R;
  constexpr bool kFull = (kItems == (8 / R) * C::kThreads);
  static_assert(Q % 16 == 0, "a butterfly's reads lie whole pads apart");
  static_assert(P == 1 || P == 8 || P % 16 == 0, "store offsets");
#pragma unroll
  for (int i = 0; i < 8 / R; ++i) {
    const int it = threadIdx.x + i * C::kThreads;
    if (kFull || it < kItems) {
      const int plane = (it >> kLogQ) * C::kPlane;
      const int j = it & (Q - 1);
      const int k = j & (P - 1);
      const float2* in = src + plane + pad(j);
      float2 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = in[r * pad(Q)];
      if (S > 0) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          a[r] = cmul(a[r], t.w[(R - 1) * i + r - 1]);
        }
      }
      if constexpr (R == 8) {
        dft8(a);
      } else {
        dft4(a[0], a[1], a[2], a[3]);
      }
      // pad(base + r p) = pad(base) + a constant in r: base is a multiple
      // of 8 when p = 1, and base mod 16 < 8 when p = 8
      float2* out = dst + plane + pad(((j - k) << kLogR) + k);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[P == 1 ? r : (P == 8 ? 8 * r + (r >> 1) : r * pad(P))] = a[r];
      }
    }
  }
}

// Passes S.. of a frame; before each barrier, what the next phase reads
// from device memory is asked for: the next pass's twiddles, or (after
// the last pass) whatever `before_last_barrier` fetches.
template <class C, int S, class F>
__device__ __forceinline__ void run_passes(float2* src, float2* dst,
                                           PassTwiddles& t,
                                           const float2* __restrict__ twiddle,
                                           F&& before_last_barrier) {
  if constexpr (S < C::kPasses) {
    fft_pass<C, S>(src, dst, t);
    if constexpr (S + 1 < C::kPasses) {
      // pass 1's twiddles came with the frame
      if constexpr (S > 0) load_twiddles<C, S + 1>(t, twiddle);
    } else {
      before_last_barrier();
    }
    __syncthreads();
    run_passes<C, S + 1>(dst, src, t, twiddle, before_last_barrier);
  }
}

// Grid (clusters * 8, C / CH); block x takes frames [x fpb, (x + 1) fpb)
// and channels [y CH, (y + 1) CH).  Layouts are those of the wrapper:
// frames/spec (B, N, C), window (N,), filtercorr (N, C), pow_sum (N, C),
// twiddle: the passes' tables one after the other, scratch
// (clusters, N, C), tickets (C / CH, 8).  Dynamic shared memory: two
// exchange buffers of CH padded planes, then the running power row and
// its Kahan compensation, N CH float each.
template <int LOG2N, int CH>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(
    Cfg<LOG2N, CH>::kThreads, Cfg<LOG2N, CH>::kMinBlocks)
    fused_fft1_kernel(const float2* __restrict__ frames,
                      const float* __restrict__ window,
                      const float2* __restrict__ filtercorr,
                      const float2* __restrict__ twiddle,
                      float2* __restrict__ spec, float* __restrict__ pow_sum,
                      float* scratch, unsigned int* tickets, int b, int c,
                      int frames_per_block, int clusters) {
  using C = Cfg<LOG2N, CH>;
  constexpr int kN = C::kN;
  constexpr int kRow = C::kRow;
  constexpr int kT = C::kThreads;
  constexpr int kV = C::kVecsPerThread;
  constexpr bool kExact = (C::kVecs % kT == 0);
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * CH;
  float2* buf_a = reinterpret_cast<float2*>(smem4);
  float2* buf_b = buf_a + CH * C::kPlane;
  float* psum = reinterpret_cast<float*>(buf_b + CH * C::kPlane);
  float* pcomp = psum + kRow;
  float2* psum2 = reinterpret_cast<float2*>(psum);
  float2* pcomp2 = reinterpret_cast<float2*>(pcomp);
  // CH == 2: 16 bytes are one point of two channels.  CH == 1: with
  // C == 1, 16 bytes are two points of the one channel; with an odd
  // C > 1 a thread moves single points of 8 bytes, strided (the slow way)
  const bool strided = (CH == 1 && c != 1);
  // vector v of a frame lies at float2 offset v vstride of the frame's
  // (and of filtercorr's) first point of channel c0
  const int vstride = (CH == 2) ? c : 2;

  // the twiddle tables (under N entries, 16 to a line) are wanted in L1
  if (tid < (kN >> 4)) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(twiddle + tid * 16));
  }

  // the final buffer of a frame: buf_a after an even count of passes
  float2* fin = (C::kPasses % 2 == 0) ? buf_a : buf_b;

  for (int g = 0; g < frames_per_block; ++g) {
    const int f = blockIdx.x * frames_per_block + g;
    if (f >= b) break;
    const size_t fbase = (size_t)f * kN * c + c0;
    PassTwiddles tw;
    // the block's next frame (one run of bytes when the block has all the
    // channels) is asked into L2 while this one is worked on
    if (c == CH && g + 1 < frames_per_block && f + 1 < b && tid == 0) {
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                       frames + fbase + (size_t)kN * c),
                   "r"(kRow * 8)
                   : "memory");
    }

    if (!strided) {
      float4 x[kV];
      float2 w[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int v = tid + i * kT;
        if (kExact || v < C::kVecs) {
          x[i] = __ldcg(reinterpret_cast<const float4*>(
              frames + fbase + (size_t)v * vstride));
          if constexpr (CH == 2) {
            w[i].x = __ldg(window + v);
            w[i].y = w[i].x;
          } else {
            w[i] = __ldg(reinterpret_cast<const float2*>(window) + v);
          }
        }
      }
      // the second pass's twiddles travel beside the frame
      load_twiddles<C, 1>(tw, twiddle);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int v = tid + i * kT;
        if (kExact || v < C::kVecs) {
          const float2 p0 = make_float2(x[i].x * w[i].x, x[i].y * w[i].x);
          const float2 p1 = make_float2(x[i].z * w[i].y, x[i].w * w[i].y);
          if constexpr (CH == 2) {
            buf_a[pad(v)] = p0;
            buf_a[C::kPlane + pad(v)] = p1;
          } else {
            buf_a[pad(2 * v)] = p0;  // 2 v + 1 shares its pad
            buf_a[pad(2 * v) + 1] = p1;
          }
        }
      }
    } else {
      load_twiddles<C, 1>(tw, twiddle);
      for (int i = tid; i < kN; i += kT) {
        const float2 x = __ldcg(frames + fbase + (size_t)i * c);
        const float w = __ldg(window + i);
        buf_a[pad(i)] = make_float2(x.x * w, x.y * w);
      }
    }
    __syncthreads();

    float4 fc[kV];
    run_passes<C, 0>(buf_a, buf_b, tw, twiddle, [&]() {
      if (!strided) {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const int v = tid + i * kT;
          if (kExact || v < C::kVecs) {
            fc[i] = __ldg(reinterpret_cast<const float4*>(
                filtercorr + c0 + (size_t)v * vstride));
          }
        }
      }
    });

    // calibration, the spectrum's store, and this frame's |Y|^2 into the
    // running row; a thread meets the same row elements in every frame
    if (!strided) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int v = tid + i * kT;
        if (kExact || v < C::kVecs) {
          const int i0 = (CH == 2) ? pad(v) : pad(2 * v);
          const int i1 = (CH == 2) ? C::kPlane + pad(v) : pad(2 * v) + 1;
          const float2 z0 = cmul(fin[i0], make_float2(fc[i].x, fc[i].y));
          const float2 z1 = cmul(fin[i1], make_float2(fc[i].z, fc[i].w));
          *reinterpret_cast<float4*>(spec + fbase + (size_t)v * vstride) =
              make_float4(z0.x, z0.y, z1.x, z1.y);
          const float q0 = z0.x * z0.x + z0.y * z0.y;
          const float q1 = z1.x * z1.x + z1.y * z1.y;
          if (g == 0) {  // the row starts here
            psum2[v] = make_float2(q0, q1);
            if (frames_per_block > 1) pcomp2[v] = make_float2(0.0f, 0.0f);
          } else {
            float2 sum = psum2[v];
            float2 cp = pcomp2[v];
            kahan_add(sum.x, cp.x, q0);
            kahan_add(sum.y, cp.y, q1);
            psum2[v] = sum;
            pcomp2[v] = cp;
          }
        }
      }
    } else {
      for (int i = tid; i < kN; i += kT) {
        const float2 z =
            cmul(fin[pad(i)], __ldg(filtercorr + c0 + (size_t)i * c));
        spec[fbase + (size_t)i * c] = z;
        if (g == 0) {
          psum[i] = z.x * z.x + z.y * z.y;
          pcomp[i] = 0.0f;
        } else {
          kahan_add(psum[i], pcomp[i], z.x * z.x + z.y * z.y);
        }
      }
    }
    __syncthreads();
  }

  // a block past the last frame offers a row of zeros
  if (blockIdx.x * frames_per_block >= b) {
    for (int q = tid; q < kRow; q += kT) psum[q] = 0.0f;
  }

  // Sum over the cluster's eight rows: block `rank` adds its eighth of
  // the row, rank 0's row first.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cluster_id = blockIdx.x / kCluster;
  constexpr int kSlice = kRow / kCluster;
  const int lo = rank * kSlice;
  cluster.sync();
  const float* rows[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    rows[r] = cluster.map_shared_rank(psum, r);
  }
  float* out_row =
      (clusters == 1) ? pow_sum : scratch + (size_t)cluster_id * kN * c;
  for (int q = lo + tid; q < lo + kSlice; q += kT) {
    float sum = 0.0f;
    float cp = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) kahan_add(sum, cp, rows[r][q]);
    out_row[(size_t)(q / CH) * c + c0 + (q % CH)] = sum;
  }
  // this block reads no other block's row from here on; none may leave
  // before all have said so (the wait is at the end)
  cluster.barrier_arrive();

  if (clusters > 1) {
    // One row per cluster lies in scratch, written an eighth per block.
    // Of the blocks of one rank, the one that draws the last ticket adds
    // that eighth of the rows in index order.
    unsigned int* ticket = tickets + blockIdx.y * kCluster + rank;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = (atomicAdd(ticket, 1u) == (unsigned int)clusters - 1u);
      if (is_last) *ticket = 0u;  // left zero for the next launch
    }
    __syncthreads();
    if (is_last) {
      __threadfence();
      for (int q = lo + tid; q < lo + kSlice; q += kT) {
        const size_t o = (size_t)(q / CH) * c + c0 + (q % CH);
        float sum = 0.0f;
        float cp = 0.0f;
        for (int r = 0; r < clusters; ++r) {
          kahan_add(sum, cp, __ldcg(scratch + (size_t)r * kN * c + o));
        }
        pow_sum[o] = sum;
      }
    }
  }
  cluster.barrier_wait();
}

__global__ void empty_kernel() {}

// Launches the instantiation for (LOG2N, CH), after allowing it its
// dynamic shared memory once per device.
template <int LOG2N, int CH>
int launch(const float2* frames, const float* window,
           const float2* filtercorr, const float2* twiddle, float2* spec,
           float* pow_sum, float* scratch, unsigned int* tickets, int b,
           int c, int threads, int frames_per_block, int grid_x,
           int smem_bytes, cudaStream_t stream) {
  using C = Cfg<LOG2N, CH>;
  static bool smem_allowed[kMaxDevices] = {};
  if (threads != C::kThreads || smem_bytes != C::kSmemBytes) {
    return (int)cudaErrorInvalidValue;  // the host's plan is another one
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !smem_allowed[dev]) {
    e = cudaFuncSetAttribute(fused_fft1_kernel<LOG2N, CH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) smem_allowed[dev] = true;
  }
  fused_fft1_kernel<LOG2N, CH>
      <<<dim3(grid_x, c / CH), C::kThreads, C::kSmemBytes, stream>>>(
          frames, window, filtercorr, twiddle, spec, pow_sum, scratch,
          tickets, b, c, frames_per_block, grid_x / kCluster);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float2*, const float*, const float2*,
                         const float2*, float2*, float*, float*,
                         unsigned int*, int, int, int, int, int, int,
                         cudaStream_t);

template <int CH>
LaunchFn launch_for(int log2n) {
  switch (log2n) {
    case 7: return launch<7, CH>;
    case 8: return launch<8, CH>;
    case 9: return launch<9, CH>;
    case 10: return launch<10, CH>;
    case 11: return launch<11, CH>;
    case 12: return launch<12, CH>;
    default: return nullptr;
  }
}

}  // namespace

// ch channels per block (1 or 2, dividing c), `threads` per block and
// smem_bytes as the kernel for (n, ch) has them, frames_per_block frames
// per block, grid_x blocks along x (a multiple of 8, at least
// b / frames_per_block rounded up).
extern "C" int lrt_fused_fft1(const void* frames, const void* window,
                              const void* filtercorr, const void* twiddle,
                              void* spec, void* pow_sum, void* scratch,
                              void* tickets, int b, int n, int c, int ch,
                              int threads, int frames_per_block, int grid_x,
                              int smem_bytes, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n || log2n < kMinLog2N || log2n > kMaxLog2N ||
      (ch != 1 && ch != 2) || c < 1 || c % ch != 0 ||
      grid_x % kCluster != 0 || frames_per_block < 1 ||
      (long long)grid_x * frames_per_block < b) {
    return (int)cudaErrorInvalidValue;
  }
  const LaunchFn fn = (ch == 2) ? launch_for<2>(log2n) : launch_for<1>(log2n);
  return fn(static_cast<const float2*>(frames),
            static_cast<const float*>(window),
            static_cast<const float2*>(filtercorr),
            static_cast<const float2*>(twiddle), static_cast<float2*>(spec),
            static_cast<float*>(pow_sum), static_cast<float*>(scratch),
            static_cast<unsigned int*>(tickets), b, c, threads,
            frames_per_block, grid_x, smem_bytes,
            static_cast<cudaStream_t>(stream));
}

// A kernel that does nothing, for timing what any launch costs.
extern "C" int lrt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
