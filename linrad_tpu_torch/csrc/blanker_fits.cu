// The clever blanker's sequential fit-and-subtract loop for sm_90a: two
// launches per call, a wide one that prepares the stream and a one-warp
// one per stream that runs every fit.
//
// Replaces the jax.lax.fori_loop of linrad_tpu/ops/blanker.py:322
// (_clever_blanker_blocked, :269-324, with the fit of _fit_subtract,
// :229-266), which XLA runs as one loop on the device; the port's plain
// version is _blanker_fits_reference in linrad_tpu_torch/ops/blanker.py.
//
// What bounds it: each fit depends on the one before (a subtraction
// changes the data under the next search), so the call's time is the
// latency of one fit times the fits run, not bytes or operations.  The
// bytes the call must move (the padded stream, its power and candidate
// power: 1.9 MB at the flagship's 65,792 samples) take 0.00055 ms at the
// card's memory rate, a tenth of one fit of the kernel this one replaced
// (5.2 us on an H100, 31 fits at the flagship).  A fit is one warp's chain
// of dependent steps: its reductions, its shared-memory reads, its round
// trip to L2.  The design keeps that chain short:
//
// - The candidates are an active bit per sample and a two-level index of
//   maxima: of every sub-block of W = 32 samples (W doubles only where the
//   index would not fit) and of every group of 32 sub-blocks.  A sample's
//   candidate power is its power where the bit is set, -1 elsewhere: the
//   JAX loop's candidate array equals that at every iteration (the power
//   changes only inside a fit's window, and its refresh rewrites the two
//   blocks around the window from the power), so no second array is
//   kept.  The maxima are held as ordered integer keys (NaN above every
//   number), so that a warp's argmax is two redux.sync instructions: the
//   largest key, then the lowest index that holds it.  The first maximal
//   group, its first maximal sub-block and that sub-block's first maximal
//   sample are the first maximal sample of the stream, as torch.argmax
//   and the JAX loop's two argmaxes pick it.
// - blanker_prep_kernel, one block per group and stream: the working
//   copies of the stream and its power (the outputs, updated in place by
//   the fits), the bits and the keys, into a scratch buffer.
// - blanker_fits_kernel, one warp per stream: one bulk asynchronous copy
//   (cp.async.bulk, completed on an mbarrier) brings the pulse bank
//   (256 x 64 complex, 128 KB), the phase function and the keys into
//   shared memory.  A fit: the group, then the sub-block; one bulk copy of
//   the rows of the stream and its power that the sub-block implies
//   (every row the fit reads or writes lies in the whole sub-blocks
//   around [s0 - pul/2, s0 + W - 1 - pul/2 + pul): 96 rows at pul 64), the
//   bits of those rows in plain loads beside it; then the sample, the fit
//   on the staged rows, the window written back to global memory without
//   waiting, and the touched sub-blocks' and groups' keys rebuilt.  One
//   round trip to L2 a fit, and no block-wide barrier.
// - A window written to global memory reaches a later bulk copy only
//   after a proxy fence.  Rather than fence every fit, the last kRing
//   windows written are kept in shared memory and patched over any staged
//   rows they overlap; the warp fences when the ring is full.
// - With pul 64 and one or two channels (every preset) the window's shape
//   is known at compile time: each lane holds 2 or 4 samples of one
//   channel, and the per-channel phase, the parabola's three sums and the
//   row powers pass through registers and shuffles.  Other shapes use the
//   general instance, which passes them through shared memory: at the
//   flagship's arguments it takes 4.05 us a fit against 2.60 (an H100,
//   chip_smoke.py phase 3b), which is why both are kept.
// - The arithmetic and every decision are those of the plain version, as
//   in the kernel this one replaced: the argument of the bank row j is
//   rounded without fused multiply-adds, clamped before the truncation
//   (XLA's conversion saturates), and the power sums round as the plain
//   version's do; only the order of the sums over lanes differs.
// - The loop stops at the first fit whose candidate is at or under the
//   threshold: from there every iteration of the JAX loop is a masked
//   no-op.  A NaN candidate is not such a stop: it fits nothing, the JAX
//   loop's refresh (cand >= 0) retires the NaNs of the two blocks around
//   it, and the loop goes on (retire_nans).  Under torch.func.vmap over R
//   streams the grids have R rows.
//
// Shared memory: the bank (nref x pul x 8 bytes), the phase function, the
// keys (4 bytes per W samples, and per 32 W), the staged rows, the ring
// and the fit's scratch: 149,088 bytes at the flagship (65,792 samples),
// 174,432 at WCW (262,400 samples, one channel) of the 232,448 a block may
// have on an H100.  Past that the bank stays in global memory and a fit
// reads its row from L2 (the kernel's second instance), and past that
// again W doubles; a stream whose index does not fit even so is refused
// at launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kPrepThreads = 256;
constexpr int kSlotsMax = 8;     // pul C <= 256: 8 elements of a window a lane
constexpr int kMaxWshift = 5;    // W up to 1,024 samples
constexpr int kRing = 8;         // windows written since the last proxy fence
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// A stream's part of the scratch buffer, in 32-bit words (sized for
// W = 32, enough for every W): the active bits, the sub-block keys and
// the group keys, each starting on 16 bytes.
struct Scratch {
  int bits, sub, top, words;
};

__host__ __device__ inline Scratch scratch(int T) {
  const int n32 = (T + 31) / 32;
  Scratch S;
  S.bits = 0;
  S.sub = round4(n32);
  S.top = S.sub + round4(n32);
  S.words = S.top + round4((n32 + 31) / 32);
  return S;
}

// Byte offsets of the fits kernel's dynamic shared memory.  Each part that
// a bulk copy fills has 16 bytes to spare, since its data sits at the
// source's address modulo 16.
struct Layout {
  int bars, bank, pf, top, sub, sw, sp, sb, pwin, ringw, ringp, scr, bytes;
  int wshift, nsub, ntop, rows;
};

__host__ __device__ inline Layout layout(int T, int C, int pul, int nref,
                                         bool bank_shared, int wshift) {
  Layout L;
  const int W = 32 << wshift;
  L.wshift = wshift;
  L.nsub = (T + W - 1) / W;
  L.ntop = (L.nsub + 31) / 32;
  L.rows = 3 * W + pul;    // the staged rows: [lo, hi) < 3 W + pul
  int o = 0;
  L.bars = o; o += 16;
  L.bank = o; o += bank_shared ? up16(nref * pul * 8) + 16 : 0;
  L.pf = o; o += up16(pul * 8) + 16;
  L.top = o; o += up16(L.ntop * 4) + 16;
  L.sub = o; o += up16(L.nsub * 4) + 16;
  L.sw = o; o += up16(L.rows * C * 8) + 16;
  L.sp = o; o += up16(L.rows * 4) + 16;
  L.sb = o; o += up16((L.rows / 32 + 2) * 4);
  L.pwin = o; o += up16(pul * 4);
  L.ringw = o; o += up16(kRing * pul * C * 8);
  L.ringp = o; o += up16(kRing * pul * 4);
  L.scr = o; o += up16(pul * C * 8) + up16(C * 8) + up16(3 * C * 4);
  L.bytes = o;
  return L;
}

// ---- mbarriers and bulk copies -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A copy of n bytes (a multiple of 4) from global memory into a part of
// shared memory, its data at dst = part + src modulo 16: the 16-byte
// aligned body by one bulk copy, the ragged ends by plain loads.
struct Piece {
  unsigned char* dst;
  const unsigned char* src;
  uint32_t n, head, body;
};

__device__ __forceinline__ Piece piece(unsigned char* part, const void* src,
                                       uint32_t n) {
  const auto s = reinterpret_cast<uintptr_t>(src);
  Piece pc;
  pc.dst = part + (s & 15);
  pc.src = static_cast<const unsigned char*>(src);
  pc.n = n;
  pc.head = min(n, static_cast<uint32_t>((16 - (s & 15)) & 15));
  pc.body = (n - pc.head) & ~15u;
  return pc;
}

__device__ __forceinline__ void issue_body(const Piece& pc, uint64_t* bar) {
  if (pc.body) bulk_load(pc.dst + pc.head, pc.src + pc.head, pc.body, bar);
}

__device__ __forceinline__ void copy_ends(const Piece& pc) {
  for (uint32_t k = 0; k < pc.head; k += 4)
    *reinterpret_cast<uint32_t*>(pc.dst + k) =
        *reinterpret_cast<const uint32_t*>(pc.src + k);
  for (uint32_t k = pc.head + pc.body; k < pc.n; k += 4)
    *reinterpret_cast<uint32_t*>(pc.dst + k) =
        *reinterpret_cast<const uint32_t*>(pc.src + k);
}

// ---- keys, reductions and complex arithmetic ---------------------------

// A float as an unsigned key in the order of torch.argmax: NaN above every
// number, -0 equal to +0.  Key 0 lies below every number's key.
__device__ __forceinline__ uint32_t okey(float v) {
  if (isnan(v)) return kFull;
  const uint32_t b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's largest key (into best) and the lowest index that holds it.
__device__ __forceinline__ uint32_t warp_argmax(uint32_t key, uint32_t idx,
                                                uint32_t& best) {
  best = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == best ? idx : kFull);
}

// Butterflies: every lane ends with the same sums (a float sum of two is
// commutative).
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float cabs(float2 a) { return hypotf(a.x, a.y); }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ bool bit(const uint32_t* words, int q) {
  return (words[q >> 5] >> (q & 31)) & 1u;
}

// The unit phasor of the power-weighted phase of the three centre points
// of channel c of the window win (rows of C samples), derotated by pf:
// ph / max(|ph|, 1e-20), as a complex over a real divisor (the reciprocal
// times each part).
__device__ __forceinline__ float2 centre_unit(const float2* win,
                                              const float2* pf, int half,
                                              int C, int c) {
  float2 ph = make_float2(0.f, 0.f);
  for (int m = -1; m <= 1; ++m) {
    const float2 d = cmul(win[(half + m) * C + c], pf[half + m]);
    const float a = cabs(d);
    ph.x = __fadd_rn(ph.x, __fmul_rn(a, d.x));
    ph.y = __fadd_rn(ph.y, __fmul_rn(a, d.y));
  }
  const float scl = 1.0f / fmaxf(cabs(ph), 1e-20f);
  return make_float2(ph.x * scl, ph.y * scl);
}

// The bank row from the parabolic fit of the summed real parts a[3]
// around the centre, clamped before the truncation as XLA's conversion
// saturates.
__device__ __forceinline__ int bank_row(const float* a, int nref) {
  const float t3 = 2.0f * (__fadd_rn(a[0], a[2]) - 2.0f * a[1]);
  const float t4 = fabsf(t3) > 1e-20f ? (a[0] - a[2]) / t3 : 0.f;
  const float sign = t4 > 0.f ? 1.f : (t4 < 0.f ? -1.f : 0.f);
  const float frac = sign * sqrtf(0.5f * fabsf(t4));
  float jf = __fadd_rn(__fmul_rn(static_cast<float>(nref),
                                 __fadd_rn(frac, 0.5f)), 0.5f);
  jf = fminf(fmaxf(jf, 0.f), static_cast<float>(nref - 1));
  return static_cast<int>(jf);
}

// ---- the prep kernel ---------------------------------------------------

// Grid (groups, R), kPrepThreads threads: block (g, r) copies the rows of
// group g of stream r (32 sub-blocks of W samples) into the working
// copies wk (T, C) and pk (T,), and writes their active bits (set where
// cand is not negative), the keys of their sub-blocks and the group's key
// into the stream's scratch.
__global__ void __launch_bounds__(kPrepThreads)
blanker_prep_kernel(const float2* __restrict__ wpad,
                    const float* __restrict__ ppad,
                    const float* __restrict__ cand, float2* __restrict__ wk,
                    float* __restrict__ pk, uint32_t* __restrict__ scr, int T,
                    int C, int wshift) {
  __shared__ uint32_t keys[32];
  const int grp = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = 32 << wshift;
  const int nsub = (T + W - 1) / W;
  const Scratch S = scratch(T);
  const long long rows = static_cast<long long>(r) * T;
  wpad += rows * C;
  ppad += rows;
  cand += rows;
  wk += rows * C;
  pk += rows;
  scr += static_cast<long long>(r) * S.words;
  const int row0 = grp * 32 * W, row1 = min(row0 + 32 * W, T);
  for (long long i = static_cast<long long>(row0) * C + tid;
       i < static_cast<long long>(row1) * C; i += kPrepThreads)
    wk[i] = wpad[i];
  for (int i = row0 + tid; i < row1; i += kPrepThreads) pk[i] = ppad[i];
  for (int j = warp; j < 32; j += kPrepThreads / 32) {
    const int g = grp * 32 + j;
    uint32_t k = 0;
    if (g < nsub) {
      for (int q = g * W; q < min(g * W + W, T); q += 32) {
        const int row = q + lane;
        const float x = row < T ? cand[row] : -1.f;
        const bool b = row < T && !(x < 0.f);
        const uint32_t word = __ballot_sync(kFull, b);
        if (lane == 0) scr[S.bits + (q >> 5)] = word;
        if (row < T) k = max(k, okey(b ? x : -1.f));
      }
      k = __reduce_max_sync(kFull, k);
    }
    if (lane == 0) keys[j] = k;
  }
  __syncthreads();
  if (warp == 0) {
    const int g = grp * 32 + lane;
    const uint32_t k = keys[lane];
    if (g < nsub) scr[S.sub + g] = k;
    const uint32_t m = __reduce_max_sync(kFull, k);
    if (lane == 0) scr[S.top + grp] = m;
  }
}

// ---- the fits kernel ---------------------------------------------------

// An iteration whose candidate is NaN fits nothing, and the JAX loop's
// refresh (was_active = cand >= 0) retires every NaN of the two blocks of
// blk samples around it: around the first NaN p, found in sub-block
// [s0, s1), the blocks from floor((p - off) / blk), clamped to the
// stream.  Then the keys of the sub-blocks and groups there are rebuilt.
// From global memory: no stream of finite power takes this path.
__device__ void retire_nans(const float* pk, uint32_t* bits, uint32_t* sub,
                            uint32_t* top, int T, int nsub, int sh, int s0,
                            int s1, int off, int blk, int lane) {
  uint32_t kr = 0, rr = kFull;
  for (int row = s0 + lane; row < s1; row += 32) {
    const uint32_t key = okey(bit(bits, row) ? pk[row] : -1.f);
    if (key > kr) { kr = key; rr = row; }
  }
  uint32_t m;
  const int p = warp_argmax(kr, rr, m);
  int b0 = p - off;
  b0 = (b0 >= 0 ? b0 : b0 - blk + 1) / blk;   // floor division
  b0 = clampi(b0, 0, T / blk - 2);
  const int r0 = b0 * blk, r1 = r0 + 2 * blk;
  for (int k = (r0 >> 5) + lane; k <= (r1 - 1) >> 5; k += 32) {
    uint32_t word = bits[k];
    for (int b = 0; b < 32; ++b) {
      const int row = 32 * k + b;
      if (row >= r0 && row < r1 && isnan(pk[row])) word &= ~(1u << b);
    }
    bits[k] = word;
  }
  __syncwarp();
  const int ga = r0 >> sh, gb = (r1 - 1) >> sh;
  for (int g = ga + lane; g <= gb; g += 32) {
    uint32_t key = 0;
    for (int row = g << sh; row < min((g + 1) << sh, T); ++row)
      key = max(key, okey(bit(bits, row) ? pk[row] : -1.f));
    sub[g] = key;
  }
  __syncwarp();
  for (int t = (ga >> 5) + lane; t <= gb >> 5; t += 32) {
    uint32_t key = 0;
    for (int k = 0; k < 32 && t * 32 + k < nsub; ++k)
      key = max(key, sub[t * 32 + k]);
    top[t] = key;
  }
  __syncwarp();
}

// One warp; stream r = blockIdx.x.  wk (T, C), pk (T,): the working copies
// of the padded stream and its power from the prep kernel, updated in
// place; scr: the stream's bits and keys from the prep kernel; refbank
// (nref, pul), phasefunc (pul,); thr: the threshold; nfit: the count of
// successful fits; blk: the JAX loop's block (its refresh's reach, which
// only a NaN candidate needs).  The tables and the threshold advance by
// their strides per stream (0: shared by every stream).  kC > 0: pul is
// 64 and C is kC.
template <bool kBankShared, int kC>
__global__ void __launch_bounds__(32, 1)
blanker_fits_kernel(float2* wk, float* pk, uint32_t* scr,
                    const float2* __restrict__ refbank,
                    const float2* __restrict__ phasefunc,
                    const float* __restrict__ thr, int* __restrict__ nfit,
                    long long ref_stride, long long pf_stride,
                    long long thr_stride, int T, int C_arg, int blk,
                    int pul_arg, int nref, int pw, int max_pulses,
                    int wshift) {
  constexpr bool kFast = kC > 0;
  constexpr int kSlots = kFast ? 2 * kC : kSlotsMax;
  const int C = kFast ? kC : C_arg;
  const int pul = kFast ? 64 : pul_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(T, C, pul, nref, kBankShared, wshift);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint32_t* sb = reinterpret_cast<uint32_t*>(smem + L.sb);
  float* pwin = reinterpret_cast<float*>(smem + L.pwin);
  float2* ringw = reinterpret_cast<float2*>(smem + L.ringw);
  float* ringp = reinterpret_cast<float*>(smem + L.ringp);
  float2* nw = reinterpret_cast<float2*>(smem + L.scr);
  float2* unit = reinterpret_cast<float2*>(smem + L.scr + up16(pul * C * 8));
  float* r3 = reinterpret_cast<float*>(smem + L.scr + up16(pul * C * 8) +
                                       up16(C * 8));

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const Scratch S = scratch(T);
  wk += static_cast<long long>(r) * T * C;
  pk += static_cast<long long>(r) * T;
  scr += static_cast<long long>(r) * S.words;
  uint32_t* bits = scr + S.bits;
  refbank += r * ref_stride;
  phasefunc += r * pf_stride;
  const float threshold = thr[r * thr_stride];
  const int W = 32 << wshift;
  const int sh = 5 + wshift;
  const int half = pul / 2;
  const int E = pul * C;

  // the tables and the keys: bulk copies completing on bars[0]
  const Piece pfp = piece(smem + L.pf, phasefunc, pul * 8);
  const Piece bkp = piece(smem + L.bank, refbank,
                          kBankShared ? nref * pul * 8 : 0);
  const Piece tpp = piece(smem + L.top, scr + S.top, L.ntop * 4);
  const Piece sbp = piece(smem + L.sub, scr + S.sub, L.nsub * 4);
  if (lane == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bars[0], pfp.body + bkp.body + tpp.body + sbp.body);
    issue_body(pfp, &bars[0]);
    issue_body(bkp, &bars[0]);
    issue_body(tpp, &bars[0]);
    issue_body(sbp, &bars[0]);
    copy_ends(pfp);
    copy_ends(bkp);
    copy_ends(tpp);
    copy_ends(sbp);
  }
  __syncwarp();
  mbar_wait(&bars[0], 0);
  __syncwarp();
  const float2* pf = reinterpret_cast<const float2*>(pfp.dst);
  const float2* bank = kBankShared
      ? reinterpret_cast<const float2*>(bkp.dst) : refbank;
  uint32_t* top = reinterpret_cast<uint32_t*>(tpp.dst);
  uint32_t* sub = reinterpret_cast<uint32_t*>(sbp.dst);

  // each slot's row and channel in the window (with kFast the channel is
  // the lane's: 32 is a multiple of C)
  int ek[kSlots], ec[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = lane + 32 * s;
    ek[s] = e / C;
    ec[s] = e - ek[s] * C;
  }
  const int cl = lane % C;

  int fitted = 0, nring = 0, ring_start = 0;   // ring_start: lane j's slot
  uint32_t phase = 0;
  for (int it = 0; it < max_pulses; ++it) {
    // the group with the largest candidate
    uint32_t key = 0, idx = kFull;
    for (int k = lane; k < L.ntop; k += 32) {
      const uint32_t t = top[k];
      if (t > key) { key = t; idx = k; }
    }
    uint32_t best;
    const int gi = warp_argmax(key, idx, best);
    const float v = unkey(best);
    // at or under the threshold: this and every later iteration would
    // write back what it read
    if (!(v > threshold || isnan(v))) break;
    // its first sub-block of that key (a group's key is the largest of its
    // sub-blocks' keys, by construction)
    const int g = gi * 32 + lane;
    const int si = __reduce_min_sync(kFull,
                                     g < L.nsub && sub[g] == best ? g : kFull);
    const int s0 = si << sh, s1 = min(s0 + W, T);
    if (isnan(v)) {
      retire_nans(pk, bits, sub, top, T, L.nsub, sh, s0, s1, half + pw, blk,
                  lane);
      continue;
    }
    // a full ring: its windows reach the bulk copies issued from here on
    if (nring == kRing) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      __syncwarp();   // every lane's fenced writes before lane 0's copy
      nring = 0;
    }
    // stage the rows the fit may touch: whole sub-blocks around every
    // window a sample of this sub-block can have
    const int wmin = clampi(s0 - half, 0, T - pul);
    const int wmax = clampi(s1 - 1 - half, 0, T - pul);
    const int lo = (wmin >> sh) << sh;
    const int hi = min((((wmax + pul - 1) >> sh) + 1) << sh, T);
    const Piece ws = piece(smem + L.sw, wk + static_cast<long long>(lo) * C,
                           (hi - lo) * C * 8);
    const Piece ps = piece(smem + L.sp, pk + lo, (hi - lo) * 4);
    if (lane == 0) {
      mbar_expect(&bars[1], ws.body + ps.body);
      issue_body(ws, &bars[1]);
      issue_body(ps, &bars[1]);
    }
    const int w0 = lo >> 5;
    for (int k = lane; k < (hi - lo + 31) >> 5; k += 32) sb[k] = bits[w0 + k];
    if (lane == 0) {
      copy_ends(ws);
      copy_ends(ps);
    }
    mbar_wait(&bars[1], phase);
    phase ^= 1;
    float2* sw = reinterpret_cast<float2*>(ws.dst);   // row lo + q at q C
    float* sp = reinterpret_cast<float*>(ps.dst);     // row lo + q at q
    // windows written since the last fence may not have reached the copy:
    // their rows from the ring, oldest first
    uint32_t olap = __ballot_sync(
        kFull, lane < nring && ring_start < hi && ring_start + pul > lo);
    if (olap) {
      while (olap) {
        const int j = __ffs(olap) - 1;
        olap &= olap - 1;
        const int rs = __shfl_sync(kFull, ring_start, j);
        const int a = max(lo, rs), b = min(hi, rs + pul);
        for (int e = lane; e < (b - a) * C; e += 32)
          sw[(a - lo) * C + e] = ringw[j * E + (a - rs) * C + e];
        for (int q = lane; q < b - a; q += 32)
          sp[a - lo + q] = ringp[j * pul + a - rs + q];
        __syncwarp();
      }
      // before a later bulk copy writes these rows of the stage again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    // the candidate: the sub-block's first maximal sample.  With kFast
    // each lane also takes the unit phasor of the power-weighted phase of
    // the three centre points of its own best row's window, per channel,
    // beside the reduction; the winner's comes by a shuffle.
    key = 0;
    idx = kFull;
    for (int row = s0 + lane; row < s1; row += 32) {
      const int q = row - lo;
      const uint32_t t = okey(bit(sb, q) ? sp[q] : -1.f);
      if (t > key) { key = t; idx = row; }
    }
    const int own = idx == kFull ? s0 : static_cast<int>(idx);
    // the sub-block's key is its rows' largest; only a candidate power
    // unlike the power (outside the operator's contract) misses it
    int p = __reduce_min_sync(kFull, key == best ? idx : kFull);
    if (p == static_cast<int>(kFull)) p = warp_argmax(key, idx, best);
    float2 u0 = make_float2(0.f, 0.f), u1 = u0;
    if constexpr (kFast) {
      const float2* wown = sw + (clampi(own - half, 0, T - pul) - lo) * C;
      u0 = centre_unit(wown, pf, half, C, 0);
      if (kC == 2) u1 = centre_unit(wown, pf, half, C, 1);
    }

    // the fit window, derotated by the phase function, rotated onto the
    // real axis by the power-weighted phase of its three centre points
    const int start = clampi(p - half, 0, T - pul);
    const int ws0 = start - lo;
    const float2* win = sw + ws0 * C;
    float2 u = make_float2(0.f, 0.f);
    if constexpr (kFast) {
      const int src = (p - s0) & 31;   // the lane that held p
      const float2 c0 = make_float2(__shfl_sync(kFull, u0.x, src),
                                    __shfl_sync(kFull, u0.y, src));
      const float2 c1 = make_float2(__shfl_sync(kFull, u1.x, src),
                                    __shfl_sync(kFull, u1.y, src));
      u = cl == 0 ? c0 : c1;
    } else {
      for (int c = lane; c < C; c += 32)
        unit[c] = centre_unit(win, pf, half, C, c);
      __syncwarp();
    }
    // I and Q power over the centre +-pw
    float2 w[kSlots];
    float rx[kSlots];
    float ip = 0.f, qp = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (lane + 32 * s < E) {
        const int k = ek[s];
        w[s] = win[lane + 32 * s];
        const float2 rot = cmulc(cmul(w[s], pf[k]),
                                 kFast ? u : unit[ec[s]]);
        rx[s] = rot.x;
        if (k >= half - pw && k <= half + pw) {
          ip += __fmul_rn(rot.x, rot.x);
          qp += __fmul_rn(rot.y, rot.y);
        }
        if (!kFast && k >= half - 1 && k <= half + 1)
          r3[(k - half + 1) * C + ec[s]] = rot.x;
      }
    }
    warp_sum2(ip, qp);
    const bool shape_ok = qp <= 0.25f * ip;   // blank1.c:121
    // the real parts of the three centre rows, summed over the channels:
    // the parabola's points; the centre row's real part of each channel
    float a[3], re;
    if constexpr (kFast) {
      constexpr int kBase = 31 * kC;   // the first element of row half - 1
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int e = kBase + m * kC + c;
          acc += __shfl_sync(kFull, rx[e >> 5], e & 31);
        }
        a[m] = acc;
      }
      re = __shfl_sync(kFull, rx[kC], cl);   // element 32 C + cl
    } else {
      __syncwarp();
      for (int m = 0; m < 3; ++m) {
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += r3[m * C + c];
        a[m] = acc;
      }
      re = 0.f;
    }
    const float2* ref = bank + static_cast<long long>(bank_row(a, nref)) * pul;
    // subtract coef * bank[j] (blank1.c:157-162), coef = unit * re
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (lane + 32 * s < E) {
        const float2 uu = kFast ? u : unit[ec[s]];
        const float rr = kFast ? re : r3[C + ec[s]];
        const float2 sub2 = cmul(ref[ek[s]], make_float2(uu.x * rr,
                                                         uu.y * rr));
        w[s] = make_float2(w[s].x - sub2.x, w[s].y - sub2.y);
        if (!kFast) nw[lane + 32 * s] = w[s];
      }
    }
    // the new window's power per row; the sums of new and old.  With kFast
    // the lanes of channel 0 hold the rows (row ek[s] in slot s).
    float newp[kSlots];
    float sn = 0.f, so = 0.f;
    if constexpr (kFast) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float np = __fadd_rn(__fmul_rn(w[s].x, w[s].x),
                             __fmul_rn(w[s].y, w[s].y));
#pragma unroll
        for (int off = 1; off < kC; off <<= 1)
          np += __shfl_xor_sync(kFull, np, off);
        newp[s] = np;
        if (cl == 0) {
          sn += np;
          so += sp[ws0 + ek[s]];
        }
      }
    } else {
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = lane + 32 * s;
        if (k < pul) {
          float np = 0.f;
          for (int c = 0; c < C; ++c) {
            const float2 x = nw[k * C + c];
            np += __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
          }
          newp[s] = np;
          sn += np;
          so += sp[ws0 + k];
        }
      }
    }
    warp_sum2(sn, so);
    const bool success =
        shape_ok && sn / fmaxf(so, 1e-20f) <= 0.5f;   // blank1.c:188
    if (success) {
      if (lane == nring) ring_start = start;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int e = lane + 32 * s;
        if (e < E) {
          wk[static_cast<long long>(start) * C + e] = w[s];
          ringw[nring * E + e] = w[s];
        }
        // the row this lane holds: ek[s] of channel 0 (kFast), else row e
        const int k = kFast ? ek[s] : e;
        if (kFast ? cl == 0 && e < E : e < pul) {
          pk[start + k] = newp[s];
          pwin[k] = newp[s];
          ringp[nring * pul + k] = newp[s];
        }
      }
      ++nring;
    }
    fitted += success ? 1 : 0;
    __syncwarp();

    // retire +-pw around the candidate; rebuild the keys of the sub-blocks
    // the window touches and of their (one or two) groups, the retired
    // rows inactive
    const int rlo = max(p - pw, 0), rhi = min(p + pw, T - 1);
    const int ga = start >> sh, gb = (start + pul - 1) >> sh;
    const int ta = ga >> 5, tb = gb >> 5;
    // the key of row lo + q after this fit
    auto row_key = [&](int q) {
      const int row = lo + q;
      const float x = success && row >= start && row < start + pul
          ? pwin[row - start] : sp[q];
      return okey(bit(sb, q) && (row < rlo || row > rhi) ? x : -1.f);
    };
    if (W == 32 && gb - ga <= 2) {
      // one row a lane in each of the (two or) three sub-blocks, their
      // reductions side by side, the groups' keys from registers
      const int g0 = (ta << 5) + lane, g1 = (tb << 5) + lane;
      uint32_t old0 = g0 < L.nsub ? sub[g0] : 0u;
      uint32_t old1 = g1 < L.nsub ? sub[g1] : 0u;
      const int q0 = (ga << 5) - lo + lane;
      const uint32_t k0 = lo + q0 < T ? row_key(q0) : 0u;
      const uint32_t k1 = gb > ga && lo + q0 + 32 < T ? row_key(q0 + 32) : 0u;
      const uint32_t k2 = gb > ga + 1 && lo + q0 + 64 < T ? row_key(q0 + 64)
                                                          : 0u;
      const uint32_t n0 = __reduce_max_sync(kFull, k0);
      const uint32_t n1 = __reduce_max_sync(kFull, k1);
      const uint32_t n2 = __reduce_max_sync(kFull, k2);
      const uint32_t nt[3] = {n0, n1, n2};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (ga + t <= gb && g0 == ga + t) old0 = nt[t];
        if (ga + t <= gb && g1 == ga + t) old1 = nt[t];
      }
      const uint32_t top0 = __reduce_max_sync(kFull, old0);
      const uint32_t top1 = __reduce_max_sync(kFull, old1);
      if (lane == 0) {
        sub[ga] = n0;
        if (gb > ga) sub[ga + 1] = n1;
        if (gb > ga + 1) sub[ga + 2] = n2;
        top[ta] = top0;
        top[tb] = top1;
      }
    } else {
      for (int t = ga; t <= gb; ++t) {
        uint32_t kt = 0;
        for (int row = (t << sh) + lane; row < min((t + 1) << sh, T);
             row += 32)
          kt = max(kt, row_key(row - lo));
        kt = __reduce_max_sync(kFull, kt);
        if (lane == 0) sub[t] = kt;
      }
      __syncwarp();
      for (int t = ta; t <= tb; ++t) {
        const int gg = t * 32 + lane;
        const uint32_t kt = __reduce_max_sync(kFull,
                                              gg < L.nsub ? sub[gg] : 0u);
        if (lane == 0) top[t] = kt;
      }
    }
    for (int k = ((rlo - lo) >> 5) + lane; k <= (rhi - lo) >> 5; k += 32) {
      const int b0 = max(rlo - lo - 32 * k, 0), b1 = min(rhi - lo - 32 * k, 31);
      const uint32_t mask = b1 - b0 == 31
          ? kFull : ((1u << (b1 - b0 + 1)) - 1u) << b0;
      bits[w0 + k] = sb[k] & ~mask;
    }
    __syncwarp();
  }
  if (lane == 0) nfit[r] = fitted;
}

using FitsKernel = void (*)(float2*, float*, uint32_t*, const float2*,
                            const float2*, const float*, int*, long long,
                            long long, long long, int, int, int, int, int,
                            int, int, int);

// The instance for the bank's place and the window's shape.
FitsKernel fits_kernel(bool bank_shared, int kc) {
  switch (kc) {
    case 1:
      return bank_shared ? blanker_fits_kernel<true, 1>
                         : blanker_fits_kernel<false, 1>;
    case 2:
      return bank_shared ? blanker_fits_kernel<true, 2>
                         : blanker_fits_kernel<false, 2>;
    default:
      return bank_shared ? blanker_fits_kernel<true, 0>
                         : blanker_fits_kernel<false, 0>;
  }
}

int max_shared_bytes(int dev) {
  static int bytes[64];
  if (!bytes[dev]) {
    int b = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
    bytes[dev] = b;
  }
  return bytes[dev];
}

// The bank in shared memory where the whole layout fits, else in global
// memory; W = 32 where it fits, else the narrowest W that does.  0 or a
// CUDA error.
int plan(int T, int C, int pul, int nref, bool* bank_shared, int* wshift,
         Layout* L, int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int maxb = max_shared_bytes(*dev);
  if (maxb < 0) return -maxb;
  for (int ws = 0; ws <= kMaxWshift; ++ws) {
    for (int shared = 1; shared >= 0; --shared) {
      *L = layout(T, C, pul, nref, shared, ws);
      if (L->bytes <= maxb) {
        *bank_shared = shared;
        *wshift = ws;
        return 0;
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool attribute_set[6][64];

}  // namespace

// 32-bit words of scratch a stream of T samples needs.
extern "C" int lrt_blanker_fits_scratch_words(int T) {
  return scratch(T).words;
}

// out: [bank in shared memory (0 or 1), W, dynamic shared bytes]
extern "C" int lrt_blanker_fits_plan(int T, int C, int pul, int nref,
                                     int* out) {
  bool shared;
  int wshift, dev;
  Layout L;
  const int err = plan(T, C, pul, nref, &shared, &wshift, &L, &dev);
  if (err) return err;
  out[0] = shared;
  out[1] = 32 << wshift;
  out[2] = L.bytes;
  return 0;
}

// wpad (R, T, C), ppad and cand (R, T): the inputs; wk (R, T, C), pk
// (R, T): the outputs; scr: R x lrt_blanker_fits_scratch_words words;
// the tables and the threshold advance by their strides per stream (0:
// shared by every stream).
extern "C" int lrt_blanker_fits(const void* wpad, const void* ppad,
                                const void* cand, void* wk, void* pk,
                                void* scr, const void* refbank,
                                const void* phasefunc, const void* thr,
                                void* nfit, long long ref_stride,
                                long long pf_stride, long long thr_stride,
                                int T, int C, int blk, int pul, int nref,
                                int pw, int max_pulses, int streams,
                                void* stream) {
  bool shared;
  int wshift, dev;
  Layout L;
  int err = plan(T, C, pul, nref, &shared, &wshift, &L, &dev);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (L.nsub + 31) / 32;
  blanker_prep_kernel<<<dim3(groups, streams), kPrepThreads, 0, st>>>(
      static_cast<const float2*>(wpad), static_cast<const float*>(ppad),
      static_cast<const float*>(cand), static_cast<float2*>(wk),
      static_cast<float*>(pk), static_cast<uint32_t*>(scr), T, C, wshift);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int kc = pul == 64 && (C == 1 || C == 2) ? C : 0;
  const FitsKernel kernel = fits_kernel(shared, kc);
  // the limit is set once per device and instance to all a block may have
  bool& set = attribute_set[2 * kc + shared][dev];
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_shared_bytes(dev));
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  kernel<<<streams, 32, L.bytes, st>>>(
      static_cast<float2*>(wk), static_cast<float*>(pk),
      static_cast<uint32_t*>(scr), static_cast<const float2*>(refbank),
      static_cast<const float2*>(phasefunc), static_cast<const float*>(thr),
      static_cast<int*>(nfit), ref_stride, pf_stride, thr_stride, T, C, blk,
      pul, nref, pw, max_pulses, wshift);
  return static_cast<int>(cudaGetLastError());
}
