// K1 / K1f: per-frame percentile clip bounds (lo, hi, fmin, fmax).
//
// Replaces bio_image_unet_tpu/ops/histogram.py:110 int_clip_bounds (uint8 and
// uint16 frames, via :62 _order_stats_bitsearch) and :142 float_clip_bounds
// (NaN-free float32 frames, via the :91 _f32_sortable bit image).  The JAX
// stage finds the floor/ceil order statistics of the two clip percentiles by
// a bitwise binary search over the value space, one compare+sum sweep of the
// frame per bit, then blends them with numpy's 'linear' rule in float32 and
// clamps the frame min/max into [lo, hi].
//
// The Siam pair form (predict/predictor.py:976-994, 'all' mode) takes the
// bounds of each pair's two planes as one row of 2*h*w values: rows i and
// i+1 of the (k+1, h, w) block are contiguous, so the kernel reads the pair
// rows in place with a row stride of one frame (h*w) apart from the row
// length (2*h*w); no (k, 2*h*w) copy is made.
//
// What bounds it on the card: bytes.  A (16, 1024*1024) uint8 chunk is 16 MB;
// the least time is one read of it at 3.35 TB/s (~5 us).  The selection is a
// radix select over the order-preserving key, one launch (clip_pass<T, VEC,
// D>) per digit D of the key: uint8 one 8-bit digit, uint16 two, float32
// three (11, 11 and 10 bits: a 64 MB float32 chunk does not fit the 50 MB L2,
// so each pass it saves is a read of device memory).  Pass D counts, per
// frame, digit D of the pixels whose higher digits equal the prefix found so
// far of a wanted order statistic (the floor and ceil ranks of the two
// percentiles; statistics that share a prefix share one histogram, a "slot",
// and the slot is picked without a branch, so a pixel costs at most one
// shared-memory atomic a pass).  Against the three-launch design it replaced
// (a memset, a pass a byte, a finalize):
//
// - One launch a pass, none for set-up or finishing.  A block adds its
//   counts to the frame's histogram in global memory, then takes a ticket
//   from the frame's arrival counter; the block that arrives last selects
//   the bucket of each statistic (a warp a statistic, a warp scan over the
//   bins), writes the prefixes for the next pass (or, after the last digit,
//   blends and clamps the bounds), and returns the frame's histogram and
//   counter to zero.  The scratch (K1_FRAME_WORDS int32 a frame, zero at
//   rest) is kept by the wrapper, one per CUDA stream, and is zero again
//   when a call's last launch has finished, so no memset runs.
// - The frame min and max: for uint8 they are ranks 0 and P-1 of the one
//   pass's histogram; for wider keys the first pass reduces them in
//   registers (stored complemented for the min, so the rest value is 0).
// - Skewed frames (most pixels on a few background levels) cost what
//   uniform ones do: Hopper's shared-memory atomics do not slow down when
//   the lanes of a warp add to one address (measured: PERF.md section 6; the
//   lane-private and thread-private histograms tried instead were slower).
//
// Exactness: selection is exact (same order statistics as the bit search);
// the blend lo + frac*(hi - lo) uses __fmul_rn/__fadd_rn (no FMA), with frac
// = float32(pos - floor(pos)) computed on the host as JAX's weak typing does.
// Counts are integers and the order of their atomic sums does not matter.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K1_THREADS = 256;
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_NRANK = 4;      // floor/ceil of q_lo, floor/ceil of q_hi
constexpr int K1_MAXBIN = 2048;  // the widest digit, 11 bits
constexpr int K1_UNROLL = 4;     // 16-byte loads in flight a thread

// the per-frame scratch, int32 words (every word 0 at rest)
constexpr int K1_HIST = 0;                             // K1_NRANK slots of a pass's bins
constexpr int K1_ARRIVE = K1_NRANK * K1_MAXBIN;        // blocks of the pass that finished
constexpr int K1_KMIN = K1_ARRIVE + 1;                 // ~(min key), first pass
constexpr int K1_KMAX = K1_KMIN + 1;                   // max key, first pass
constexpr int K1_NSLOT = K1_KMAX + 1;                  // slots of the next pass
constexpr int K1_PREF = K1_NSLOT + 1;                  // [K1_NRANK] prefix of each statistic
constexpr int K1_RANK = K1_PREF + K1_NRANK;            // [K1_NRANK] rank left within it
constexpr int K1_SLOT = K1_RANK + K1_NRANK;            // [K1_NRANK] its slot
constexpr int K1_SLOTPREF = K1_SLOT + K1_NRANK;        // [K1_NRANK] each slot's prefix
constexpr int K1_SMIN = K1_SLOTPREF + K1_NRANK;        // min / max key, kept for the last pass
constexpr int K1_SMAX = K1_SMIN + 1;
constexpr int K1_FRAME_WORDS = 8224;
static_assert(K1_SMAX < K1_FRAME_WORDS, "per-frame scratch layout");

// the digits of a key of nb bytes, from the top: uint8 8; uint16 8, 8;
// float32 11, 11, 10
__host__ __device__ constexpr int n_digits(int nb) { return nb == 4 ? 3 : nb; }
__host__ __device__ constexpr int digit_bits(int nb, int d) {
  return nb == 4 ? (d < 2 ? 11 : 10) : 8;
}
__host__ __device__ constexpr int digit_shift(int nb, int d) {  // the bits below digit d
  int s = 0;
  for (int e = d + 1; e < n_digits(nb); ++e) s += digit_bits(nb, e);
  return s;
}

struct Ranks {
  int k[K1_NRANK];
};

template <typename T>
__device__ __forceinline__ uint32_t to_key(T v);
template <>
__device__ __forceinline__ uint32_t to_key<uint8_t>(uint8_t v) { return v; }
template <>
__device__ __forceinline__ uint32_t to_key<uint16_t>(uint16_t v) { return v; }
template <>
__device__ __forceinline__ uint32_t to_key<float>(float v) {
  // order-preserving image of IEEE-754 float32 (negatives flip all bits,
  // non-negatives set the sign bit) -- ops/histogram.py:91 _f32_sortable
  uint32_t b = __float_as_uint(v);
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

template <typename T>
__device__ __forceinline__ float key_value(uint32_t k) {
  if constexpr (sizeof(T) == 4) {
    const uint32_t b = (k >> 31) ? (k ^ 0x80000000u) : ~k;
    return __uint_as_float(b);
  } else {
    return (float)k;
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// element k of a 16-byte vector (k is a constant after unrolling, so this is
// a register extract, never a local-memory copy)
template <typename T>
__device__ __forceinline__ T element(const uint4& w, int k) {
  if constexpr (sizeof(T) == 1) {
    return (T)((word_of(w, k >> 2) >> ((k & 3) * 8)) & 0xFFu);
  } else if constexpr (sizeof(T) == 2) {
    return (T)((word_of(w, k >> 1) >> ((k & 1) * 16)) & 0xFFFFu);
  } else {
    return __uint_as_float(word_of(w, k));
  }
}

// The bucket of an NBIN-bin histogram that holds the element of rank `rank`,
// and the rank left within it.  Called by a whole warp: lane l sums bins
// [l * PER, (l + 1) * PER) (starting at a bin that spreads the lanes over
// the banks), a warp scan finds the lane whose range holds the rank, and
// that lane walks its range.
template <int NBIN>
__device__ __forceinline__ void select_bucket(const int* h, int rank, int* bucket_out,
                                              int* left_out) {
  constexpr int PER = NBIN / 32;
  const int lane = threadIdx.x & 31;
  const int* mine = h + lane * PER;
  int local = 0;
#pragma unroll 8
  for (int i = 0; i < PER; ++i) local += mine[(i + lane) % PER];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - local;
  const int src = __ffs(__ballot_sync(0xffffffffu, excl <= rank && rank < incl)) - 1;
  int bucket = 0, left = 0;
  if (lane == src) {
    int acc = excl;
    for (int i = 0; i < PER; ++i) {
      if (rank < acc + mine[i]) {
        bucket = lane * PER + i;
        left = rank - acc;
        break;
      }
      acc += mine[i];
    }
  }
  *bucket_out = __shfl_sync(0xffffffffu, bucket, src);
  *left_out = __shfl_sync(0xffffffffu, left, src);
}

// Pass D over row f = blockIdx.y: P values from x + f*S, VEC values a
// 16-byte load (1: element loads).
template <typename T, int VEC, int D>
__global__ void __launch_bounds__(K1_THREADS)
clip_pass(const T* __restrict__ x, long long P, long long S, Ranks ranks, float frac_lo,
          float frac_hi, int blend_lo, int blend_hi, int* __restrict__ scratch,
          float* __restrict__ out, int F) {
  constexpr int NB = (int)sizeof(T);
  constexpr bool FIRST = D == 0;
  constexpr bool LAST = D == n_digits(NB) - 1;
  constexpr bool MINMAX = FIRST && NB > 1;
  constexpr int BITS = digit_bits(NB, D);
  constexpr int NBIN = 1 << BITS;
  constexpr int SHIFT = digit_shift(NB, D);
  constexpr int SLOTS = FIRST ? 1 : K1_NRANK;
  __shared__ int h[SLOTS * NBIN];
  __shared__ uint32_t s_min[K1_WARPS], s_max[K1_WARPS];
  __shared__ uint32_t s_key[K1_NRANK + 2];
  __shared__ int s_left[K1_NRANK];
  __shared__ int s_last;
  const int f = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* st = scratch + (size_t)f * K1_FRAME_WORDS;
  const int nslot = FIRST ? 1 : st[K1_NSLOT];
  // a slot past nslot gets a prefix no key has (prefixes have < 32 bits)
  uint32_t pref[K1_NRANK];
#pragma unroll
  for (int j = 0; j < K1_NRANK; ++j)
    pref[j] = !FIRST && j < nslot ? (uint32_t)st[K1_SLOTPREF + j] : 0xFFFFFFFFu;
  for (int i = threadIdx.x; i < nslot * NBIN; i += K1_THREADS) h[i] = 0;
  __syncthreads();

  uint32_t kmin = 0xFFFFFFFFu, kmax = 0u;
  auto one = [&](T v) {
    const uint32_t key = to_key<T>(v);
    const int bin = (int)((key >> SHIFT) & (NBIN - 1));
    if constexpr (FIRST) {
      atomicAdd(&h[bin], 1);
      if constexpr (MINMAX) {
        kmin = min(kmin, key);
        kmax = max(kmax, key);
      }
    } else {
      const uint32_t hi = key >> (SHIFT + BITS);
      int j = -1;
#pragma unroll
      for (int jj = K1_NRANK - 1; jj >= 0; --jj) j = hi == pref[jj] ? jj : j;
      if (j >= 0) atomicAdd(&h[j * NBIN + bin], 1);
    }
  };

  const T* xf = x + (size_t)f * S;
  const long long stride = (long long)gridDim.x * K1_THREADS;
  const long long tid = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
  if constexpr (VEC > 1) {
    // 16-byte loads: P and S are multiples of VEC and the rows 16-byte aligned
    const uint4* xv = reinterpret_cast<const uint4*>(xf);
    const long long nv = P / VEC;
    for (long long i0 = tid; i0 < nv; i0 += stride * K1_UNROLL) {
      uint4 w[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const long long i = i0 + u * stride;
        if (i < nv) w[u] = __ldg(xv + i);
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        if (i0 + u * stride < nv) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) one(element<T>(w[u], k));
        }
      }
    }
  } else {
    for (long long i0 = tid; i0 < P; i0 += stride * K1_UNROLL) {
      T v[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const long long i = i0 + u * stride;
        if (i < P) v[u] = xf[i];
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u)
        if (i0 + u * stride < P) one(v[u]);
    }
  }
  if constexpr (MINMAX) {
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    if (lane == 0) {
      s_min[warp] = kmin;
      s_max[warp] = kmax;
    }
  }
  __syncthreads();

  // the block's counts into the frame's
  int* hg = st + K1_HIST;
  for (int i = threadIdx.x; i < nslot * NBIN; i += K1_THREADS) {
    const int c = h[i];
    if (c) atomicAdd(&hg[i], c);
  }
  if constexpr (MINMAX) {
    if (threadIdx.x == 0) {
      uint32_t mn = s_min[0], mx = s_max[0];
      for (int i = 1; i < K1_WARPS; ++i) {
        mn = min(mn, s_min[i]);
        mx = max(mx, s_max[i]);
      }
      atomicMax(reinterpret_cast<unsigned*>(&st[K1_KMIN]), ~mn);
      atomicMax(reinterpret_cast<unsigned*>(&st[K1_KMAX]), mx);
    }
  }
  // every thread's adds visible on the card before the block takes its ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&st[K1_ARRIVE], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block of the frame: its counts (L2 reads), the scratch to rest
  __threadfence();
  for (int i = threadIdx.x; i < nslot * NBIN; i += K1_THREADS) {
    h[i] = __ldcg(&hg[i]);
    hg[i] = 0;
  }
  if (threadIdx.x == 0) {
    st[K1_ARRIVE] = 0;
    if constexpr (MINMAX) {
      s_key[K1_NRANK] = ~atomicExch(reinterpret_cast<unsigned*>(&st[K1_KMIN]), 0u);
      s_key[K1_NRANK + 1] = atomicExch(reinterpret_cast<unsigned*>(&st[K1_KMAX]), 0u);
    }
  }
  __syncthreads();
  // a warp a statistic: its bucket of digit D; for uint8 warps 4 and 5 take
  // the min and max as ranks 0 and P-1
  constexpr int NSEL = NB == 1 ? K1_NRANK + 2 : K1_NRANK;
  if (warp < NSEL) {
    const bool ranked = warp < K1_NRANK;
    const int slot = FIRST || !ranked ? 0 : st[K1_SLOT + warp];
    const int rank = ranked ? (FIRST ? ranks.k[warp] : st[K1_RANK + warp])
                            : (warp == K1_NRANK ? 0 : (int)(P - 1));
    const uint32_t pre = FIRST || !ranked ? 0u : (uint32_t)st[K1_PREF + warp];
    int bucket, left;
    select_bucket<NBIN>(h + slot * NBIN, rank, &bucket, &left);
    if (lane == 0) {
      s_key[warp] = (pre << BITS) | (uint32_t)bucket;
      if (ranked) s_left[warp] = left;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if constexpr (LAST) {
    // statistics 0/1 = floor/ceil of q_lo, 2/3 = floor/ceil of q_hi
    const float v0 = key_value<T>(s_key[0]), v1 = key_value<T>(s_key[1]);
    const float v2 = key_value<T>(s_key[2]), v3 = key_value<T>(s_key[3]);
    const uint32_t kmn = FIRST ? s_key[K1_NRANK] : (uint32_t)st[K1_SMIN];
    const uint32_t kmx = FIRST ? s_key[K1_NRANK + 1] : (uint32_t)st[K1_SMAX];
    const float lo = blend_lo ? __fadd_rn(v0, __fmul_rn(frac_lo, __fsub_rn(v1, v0))) : v0;
    const float hi = blend_hi ? __fadd_rn(v2, __fmul_rn(frac_hi, __fsub_rn(v3, v2))) : v2;
    out[0 * F + f] = lo;
    out[1 * F + f] = hi;
    out[2 * F + f] = fmaxf(key_value<T>(kmn), lo);
    out[3 * F + f] = fminf(key_value<T>(kmx), hi);
  } else {
    // the next pass's prefixes, one slot for each distinct prefix
    int n = 0;
    for (int s = 0; s < K1_NRANK; ++s) {
      const uint32_t p = s_key[s];
      int j = 0;
      while (j < n && (uint32_t)st[K1_SLOTPREF + j] != p) ++j;
      if (j == n) st[K1_SLOTPREF + n++] = (int)p;
      st[K1_PREF + s] = (int)p;
      st[K1_RANK + s] = s_left[s];
      st[K1_SLOT + s] = j;
    }
    st[K1_NSLOT] = n;
    if constexpr (MINMAX) {
      st[K1_SMIN] = (int)s_key[K1_NRANK];
      st[K1_SMAX] = (int)s_key[K1_NRANK + 1];
    }
  }
}

template <typename T, int VEC, int D>
static int launch_pass(const void* x, long long P, long long S, int F, Ranks r, float frac_lo,
                       float frac_hi, int blend_lo, int blend_hi, void* scratch, void* out,
                       int blocks_per_frame, cudaStream_t s) {
  clip_pass<T, VEC, D><<<dim3(blocks_per_frame, F), K1_THREADS, 0, s>>>(
      (const T*)x, P, S, r, frac_lo, frac_hi, blend_lo, blend_hi, (int*)scratch, (float*)out, F);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_digit(const void* x, long long P, long long S, int F, int d, Ranks r,
                        float frac_lo, float frac_hi, int blend_lo, int blend_hi, void* scratch,
                        void* out, int blocks_per_frame, cudaStream_t s) {
  constexpr int ND = n_digits((int)sizeof(T));
  switch (d) {
    case 0: return launch_pass<T, VEC, 0>(x, P, S, F, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, s);
    case 1: if constexpr (ND > 1) return launch_pass<T, VEC, 1>(x, P, S, F, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, s);
            break;
    case 2: if constexpr (ND > 2) return launch_pass<T, VEC, 2>(x, P, S, F, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, s);
            break;
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_typed(const void* x, long long P, long long S, int F, int d, Ranks r,
                        float frac_lo, float frac_hi, int blend_lo, int blend_hi, void* scratch,
                        void* out, int blocks_per_frame, int vec, cudaStream_t s) {
  if (vec)
    return launch_digit<T, 16 / (int)sizeof(T)>(x, P, S, F, d, r, frac_lo, frac_hi, blend_lo,
                                                 blend_hi, scratch, out, blocks_per_frame, s);
  return launch_digit<T, 1>(x, P, S, F, d, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out,
                            blocks_per_frame, s);
}

extern "C" {

// Pass d of a call (d = 0 .. digits - 1: 1 for uint8, 2 for uint16, 3 for
// float32; one launch each, in order on one stream).  dtype: 0 = uint8,
// 1 = uint16, 2 = float32.  x holds F rows of P values, row f starting at
// x + f*S (S = P: an (F, P) array; S < P: overlapping rows, as the Siam pair
// rows).  k0..k3: the floor and ceil ranks of q_lo and of q_hi.  scratch:
// F * frame_words int32, zero at rest (the wrapper's, one a stream);
// frame_words must equal K1_FRAME_WORDS.  The last pass writes out, (4, F)
// float32: lo, hi, fmin, fmax.
int k1_clip_pass(const void* x, int dtype, long long P, long long S, int F, int d, int k0,
                 int k1, int k2, int k3, float frac_lo, float frac_hi, int blend_lo,
                 int blend_hi, void* scratch, int frame_words, void* out, int blocks_per_frame,
                 int vec, void* stream) {
  if (frame_words != K1_FRAME_WORDS || F < 1 || F > 65535 || blocks_per_frame < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  Ranks r;
  r.k[0] = k0;
  r.k[1] = k1;
  r.k[2] = k2;
  r.k[3] = k3;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_typed<uint8_t>(x, P, S, F, d, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, vec, s);
    case 1: return launch_typed<uint16_t>(x, P, S, F, d, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, vec, s);
    case 2: return launch_typed<float>(x, P, S, F, d, r, frac_lo, frac_hi, blend_lo, blend_hi, scratch, out, blocks_per_frame, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
