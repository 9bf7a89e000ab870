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
// the least time is one read of it at 3.35 TB/s (~5 us).  The bitwise search
// would read the chunk n_bits times (8, 16 or 32), so this kernel selects by
// radix instead: one pass per 8-bit digit of the order-preserving key (1 pass
// for uint8, 2 for uint16, 4 for float32).  Each pass builds, per frame and per
// wanted order statistic, a 256-bin histogram of the current digit among the
// pixels whose higher digits match that statistic's prefix so far.  Blocks
// count in shared memory and add their non-zero bins to global memory with
// integer atomics, so the result is exact and deterministic.  The min and max
// are order statistics 0 and P-1 and ride along in the same passes, so there
// is no separate min/max sweep.  A pass recovers the prefixes of the passes
// before it from their histograms (one warp per statistic, a warp scan over
// 256 bins), so no launch is spent on a separate select step; a last one-block-
// per-frame launch selects the final digit, blends and clamps.
//
// Exactness: selection is exact (same order statistics as the bit search);
// the blend lo + frac*(hi - lo) uses __fmul_rn/__fadd_rn (no FMA), with frac
// = float32(pos - floor(pos)) computed on the host as JAX's weak typing does.

#include <cuda_runtime.h>
#include <stdint.h>

#define NSTAT 6
#define NBIN 256
#define HIST_THREADS 256

struct Ranks {
  int k[NSTAT];
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

__device__ __forceinline__ float key_to_float(uint32_t k) {
  uint32_t b = (k >> 31) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(b);
}

// Digits 0..d-1 of order statistic `s` of frame `f`, rebuilt from the pass
// histograms: returns the key prefix and the rank left within it.  Called by
// a whole warp.
__device__ void select_prefix(const int* __restrict__ hist, int F, int f, int s,
                              int d, int rank, uint32_t* prefix_out,
                              int* rank_out) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int dd = 0; dd < d; ++dd) {
    const int* h = hist + ((size_t)(dd * F + f) * NSTAT + (dd == 0 ? 0 : s)) * NBIN;
    int c[8];
    int local = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = h[lane * 8 + i];
      local += c[i];
    }
    int incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - local;
    const unsigned hit = __ballot_sync(0xffffffffu, excl <= rank && rank < incl);
    const int src = __ffs(hit) - 1;
    int bucket = 0, left = 0;
    if (lane == src) {
      int acc = excl;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (rank < acc + c[i]) {
          bucket = lane * 8 + i;
          left = rank - acc;
          break;
        }
        acc += c[i];
      }
    }
    bucket = __shfl_sync(0xffffffffu, bucket, src);
    rank = __shfl_sync(0xffffffffu, left, src);
    prefix = (prefix << 8) | (uint32_t)bucket;
  }
  *prefix_out = prefix;
  *rank_out = rank;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(HIST_THREADS)
hist_pass(const T* __restrict__ x, long long P, long long S, int F, int d, int n_digits,
          Ranks ranks, int* __restrict__ hist) {
  __shared__ int sh[NSTAT * NBIN];
  __shared__ uint32_t s_prefix[NSTAT];
  const int f = blockIdx.y;
  const int n_active = (d == 0) ? 1 : NSTAT;
  for (int i = threadIdx.x; i < n_active * NBIN; i += blockDim.x) sh[i] = 0;
  if (d > 0) {
    const int warp = threadIdx.x >> 5;
    if (warp < NSTAT) {
      uint32_t pre;
      int r;
      select_prefix(hist, F, f, warp, d, ranks.k[warp], &pre, &r);
      if ((threadIdx.x & 31) == 0) s_prefix[warp] = pre;
    }
  }
  __syncthreads();

  uint32_t pre[NSTAT];
#pragma unroll
  for (int s = 0; s < NSTAT; ++s) pre[s] = (d > 0) ? s_prefix[s] : 0u;
  const int shift = (n_digits - 1 - d) * 8;  // bit offset of digit d
  const int hshift = shift + 8;               // bits above digit d (<= 24 when d > 0)

  auto count = [&](T v) {
    const uint32_t key = to_key<T>(v);
    const int dig = (key >> shift) & 0xFF;
    if (d == 0) {
      atomicAdd(&sh[dig], 1);
    } else {
      const uint32_t hi = key >> hshift;
#pragma unroll
      for (int s = 0; s < NSTAT; ++s)
        if (hi == pre[s]) atomicAdd(&sh[s * NBIN + dig], 1);
    }
  };

  const T* xf = x + (size_t)f * S;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC > 1) {
    // 16-byte loads: P and S are multiples of VEC and the rows 16-byte aligned
    const uint4* xv = reinterpret_cast<const uint4*>(xf);
    const long long nv = P / VEC;
    for (long long i = tid; i < nv; i += stride) {
      uint4 w = xv[i];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) count(e[k]);
    }
  } else {
    for (long long i = tid; i < P; i += stride) count(xf[i]);
  }
  __syncthreads();

  int* hf = hist + (size_t)(d * F + f) * NSTAT * NBIN;
  for (int i = threadIdx.x; i < n_active * NBIN; i += blockDim.x) {
    const int c = sh[i];
    if (c) atomicAdd(&hf[i], c);
  }
}

// One block of NSTAT warps per frame: last digit, blend, clamp.
__global__ void finalize(const int* __restrict__ hist, int F, int n_digits,
                         Ranks ranks, float frac_lo, float frac_hi, int blend_lo,
                         int blend_hi, int is_float, float* __restrict__ out) {
  __shared__ float val[NSTAT];
  const int f = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  if (warp < NSTAT) {
    uint32_t key;
    int r;
    select_prefix(hist, F, f, warp, n_digits, ranks.k[warp], &key, &r);
    if ((threadIdx.x & 31) == 0) val[warp] = is_float ? key_to_float(key) : (float)key;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // stats: 0 = min, 1/2 = floor/ceil of q_lo, 3/4 = floor/ceil of q_hi, 5 = max
    const float lo = blend_lo ? __fadd_rn(val[1], __fmul_rn(frac_lo, __fsub_rn(val[2], val[1])))
                              : val[1];
    const float hi = blend_hi ? __fadd_rn(val[3], __fmul_rn(frac_hi, __fsub_rn(val[4], val[3])))
                              : val[3];
    out[0 * F + f] = lo;
    out[1 * F + f] = hi;
    out[2 * F + f] = fmaxf(val[0], lo);
    out[3 * F + f] = fminf(val[5], hi);
  }
}

template <typename T>
static int launch_hist(const void* x, long long P, long long S, int F, int d, int n_digits,
                       Ranks r, void* hist, int blocks_per_frame, int vec,
                       void* stream) {
  dim3 grid(blocks_per_frame, F);
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int V = 16 / sizeof(T);
  if (vec)
    hist_pass<T, V><<<grid, HIST_THREADS, 0, s>>>((const T*)x, P, S, F, d, n_digits, r, (int*)hist);
  else
    hist_pass<T, 1><<<grid, HIST_THREADS, 0, s>>>((const T*)x, P, S, F, d, n_digits, r, (int*)hist);
  return (int)cudaGetLastError();
}

static Ranks make_ranks(int k0, int k1, int k2, int k3, int k4, int k5) {
  Ranks r;
  r.k[0] = k0; r.k[1] = k1; r.k[2] = k2; r.k[3] = k3; r.k[4] = k4; r.k[5] = k5;
  return r;
}

extern "C" {

// dtype: 0 = uint8, 1 = uint16, 2 = float32.  x holds F rows of P values,
// row f starting at x + f*S (S = P: an (F, P) array; S < P: overlapping
// rows, as the Siam pair rows); hist is (n_digits, F, NSTAT, NBIN) int32,
// zeroed by the caller.  One launch.
int k1_hist_pass(const void* x, int dtype, long long P, long long S, int F, int d, int n_digits,
                 int k0, int k1, int k2, int k3, int k4, int k5, void* hist,
                 int blocks_per_frame, int vec, void* stream) {
  Ranks r = make_ranks(k0, k1, k2, k3, k4, k5);
  switch (dtype) {
    case 0: return launch_hist<uint8_t>(x, P, S, F, d, n_digits, r, hist, blocks_per_frame, vec, stream);
    case 1: return launch_hist<uint16_t>(x, P, S, F, d, n_digits, r, hist, blocks_per_frame, vec, stream);
    case 2: return launch_hist<float>(x, P, S, F, d, n_digits, r, hist, blocks_per_frame, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out is (4, F) float32: lo, hi, fmin, fmax.  One launch.
int k1_finalize(const void* hist, int F, int n_digits, int k0, int k1, int k2,
                int k3, int k4, int k5, float frac_lo, float frac_hi, int blend_lo,
                int blend_hi, int is_float, void* out, void* stream) {
  Ranks r = make_ranks(k0, k1, k2, k3, k4, k5);
  finalize<<<F, NSTAT * 32, 0, (cudaStream_t)stream>>>(
      (const int*)hist, F, n_digits, r, frac_lo, frac_hi, blend_lo, blend_hi,
      is_float, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
