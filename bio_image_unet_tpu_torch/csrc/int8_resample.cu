// K11, K11v: the x2 linear upsample of int8 activations, written straight
// into a channel range of the consumer's concat buffer.
//
// Replaces
//   K11  bio_image_unet_tpu/predict/quant_nested.py:249-253 (build_int8_apply_nested):
//        upsample_linear(q.astype(f32), 2, align_corners=True) (ops/functional.py:55-86
//        resize_linear), then round half to even and clip to +-127, the deeper UNet++
//        cell's int8 values at their own scale, concatenated after the partners;
//   K11v bio_image_unet_tpu/predict/quant3d.py:305-310: the same x2 of NDHWC int8
//        values with half-pixel centres (the trilinear UNet3D decoder), into the first
//        channels of the decoder's concat buffer.
// The JAX package leaves both to XLA as a gather, a blend per axis and a concat.
//
// What bounds them on the card: bytes.  An output byte costs one input byte
// read (each input pixel feeds 4 or 8 outputs: read once from HBM, the rest
// from L2) and one byte written: at 3.35 TB/s the (16, 256^2, 64) ->
// (16, 512^2, 64) main shape needs 0.100 ms.  int8 <-> float32 conversions
// (I2F, F2I, FRND) issue at a quarter of the FMA rate on sm_90, so a design
// that converts every corner of every output (4 or 8 a byte) is held by them.
//
// K11 (2D) stages and converts each input byte once:
// - a block owns K11_ROWS output rows of one image, a strip of tile_w output
//   columns and up to K11_MAX_VECS channel vectors of V bytes (V = 16 where
//   the channel count, both row strides, the offset and both addresses allow
//   it, else 8, 4, 2 or 1: ops/int8.py _vec_width);
// - it copies the input rows and columns those outputs need (at most
//   K11_ROWS/2 + 2 rows, tile_w/2 + 2 columns: the ratio is below 1/2) into
//   shared memory with cp.async (byte loads for V < 4), from a channel range
//   of a wider row buffer too, and the rows' and columns' blend weights;
// - the H pass: a thread per (staged column, 4 channels) converts each staged
//   row once (a float's bits 0x4B000000 | (v + 128), minus 2^23 + 128: exact,
//   on the full-rate pipes), keeps the two rows an output row blends in
//   registers as it walks the block's output rows, and writes their H blend
//   to shared memory as float32;
// - the W pass: a thread per (output row, channel vector, run of K11_RUN
//   output pixels) blends the H blends of each pixel's two columns, rounds by
//   an add of 1.5*2^23 (the float's low byte is then the integer), packs four
//   bytes and clips them at -127 with one __vmaxs4, and stores V bytes into
//   the concat buffer; a warp's stores cover consecutive pixels of one row;
// - a thread's channel vector is threadIdx.x % gb for the whole block, so no
//   loop divides.
// What holds it: the row buffers' layout.  At the main shape it reads 64 of
// every 320 bytes and writes 64 of every 192; a kernel that only stores 16
// bytes a thread into that layout needs 0.167 ms against 0.088 for the same
// bytes contiguous (H100, chip_smoke.py [kernels nested int8]).
// K11v (3D) works in integers, so it converts nothing:
// - along each axis output 2j blends inputs (j-1, j) and 2j+1 blends (j, j+1)
//   with weights 1/4 and 3/4 (the neighbour clamped at the borders), so the
//   trilinear value is S/64 with S = sum w_z w_y w_x v, w in quarters: an
//   exact integer, |S| <= 64 * 128;
// - a block owns an output brick of K11V_T^3 voxels and up to K11V_VECS
//   channel vectors of V bytes; it copies the input brick those need
//   (K11V_T/2 + 2 voxels an axis, clamped at the borders) into shared memory
//   with cp.async, from rows of in_stride bytes;
// - each staged byte is biased by 128 (a byte XOR) and spread into a 16-bit
//   lane, two channels a 32-bit word (even channels in one word, odd in the
//   next); the biased sums stay non-negative and below 2^14, so one integer
//   multiply-add blends two channels without carries between lanes;
// - the W pass blends the staged columns of every staged row into shared
//   memory (3 a + b); then a thread per (output row, column, channel vector)
//   blends H from there and walks z with the last three planes' H blends in
//   registers, making two output planes a staged plane;
// - each lane's S + 64 * 128 is rounded half to even by a shift and the
//   remainder, (s + 31 + ((s >> 6) & 1)) >> 6, clipped at -127 beforehand by
//   a max of the biased sum with 64 (max.u16x2), packed into bytes by one
//   byte permutation per four channels and unbiased by an XOR; a 16-byte
//   store covers consecutive channels of one voxel and a warp covers eight
//   consecutive voxels of one row.
// What holds it: bytes and their layout, as K11: at up3 (16, 16x64^2, 64)
// into 64 of the 96 bytes of each voxel of the concat buffer it takes 0.281
// ms against 0.180 for its bytes and 0.187 for 16-byte stores alone into that
// layout (H100 80GB HBM3, 700 W, utils/kernel_ab_times.py).
//
// Numbers, kept exactly as the reference computes them, so a kernel equals
// its plain version bit for bit:
// - K11 (JAX, align_corners=True): per axis coords = float(i) * ratio, ratio
//   the float32 of (n-1)/(2n-1) (0 for n = 1) from the host, lo = floor
//   clipped to [0, n-1], hi = min(lo + 1, n - 1), t = coords - lo, 1 - t; the
//   axis H blend first, then W, each x_lo * (1-t) + x_hi * t, which XLA's CPU
//   backend contracts to fma(x_lo, 1-t, x_hi * t) (measured against JAX):
//   __fmul_rn then __fmaf_rn (the build's -fmad=false contracts nothing else),
//   the H blend of input columns x0 and x1 first and then their W blend, as
//   the reference does;
// - K11v (ATen's trilinear, align_corners=False, scale 1/2): source index
//   max(0.5 * (i + 0.5) - 0.5, 0), lo its floor, hi = lo + (lo < n-1),
//   weights l1 = index - lo and 1 - l1: output 2j takes 1/4 of input j-1 and
//   3/4 of j (all of input 0 at j = 0), 2j+1 takes 3/4 of j and 1/4 of j+1
//   (all of input n-1 at j = n-1).  Every product and sum of the reference
//   is a multiple of 1/64 under 128 and exact in float32, so it computes
//   S/64 exactly, and rintf(S/64) is the integer rounding above;
// - then round half to even (as jnp.round and torch.round: K11 the add of
//   1.5*2^23, exact for |v| < 2^22) and the clip.  K11's blends
//   of values in [-128, 127] stay within [-128, 127] once rounded (weights
//   summing to at most 1 + 2^-23), so its clip is the lower bound alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

template <int V>
struct VecOf;
template <>
struct VecOf<16> {
  using T = uint4;
};
template <>
struct VecOf<8> {
  using T = uint2;
};
template <>
struct VecOf<4> {
  using T = uint32_t;
};
template <>
struct VecOf<2> {
  using T = uint16_t;
};
template <>
struct VecOf<1> {
  using T = uint8_t;
};

template <int V>
union Pack {
  typename VecOf<V>::T v;
  int8_t b[V];
  uint32_t w[V >= 4 ? V / 4 : 1];
};

template <int V>
__device__ __forceinline__ Pack<V> load(const int8_t* p) {
  Pack<V> r;
  r.v = *reinterpret_cast<const typename VecOf<V>::T*>(p);
  return r;
}

// align_corners=True, JAX's float32 arithmetic (ops/functional.py:74-84)
__device__ __forceinline__ void aligned_axis(int i, int n, float ratio, int& lo, int& hi,
                                             float& t, float& omt) {
  const float c = __fmul_rn((float)i, ratio);
  lo = min(max((int)floorf(c), 0), n - 1);
  hi = min(lo + 1, n - 1);
  t = __fsub_rn(c, (float)lo);
  omt = __fsub_rn(1.0f, t);
}

// --- K11 -----------------------------------------------------------------------

constexpr int K11_THREADS = 256;
constexpr int K11_ROWS = 4;        // output rows a block
constexpr int K11_RUN = 4;         // output pixels a thread takes in the W pass
constexpr int K11_MAX_VECS = 64;   // channel vectors a block
constexpr int K11_MAX_DEVICES = 64;
constexpr float ROUND_MAGIC = 12582912.0f;  // 1.5 * 2^23

struct K11Args {
  const int8_t* x;  // (n, h, wd) pixels of in_stride bytes, C channels read
  int8_t* out;      // (n, 2h, 2wd) pixels of out_stride bytes, from out_off
  int n, h, wd, C, in_stride, out_stride, out_off;
  float ratio_h, ratio_w;
  int tile_w;  // output columns a block, a multiple of K11_RUN
  int chunks;  // groups of at most K11_MAX_VECS channel vectors (blocks along z)
};

__device__ __forceinline__ void cp_async_4_8_16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

// V int8 values to float32, exactly: 0x4B000000 | (v + 128) is the float
// 2^23 + v + 128
template <int V>
__device__ __forceinline__ void i8_to_float(const Pack<V>& a, float* f) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const uint32_t u = a.w[j] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * j + k] =
            __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)), 8388736.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      f[k] = __fsub_rn(__uint_as_float(0x4B000000u | ((uint8_t)a.b[k] ^ 0x80u)), 8388736.0f);
  }
}

// CW floats of the H blends (16-byte aligned where CW = 4)
template <int CW>
__device__ __forceinline__ void load_chunk(const float* a, float* f) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(a);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) f[j] = a[j];
  }
}

// blend4: output pixels i = 0..3 of a W-pass item, chunk k: the W blend of
// H blends lo[i], hi[i] with column weights t[i] (and 1 - t[i]), rounded,
// packed and clipped at -127 into word k of o[i]; CW < 4: bytes
template <int V, int CW>
__device__ __forceinline__ void blend4(const float (&lo)[K11_RUN][CW],
                                       const float (&hi)[K11_RUN][CW], const float* t, int k,
                                       Pack<V>* o) {
#pragma unroll
  for (int i = 0; i < K11_RUN; ++i) {
    const float omt = __fsub_rn(1.0f, t[i]);
    uint32_t bits[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c)
      bits[c] = __float_as_uint(
          __fadd_rn(__fmaf_rn(lo[i][c], omt, __fmul_rn(hi[i][c], t[i])), ROUND_MAGIC));
    if constexpr (CW == 4) {
      const uint32_t packed = __byte_perm(__byte_perm(bits[0], bits[1], 0x0040),
                                          __byte_perm(bits[2], bits[3], 0x0040), 0x5410);
      o[i].w[k] = __vmaxs4(packed, 0x81818181u);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i].b[c] = (int8_t)max((int)(int8_t)(bits[c] & 0xFFu), -127);
    }
  }
}

// where a block's shared memory holds what (bytes), and the H blends'
// pitches (in chunks of CW floats): the column and row weights, the staged
// input (nr, nc, gb vectors), the H blends (chunk k of 4 channels, output row
// r, column, vector).  pk is congruent to 4 (2 where gbm is not a multiple of
// 4) mod 8, so that the 8-lane phases of the H pass's 16-byte stores (vector
// g, then chunk k) hit 8 distinct bank groups.
struct K11Smem {
  int rows, in, hb, total, pr, pk;
};

__host__ __device__ __forceinline__ K11Smem k11_layout(int tile_w, int gbm, int v) {
  const int cw = v < 4 ? v : 4, max_cols = tile_w / 2 + 2;
  K11Smem m;
  m.pr = max_cols * gbm;
  const int want = gbm % 4 == 0 ? 4 : 2;
  m.pk = K11_ROWS * m.pr + ((want - K11_ROWS * m.pr) % 8 + 8) % 8;
  m.rows = tile_w * 8;  // after the column weights
  m.in = m.rows + K11_ROWS * 8;
  m.hb = m.in + ((K11_ROWS / 2 + 2) * max_cols * gbm * v + 15) / 16 * 16;
  m.total = m.hb + (v / cw) * m.pk * cw * 4;
  return m;
}

// the weights of output index i of an axis: (lo - first | (hi - first) << 16,
// the bits of t); 1 - t is recomputed as aligned_axis does
__device__ __forceinline__ int2 axis_weights(int i, int n, float ratio, int first) {
  int lo, hi;
  float t, omt;
  aligned_axis(i, n, ratio, lo, hi, t, omt);
  return make_int2((lo - first) | ((hi - first) << 16), __float_as_int(t));
}

// K11: (n, h, w, C) int8 in rows of in_stride bytes -> channels [out_off,
// out_off + C) of rows of out_stride bytes, (n, 2h, 2w, out_stride).  Block
// (strip, band, image x chunk) computes K11_ROWS output rows, tile_w output
// columns and up to K11_MAX_VECS channel vectors.  Thread threadIdx.x takes
// channel vector threadIdx.x % gb and items threadIdx.x / gb + i *
// (K11_THREADS / gb) of each pass.
template <int V>
__global__ void __launch_bounds__(K11_THREADS) upsample2x_i8(const K11Args p) {
  constexpr int CW = V < 4 ? V : 4;  // channels of one float chunk
  constexpr int NK = V / CW;         // chunks a vector
  constexpr int LOG_NK = NK == 4 ? 2 : NK == 2 ? 1 : 0;
  extern __shared__ __align__(16) uint8_t k11_smem[];
  const int G = p.C / V, ho = 2 * p.h, wo = 2 * p.wd;
  const K11Smem m = k11_layout(p.tile_w, min(G, K11_MAX_VECS), V);
  int2* s_cols = reinterpret_cast<int2*>(k11_smem);           // [tile_w]
  int2* s_rows = reinterpret_cast<int2*>(k11_smem + m.rows);  // [K11_ROWS]
  int8_t* s_in = reinterpret_cast<int8_t*>(k11_smem + m.in);
  float* s_hb = reinterpret_cast<float*>(k11_smem + m.hb);

  // the tile: output rows [ya, ya + nrow), columns [xa, xa + ncol), vectors
  // [g0, g0 + gb) of image ni, from staged rows [ylo, ylo + nr), columns
  // [xlo, xlo + nc)
  const int ni = blockIdx.z / p.chunks, g0 = (blockIdx.z - ni * p.chunks) * K11_MAX_VECS;
  const int gb = min(G - g0, K11_MAX_VECS), cb = gb * V;
  const int ya = blockIdx.y * K11_ROWS, nrow = min(K11_ROWS, ho - ya);
  const int xa = blockIdx.x * p.tile_w, ncol = min(p.tile_w, wo - xa);
  int ylo, xlo, nr, nc;
  {
    int unused, last;
    float t0, t1;
    aligned_axis(ya, p.h, p.ratio_h, ylo, unused, t0, t1);
    aligned_axis(ya + nrow - 1, p.h, p.ratio_h, unused, last, t0, t1);
    nr = last - ylo + 1;
    aligned_axis(xa, p.wd, p.ratio_w, xlo, unused, t0, t1);
    aligned_axis(xa + ncol - 1, p.wd, p.ratio_w, unused, last, t0, t1);
    nc = last - xlo + 1;
  }
  const int tpg = K11_THREADS / gb, g = threadIdx.x % gb, e = threadIdx.x / gb;
  const bool active = e < tpg;

  // 1. the copies of the input (cp.async; byte loads below 4 bytes) and the
  // weights (rows and columns past the image repeat the last one)
  if (active) {
    const int8_t* img = p.x + (long long)ni * p.h * p.wd * p.in_stride + (g0 + g) * V;
    for (int iy = 0; iy < nr; ++iy) {
      const int8_t* src = img + ((long long)(ylo + iy) * p.wd + xlo) * p.in_stride;
      int8_t* dst = s_in + (iy * nc * gb + g) * V;
      for (int ix = e; ix < nc; ix += tpg) {
        if constexpr (V >= 4)
          cp_async_4_8_16(dst + ix * cb, src + (long long)ix * p.in_stride, V);
        else
          *reinterpret_cast<typename VecOf<V>::T*>(dst + ix * cb) =
              *reinterpret_cast<const typename VecOf<V>::T*>(src + (long long)ix * p.in_stride);
      }
    }
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < p.tile_w; c += K11_THREADS)
    s_cols[c] = axis_weights(min(xa + c, wo - 1), p.wd, p.ratio_w, xlo);
  if (threadIdx.x < K11_ROWS)
    s_rows[threadIdx.x] = axis_weights(min(ya + (int)threadIdx.x, ho - 1), p.h, p.ratio_h, ylo);
  cp_async_wait_all();
  __syncthreads();

  // 2. the H pass: chunk k of vector g of staged column ix, every output row
  // in turn, each staged byte converted once
  if (active) {
    for (int j = e; j < nc * NK; j += tpg) {
      const int k = j & (NK - 1), ix = j >> LOG_NK;
      const int8_t* col = s_in + ix * cb + g * V + k * CW;  // + staged row * nc * cb
      float* hb = s_hb + (k * m.pk + ix * gb + g) * CW;     // + output row * pr * CW
      float fa[CW], fb[CW];
      int ra = -1, rb = -1;  // the staged rows in fa, fb
#pragma unroll
      for (int r = 0; r < K11_ROWS; ++r) {
        if (r >= nrow) break;
        const int2 w = s_rows[r];
        const int y0 = w.x & 0xFFFF, y1 = w.x >> 16;
        if (y0 != ra) {
          if (y0 == rb) {
#pragma unroll
            for (int c = 0; c < CW; ++c) fa[c] = fb[c];
          } else {
            i8_to_float<CW>(load<CW>(col + y0 * nc * cb), fa);
          }
          ra = y0;
        }
        if (y1 != rb) {
          if (y1 == ra) {
#pragma unroll
            for (int c = 0; c < CW; ++c) fb[c] = fa[c];
          } else {
            i8_to_float<CW>(load<CW>(col + y1 * nc * cb), fb);
          }
          rb = y1;
        }
        const float ty = __int_as_float(w.y), oty = __fsub_rn(1.0f, ty);
        float h[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) h[c] = __fmaf_rn(fa[c], oty, __fmul_rn(fb[c], ty));
        float* dst = hb + r * m.pr * CW;
        if constexpr (CW == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
        else
#pragma unroll
          for (int c = 0; c < CW; ++c) dst[c] = h[c];
      }
    }
  }
  __syncthreads();

  // 3. the W pass: output row r, vector g, pixels [c0, c0 + K11_RUN) of the
  // tile, a chunk of CW channels at a time; lanes take neighbouring vectors,
  // then neighbouring runs of one row
  if (!active) return;
  const int runs = (ncol + K11_RUN - 1) / K11_RUN;
  for (int j = e; j < runs * nrow; j += tpg) {
    const int r = j / runs, c0 = (j - r * runs) * K11_RUN;
    const float* row = s_hb + (r * m.pr + g) * CW;  // + k * pk * CW + column * gb * CW
    int x0[K11_RUN], x1[K11_RUN];
    float tw[K11_RUN];
#pragma unroll
    for (int i = 0; i < K11_RUN; ++i) {
      const int2 w = s_cols[c0 + i];
      x0[i] = w.x & 0xFFFF;
      x1[i] = w.x >> 16;
      tw[i] = __int_as_float(w.y);
    }
    Pack<V> o[K11_RUN];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      float lo[K11_RUN][CW], hi[K11_RUN][CW];
#pragma unroll
      for (int i = 0; i < K11_RUN; ++i) {
        load_chunk<CW>(row + (k * m.pk + x0[i] * gb) * CW, lo[i]);
        load_chunk<CW>(row + (k * m.pk + x1[i] * gb) * CW, hi[i]);
      }
      blend4<V, CW>(lo, hi, tw, k, o);
    }
    const int cnt = min(K11_RUN, ncol - c0);
    int8_t* dst = p.out + (((long long)ni * ho + ya + r) * wo + xa + c0) * p.out_stride +
                  p.out_off + (g0 + g) * V;
#pragma unroll
    for (int i = 0; i < K11_RUN; ++i)
      if (i < cnt) *reinterpret_cast<typename VecOf<V>::T*>(dst + i * p.out_stride) = o[i].v;
  }
}

// --- K11v ----------------------------------------------------------------------

constexpr int K11V_THREADS = 256;
constexpr int K11V_T = 8;                 // output voxels a block along each axis
constexpr int K11V_S = K11V_T / 2 + 2;    // staged input voxels a block along each axis
constexpr int K11V_VECS = 4;              // channel vectors a block
constexpr uint32_t LANE_BIAS = 0x80808080u;

struct K11vArgs {
  const int8_t* x;  // (n, d, h, wd) voxels of in_stride bytes, C channels read
  int8_t* out;      // (n, 2d, 2h, 2wd) voxels of out_stride bytes, from out_off
  int n, d, h, wd, C, in_stride, out_stride, out_off;
  int tiles_z, chunks;  // tiles of planes, groups of at most K11V_VECS channel vectors
  int log_z, log_c;     // blockIdx.z = (image << (log_c + log_z)) | (group << log_z) | tile,
                        // 2^log_z >= tiles_z, 2^log_c >= chunks: no division
};

// 32-bit words of 16-bit lanes a vector of V channels spreads into
template <int V>
__host__ __device__ constexpr int k11v_words() {
  return V >= 2 ? V / 2 : 1;
}

// the staged input (K11V_S^3 voxels x K11V_VECS vectors of V bytes), then the
// W blends (K11V_S^2 staged rows x K11V_T output columns x K11V_VECS vectors
// of k11v_words<V>() words)
template <int V>
__host__ __device__ constexpr int k11v_in_bytes() {
  return (K11V_S * K11V_S * K11V_S * K11V_VECS * V + 15) / 16 * 16;
}

template <int V>
__host__ __device__ constexpr int k11v_smem() {
  return k11v_in_bytes<V>() + K11V_S * K11V_S * K11V_T * K11V_VECS * k11v_words<V>() * 4;
}

// output index o of an axis of n inputs: the input it takes 3/4 of (near)
// and the one it takes 1/4 of (far: below for even o, above for odd, clamped
// at the borders), relative to the first staged input lo
__device__ __forceinline__ void k11v_axis(int o, int n, int lo, int& near, int& far) {
  const int j = o >> 1;
  near = j - lo;
  far = ((o & 1) ? min(j + 1, n - 1) : max(j - 1, 0)) - lo;
}

// B staged bytes -> (B + 1) / 2 words of biased 16-bit lanes (v + 128): for
// each 4 bytes, channels 0 and 2 in one word, 1 and 3 in the next
template <int B>
__device__ __forceinline__ void k11v_spread(const int8_t* p, uint32_t* w) {
  if constexpr (B >= 4) {
#pragma unroll
    for (int k = 0; k < B / 4; ++k) {
      const uint32_t u = reinterpret_cast<const uint32_t*>(p)[k] ^ LANE_BIAS;
      w[2 * k] = __byte_perm(u, 0, 0x4240);
      w[2 * k + 1] = __byte_perm(u, 0, 0x4341);
    }
  } else if constexpr (B == 2) {
    w[0] = __byte_perm(*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u, 0, 0x4140);
  } else {
    w[0] = (uint8_t)*p ^ 0x80u;
  }
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// each lane of s holds S + 64 * 128, S the blend in 64ths (|S| <= 64 * 128):
// round(S / 64) half to even, clipped at -127, plus 128, in the lane's low
// byte (the lanes' other bits are not used)
__device__ __forceinline__ uint32_t k11v_round(uint32_t s) {
  s = max_u16x2(s, 0x00400040u);
  return (s + 0x001F001Fu + ((s >> 6) & 0x00010001u)) >> 6;
}

// the rounded words of a vector -> its V int8 values
template <int V>
__device__ __forceinline__ typename VecOf<V>::T k11v_pack(const uint32_t* u) {
  Pack<V> r;
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) r.w[k] = __byte_perm(u[2 * k], u[2 * k + 1], 0x6240) ^ LANE_BIAS;
  } else if constexpr (V == 2) {
    r.v = (uint16_t)(__byte_perm(u[0], 0, 0x0020) ^ 0x8080u);
  } else {
    r.v = (uint8_t)(u[0] ^ 0x80u);
  }
  return r.v;
}

template <int N>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* w) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t* w) {
  if constexpr (N == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *p = w[0];
}

// K11v: (n, d, h, w, C) int8 in voxels of in_stride bytes -> channels
// [out_off, out_off + C) of (n, 2d, 2h, 2w, out_stride).  Block (tile of
// columns, tile of rows, (image, channel group, tile of planes)) makes
// K11V_T^3 output voxels of up to K11V_VECS channel vectors; the blocks past
// the last tile of planes or channel group return at once.
template <int V>
__global__ void __launch_bounds__(K11V_THREADS) upsample2x_i8_3d(const K11vArgs p) {
  constexpr int NW = k11v_words<V>();  // words a vector
  constexpr int QW = NW < 4 ? NW : 4;  // words a chunk (16 bytes at most)
  constexpr int NQ = NW / QW;          // chunks a vector
  constexpr int CB = V / NQ;           // input bytes a chunk
  constexpr int S = K11V_S, T = K11V_T, VECS = K11V_VECS;
  extern __shared__ __align__(16) uint8_t k11v_smem_buf[];
  int8_t* s_in = reinterpret_cast<int8_t*>(k11v_smem_buf);
  uint32_t* s_w = reinterpret_cast<uint32_t*>(k11v_smem_buf + k11v_in_bytes<V>());

  // the tile: output voxels [za, za + nzo) x [ya, ya + nyo) x [xa, xa + nxo),
  // vectors [g0, g0 + gb) of image ni, from staged inputs [zlo, zlo + nz) x
  // [ylo, ylo + ny) x [xlo, xlo + nx)
  const int tile_z = blockIdx.z & ((1 << p.log_z) - 1);
  const int chunk = (blockIdx.z >> p.log_z) & ((1 << p.log_c) - 1);
  if (tile_z >= p.tiles_z || chunk >= p.chunks) return;  // the whole block
  const int ni = blockIdx.z >> (p.log_z + p.log_c), g0 = chunk * VECS;
  const int gb = min(p.C / V - g0, VECS);
  const int xa = blockIdx.x * T, ya = blockIdx.y * T, za = tile_z * T;
  const int nzo = min(T, 2 * p.d - za), nyo = min(T, 2 * p.h - ya), nxo = min(T, 2 * p.wd - xa);
  const int zlo = max(za / 2 - 1, 0), nz = min(za / 2 + T / 2, p.d - 1) - zlo + 1;
  const int ylo = max(ya / 2 - 1, 0), ny = min(ya / 2 + T / 2, p.h - 1) - ylo + 1;
  const int xlo = max(xa / 2 - 1, 0), nx = min(xa / 2 + T / 2, p.wd - 1) - xlo + 1;

  // 1. the input brick (cp.async; byte loads below 4 bytes), voxel (iz, iy,
  // ix) vector g at ((iz * S + iy) * S + ix) * VECS + g
  const int8_t* img = p.x + (long long)ni * p.d * p.h * p.wd * p.in_stride + g0 * V;
  for (int i = threadIdx.x; i < S * S * S * VECS; i += K11V_THREADS) {
    const int g = i % VECS, vox = i / VECS;
    const int ix = vox % S, iy = vox / S % S, iz = vox / (S * S);
    if (g >= gb || ix >= nx || iy >= ny || iz >= nz) continue;
    const int8_t* src =
        img + (((long long)(zlo + iz) * p.h + ylo + iy) * p.wd + xlo + ix) * p.in_stride + g * V;
    if constexpr (V >= 4)
      cp_async_4_8_16(s_in + i * V, src, V);
    else
      *reinterpret_cast<typename VecOf<V>::T*>(s_in + i * V) =
          *reinterpret_cast<const typename VecOf<V>::T*>(src);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // 2. the W pass: chunk q of vector g, staged plane iz, row iy, output column
  // ox -> 3 a + b at word (((q * S + iz) * S + iy) * T + ox) * VECS + g of QW
  for (int i = threadIdx.x; i < NQ * S * S * T * VECS; i += K11V_THREADS) {
    const int g = i % VECS, ox = i / VECS % T, row = i / (VECS * T);
    const int iy = row % S, iz = row / S % S, q = row / (S * S);
    if (g >= gb || ox >= nxo || iy >= ny || iz >= nz) continue;
    int near, far;
    k11v_axis(xa + ox, p.wd, xlo, near, far);
    const int8_t* staged = s_in + ((iz * S + iy) * S * VECS + g) * V + q * CB;
    uint32_t a[QW], b[QW];
    k11v_spread<CB>(staged + near * VECS * V, a);
    k11v_spread<CB>(staged + far * VECS * V, b);
#pragma unroll
    for (int k = 0; k < QW; ++k) a[k] = a[k] * 3u + b[k];
    store_words<QW>(s_w + i * QW, a);
  }
  __syncthreads();

  // 3. output row oy, column ox, vector g: the H blend of each staged plane,
  // then the D blend walking z, two output planes a staged plane; a warp
  // takes the vectors of eight consecutive voxels of one row
  const int g = threadIdx.x % VECS, ox = threadIdx.x / VECS % T, oy = threadIdx.x / (VECS * T);
  if (g >= gb || ox >= nxo || oy >= nyo) return;
  int yn, yf;
  k11v_axis(ya + oy, p.h, ylo, yn, yf);
  const uint32_t* wn = s_w + ((yn * T + ox) * VECS + g) * QW;  // + (q * S + iz) * S * T * VECS * QW
  const uint32_t* wf = s_w + ((yf * T + ox) * VECS + g) * QW;
  auto hblend = [&](int iz, uint32_t* h) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int plane = (q * S + iz) * S * T * VECS * QW;
      uint32_t a[QW], b[QW];
      load_words<QW>(wn + plane, a);
      load_words<QW>(wf + plane, b);
#pragma unroll
      for (int k = 0; k < QW; ++k) h[q * QW + k] = a[k] * 3u + b[k];
    }
  };
  const int j0 = za >> 1;
  uint32_t prev[NW], cur[NW], next[NW];
  hblend(max(j0 - 1, 0) - zlo, prev);
  hblend(j0 - zlo, cur);
  const long long plane = (long long)2 * p.h * 2 * p.wd * p.out_stride;
  int8_t* dst = p.out +
                ((((long long)ni * 2 * p.d + za) * 2 * p.h + ya + oy) * 2 * p.wd + xa + ox) *
                    p.out_stride +
                p.out_off + (g0 + g) * V;
#pragma unroll
  for (int k = 0; k < T; k += 2) {
    if (k >= nzo) break;
    hblend(min(j0 + k / 2 + 1, p.d - 1) - zlo, next);
    uint32_t lo[NW], hi[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t c3 = cur[w] * 3u;
      lo[w] = k11v_round(prev[w] + c3);
      hi[w] = k11v_round(c3 + next[w]);
      prev[w] = cur[w];
      cur[w] = next[w];
    }
    *reinterpret_cast<typename VecOf<V>::T*>(dst) = k11v_pack<V>(lo);
    *reinterpret_cast<typename VecOf<V>::T*>(dst + plane) = k11v_pack<V>(hi);
    dst += 2 * plane;
  }
}

// raise kernel's dynamic shared-memory limit to smem bytes, once per device
// for the most a launch has asked (set: one slot a device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem, std::atomic<int>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= K11_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    set[dev].store((int)smem, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// K11: the block tile from the channel vectors (K11_THREADS items of the W
// pass where the width allows), shared memory as the kernel lays it out
template <int V>
cudaError_t launch_2d(const void* x, void* out, int n, int h, int wd, int C, int in_stride,
                      int out_stride, int out_off, float ratio_h, float ratio_w, cudaStream_t st) {
  if ((long long)n * h * wd * C == 0) return cudaSuccess;
  // the tile: K11_THREADS W-pass items where the width allows
  const int G = C / V, gb = G < K11_MAX_VECS ? G : K11_MAX_VECS;
  const int wo = 2 * wd, ho = 2 * h;
  int tile_w = K11_THREADS / (K11_ROWS * gb) * K11_RUN;
  if (tile_w < K11_RUN) tile_w = K11_RUN;
  const int wo_run = (wo + K11_RUN - 1) / K11_RUN * K11_RUN;
  if (tile_w > wo_run) tile_w = wo_run;
  const int chunks = (G + K11_MAX_VECS - 1) / K11_MAX_VECS;
  const long long bands = (ho + K11_ROWS - 1) / K11_ROWS;
  if (bands > 65535 || (long long)n * chunks > 65535) return cudaErrorInvalidValue;
  const long long smem = k11_layout(tile_w, gb, V).total;
  auto kernel = upsample2x_i8<V>;
  static std::atomic<int> smem_set[K11_MAX_DEVICES];
  const cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  K11Args a;
  a.x = static_cast<const int8_t*>(x);
  a.out = static_cast<int8_t*>(out);
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.C = C;
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.ratio_h = ratio_h;
  a.ratio_w = ratio_w;
  a.tile_w = tile_w;
  a.chunks = chunks;
  const dim3 grid((unsigned)((wo + tile_w - 1) / tile_w), (unsigned)bands,
                  (unsigned)(n * chunks));
  kernel<<<grid, K11_THREADS, (size_t)smem, st>>>(a);
  return cudaGetLastError();
}

// K11v: one block a K11V_T^3 output tile and group of K11V_VECS vectors (the grid's
// z extent padded to powers of two of tiles of planes and of groups)
template <int V>
cudaError_t launch_3d(const void* x, void* out, int n, int d, int h, int wd, int C,
                      int in_stride, int out_stride, int out_off, cudaStream_t st) {
  if ((long long)n * d * h * wd * C == 0) return cudaSuccess;
  const int chunks = (C / V + K11V_VECS - 1) / K11V_VECS;
  const long long tiles_x = (2LL * wd + K11V_T - 1) / K11V_T;
  const long long tiles_y = (2LL * h + K11V_T - 1) / K11V_T;
  const int tiles_z = (2 * d + K11V_T - 1) / K11V_T;
  int log_z = 0, log_c = 0;
  while ((1 << log_z) < tiles_z) ++log_z;
  while ((1 << log_c) < chunks) ++log_c;
  if (tiles_x > INT32_MAX || tiles_y > 65535 || ((long long)n << (log_z + log_c)) > 65535)
    return cudaErrorInvalidValue;
  auto kernel = upsample2x_i8_3d<V>;
  static std::atomic<int> smem_set[K11_MAX_DEVICES];
  const cudaError_t err = allow_smem(kernel, k11v_smem<V>(), smem_set);
  if (err != cudaSuccess) return err;
  K11vArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.out = static_cast<int8_t*>(out);
  a.n = n;
  a.d = d;
  a.h = h;
  a.wd = wd;
  a.C = C;
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.tiles_z = tiles_z;
  a.chunks = chunks;
  a.log_z = log_z;
  a.log_c = log_c;
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, (unsigned)(n << (log_z + log_c)));
  kernel<<<grid, K11V_THREADS, (size_t)k11v_smem<V>(), st>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const void* x, void* out, int n, int d, int h, int wd, int C, int in_stride,
                   int out_stride, int out_off, float ratio_h, float ratio_w, cudaStream_t st) {
  return d ? launch_3d<V>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off, st)
           : launch_2d<V>(x, out, n, h, wd, C, in_stride, out_stride, out_off, ratio_h, ratio_w,
                          st);
}

}  // namespace

extern "C" {

// d = 0: K11 on (n, h, w, C), align_corners=True, ratio_h / ratio_w the
// float32 of (h-1)/(2h-1) and (w-1)/(2w-1); d > 0: K11v on (n, d, h, w, C),
// half-pixel.  The input's pixels are in_stride bytes apart (C, or more for a
// channel range of a wider buffer).  vec: bytes a thread moves (16, 8, 4, 2
// or 1), dividing C, in_stride, out_stride, out_off and both addresses.
int k11_upsample2x_i8(const void* x, void* out, int n, int d, int h, int wd, int C,
                      int in_stride, int out_stride, int out_off, int vec, float ratio_h,
                      float ratio_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16:
      return (int)launch<16>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off,
                              ratio_h, ratio_w, st);
    case 8:
      return (int)launch<8>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off,
                              ratio_h, ratio_w, st);
    case 4:
      return (int)launch<4>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off,
                              ratio_h, ratio_w, st);
    case 2:
      return (int)launch<2>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off,
                              ratio_h, ratio_w, st);
    case 1:
      return (int)launch<1>(x, out, n, d, h, wd, C, in_stride, out_stride, out_off,
                              ratio_h, ratio_w, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
