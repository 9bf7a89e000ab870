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
// K11v (3D) keeps the first design: a thread per (output voxel, vector of V
// channels), 8 vector loads of its corners, the blends in registers.
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
//   weights l1 = index - lo and 1 - l1, blended W innermost, then H, then D.
//   Every weight is 0, 1/4, 3/4 or 1 and the values are integers below 128,
//   so every product and sum is a multiple of 1/64 under 128 and exact in
//   float32: any order gives the same bits;
// - then round half to even (as jnp.round and torch.round: K11v rintf, K11
//   the add of 1.5*2^23, exact for |v| < 2^22) and the clip.  K11's blends
//   of values in [-128, 127] stay within [-128, 127] once rounded (weights
//   summing to at most 1 + 2^-23), so its clip is the lower bound alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ int8_t to_i8(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
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

// half-pixel centres at scale 1/2, ATen's compute_source_index_and_lambda
__device__ __forceinline__ void half_pixel_axis(int i, int n, int& lo, int& hi, float& l0,
                                                float& l1) {
  const float real = fmaxf(__fsub_rn(__fmul_rn(0.5f, __fadd_rn((float)i, 0.5f)), 0.5f), 0.0f);
  lo = min((int)floorf(real), n - 1);
  hi = lo + (lo < n - 1 ? 1 : 0);
  l1 = fminf(fmaxf(__fsub_rn(real, (float)lo), 0.0f), 1.0f);
  l0 = __fsub_rn(1.0f, l1);
}

__device__ __forceinline__ float lerp_exact(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
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

// K11v: (n, d, h, w, C) int8 in rows of in_stride bytes -> channels
// [out_off, out_off + C) of (n, 2d, 2h, 2w, out_stride)
template <int V>
__global__ void __launch_bounds__(THREADS)
upsample2x_i8_3d(const int8_t* __restrict__ x, int8_t* __restrict__ out, int n, int dd, int h,
                 int wd, int C, int in_stride, int out_stride, int out_off) {
  const int cv = C / V, dout = 2 * dd, ho = 2 * h, wo = 2 * wd;
  const unsigned total = (unsigned)n * dout * ho * wo * cv;
  const unsigned e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % cv) * V;
  unsigned p = e / cv;
  const int xo = (int)(p % wo);
  p /= wo;
  const int yo = (int)(p % ho);
  p /= ho;
  const int zo = (int)(p % dout);
  const int ni = (int)(p / dout);
  int z[2], y[2], xx[2];
  float lz[2], ly[2], lx[2];
  half_pixel_axis(zo, dd, z[0], z[1], lz[0], lz[1]);
  half_pixel_axis(yo, h, y[0], y[1], ly[0], ly[1]);
  half_pixel_axis(xo, wd, xx[0], xx[1], lx[0], lx[1]);
  const int8_t* base = x + (long long)ni * dd * h * wd * in_stride + c;
  Pack<V> a[2][2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        a[i][j][k] = load<V>(base + (((long long)z[i] * h + y[j]) * wd + xx[k]) * in_stride);
  Pack<V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float hz[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float w0 = lerp_exact((float)a[i][0][0].b[k], lx[0], (float)a[i][0][1].b[k], lx[1]);
      const float w1 = lerp_exact((float)a[i][1][0].b[k], lx[0], (float)a[i][1][1].b[k], lx[1]);
      hz[i] = lerp_exact(w0, ly[0], w1, ly[1]);
    }
    r.b[k] = to_i8(lerp_exact(hz[0], lz[0], hz[1], lz[1]));
  }
  *reinterpret_cast<typename VecOf<V>::T*>(
      out + ((((long long)ni * dout + zo) * ho + yo) * wo + xo) * out_stride + out_off + c) = r.v;
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
  // the shared-memory limit is raised once per device to the most a launch has asked
  static std::atomic<int> smem_set[K11_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= K11_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store((int)smem, std::memory_order_relaxed);
  }
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

template <int V>
cudaError_t launch_3d(const void* x, void* out, int n, int d, int h, int wd, int C,
                      int in_stride, int out_stride, int out_off, cudaStream_t st) {
  const long long total = (long long)n * 8 * d * h * wd * (C / V);
  if (total == 0) return cudaSuccess;
  if (total + THREADS > INT32_MAX) return cudaErrorInvalidValue;  // 32-bit thread indices
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  upsample2x_i8_3d<V><<<blocks, THREADS, 0, st>>>(static_cast<const int8_t*>(x),
                                                  static_cast<int8_t*>(out), n, d, h, wd, C,
                                                  in_stride, out_stride, out_off);
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
