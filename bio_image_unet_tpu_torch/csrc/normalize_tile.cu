// K2: fused normalize -> reflect pad -> uint8 -> tile gather -> batch pad,
// and K2h, its float-tile mode for the multi-head path.
//
// Replaces the fused-pipeline stage at bio_image_unet_tpu/predict/predictor.py
// :742-755 (:203 _normalize_clip, jnp.pad(mode="reflect"), astype(uint8),
// :102 _extract_tiles, and the batch padded by repeating the last tile).  The
// JAX program materialises the normalized float32 frames, the padded frames,
// the uint8 frames and the row-gathered frames before the column gather.
//
// What bounds it on the card: bytes.  The least work reads each source pixel
// once (16 MB for a (16, 1024, 1024) uint8 chunk) and writes each tile pixel
// once (n_pad * th * tw bytes, 16 MB for the exact 256-tile grid).  The
// kernel (normalize_tile<T, O, RUN, false>) writes every output byte once and reads
// the source directly; nothing intermediate touches device memory, and
// overlapping tiles re-read source pixels from L2 (50 MB).  Its design
// keeps the instructions a byte below what the bytes take:
//
// - A block owns a strip of one tile (blocks_per_tile strips a tile, iters
//   runs a thread, both chosen by the wrapper, predict/normalize.py
//   _k2_geometry), so the tile's frame, grid cell and bounds are worked out
//   once a block, with one division, not once a thread.
// - A thread makes RUN = 16 outputs of one tile row (where 16 divides the
//   tile width; else 1): 16-byte stores, and, where the run lies inside the
//   frame at a 16-byte aligned address (the exact grid's column starts are
//   multiples of 256), 16-byte loads; the reflect and gather grids load
//   pixel by pixel.
// - uint8 frames: a block first maps the 256 levels its frame can hold
//   through the float32 steps into a table in shared memory; a pixel is then
//   one table read.  uint16 and float32 frames take the steps per pixel.
// - The division is IEEE's without __fdiv_rn's slow-path call (which saves
//   registers to local memory): the frame's reciprocal once, one float64
//   Newton step from the hardware estimate, and per pixel the float nearest
//   the product moved across the midpoint by an exact residual (NormRN).
//
// Exactness: clip = min(max(v, lo), hi) as jnp.clip; (v - fmin) / (fmax - fmin)
// * 255 with __fsub_rn, IEEE division and __fmul_rn (no FMA), 255 - v for
// invert, truncation toward zero to uint8 -- the same float32 steps as the
// JAX program, so the tiles are bit-identical (the table holds those steps'
// results).
//
// K2h replaces bio_image_unet_tpu/predict/predictor.py:1101-1117 (the
// multi-head fused program: _normalize_clip with scale=1.0, the reflect pad,
// :102 _extract_tiles, the batch padded by the last tile, and the forward's
// astype of the float32 tile to the working dtype, :455).  K2's kernel with
// O = float or __nv_bfloat16: the same float32 steps with scale 1 (times 1.0
// is exact), no truncation, the tile written as float32 or rounded to
// bfloat16 (round to nearest even, as astype does).  Bound by bytes as K2;
// its output is 2 or 4 bytes a pixel.
//
// K2v is the 3D form.  It replaces bio_image_unet_tpu/predict/predictor.py
// :1222-1235 (Predict3D's fused program: _normalize_clip over the whole
// volume's bounds, jnp.pad(mode="reflect") of the axes the tile exceeds,
// astype(uint8), :158 _extract_tiles_3d over the :143 _tile_plan_3d grid, the
// batch padded by the last tile) and :1324-1340 (PredictMultiOutput3D's:
// scale 1, per-volume or stack-global bounds, the tile in the working dtype).
// The JAX program materialises the normalized float32 volume, the padded
// volume and three axis gathers.  A 3D tile (tz, tx, ty) is tz stacked 2D
// (tx, ty) tiles of the planes reflect(zs[iz] + rz) of its volume, so K2v is
// K2's kernel with a 3D row map (normalize_tile<T, O, RUN, true>: a tile row
// R = rz * tx + rx, two divisions a run) and K2's design whole: a strip of
// one tile a block (its volume, grid cell, bounds and table once a block,
// 32-bit indices within the tile), 16 outputs a thread (one 16-byte store
// for uint8, two for bf16, four for float32), 16-byte loads where a run lies
// inside the volume (PredictMultiOutput3D's in-plane starts 0, 230 and 256:
// 230 is 6 mod 16, so those runs shift two aligned chunks into place), uint8
// volumes through the 256-level table, uint16 and float32 through NormRN.
// Bound by bytes: the least work reads each source voxel once and writes
// each tile voxel once (151 MB of bf16 for PredictMultiOutput3D's 18 tiles of
// (64, 256, 256)); overlapping tiles re-read source voxels from L2.

// K2p is the Siam pair mode.  It replaces the pair stage of
// bio_image_unet_tpu/predict/predictor.py:995-1010 (fused_predict_pairs:
// _normalize_clip of the prev planes block[:-1] and the cur planes block[1:]
// with their per-pair bounds, jnp.pad with ZEROS -- not reflect -- after the
// normalization, astype(uint8), :102 _extract_tiles of both, each set padded
// by its last tile).  One launch reads the (k+1, H, W) block and writes both
// tile sets, (2, n_total, th, tw) uint8: set 0 (prev) from frames 0..k-1,
// set 1 (cur) from frames 1..k.  K2's index math and float32 steps; a pixel
// past the frame is the normalized value 0 (so 0 under invert too).  The
// bounds are per source frame ('single': (4, k+1)) or per pair ('first',
// 'all': (4, k)).  Bound by bytes: the block read once, both tile sets
// written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void store(uint8_t* o, float v) { *o = (uint8_t)__float2uint_rz(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// clip to [lo, hi], min-max to [0, scale], optionally invert: the float32
// steps of _normalize_clip (predictor.py:203), each rounded once.  Only K2p
// (not redesigned) uses it: its __fdiv_rn keeps a slow-path call, which
// NormRN (below) does without.
struct Norm {
  float lo, hi, fmin, den, scale;
  bool span;
  int invert;
  __device__ __forceinline__ Norm(const float* bounds, int Fb, int col, float scale_, int inv)
      : scale(scale_), invert(inv) {
    lo = bounds[0 * Fb + col];
    hi = bounds[1 * Fb + col];
    fmin = bounds[2 * Fb + col];
    const float fmax = bounds[3 * Fb + col];
    span = fmax > fmin;
    den = __fsub_rn(fmax, fmin);
  }
  __device__ __forceinline__ float operator()(float v) const {
    v = fminf(fmaxf(v, lo), hi);
    v = span ? __fmul_rn(__fdiv_rn(__fsub_rn(v, fmin), den), scale) : 0.0f;
    return invert ? __fsub_rn(scale, v) : v;
  }
};

// The tile row segment of output group g of a (n_total, th, tw) tile set in
// frame-major grid order, VEC pixels a group: tile t, row r, first column
// c0, and the real tile it shows (batch padding repeats the last real tile):
// frame f, grid cell (i, j).
struct TileRow {
  long long t, f;
  int r, c0, i, j;
  __device__ __forceinline__ TileRow(long long g, int th, int tw, int vec, int nx, int ny,
                                     long long n_real) {
    const int twv = tw / vec;
    t = g / ((long long)th * twv);
    const int rem = (int)(g - t * th * twv);
    r = rem / twv;
    c0 = (rem - r * twv) * vec;
    const long long ts = t < n_real ? t : n_real - 1;
    const int per = nx * ny;
    f = ts / per;
    const int ij = (int)(ts - f * per);
    i = ij / ny;
    j = ij - i * ny;
  }
};

template <typename O, int VEC>
__device__ __forceinline__ void store_row(O* o, const float* res) {
  if constexpr (VEC == 4 && sizeof(O) == 1) {
    // uint8: one 4-byte store of the four truncated levels
    *reinterpret_cast<uchar4*>(o) =
        make_uchar4((uint8_t)__float2uint_rz(res[0]), (uint8_t)__float2uint_rz(res[1]),
                    (uint8_t)__float2uint_rz(res[2]), (uint8_t)__float2uint_rz(res[3]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) store(o + k, res[k]);
  }
}

constexpr int K2_THREADS = 256;  // one table entry a thread
constexpr int K2_RUN = 16;       // outputs a thread where 16 divides the tile width

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Norm's steps with IEEE division by the frame's span, without __fdiv_rn's
// slow-path call (which saves registers to local memory).  inv: 1/den from
// the hardware estimate (relative error below 2^-21; den scaled by 2^-64 or
// 2^64 first, exactly, where its reciprocal would leave the estimate's
// normal range) and one float64 Newton step, once a frame: within 2^-41 of
// 1/den, so z = |a| * inv lies within 2^12 float64 ulps of |a| / den.  Where
// the 29 bits of z below float32 precision are more than 2^13 from the
// half-way pattern (all but about 3e-5 of the quotients), |a| / den lies on
// the same side of the same midpoint and rounding z rounds the quotient.
// Else (and below 2^-126) the exact path: the float nearest z is the rounded
// quotient or a neighbour of it; the residual |a| - den q is exact in
// float64, and so are the half-gaps to q's neighbours times den, so q moves
// to the neighbour on whose side of the midpoint |a| / den lies.  A quotient
// is a midpoint only below 2^-126 (subnormal spacing): there the tie goes
// to the even neighbour, as IEEE division rounds it.  Needs a / den finite.
// (A float32 path -- the quotient from a float reciprocal corrected by fused
// multiply-adds, moved by its exact remainder -- was slower on the gather
// grid: PERF.md section 6.)
struct NormRN {
  float lo, hi, fmin, den, scale;
  double inv;
  bool span;
  int invert;
  __device__ __forceinline__ NormRN(const float* bounds, int Fb, int col, float scale_, int inv_)
      : scale(scale_), invert(inv_) {
    lo = bounds[0 * Fb + col];
    hi = bounds[1 * Fb + col];
    fmin = bounds[2 * Fb + col];
    const float fmax = bounds[3 * Fb + col];
    span = fmax > fmin;
    den = __fsub_rn(fmax, fmin);
    const float e = den > 0x1p100f ? 0x1p-64f : (den < 0x1p-100f ? 0x1p64f : 1.0f);
    const double y = (double)rcp_approx(span ? __fmul_rn(den, e) : 1.0f) * (double)e;
    inv = y * (2.0 - (double)den * y);
  }
  __device__ __forceinline__ float exact(double m) const {
    const double bd = den;
    float q = __double2float_rn(m * inv);
    const double r = m - bd * (double)q;
    const uint32_t qb = __float_as_uint(q);
    const float up = __uint_as_float(qb + 1u), dn = __uint_as_float(qb - 1u);
    const double h_up = bd * (0.5 * ((double)up - (double)q));
    const double h_dn = bd * (0.5 * ((double)q - (double)dn));
    if (r > h_up || (r == h_up && (qb & 1u)))
      q = up;
    else if (-r > h_dn || (-r == h_dn && (qb & 1u)))
      q = dn;
    return q;
  }
  __device__ __forceinline__ float quotient(float a) const {
    if (a == 0.0f) return a;
    const double m = fabs((double)a);
    const double z = m * inv;
    const int low = (int)(__double_as_longlong(z) & 0x1FFFFFFFLL) - (1 << 28);
    const float q = z >= 0x1p-126 && (low > 8192 || low < -8192) ? __double2float_rn(z)
                                                                  : exact(m);
    return copysignf(q, a);
  }
  __device__ __forceinline__ float operator()(float v) const {
    v = fminf(fmaxf(v, lo), hi);
    v = span ? __fmul_rn(quotient(__fsub_rn(v, fmin)), scale) : 0.0f;
    return invert ? __fsub_rn(scale, v) : v;
  }
};

template <typename O>
__device__ __forceinline__ O to_out(float v);
template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) { return (uint8_t)__float2uint_rz(v); }
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t out_bits(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t out_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t out_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// element k of a 16-byte vector (k a constant after unrolling: a register
// extract)
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

// RUN values from a 16-byte aligned address
template <typename T, int RUN>
__device__ __forceinline__ void load_run(const T* p, T* v) {
  constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < RUN / PER; ++q) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + q);
#pragma unroll
    for (int k = 0; k < PER; ++k) v[q * PER + k] = element<T>(w, k);
  }
}

// RUN values from a T-aligned address p with the run inside its row: the
// aligned 16-byte chunks that hold them (each holds a byte of the run, so
// none reads past the row), shifted into place word by word
template <typename T, int RUN>
__device__ __forceinline__ void load_run_shifted(const T* p, T* v) {
  constexpr int NW = RUN * (int)sizeof(T) / 4;  // words of the run
  constexpr int NC = NW / 4 + 1;                // chunks that may hold it
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
  const int o = (int)(a & 15);
  const int last = (o + NW * 4 - 1) >> 4;  // the last chunk holding a byte of the run
  uint32_t w[4 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint4 u = c <= last ? __ldg(base + c) : make_uint4(0u, 0u, 0u, 0u);
    w[4 * c] = u.x;
    w[4 * c + 1] = u.y;
    w[4 * c + 2] = u.z;
    w[4 * c + 3] = u.w;
  }
  const int q = o >> 2, sh = (o & 3) * 8;
  uint32_t s[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i)
    s[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 word = make_uint4(__funnelshift_r(s[i], s[i + 1], sh), 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 4 / (int)sizeof(T); ++k) v[i * (4 / (int)sizeof(T)) + k] = element<T>(word, k);
  }
}

// RUN outputs to a 16-byte aligned address, 16 bytes a store
template <typename O, int RUN>
__device__ __forceinline__ void store_run(O* o, const O* res) {
  if constexpr (RUN == 1) {
    *o = res[0];
  } else {
    constexpr int PER_WORD = 4 / (int)sizeof(O);
    constexpr int WORDS = RUN / PER_WORD;
    uint32_t wd[WORDS];
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      wd[q] = 0u;
#pragma unroll
      for (int k = 0; k < PER_WORD; ++k)
        wd[q] |= out_bits(res[q * PER_WORD + k]) << (8 * (int)sizeof(O) * k);
    }
#pragma unroll
    for (int q = 0; q < WORDS / 4; ++q)
      reinterpret_cast<uint4*>(o)[q] =
          make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]);
  }
}

// O = uint8_t: K2 / K2v (scale 255, truncation); O = float or
// __nv_bfloat16: K2h / K2v's float mode (scale 1).  Block b makes strip b %
// blocks_per_tile of tile b / blocks_per_tile: its thread's runs start at
// elements (strip * iters + it) * K2_THREADS * RUN + threadIdx.x * RUN of the
// tile (it < iters).  VOL = false (K2): a tile is th rows of tw of frame f,
// grid cell (i, j).  VOL = true (K2v): a tile (tz, th, tw) is tz stacked 2D
// tiles, its row R = rz * th + rx from row reflect(xs[i] + rx) of plane
// reflect(zs[iz] + rz) of volume v, grid cell (iz, i, j); d, zs, nz and tz
// are read only there.
template <typename T, typename O, int RUN, bool VOL>
__global__ void __launch_bounds__(K2_THREADS)
normalize_tile(const T* __restrict__ x, int d, int H, int W, const float* __restrict__ bounds,
               int Fb, const int* __restrict__ zs, const int* __restrict__ xs,
               const int* __restrict__ ys, int nz, int nx, int ny, int tz, int th, int tw,
               long long n_real, int blocks_per_tile, int iters, int invert, float scale,
               O* __restrict__ out) {
  static_assert(K2_THREADS == 256, "one table entry a thread");
  __shared__ __align__(16) unsigned char table_bytes[256 * sizeof(O)];
  O* table = reinterpret_cast<O*>(table_bytes);
  const unsigned b = blockIdx.x;
  const long long t = b / (unsigned)blocks_per_tile;
  const int strip = (int)(b - (unsigned)t * (unsigned)blocks_per_tile);
  const long long ts = t < n_real ? t : n_real - 1;  // batch padding repeats the last real tile
  const int per = (VOL ? nz : 1) * nx * ny;
  const long long f = ts / per;  // the frame (K2) or the volume (K2v)
  int ij = (int)(ts - f * per);
  int z0 = 0;
  if constexpr (VOL) {
    const int iz = ij / (nx * ny);
    ij -= iz * nx * ny;
    z0 = zs[iz];
  }
  const int gi = ij / ny;
  const int x0 = xs[gi], y0 = ys[ij - gi * ny];
  const NormRN norm(bounds, Fb, Fb == 1 ? 0 : (int)f, scale, invert);
  if constexpr (sizeof(T) == 1) {
    // every level a uint8 frame can hold, through the float32 steps once
    table[threadIdx.x] = to_out<O>(norm((float)threadIdx.x));
    __syncthreads();
  }
  const T* frame = x + (size_t)f * (VOL ? d : 1) * H * W;
  const int tile_px = (VOL ? tz : 1) * th * tw;
  O* tile = out + (size_t)t * tile_px;
  for (int it = 0; it < iters; ++it) {
    const int e = ((strip * iters + it) * K2_THREADS + (int)threadIdx.x) * RUN;
    if (e >= tile_px) break;
    const int r = e / tw, c0 = e - r * tw;
    const T* row;
    if constexpr (VOL) {
      const int rz = r / th;
      int pz = z0 + rz, pr = x0 + r - rz * th;
      if (pz >= d) pz = 2 * (d - 1) - pz;  // numpy/jnp 'reflect' (edge not repeated)
      if (pr >= H) pr = 2 * (H - 1) - pr;
      row = frame + ((size_t)pz * H + pr) * W;
    } else {
      int pr = x0 + r;
      if (pr >= H) pr = 2 * (H - 1) - pr;  // numpy/jnp 'reflect' (edge not repeated)
      row = frame + (size_t)pr * W;
    }
    const int pc0 = y0 + c0;
    T v[RUN];
    if (RUN > 1 && pc0 + RUN <= W) {
      if ((reinterpret_cast<uintptr_t>(row + pc0) & 15u) == 0)
        load_run<T, RUN>(row + pc0, v);
      else
        load_run_shifted<T, RUN>(row + pc0, v);
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        int pc = pc0 + k;
        if (pc >= W) pc = 2 * (W - 1) - pc;
        v[k] = row[pc];
      }
    }
    O res[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if constexpr (sizeof(T) == 1)
        res[k] = table[v[k]];
      else
        res[k] = to_out<O>(norm((float)v[k]));
    }
    store_run<O, RUN>(tile + e, res);
  }
}

// K2p: both tile sets of k Siam pairs, (2, n_total, th, tw) uint8, from a
// (k+1, H, W) block; zero pad; bounds (4, Fb): Fb = k+1 per source frame,
// Fb = k per pair, Fb = 1 global.
template <typename T, int VEC>
__global__ void normalize_tile_pairs(const T* __restrict__ x, int H, int W,
                                     const float* __restrict__ bounds, int Fb, int k,
                                     const int* __restrict__ xs, const int* __restrict__ ys,
                                     int nx, int ny, int th, int tw, long long n_real,
                                     long long n_total, int invert, uint8_t* __restrict__ out) {
  const long long per_set = n_total * th * (tw / VEC);
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= 2 * per_set) return;
  const int set = g >= per_set;  // 0: prev planes (frames f), 1: cur planes (frames f + 1)
  g -= set * per_set;
  const TileRow tr(g, th, tw, VEC, nx, ny, n_real);
  const long long src = tr.f + set;

  const int pr = xs[tr.i] + tr.r;
  const T* row = x + ((size_t)src * H + (pr < H ? pr : 0)) * W;
  const int col = Fb == k + 1 ? (int)src : (Fb == 1 ? 0 : (int)tr.f);
  const Norm norm(bounds, Fb, col, 255.0f, invert);

  float res[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const int pc = ys[tr.j] + tr.c0 + c;
    // the zero pad is applied to the normalized frame (jnp.pad after
    // _normalize_clip): a pixel past the frame is 0, inverted or not
    res[c] = (pr < H && pc < W) ? norm((float)row[pc]) : 0.0f;
  }
  store_row<uint8_t, VEC>(
      out + (size_t)set * n_total * th * tw + (size_t)tr.t * th * tw + (size_t)tr.r * tw + tr.c0,
      res);
}

// K2 and K2h (zs null, d = nz = tz = 1) and K2v: the wrapper's geometry must
// cover each tile, blocks_per_tile strips of iters * K2_THREADS runs of RUN
// outputs, the runs inside one row
template <typename T, typename O>
static int launch(const void* x, int d, int H, int W, const void* bounds, int Fb,
                  const void* zs, const void* xs, const void* ys, int nz, int nx, int ny, int tz,
                  int th, int tw, long long n_real, long long n_total, int invert, float scale,
                  int run, int blocks_per_tile, int iters, void* out, void* stream) {
  const long long tile_px = (long long)tz * th * tw;
  if ((run != 1 && !(run == K2_RUN && tw % K2_RUN == 0)) || blocks_per_tile < 1 || iters < 1 ||
      (long long)blocks_per_tile * iters * K2_THREADS * run < tile_px ||
      tile_px > 0x7FFFFFFFLL - (long long)K2_THREADS * K2_RUN ||
      n_total * blocks_per_tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(n_total * blocks_per_tile);
  cudaStream_t s = (cudaStream_t)stream;
#define K2_LAUNCH(R, V)                                                                      \
  normalize_tile<T, O, R, V><<<blocks, K2_THREADS, 0, s>>>(                                  \
      (const T*)x, d, H, W, (const float*)bounds, Fb, (const int*)zs, (const int*)xs,        \
      (const int*)ys, nz, nx, ny, tz, th, tw, n_real, blocks_per_tile, iters, invert, scale, \
      (O*)out)
  if (run == K2_RUN) {
    if (zs) K2_LAUNCH(K2_RUN, true); else K2_LAUNCH(K2_RUN, false);
  } else {
    if (zs) K2_LAUNCH(1, true); else K2_LAUNCH(1, false);
  }
#undef K2_LAUNCH
  return (int)cudaGetLastError();
}

template <typename O>
static int dispatch(const void* x, int dtype, int d, int H, int W, const void* bounds, int Fb,
                    const void* zs, const void* xs, const void* ys, int nz, int nx, int ny,
                    int tz, int th, int tw, long long n_real, long long n_total, int invert,
                    float scale, int run, int blocks_per_tile, int iters, void* out,
                    void* stream) {
  switch (dtype) {
    case 0: return launch<uint8_t, O>(x, d, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, th, tw, n_real, n_total, invert, scale, run, blocks_per_tile, iters, out, stream);
    case 1: return launch<uint16_t, O>(x, d, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, th, tw, n_real, n_total, invert, scale, run, blocks_per_tile, iters, out, stream);
    case 2: return launch<float, O>(x, d, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, th, tw, n_real, n_total, invert, scale, run, blocks_per_tile, iters, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_pairs(const void* x, int H, int W, const void* bounds, int Fb, int k,
                        const void* xs, const void* ys, int nx, int ny, int th, int tw,
                        long long n_real, long long n_total, int invert, void* out,
                        void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = tw % 4 == 0 ? 4 : 1;
  const long long groups = 2 * n_total * th * (tw / vec);
  const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
  if (vec == 4)
    normalize_tile_pairs<T, 4><<<blocks, threads, 0, s>>>(
        (const T*)x, H, W, (const float*)bounds, Fb, k, (const int*)xs, (const int*)ys, nx, ny,
        th, tw, n_real, n_total, invert, (uint8_t*)out);
  else
    normalize_tile_pairs<T, 1><<<blocks, threads, 0, s>>>(
        (const T*)x, H, W, (const float*)bounds, Fb, k, (const int*)xs, (const int*)ys, nx, ny,
        th, tw, n_real, n_total, invert, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 = uint8, 1 = uint16, 2 = float32.  x is (F, H, W) contiguous;
// bounds is (4, Fb) float32 (Fb = F per-frame, or 1 for stack-global bounds);
// xs (nx,) and ys (ny,) int32 tile starts; out is (n_total, th, tw) uint8.
// run, blocks_per_tile, iters: the launch geometry (predict/normalize.py
// _k2_geometry).  One launch.
int k2_normalize_tile(const void* x, int dtype, int H, int W, const void* bounds,
                      int Fb, const void* xs, const void* ys, int nx, int ny,
                      int th, int tw, long long n_real, long long n_total,
                      int invert, int run, int blocks_per_tile, int iters, void* out,
                      void* stream) {
  return dispatch<uint8_t>(x, dtype, 1, H, W, bounds, Fb, nullptr, xs, ys, 1, nx, ny, 1, th, tw,
                           n_real, n_total, invert, 255.0f, run, blocks_per_tile, iters, out,
                           stream);
}

// K2h: the same arguments; out is (n_total, th, tw) float32 (out_bf16 = 0)
// or bfloat16 (1) tiles of the frames normalized to [0, 1].
int k2h_normalize_tile_float(const void* x, int dtype, int H, int W, const void* bounds,
                             int Fb, const void* xs, const void* ys, int nx, int ny,
                             int th, int tw, long long n_real, long long n_total,
                             int invert, int out_bf16, int run, int blocks_per_tile, int iters,
                             void* out, void* stream) {
  if (out_bf16)
    return dispatch<__nv_bfloat16>(x, dtype, 1, H, W, bounds, Fb, nullptr, xs, ys, 1, nx, ny, 1,
                                   th, tw, n_real, n_total, invert, 1.0f, run, blocks_per_tile,
                                   iters, out, stream);
  return dispatch<float>(x, dtype, 1, H, W, bounds, Fb, nullptr, xs, ys, 1, nx, ny, 1, th, tw,
                         n_real, n_total, invert, 1.0f, run, blocks_per_tile, iters, out,
                         stream);
}

// K2v: x is (V, D, H, W) contiguous (dtype as above); bounds (4, Fb) float32
// (Fb = V per-volume, or 1 stack-global); zs (nz,), xs (nx,), ys (ny,) int32
// tile starts; out is (n_total, tz, tx, ty): out_code 0 = uint8 (scale 255),
// 1 = float32, 2 = bfloat16 (scale 1).  Each tile may exceed its axis by
// less than the axis's extent (one reflection).  run, blocks_per_tile,
// iters: K2's geometry of a tile of tz * tx rows of ty (predict/normalize.py
// _k2_geometry).  One launch.
int k2v_normalize_tile_3d(const void* x, int dtype, int D, int H, int W, const void* bounds,
                          int Fb, const void* zs, const void* xs, const void* ys, int nz,
                          int nx, int ny, int tz, int tx, int ty, long long n_real,
                          long long n_total, int invert, int out_code, int run,
                          int blocks_per_tile, int iters, void* out, void* stream) {
  if (zs == nullptr) return (int)cudaErrorInvalidValue;
  switch (out_code) {
    case 0: return dispatch<uint8_t>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 255.0f, run, blocks_per_tile, iters, out, stream);
    case 1: return dispatch<float>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 1.0f, run, blocks_per_tile, iters, out, stream);
    case 2: return dispatch<__nv_bfloat16>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 1.0f, run, blocks_per_tile, iters, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2p: x is the (k+1, H, W) block (dtype as above); bounds (4, Fb) float32
// with Fb = k+1 (per source frame), k (per pair) or 1; xs, ys int32 tile
// starts; out is (2, n_total, th, tw) uint8: the prev tiles of the k pairs,
// then their cur tiles, each set frame-major with n_real = k*nx*ny real
// tiles.  One launch.
int k2p_normalize_tile_pairs(const void* x, int dtype, int H, int W, const void* bounds,
                             int Fb, int k, const void* xs, const void* ys, int nx, int ny,
                             int th, int tw, long long n_real, long long n_total, int invert,
                             void* out, void* stream) {
  switch (dtype) {
    case 0: return launch_pairs<uint8_t>(x, H, W, bounds, Fb, k, xs, ys, nx, ny, th, tw, n_real, n_total, invert, out, stream);
    case 1: return launch_pairs<uint16_t>(x, H, W, bounds, Fb, k, xs, ys, nx, ny, th, tw, n_real, n_total, invert, out, stream);
    case 2: return launch_pairs<float>(x, H, W, bounds, Fb, k, xs, ys, nx, ny, th, tw, n_real, n_total, invert, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
