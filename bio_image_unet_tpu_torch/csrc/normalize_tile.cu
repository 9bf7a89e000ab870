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
// once (n_pad * th * tw bytes, 16 MB for the exact 256-tile grid).  This
// kernel writes every output byte once and reads the source directly: one
// thread makes VEC (4) neighbouring pixels of one tile row, mapping each
// through the grid start and the reflect pad to its source pixel, normalizing
// it in float32 and truncating.  Nothing intermediate touches device memory;
// overlapping tiles re-read source pixels, which stay in L2 (50 MB).
//
// Exactness: clip = min(max(v, lo), hi) as jnp.clip; (v - fmin) / (fmax - fmin)
// * 255 with __fsub_rn/__fdiv_rn/__fmul_rn (no FMA, IEEE division), 255 - v
// for invert, truncation toward zero to uint8 -- the same float32 steps as the
// JAX program, so the tiles are bit-identical.
//
// K2h replaces bio_image_unet_tpu/predict/predictor.py:1101-1117 (the
// multi-head fused program: _normalize_clip with scale=1.0, the reflect pad,
// :102 _extract_tiles, the batch padded by the last tile, and the forward's
// astype of the float32 tile to the working dtype, :455).  Same gather, same
// float32 steps with scale 1 (times 1.0 is exact), no truncation: the tile is
// written as float32 or rounded to bfloat16 (round to nearest even, as
// astype does).  Bound by bytes as K2; its output is 2 or 4 bytes a pixel.
//
// K2v is the 3D form.  It replaces bio_image_unet_tpu/predict/predictor.py
// :1222-1235 (Predict3D's fused program: _normalize_clip over the whole
// volume's bounds, jnp.pad(mode="reflect") of the axes the tile exceeds,
// astype(uint8), :158 _extract_tiles_3d over the :143 _tile_plan_3d grid, the
// batch padded by the last tile) and :1324-1340 (PredictMultiOutput3D's:
// scale 1, per-volume or stack-global bounds, the tile in the working dtype).
// The JAX program materialises the normalized float32 volume, the padded
// volume and three axis gathers.  Here one thread makes VEC neighbouring
// voxels of one tile row (z, x fixed, VEC consecutive y): it maps each
// through the grid start and the reflect pad of each axis to its source
// voxel and normalizes it with K2's float32 steps.  Bound by bytes: the least
// work reads each source voxel once and writes each tile voxel once
// (n_pad * tz * tx * ty * sizeof(out)); overlapping tiles re-read source
// voxels from L2.

//
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
// steps of _normalize_clip (predictor.py:203), each rounded once
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

// O = uint8_t: K2 (scale 255, truncation); O = float or __nv_bfloat16: K2h
// (scale 1).
template <typename T, typename O, int VEC>
__global__ void normalize_tile(const T* __restrict__ x, int H, int W,
                               const float* __restrict__ bounds, int Fb,
                               const int* __restrict__ xs, const int* __restrict__ ys,
                               int nx, int ny, int th, int tw, long long n_real,
                               long long n_total, int invert, float scale,
                               O* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_total * th * (tw / VEC)) return;
  const TileRow tr(g, th, tw, VEC, nx, ny, n_real);

  int pr = xs[tr.i] + tr.r;
  if (pr >= H) pr = 2 * (H - 1) - pr;  // numpy/jnp 'reflect' (edge not repeated)
  const T* row = x + ((size_t)tr.f * H + pr) * W;
  const Norm norm(bounds, Fb, Fb == 1 ? 0 : (int)tr.f, scale, invert);

  float res[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    int pc = ys[tr.j] + tr.c0 + k;
    if (pc >= W) pc = 2 * (W - 1) - pc;
    res[k] = norm((float)row[pc]);
  }
  store_row<O, VEC>(out + (size_t)tr.t * th * tw + (size_t)tr.r * tw + tr.c0, res);
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

template <typename T, typename O>
static int launch(const void* x, int H, int W, const void* bounds, int Fb,
                  const void* xs, const void* ys, int nx, int ny, int th, int tw,
                  long long n_real, long long n_total, int invert, float scale, void* out,
                  void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (tw % 4 == 0) {
    const long long groups = n_total * th * (tw / 4);
    const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
    normalize_tile<T, O, 4><<<blocks, threads, 0, s>>>(
        (const T*)x, H, W, (const float*)bounds, Fb, (const int*)xs, (const int*)ys,
        nx, ny, th, tw, n_real, n_total, invert, scale, (O*)out);
  } else {
    const long long groups = n_total * th * tw;
    const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
    normalize_tile<T, O, 1><<<blocks, threads, 0, s>>>(
        (const T*)x, H, W, (const float*)bounds, Fb, (const int*)xs, (const int*)ys,
        nx, ny, th, tw, n_real, n_total, invert, scale, (O*)out);
  }
  return (int)cudaGetLastError();
}

// K2v: tiles (n_total, tz, tx, ty) of (V, D, H, W) volumes in volume-major
// z/x/y grid order; O = uint8_t: scale 255 and truncation, float or
// __nv_bfloat16: scale 1.
template <typename T, typename O, int VEC>
__global__ void normalize_tile_3d(const T* __restrict__ x, int D, int H, int W,
                                  const float* __restrict__ bounds, int Fb,
                                  const int* __restrict__ zs, const int* __restrict__ xs,
                                  const int* __restrict__ ys, int nz, int nx, int ny, int tz,
                                  int tx, int ty, long long n_real, long long n_total,
                                  int invert, float scale, O* __restrict__ out) {
  const int tyv = ty / VEC;
  const long long per_tile = (long long)tz * tx * tyv;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_total * per_tile) return;
  const long long t = g / per_tile;
  const int rem = (int)(g - t * per_tile);
  const int rz = rem / (tx * tyv);
  const int rem2 = rem - rz * tx * tyv;
  const int rx = rem2 / tyv;
  const int c0 = (rem2 - rx * tyv) * VEC;

  // batch padding repeats the last real tile
  const long long ts = t < n_real ? t : n_real - 1;
  const int per = nz * nx * ny;
  const long long v = ts / per;
  const int ijk = (int)(ts - v * per);
  const int iz = ijk / (nx * ny);
  const int ij = ijk - iz * nx * ny;
  const int ix = ij / ny, iy = ij - (ij / ny) * ny;

  int pz = zs[iz] + rz;
  if (pz >= D) pz = 2 * (D - 1) - pz;  // numpy/jnp 'reflect' (edge not repeated)
  int px = xs[ix] + rx;
  if (px >= H) px = 2 * (H - 1) - px;
  const T* row = x + (((size_t)v * D + pz) * H + px) * W;

  const Norm norm(bounds, Fb, Fb == 1 ? 0 : (int)v, scale, invert);

  O* o = out + (size_t)t * tz * tx * ty + ((size_t)rz * tx + rx) * ty + c0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    int py = ys[iy] + c0 + k;
    if (py >= W) py = 2 * (W - 1) - py;
    store(o + k, norm((float)row[py]));
  }
}

template <typename T, typename O>
static int launch_3d(const void* x, int D, int H, int W, const void* bounds, int Fb,
                     const void* zs, const void* xs, const void* ys, int nz, int nx, int ny,
                     int tz, int tx, int ty, long long n_real, long long n_total, int invert,
                     float scale, void* out, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = ty % 4 == 0 ? 4 : 1;
  const long long groups = n_total * tz * tx * (ty / vec);
  const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
  if (vec == 4)
    normalize_tile_3d<T, O, 4><<<blocks, threads, 0, s>>>(
        (const T*)x, D, H, W, (const float*)bounds, Fb, (const int*)zs, (const int*)xs,
        (const int*)ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, scale, (O*)out);
  else
    normalize_tile_3d<T, O, 1><<<blocks, threads, 0, s>>>(
        (const T*)x, D, H, W, (const float*)bounds, Fb, (const int*)zs, (const int*)xs,
        (const int*)ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, scale, (O*)out);
  return (int)cudaGetLastError();
}

template <typename O>
static int dispatch_3d(const void* x, int dtype, int D, int H, int W, const void* bounds,
                       int Fb, const void* zs, const void* xs, const void* ys, int nz, int nx,
                       int ny, int tz, int tx, int ty, long long n_real, long long n_total,
                       int invert, float scale, void* out, void* stream) {
  switch (dtype) {
    case 0: return launch_3d<uint8_t, O>(x, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, scale, out, stream);
    case 1: return launch_3d<uint16_t, O>(x, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, scale, out, stream);
    case 2: return launch_3d<float, O>(x, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, scale, out, stream);
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

template <typename O>
static int dispatch(const void* x, int dtype, int H, int W, const void* bounds, int Fb,
                    const void* xs, const void* ys, int nx, int ny, int th, int tw,
                    long long n_real, long long n_total, int invert, float scale, void* out,
                    void* stream) {
  switch (dtype) {
    case 0: return launch<uint8_t, O>(x, H, W, bounds, Fb, xs, ys, nx, ny, th, tw, n_real, n_total, invert, scale, out, stream);
    case 1: return launch<uint16_t, O>(x, H, W, bounds, Fb, xs, ys, nx, ny, th, tw, n_real, n_total, invert, scale, out, stream);
    case 2: return launch<float, O>(x, H, W, bounds, Fb, xs, ys, nx, ny, th, tw, n_real, n_total, invert, scale, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// dtype: 0 = uint8, 1 = uint16, 2 = float32.  x is (F, H, W) contiguous;
// bounds is (4, Fb) float32 (Fb = F per-frame, or 1 for stack-global bounds);
// xs (nx,) and ys (ny,) int32 tile starts; out is (n_total, th, tw) uint8.
int k2_normalize_tile(const void* x, int dtype, int H, int W, const void* bounds,
                      int Fb, const void* xs, const void* ys, int nx, int ny,
                      int th, int tw, long long n_real, long long n_total,
                      int invert, void* out, void* stream) {
  return dispatch<uint8_t>(x, dtype, H, W, bounds, Fb, xs, ys, nx, ny, th, tw, n_real,
                           n_total, invert, 255.0f, out, stream);
}

// K2h: the same arguments; out is (n_total, th, tw) float32 (out_bf16 = 0)
// or bfloat16 (1) tiles of the frames normalized to [0, 1].
int k2h_normalize_tile_float(const void* x, int dtype, int H, int W, const void* bounds,
                             int Fb, const void* xs, const void* ys, int nx, int ny,
                             int th, int tw, long long n_real, long long n_total,
                             int invert, int out_bf16, void* out, void* stream) {
  if (out_bf16)
    return dispatch<__nv_bfloat16>(x, dtype, H, W, bounds, Fb, xs, ys, nx, ny, th, tw,
                                   n_real, n_total, invert, 1.0f, out, stream);
  return dispatch<float>(x, dtype, H, W, bounds, Fb, xs, ys, nx, ny, th, tw, n_real,
                         n_total, invert, 1.0f, out, stream);
}

// K2v: x is (V, D, H, W) contiguous (dtype as above); bounds (4, Fb) float32
// (Fb = V per-volume, or 1 stack-global); zs (nz,), xs (nx,), ys (ny,) int32
// tile starts; out is (n_total, tz, tx, ty): out_code 0 = uint8 (scale 255),
// 1 = float32, 2 = bfloat16 (scale 1).  Each tile may exceed its axis by
// less than the axis's extent (one reflection).  One launch.
int k2v_normalize_tile_3d(const void* x, int dtype, int D, int H, int W, const void* bounds,
                          int Fb, const void* zs, const void* xs, const void* ys, int nz,
                          int nx, int ny, int tz, int tx, int ty, long long n_real,
                          long long n_total, int invert, int out_code, void* out,
                          void* stream) {
  switch (out_code) {
    case 0: return dispatch_3d<uint8_t>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 255.0f, out, stream);
    case 1: return dispatch_3d<float>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 1.0f, out, stream);
    case 2: return dispatch_3d<__nv_bfloat16>(x, dtype, D, H, W, bounds, Fb, zs, xs, ys, nz, nx, ny, tz, tx, ty, n_real, n_total, invert, 1.0f, out, stream);
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
