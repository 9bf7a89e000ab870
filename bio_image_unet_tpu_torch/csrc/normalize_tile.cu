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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void store(uint8_t* o, float v) { *o = (uint8_t)__float2uint_rz(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// O = uint8_t: K2 (scale 255, truncation); O = float or __nv_bfloat16: K2h
// (scale 1).
template <typename T, typename O, int VEC>
__global__ void normalize_tile(const T* __restrict__ x, int H, int W,
                               const float* __restrict__ bounds, int Fb,
                               const int* __restrict__ xs, const int* __restrict__ ys,
                               int nx, int ny, int th, int tw, long long n_real,
                               long long n_total, int invert, float scale,
                               O* __restrict__ out) {
  const int twv = tw / VEC;
  const long long groups = n_total * th * twv;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long t = g / ((long long)th * twv);
  const int rem = (int)(g - t * th * twv);
  const int r = rem / twv;
  const int c0 = (rem - r * twv) * VEC;

  // batch padding repeats the last real tile
  const long long ts = t < n_real ? t : n_real - 1;
  const int per = nx * ny;
  const long long f = ts / per;
  const int ij = (int)(ts - f * per);
  const int i = ij / ny, j = ij - (ij / ny) * ny;

  int pr = xs[i] + r;
  if (pr >= H) pr = 2 * (H - 1) - pr;  // numpy/jnp 'reflect' (edge not repeated)
  const T* row = x + ((size_t)f * H + pr) * W;

  const int fb = Fb == 1 ? 0 : (int)f;
  const float lo = bounds[0 * Fb + fb], hi = bounds[1 * Fb + fb];
  const float fmin = bounds[2 * Fb + fb], fmax = bounds[3 * Fb + fb];
  const bool span = fmax > fmin;
  const float den = __fsub_rn(fmax, fmin);

  float res[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    int pc = ys[j] + c0 + k;
    if (pc >= W) pc = 2 * (W - 1) - pc;
    float v = (float)row[pc];
    v = fminf(fmaxf(v, lo), hi);
    v = span ? __fmul_rn(__fdiv_rn(__fsub_rn(v, fmin), den), scale) : 0.0f;
    if (invert) v = __fsub_rn(scale, v);
    res[k] = v;
  }
  O* o = out + (size_t)t * th * tw + (size_t)r * tw + c0;
  if constexpr (VEC == 4 && sizeof(O) == 1) {
    // K2: one 4-byte store of the four truncated levels
    *reinterpret_cast<uchar4*>(o) =
        make_uchar4((uint8_t)__float2uint_rz(res[0]), (uint8_t)__float2uint_rz(res[1]),
                    (uint8_t)__float2uint_rz(res[2]), (uint8_t)__float2uint_rz(res[3]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) store(o + k, res[k]);
  }
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

  const int fb = Fb == 1 ? 0 : (int)v;
  const float lo = bounds[0 * Fb + fb], hi = bounds[1 * Fb + fb];
  const float fmin = bounds[2 * Fb + fb], fmax = bounds[3 * Fb + fb];
  const bool span = fmax > fmin;
  const float den = __fsub_rn(fmax, fmin);

  O* o = out + (size_t)t * tz * tx * ty + ((size_t)rz * tx + rx) * ty + c0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    int py = ys[iy] + c0 + k;
    if (py >= W) py = 2 * (W - 1) - py;
    float f = fminf(fmaxf((float)row[py], lo), hi);
    f = span ? __fmul_rn(__fdiv_rn(__fsub_rn(f, fmin), den), scale) : 0.0f;
    if (invert) f = __fsub_rn(scale, f);
    store(o + k, f);
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

}  // extern "C"
