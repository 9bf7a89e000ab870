// K4: gather one training batch from the resident tile set and augment it.
//
// Replaces bio_image_unet_tpu/data/augment_jax.py:132 augment_batch (with
// :27-129: the per-sample rot90 by k and the H/V flips of _spatial_tx, the
// brightness/contrast, multiplicative-noise and Gaussian-noise stages of
// _intensity, the p_pipeline gate) and, in the Trainer's device-cache path,
// the gather `v[idx]` of bio_image_unet_tpu/train/trainer.py:569 in front of
// it.  The random draws are made by the caller (a torch.Generator) and passed
// in: per sample, the flags (gate, k, flip_h, flip_v, brightness/contrast
// apply, multiplicative apply, Gaussian apply) and (alpha, beta); per pixel,
// in the output frame, the multiplier field and the standard normal field.
//
// What bounds it on the card: bytes.  The least work reads each gathered
// source pixel of image and mask (and prev) once, each noise field once, and
// writes each output pixel once: about 16 MB for a batch of 12 one-channel
// 256^2 tiles with one noise field, a few microseconds at 3.35 TB/s.  There
// is no arithmetic to speak of, so the design is one pass: a thread owns 4
// neighbouring output pixels of one row of one sample, maps each back through
// flip_v, flip_h and rot90 to its source pixel (a rotated tile is read along
// a column, the gather's cost), applies the intensity stage to the image in
// registers, and stores 4 floats at once (float4) when the tile width allows.
// Mask and prev share the source offsets, so the index arithmetic is done
// once for all targets.
//
// Exactness: every float step is __fmul_rn/__fadd_rn (and the library is
// built with -fmad=false), so the image equals the plain version's
// x*alpha + beta, x*m, x + sigma*n, each clipped to [0, 1], step by step.
//
// K4h, the multi-head form in the same library, replaces
// bio_image_unet_tpu/data/augment_jax.py:192 augment_batch_heads (with
// :178 _orientation_components) and the same gather: one spatial draw per
// sample moves the image and every channel of the concatenated head targets
// (N, CT, S, S); a per-channel code table marks the (cos, sin) pairs of the
// orientation heads, which are re-expressed in the output frame from both
// components at the shared source pixel: c' = c*ck + s*sk, s' = s*ck - c*sk
// (ck, sk = cos, sin of k quarter turns, each 0 or +-1, so exact), then
// c' = -c' on flip_h and s' = -s' on flip_v.  The intensity stage touches the
// image only.  Same thread mapping as K4; same bound (bytes).
//
// K4v and K4hv, the 5-D forms of both (augment_jax.py:132 and :192 with
// image.ndim == 5), take resident volume sets (N, C, Z, S, S) (JAX's
// (B, Z, X, Y, C) moved to channels-first): rot90 and the flips move the
// (X, Y) plane alike for every z (spatial_axes=(1, 2), :147), and an
// orientation pair's partner is the same z of the neighbouring channel, Z
// planes away.  z is in the launch grid (blockIdx.y) so that a small batch
// of deep volumes still fills the card: the main path's 4 volumes of
// (16, 64, 64) are 16 x 16 blocks of 256 threads, where folding z into a
// per-thread loop would leave 4096 threads.  A thread's 4 source offsets are
// computed once and reused for every z it visits; every offset into a
// tensor is 64-bit (a (1 + 3)-channel 128^3 volume is 8.4 M floats, so a
// resident set of 256 of them passes 2^31).  Bound: bytes, as for K4 (the
// main path's step moves about 5 MB, some 1.6 microseconds at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { F_GATE = 0, F_K, F_FH, F_FV, F_BC, F_MULT, F_GAUSS, N_FLAGS };

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

struct Noise {
  const float* mult;   // (B, C[, Z], S, S) multiplier field or nullptr
  const float* gauss;  // (B, C[, Z], S, S) standard normal field or nullptr
};

__device__ __forceinline__ float intensity(float v, const int* fl, float alpha, float beta,
                                           Noise nz, float sigma, size_t o) {
  if (fl[F_BC]) v = clip01(__fadd_rn(__fmul_rn(v, alpha), beta));
  if (nz.mult != nullptr && fl[F_MULT]) v = clip01(__fmul_rn(v, nz.mult[o]));
  if (nz.gauss != nullptr && fl[F_GAUSS]) v = clip01(__fadd_rn(v, __fmul_rn(sigma, nz.gauss[o])));
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store(float* out, const float* v, int n) {
  if (VEC) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n; ++j) out[j] = v[j];
  }
}

// the offset of plane z of channel c of sample n in a (N, channels, zdim, S, S)
// tensor (zdim 1 for 2D tiles), 64-bit
__device__ __forceinline__ size_t plane_at(long long n, int channels, int c, int zdim, int z,
                                           size_t plane) {
  return (((size_t)n * channels + c) * zdim + z) * plane;
}

// one target (image, prev or mask): plane z of the `channels` channels of one
// gathered tile or volume
template <bool VEC>
__device__ __forceinline__ void emit(const float* __restrict__ src, float* __restrict__ out,
                                     long long s, int b, int channels, int zdim, int z,
                                     size_t plane, size_t out_row, const int* src_off, int nx,
                                     bool augment, const int* fl, float alpha, float beta,
                                     Noise nz, float sigma) {
  for (int c = 0; c < channels; ++c) {
    const float* p = src + plane_at(s, channels, c, zdim, z, plane);
    const size_t ob = plane_at(b, channels, c, zdim, z, plane) + out_row;
    float v[4];
    for (int j = 0; j < nx; ++j) {
      v[j] = p[src_off[j]];
      if (augment) v[j] = intensity(v[j], fl, alpha, beta, nz, sigma, ob + j);
    }
    store<VEC>(out + ob, v, nx);
  }
}

// the orientation-pair codes of K4h's per-channel table
enum { C_PLAIN = 0, C_COS = 1, C_SIN = 2 };

// head targets of one gathered tile (plane z of a volume): every channel
// moves with the image; the channels of an orientation pair are also rotated
// into the output frame.  A pair's partner is the same pixel of the same z
// in the neighbouring channel, zdim planes away.
template <bool VEC>
__device__ __forceinline__ void emit_heads(const float* __restrict__ src,
                                           float* __restrict__ out, long long s, int b,
                                           int channels, int zdim, int z, size_t plane,
                                           size_t out_row, const int* src_off, int nx,
                                           bool augment, const int* __restrict__ codes,
                                           const int* fl) {
  const int k = fl[F_K] & 3;
  const float ck = k == 0 ? 1.0f : (k == 2 ? -1.0f : 0.0f);
  const float sk = k == 1 ? 1.0f : (k == 3 ? -1.0f : 0.0f);
  const size_t chan = (size_t)zdim * plane;  // one channel's extent
  for (int c = 0; c < channels; ++c) {
    const float* p = src + plane_at(s, channels, c, zdim, z, plane);
    const size_t ob = plane_at(b, channels, c, zdim, z, plane) + out_row;
    int code = augment ? codes[c] : C_PLAIN;
    // a pair cut off by the channel range (a malformed table) only moves:
    // never read outside the tile
    if ((code == C_COS && c + 1 >= channels) || (code == C_SIN && c == 0)) code = C_PLAIN;
    float v[4];
    if (code == C_COS) {  // partner: the sin component in channel c + 1
      for (int j = 0; j < nx; ++j) {
        const float cv = p[src_off[j]], sv = p[chan + src_off[j]];
        const float r = __fadd_rn(__fmul_rn(cv, ck), __fmul_rn(sv, sk));
        v[j] = fl[F_FH] ? -r : r;
      }
    } else if (code == C_SIN) {  // partner: the cos component in channel c - 1
      for (int j = 0; j < nx; ++j) {
        const float sv = p[src_off[j]], cv = p[src_off[j] - (long long)chan];
        const float r = __fsub_rn(__fmul_rn(sv, ck), __fmul_rn(cv, sk));
        v[j] = fl[F_FV] ? -r : r;
      }
    } else {
      for (int j = 0; j < nx; ++j) v[j] = p[src_off[j]];
    }
    store<VEC>(out + ob, v, nx);
  }
}

// the sample, source row and source offsets of one thread's 4 output pixels
// (shared by K4 and K4h); false when the thread has no pixels
struct Pixels {
  int b, nx;
  long long s;
  bool gate;
  size_t out_row;
  int src_off[4];
};

__device__ __forceinline__ bool map_pixels(Pixels& px, const long long* __restrict__ index,
                                           int n_src, int B, int S,
                                           const int* __restrict__ flags) {
  const int groups = (S + 3) / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * S * groups) return false;
  const int g = (int)(t % groups);
  const long long row = t / groups;
  const int y = (int)(row % S);
  const int b = (int)(row / S);
  const int* fl = flags + (size_t)b * N_FLAGS;
  long long s = index != nullptr ? index[b] : b;
  s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);  // never read outside the tile set
  const bool gate = fl[F_GATE] != 0;
  const int k = fl[F_K] & 3;
  const int x0 = g * 4;
  const int nx = S - x0 < 4 ? S - x0 : 4;
  for (int j = 0; j < nx; ++j) {
    const int x = x0 + j;
    if (!gate) {  // the untransformed source pixel (augment_jax.py:155-156, :216-217)
      px.src_off[j] = y * S + x;
      continue;
    }
    // out = flip_v(flip_h(rot90(src, k))) (augment_jax.py:41-47): undo the
    // flips, then read rot90's pixel (yy, xx) from the source
    const int yy = fl[F_FV] ? S - 1 - y : y;
    const int xx = fl[F_FH] ? S - 1 - x : x;
    int sy, sx;
    switch (k) {
      case 0: sy = yy; sx = xx; break;
      case 1: sy = xx; sx = S - 1 - yy; break;
      case 2: sy = S - 1 - yy; sx = S - 1 - xx; break;
      default: sy = S - 1 - xx; sx = yy; break;
    }
    px.src_off[j] = sy * S + sx;
  }
  px.b = b;
  px.nx = nx;
  px.s = s;
  px.gate = gate;
  px.out_row = (size_t)y * S + x0;
  return true;
}

template <bool VEC>
__global__ void augment_heads(const float* __restrict__ img_src, const float* __restrict__ tgt_src,
                              const long long* __restrict__ index, int n_src, int B, int ci,
                              int ct, int S, const int* __restrict__ codes,
                              const int* __restrict__ flags, const float* __restrict__ coef,
                              Noise noise, float sigma, float* __restrict__ img_out,
                              float* __restrict__ tgt_out) {
  Pixels px;
  if (!map_pixels(px, index, n_src, B, S, flags)) return;
  const int* fl = flags + (size_t)px.b * N_FLAGS;
  const float alpha = coef[2 * px.b], beta = coef[2 * px.b + 1];
  const size_t plane = (size_t)S * S;
  emit<VEC>(img_src, img_out, px.s, px.b, ci, 1, 0, plane, px.out_row, px.src_off, px.nx,
            px.gate, fl, alpha, beta, noise, sigma);
  emit_heads<VEC>(tgt_src, tgt_out, px.s, px.b, ct, 1, 0, plane, px.out_row, px.src_off, px.nx,
                  px.gate, codes, fl);
}

template <bool VEC>
__global__ void augment_batch(const float* __restrict__ img_src, const float* __restrict__ mask_src,
                              const float* __restrict__ prev_src, const long long* __restrict__ index,
                              int n_src, int B, int ci, int co, int S,
                              const int* __restrict__ flags, const float* __restrict__ coef,
                              Noise img_noise, Noise prev_noise, float sigma,
                              float* __restrict__ img_out, float* __restrict__ mask_out,
                              float* __restrict__ prev_out) {
  Pixels px;
  if (!map_pixels(px, index, n_src, B, S, flags)) return;
  const int* fl = flags + (size_t)px.b * N_FLAGS;
  const float alpha = coef[2 * px.b], beta = coef[2 * px.b + 1];
  const size_t plane = (size_t)S * S;
  emit<VEC>(img_src, img_out, px.s, px.b, ci, 1, 0, plane, px.out_row, px.src_off, px.nx,
            px.gate, fl, alpha, beta, img_noise, sigma);
  if (prev_src != nullptr)
    emit<VEC>(prev_src, prev_out, px.s, px.b, ci, 1, 0, plane, px.out_row, px.src_off, px.nx,
              px.gate, fl, alpha, beta, prev_noise, sigma);
  emit<VEC>(mask_src, mask_out, px.s, px.b, co, 1, 0, plane, px.out_row, px.src_off, px.nx,
            false, fl, alpha, beta, img_noise, sigma);
}

// K4v and K4hv, the 5-D forms: (N, C, Z, S, S) volumes, rot90 and flips in
// the (X, Y) plane alike for every z.  blockIdx.x maps (sample, row,
// 4-pixel group) as K4's grid does, so a thread computes its 4 source offsets
// once (map_pixels); blockIdx.y walks the z planes, and the thread reuses
// those offsets for every z it visits.
template <bool VEC>
__global__ void augment_volume(const float* __restrict__ img_src,
                               const float* __restrict__ mask_src,
                               const long long* __restrict__ index, int n_src, int B, int ci,
                               int co, int Z, int S, const int* __restrict__ flags,
                               const float* __restrict__ coef, Noise noise, float sigma,
                               float* __restrict__ img_out, float* __restrict__ mask_out) {
  Pixels px;
  if (!map_pixels(px, index, n_src, B, S, flags)) return;
  const int* fl = flags + (size_t)px.b * N_FLAGS;
  const float alpha = coef[2 * px.b], beta = coef[2 * px.b + 1];
  const size_t plane = (size_t)S * S;
  for (int z = blockIdx.y; z < Z; z += gridDim.y) {
    emit<VEC>(img_src, img_out, px.s, px.b, ci, Z, z, plane, px.out_row, px.src_off, px.nx,
              px.gate, fl, alpha, beta, noise, sigma);
    emit<VEC>(mask_src, mask_out, px.s, px.b, co, Z, z, plane, px.out_row, px.src_off, px.nx,
              false, fl, alpha, beta, noise, sigma);
  }
}

template <bool VEC>
__global__ void augment_heads_volume(const float* __restrict__ img_src,
                                     const float* __restrict__ tgt_src,
                                     const long long* __restrict__ index, int n_src, int B,
                                     int ci, int ct, int Z, int S, const int* __restrict__ codes,
                                     const int* __restrict__ flags,
                                     const float* __restrict__ coef, Noise noise, float sigma,
                                     float* __restrict__ img_out, float* __restrict__ tgt_out) {
  Pixels px;
  if (!map_pixels(px, index, n_src, B, S, flags)) return;
  const int* fl = flags + (size_t)px.b * N_FLAGS;
  const float alpha = coef[2 * px.b], beta = coef[2 * px.b + 1];
  const size_t plane = (size_t)S * S;
  for (int z = blockIdx.y; z < Z; z += gridDim.y) {
    emit<VEC>(img_src, img_out, px.s, px.b, ci, Z, z, plane, px.out_row, px.src_off, px.nx,
              px.gate, fl, alpha, beta, noise, sigma);
    emit_heads<VEC>(tgt_src, tgt_out, px.s, px.b, ct, Z, z, plane, px.out_row, px.src_off,
                    px.nx, px.gate, codes, fl);
  }
}

unsigned blocks_for(int B, int S, int threads) {
  const long long total = (long long)B * S * ((S + 3) / 4);
  return (unsigned)((total + threads - 1) / threads);
}

dim3 volume_grid(int B, int Z, int S, int threads) {
  return dim3(blocks_for(B, S, threads), (unsigned)(Z < 65535 ? Z : 65535));
}

}  // namespace

extern "C" {

// img_src (n_src, ci, S, S), mask_src (n_src, co, S, S), prev_src (n_src, ci,
// S, S) or null: float32 tile sets.  index: (B,) int64 rows of the tile set,
// or null for rows 0..B-1.  flags: (B, 7) int32 (gate, k, flip_h, flip_v,
// bc apply, mult apply, gauss apply); coef: (B, 2) float32 (alpha, beta).
// mult/gauss (and mult_prev/gauss_prev): (B, ci, S, S) float32 fields in the
// output frame, or null when that stage is off.  Outputs (B, ci|co, S, S)
// float32.  One launch.
int k4_augment_batch(const void* img_src, const void* mask_src, const void* prev_src,
                     const void* index, int n_src, int B, int ci, int co, int S,
                     const void* flags, const void* coef, const void* mult, const void* gauss,
                     const void* mult_prev, const void* gauss_prev, float sigma, void* img_out,
                     void* mask_out, void* prev_out, void* stream) {
  const int threads = 256;
  const unsigned blocks = blocks_for(B, S, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const Noise img_noise{(const float*)mult, (const float*)gauss};
  const Noise prev_noise{(const float*)mult_prev, (const float*)gauss_prev};
  if (S % 4 == 0)
    augment_batch<true><<<blocks, threads, 0, st>>>(
        (const float*)img_src, (const float*)mask_src, (const float*)prev_src,
        (const long long*)index, n_src, B, ci, co, S, (const int*)flags, (const float*)coef,
        img_noise, prev_noise, sigma, (float*)img_out, (float*)mask_out, (float*)prev_out);
  else
    augment_batch<false><<<blocks, threads, 0, st>>>(
        (const float*)img_src, (const float*)mask_src, (const float*)prev_src,
        (const long long*)index, n_src, B, ci, co, S, (const int*)flags, (const float*)coef,
        img_noise, prev_noise, sigma, (float*)img_out, (float*)mask_out, (float*)prev_out);
  return (int)cudaGetLastError();
}

// K4h.  img_src (n_src, ci, S, S) and tgt_src (n_src, ct, S, S): float32 tile
// sets (the head targets concatenated along channels).  codes: (ct,) int32,
// 0 for a channel that only moves, 1 for the cos and 2 for the sin component
// of an orientation pair (1 is always followed by 2).  index, flags, coef,
// mult, gauss and sigma as for k4_augment_batch.  Outputs (B, ci|ct, S, S)
// float32.  One launch.
int k4h_augment_heads(const void* img_src, const void* tgt_src, const void* index, int n_src,
                      int B, int ci, int ct, int S, const void* codes, const void* flags,
                      const void* coef, const void* mult, const void* gauss, float sigma,
                      void* img_out, void* tgt_out, void* stream) {
  const int threads = 256;
  const unsigned blocks = blocks_for(B, S, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const Noise noise{(const float*)mult, (const float*)gauss};
  if (S % 4 == 0)
    augment_heads<true><<<blocks, threads, 0, st>>>(
        (const float*)img_src, (const float*)tgt_src, (const long long*)index, n_src, B, ci, ct,
        S, (const int*)codes, (const int*)flags, (const float*)coef, noise, sigma,
        (float*)img_out, (float*)tgt_out);
  else
    augment_heads<false><<<blocks, threads, 0, st>>>(
        (const float*)img_src, (const float*)tgt_src, (const long long*)index, n_src, B, ci, ct,
        S, (const int*)codes, (const int*)flags, (const float*)coef, noise, sigma,
        (float*)img_out, (float*)tgt_out);
  return (int)cudaGetLastError();
}

// K4v.  img_src (n_src, ci, Z, S, S) and mask_src (n_src, co, Z, S, S):
// float32 volume sets.  index, flags and coef as for k4_augment_batch;
// mult/gauss: (B, ci, Z, S, S) float32 fields in the output frame, or null.
// Outputs (B, ci|co, Z, S, S) float32.  One launch.
int k4v_augment_volume(const void* img_src, const void* mask_src, const void* index, int n_src,
                       int B, int ci, int co, int Z, int S, const void* flags, const void* coef,
                       const void* mult, const void* gauss, float sigma, void* img_out,
                       void* mask_out, void* stream) {
  const int threads = 256;
  const dim3 grid = volume_grid(B, Z, S, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const Noise noise{(const float*)mult, (const float*)gauss};
  if (S % 4 == 0)
    augment_volume<true><<<grid, threads, 0, st>>>(
        (const float*)img_src, (const float*)mask_src, (const long long*)index, n_src, B, ci, co,
        Z, S, (const int*)flags, (const float*)coef, noise, sigma, (float*)img_out,
        (float*)mask_out);
  else
    augment_volume<false><<<grid, threads, 0, st>>>(
        (const float*)img_src, (const float*)mask_src, (const long long*)index, n_src, B, ci, co,
        Z, S, (const int*)flags, (const float*)coef, noise, sigma, (float*)img_out,
        (float*)mask_out);
  return (int)cudaGetLastError();
}

// K4hv.  img_src (n_src, ci, Z, S, S) and tgt_src (n_src, ct, Z, S, S): float32
// volume sets (the head targets concatenated along channels); codes as for
// k4h_augment_heads; index, flags, coef, mult, gauss and sigma as for
// k4v_augment_volume.  Outputs (B, ci|ct, Z, S, S) float32.  One launch.
int k4hv_augment_heads_volume(const void* img_src, const void* tgt_src, const void* index,
                              int n_src, int B, int ci, int ct, int Z, int S, const void* codes,
                              const void* flags, const void* coef, const void* mult,
                              const void* gauss, float sigma, void* img_out, void* tgt_out,
                              void* stream) {
  const int threads = 256;
  const dim3 grid = volume_grid(B, Z, S, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const Noise noise{(const float*)mult, (const float*)gauss};
  if (S % 4 == 0)
    augment_heads_volume<true><<<grid, threads, 0, st>>>(
        (const float*)img_src, (const float*)tgt_src, (const long long*)index, n_src, B, ci, ct,
        Z, S, (const int*)codes, (const int*)flags, (const float*)coef, noise, sigma,
        (float*)img_out, (float*)tgt_out);
  else
    augment_heads_volume<false><<<grid, threads, 0, st>>>(
        (const float*)img_src, (const float*)tgt_src, (const long long*)index, n_src, B, ci, ct,
        Z, S, (const int*)codes, (const int*)flags, (const float*)coef, noise, sigma,
        (float*)img_out, (float*)tgt_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
