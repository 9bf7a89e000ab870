// K5: safe-margin weighted stitch of float16 head tiles; K5s: the sum of a
// chunk's real head tiles, for the uncovered-pixel fill.
//
// K5 replaces bio_image_unet_tpu/ops/stitch.py:163 _stitch_factored_xla with
// the epilogue of predict/predictor.py:1130-1145 (fused path: weighted sum /
// weight sum, float16 out) and its host form ops/stitch.py:138
// _stitch_weighted_xla / :203 _stitch_weighted_frames (float32 out).  The JAX
// program scans the tiles of each frame in grid order n = i*ny + j, adding
// patch*w and w into float32 sum and weight planes with dynamic_update_slice;
// each tile's weight is the outer MIN of per-axis factor rows
// (predict/tiling.py:91 _margin_factors).  This is the gather form: one
// thread per output pixel (frame, channel, row, column) of the cropped frame
// loops over the tiles that cover it, from per-row and per-column ranges
// computed on the host, i outer and j inner (the scan's order), takes
// w = min(fx[i][r - xs[i]], fy[j][q - ys[j]]) from the factor tables and
// accumulates acc = acc + tile*w and wsum = wsum + w in float32 registers
// (__fmul_rn/__fadd_rn, -fmad=false), then divides (IEEE) where wsum > 0.
// Pixels no tile weighs are written as 0; the caller writes the fill there
// (the uncovered set depends on the grid and the margin only).  No atomics,
// no planes in device memory, bit-equal to the scan for the same float16
// tiles.
//
// K5s replaces the jnp.mean fill of predictor.py:1133 / ops/stitch.py:208.
// The JAX program runs the whole movie at once and averages every real head
// tile; the port runs 16-frame chunks, so each chunk adds the sum of its real
// tiles (not the tail chunk's repeated frames, not the batch padding) into a
// float64 total and the mean is taken after the last chunk.  Pass 1: each
// block sums a grid-stride share in float64 and reduces it in shared memory
// to one partial; pass 2: one block adds the partials in a fixed tree order,
// so the result does not depend on scheduling.  (Float16 values summed in
// float64 are exact for any realistic magnitude and count.)
//
// What bounds both on the card: bytes.  K5 reads each real tile value once
// on an exact grid (64 tiles x C x 512^2 float16 per chunk) and writes each
// output pixel once; K5s reads the real tiles once.
//
// K5v is K5's 3D linear-blend form.  It replaces ops/stitch.py:163
// _stitch_factored_xla with the 3D factors of predict/tiling.py:113
// _blend_factors and the epilogue of predictor.py:1354-1365 (fused path,
// float16 out), and the host form ops/stitch.py:138 / :204 with
// fill_mean=False (float32 out).  One thread per output voxel (volume,
// channel, z, row, column) loops over the covering tiles in the scan's order
// (z outer, y inner), takes w = min(fz, fx, fy) from the factor tables and
// accumulates acc = fma(tile, w, acc), wsum = wsum + w: XLA contracts the
// scan's block + patch * w into one fused multiply-add, and the blend
// weights are fractions, so the rounding of each step is that of
// __fmaf_rn (with -fmad=false nothing else is contracted).  Where
// wsum > 0 the voxel is acc / wsum (IEEE), elsewhere 0: the reference fills
// uncovered voxels with 0.  No atomics, no planes in device memory,
// bit-equal to the scan for the same float16 tiles.  Bound by bytes: each
// real tile value read once on a one-cover grid, each output voxel written
// once; an overlapping grid re-reads tile values only at the seams.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void store(__half* o, float v) { *o = __float2half_rn(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }

template <typename O>
__global__ void margin_stitch(const __half* __restrict__ tiles, int C, int h, int w, int th,
                              int tw, int nx, int ny,
                              const int* __restrict__ xs, const int* __restrict__ ys,
                              const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                              const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                              const float* __restrict__ fx, const float* __restrict__ fy,
                              O* __restrict__ out) {
  // grid: x over the columns of a row, y the row, z frame * C + channel, so
  // the tile rows and their factors are the same for the whole block
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= w) return;
  const int r = blockIdx.y;
  const int fc = blockIdx.z;
  const int f = fc / C;
  const int c = fc - f * C;

  const int i0 = row_lo[r], i1 = row_hi[r];
  const int j0 = col_lo[q], j1 = col_hi[q];
  const size_t tile = (size_t)th * tw;
  float acc = 0.0f, wsum = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const int tr = r - xs[i];
    const float wx = fx[(size_t)i * th + tr];
    for (int j = j0; j < j1; ++j) {
      const int tq = q - ys[j];
      const float wt = fminf(wx, fy[(size_t)j * tw + tq]);
      const size_t t = ((size_t)f * nx + i) * ny + j;
      const float v = __half2float(tiles[(t * C + c) * tile + (size_t)tr * tw + tq]);
      acc = __fadd_rn(acc, __fmul_rn(v, wt));
      wsum = __fadd_rn(wsum, wt);
    }
  }
  store(out + ((size_t)fc * h + r) * w + q, wsum > 0.0f ? __fdiv_rn(acc, wsum) : 0.0f);
}

template <typename O>
__global__ void blend_stitch_3d(const __half* __restrict__ tiles, int C, int d, int h, int w,
                                int tz, int tx, int ty, int nz, int nx, int ny,
                                const int* __restrict__ zs, const int* __restrict__ xs,
                                const int* __restrict__ ys, const int* __restrict__ z_lo,
                                const int* __restrict__ z_hi,
                                const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                                const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                                const float* __restrict__ fz, const float* __restrict__ fx,
                                const float* __restrict__ fy, long long total,
                                O* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)h * w;
  const long long vc = idx / (plane * d);  // volume * C + channel
  const long long vox = idx - vc * plane * d;
  const int z = (int)(vox / plane);
  const int rem = (int)(vox - (long long)z * plane);
  const int r = rem / w;
  const int q = rem - r * w;
  const int v = (int)(vc / C);
  const int c = (int)(vc - (long long)v * C);

  const int k0 = z_lo[z], k1 = z_hi[z];
  const int i0 = row_lo[r], i1 = row_hi[r];
  const int j0 = col_lo[q], j1 = col_hi[q];
  const size_t tile = (size_t)tz * tx * ty;
  float acc = 0.0f, wsum = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const int tzo = z - zs[k];
    const float wz = fz[(size_t)k * tz + tzo];
    for (int i = i0; i < i1; ++i) {
      const int txo = r - xs[i];
      const float wzx = fminf(wz, fx[(size_t)i * tx + txo]);
      for (int j = j0; j < j1; ++j) {
        const int tyo = q - ys[j];
        const float wt = fminf(wzx, fy[(size_t)j * ty + tyo]);
        const size_t t = (((size_t)v * nz + k) * nx + i) * ny + j;
        const float val = __half2float(
            tiles[(t * C + c) * tile + ((size_t)tzo * tx + txo) * ty + tyo]);
        acc = __fmaf_rn(val, wt, acc);
        wsum = __fadd_rn(wsum, wt);
      }
    }
  }
  store(out + idx, wsum > 0.0f ? __fdiv_rn(acc, wsum) : 0.0f);
}

constexpr int kSumThreads = 256;

__device__ __forceinline__ double block_sum(double s, double* buf) {
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  return buf[0];
}

__global__ void tile_sum_partial(const __half* __restrict__ x, long long n,
                                 double* __restrict__ partials) {
  __shared__ double buf[kSumThreads];
  const long long step = (long long)gridDim.x * kSumThreads;
  // the pairs are read as __half2, which needs 4-byte alignment: a view that
  // starts at an odd float16 offset sums its first value on its own
  const int lead = (reinterpret_cast<uintptr_t>(x) & 3) ? 1 : 0;
  const long long pairs = (n - lead) / 2;
  const __half2* x2 = reinterpret_cast<const __half2*>(x + lead);
  double s = 0.0;
  for (long long k = (long long)blockIdx.x * kSumThreads + threadIdx.x; k < pairs; k += step) {
    const float2 v = __half22float2(x2[k]);
    s += (double)v.x;
    s += (double)v.y;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (lead) s += (double)__half2float(x[0]);
    if ((n - lead) & 1) s += (double)__half2float(x[n - 1]);
  }
  const double b = block_sum(s, buf);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
}

__global__ void tile_sum_final(const double* __restrict__ partials, int n_blocks,
                               double* __restrict__ out) {
  __shared__ double buf[kSumThreads];
  double s = 0.0;
  for (int k = threadIdx.x; k < n_blocks; k += kSumThreads) s += partials[k];
  const double b = block_sum(s, buf);
  if (threadIdx.x == 0) out[0] = b;
}

extern "C" {

// tiles: (>= n_frames*nx*ny, C, th, tw) float16, frame-major grid order;
// xs (nx,), ys (ny,) int32 tile starts; row_lo/row_hi (h,), col_lo/col_hi (w,)
// int32 ranges of the tiles covering each row / column; fx (nx, th), fy (ny,
// tw) float32 factor tables; out is (n_frames, C, h, w) float16 (out_f32 = 0)
// or float32 (1), h and n_frames * C at most 65535.  One launch.
int k5_margin_stitch(const void* tiles, int n_frames, int C, int h, int w, int th, int tw,
                     int nx, int ny, const void* xs, const void* ys, const void* row_lo,
                     const void* row_hi, const void* col_lo, const void* col_hi,
                     const void* fx, const void* fy, int out_f32, void* out, void* stream) {
  const int threads = 256;
  if (h > 65535 || (long long)n_frames * C > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + threads - 1) / threads, h, n_frames * C);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    margin_stitch<float><<<grid, threads, 0, s>>>(
        (const __half*)tiles, C, h, w, th, tw, nx, ny, (const int*)xs, (const int*)ys,
        (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
        (const float*)fx, (const float*)fy, (float*)out);
  else
    margin_stitch<__half><<<grid, threads, 0, s>>>(
        (const __half*)tiles, C, h, w, th, tw, nx, ny, (const int*)xs, (const int*)ys,
        (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
        (const float*)fx, (const float*)fy, (__half*)out);
  return (int)cudaGetLastError();
}

// x: n float16 values (any float16 offset); partials: n_blocks float64 scratch;
// out: one float64, the sum.  Two launches on the stream.
int k5s_tile_sum(const void* x, long long n, int n_blocks, void* partials, void* out,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  tile_sum_partial<<<n_blocks, kSumThreads, 0, s>>>((const __half*)x, n, (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_sum_final<<<1, kSumThreads, 0, s>>>((const double*)partials, n_blocks, (double*)out);
  return (int)cudaGetLastError();
}

// K5v: tiles (>= n_vols*nz*nx*ny, C, tz, tx, ty) float16, volume-major z/x/y
// grid order; zs, xs, ys int32 tile starts; z_lo/z_hi (d,), row_lo/row_hi
// (h,), col_lo/col_hi (w,) int32 cover ranges; fz (nz, tz), fx (nx, tx), fy
// (ny, ty) float32 factor tables; out is (n_vols, C, d, h, w) float16
// (out_f32 = 0) or float32 (1).  One launch.
int k5v_blend_stitch_3d(const void* tiles, int n_vols, int C, int d, int h, int w, int tz,
                        int tx, int ty, int nz, int nx, int ny, const void* zs, const void* xs,
                        const void* ys, const void* z_lo, const void* z_hi,
                        const void* row_lo, const void* row_hi, const void* col_lo,
                        const void* col_hi, const void* fz, const void* fx, const void* fy,
                        int out_f32, void* out, void* stream) {
  const int threads = 256;
  const long long total = (long long)n_vols * C * d * h * w;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    blend_stitch_3d<float><<<blocks, threads, 0, s>>>(
        (const __half*)tiles, C, d, h, w, tz, tx, ty, nz, nx, ny, (const int*)zs,
        (const int*)xs, (const int*)ys, (const int*)z_lo, (const int*)z_hi,
        (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
        (const float*)fz, (const float*)fx, (const float*)fy, total, (float*)out);
  else
    blend_stitch_3d<__half><<<blocks, threads, 0, s>>>(
        (const __half*)tiles, C, d, h, w, tz, tx, ty, nz, nx, ny, (const int*)zs,
        (const int*)xs, (const int*)ys, (const int*)z_lo, (const int*)z_hi,
        (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
        (const float*)fz, (const float*)fx, (const float*)fy, total, (__half*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
