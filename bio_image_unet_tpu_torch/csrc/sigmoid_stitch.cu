// K3: sigmoid*255 -> uint8 per tile, then the mean-overlap stitch.
//
// Replaces the epilogue of bio_image_unet_tpu/predict/predictor.py:450-463
// _forward_with (sigmoid of the float32 logits at predict/fastpath.py:224-225,
// *255 -> uint8 at :462) and the stitch of :117 _stitch_chunk_u8 /
// ops/stitch.py:35 _stitch_xla (exact grids: inverse transpose + crop;
// overlapping grids: float32 sum of the covering tiles' uint8 values over
// max(count, 1), truncated to uint8).  The JAX program writes the uint8 tiles
// and scans them into float32 sum and count planes with dynamic_update_slice.
//
// What bounds it on the card: bytes.  The least work reads every logit once
// (4 bytes each in float32, 2 in bf16; 64 MB for 256 tiles of 256^2 in
// float32) and writes each stitched pixel once (16 MB for 16 frames of
// 1024^2).  This is the gather form: one thread per output pixel finds the
// tiles that cover it from per-row and per-column start ranges computed on the
// host, quantizes each covering logit itself and averages in registers.  No
// atomics, no sum or count planes in device memory; exact grids are the
// one-cover case and read each logit exactly once.
//
// Exactness: sigmoid is 1 / (1 + expf(-z)) with IEEE division (the formula
// torch.sigmoid uses on the card), quantization and the mean use
// __fmul_rn/__fdiv_rn and truncation toward zero, as the JAX program does.
//
// K3v is the 3D form.  It replaces the epilogue of predictor.py:1242-1256
// (Predict3D's fused program: the quantize of _forward_with :460-462, then,
// on an exact grid, the inverse tiling transpose, else ops/stitch.py:95
// _stitch_xla_3d with the mean and truncation of :114 _stitch_3d_jit, which
// is also the host path's stitch).  One thread per voxel of the cropped
// (d, h, w) volume loops over the z, x and y tile ranges that cover it,
// quantizes each covering logit as K3 does and averages the integer sum in
// registers.  Bound by bytes: the least work reads every real logit once
// and writes each voxel once; the exact grid is the one-cover case and reads
// each logit exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void sigmoid_stitch(const T* __restrict__ logits, int n_frames, int h, int w,
                               int th, int tw, int nx, int ny,
                               const int* __restrict__ xs, const int* __restrict__ ys,
                               const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                               const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                               uint8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)n_frames * h * w;
  if (idx >= total) return;
  const long long f = idx / ((long long)h * w);
  const int rem = (int)(idx - f * h * w);
  const int r = rem / w;
  const int c = rem - r * w;

  const int i0 = row_lo[r], i1 = row_hi[r];
  const int j0 = col_lo[c], j1 = col_hi[c];
  const size_t tile = (size_t)th * tw;
  const size_t frame0 = (size_t)f * nx * ny;
  int sum = 0;
  for (int i = i0; i < i1; ++i) {
    const size_t rowoff = (size_t)(r - xs[i]) * tw;
    for (int j = j0; j < j1; ++j) {
      const float z = load_f32(logits + (frame0 + (size_t)i * ny + j) * tile + rowoff + (c - ys[j]));
      const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      sum += (int)__float2uint_rz(__fmul_rn(p, 255.0f));
    }
  }
  int cnt = (i1 - i0) * (j1 - j0);
  if (cnt < 1) cnt = 1;
  out[idx] = (uint8_t)__float2uint_rz(__fdiv_rn((float)sum, (float)cnt));
}

template <typename T>
__global__ void sigmoid_stitch_3d(const T* __restrict__ logits, int d, int h, int w, int tz,
                                  int tx, int ty, int nx, int ny,
                                  const int* __restrict__ zs, const int* __restrict__ xs,
                                  const int* __restrict__ ys, const int* __restrict__ z_lo,
                                  const int* __restrict__ z_hi,
                                  const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                                  const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                                  uint8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)d * h * w) return;
  const int z = (int)(idx / ((long long)h * w));
  const int rem = (int)(idx - (long long)z * h * w);
  const int r = rem / w;
  const int c = rem - r * w;

  const int k0 = z_lo[z], k1 = z_hi[z];
  const int i0 = row_lo[r], i1 = row_hi[r];
  const int j0 = col_lo[c], j1 = col_hi[c];
  const size_t tile = (size_t)tz * tx * ty;
  int sum = 0;
  for (int k = k0; k < k1; ++k) {
    const size_t zoff = (size_t)(z - zs[k]) * tx;
    for (int i = i0; i < i1; ++i) {
      const size_t rowoff = (zoff + (size_t)(r - xs[i])) * ty;
      for (int j = j0; j < j1; ++j) {
        const float v = load_f32(logits + (((size_t)k * nx + i) * ny + j) * tile + rowoff +
                                 (c - ys[j]));
        const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
        sum += (int)__float2uint_rz(__fmul_rn(p, 255.0f));
      }
    }
  }
  int cnt = (k1 - k0) * (i1 - i0) * (j1 - j0);
  if (cnt < 1) cnt = 1;
  out[idx] = (uint8_t)__float2uint_rz(__fdiv_rn((float)sum, (float)cnt));
}

extern "C" {

// logits: (>= n_frames*nx*ny, th, tw) float32 (is_bf16 = 0) or bf16 (1);
// xs (nx,), ys (ny,) int32 tile starts; row_lo/row_hi (h,) and col_lo/col_hi
// (w,) int32 ranges of the tiles covering each row / column; out is
// (n_frames, h, w) uint8.  One launch.
int k3_sigmoid_stitch(const void* logits, int is_bf16, int n_frames, int h, int w,
                      int th, int tw, int nx, int ny, const void* xs, const void* ys,
                      const void* row_lo, const void* row_hi, const void* col_lo,
                      const void* col_hi, void* out, void* stream) {
  const int threads = 256;
  const long long total = (long long)n_frames * h * w;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    sigmoid_stitch<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)logits, n_frames, h, w, th, tw, nx, ny, (const int*)xs,
        (const int*)ys, (const int*)row_lo, (const int*)row_hi, (const int*)col_lo,
        (const int*)col_hi, (uint8_t*)out);
  else
    sigmoid_stitch<float><<<blocks, threads, 0, s>>>(
        (const float*)logits, n_frames, h, w, th, tw, nx, ny, (const int*)xs,
        (const int*)ys, (const int*)row_lo, (const int*)row_hi, (const int*)col_lo,
        (const int*)col_hi, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// K3v: logits (>= nz*nx*ny, tz, tx, ty) float32 (is_bf16 = 0) or bf16 (1) of
// one volume's tiles in z/x/y grid order; zs, xs, ys int32 tile starts;
// z_lo/z_hi (d,), row_lo/row_hi (h,), col_lo/col_hi (w,) int32 ranges of the
// tiles covering each plane, row and column; out is (d, h, w) uint8.  One
// launch.
int k3v_sigmoid_stitch_3d(const void* logits, int is_bf16, int d, int h, int w, int tz, int tx,
                          int ty, int nx, int ny, const void* zs, const void* xs,
                          const void* ys, const void* z_lo, const void* z_hi,
                          const void* row_lo, const void* row_hi, const void* col_lo,
                          const void* col_hi, void* out, void* stream) {
  const int threads = 256;
  const long long total = (long long)d * h * w;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    sigmoid_stitch_3d<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)logits, d, h, w, tz, tx, ty, nx, ny, (const int*)zs,
        (const int*)xs, (const int*)ys, (const int*)z_lo, (const int*)z_hi,
        (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
        (uint8_t*)out);
  else
    sigmoid_stitch_3d<float><<<blocks, threads, 0, s>>>(
        (const float*)logits, d, h, w, tz, tx, ty, nx, ny, (const int*)zs, (const int*)xs,
        (const int*)ys, (const int*)z_lo, (const int*)z_hi, (const int*)row_lo,
        (const int*)row_hi, (const int*)col_lo, (const int*)col_hi, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
