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
// 1024^2).  This is the gather form: each output pixel finds the tiles that
// cover it from per-row and per-column start ranges computed on the host,
// quantizes each covering logit itself and averages in registers.  No
// atomics, no sum or count planes in device memory; exact grids are the
// one-cover case and read each logit exactly once.
//
// The design keeps the work per pixel near the bytes: a 3-D grid over
// (frame, band of K3_ROWS rows, strip of K3_STRIP columns), one warp a row of
// the strip, so no thread divides to find its pixel.  Each lane owns a run of
// K3_RUN = 16 output pixels.  Where the run lies in one tile that alone
// covers it and its logits are 16-byte aligned (every run of an exact grid
// whose tile width is a multiple of 16, the form of every path), the lane
// reads them with two 16-byte loads (bf16) or four (float32) and writes its
// 16 levels with one 16-byte store where the row allows.  The other runs
// (tile edges inside a run, overlaps, narrow frames) are done pixel by pixel
// in the same kernel, the warp's lanes on consecutive pixels, each summing
// the pixel's covering tiles: the block stages the strip's column ranges and
// each column's offsets in its first two covering tiles in shared memory
// once, a warp its row's offsets in its first two, so a pixel with up to two
// covers an axis (every overlapping grid of add_tile <= 1) issues its loads
// at once; more covers take loops.  The mean divides only where the count
// is not a power of two.
// What holds it (H100 80GB HBM3, 700 W, utils/kernel_ab_times.py): the exact bf16 form takes
// 0.042 ms against 0.015 for its bytes; an overlapping grid whose tiles start
// off 16-byte boundaries (1000^2 frames in 256^2 tiles, add_tile=1) goes
// mostly pixel by pixel and takes 0.122 ms, its loop latency-bound: designs
// with more registers or per-lane cover loops measured slower.
//
// Exactness: sigmoid is 1 / (1 + expf(-z)) with a correctly rounded
// reciprocal (rcp_rn: the bits of __frcp_rn and of the IEEE division 1 / x
// that torch.sigmoid uses on the card), quantization uses __fmul_rn and
// truncation toward zero, as the JAX program does.  The mean of cnt covering
// levels is the integer quotient sum / cnt: it equals the truncated float32
// division of the reference, because sum <= 255 cnt is exact in float32 and
// a quotient that is not an integer lies at least 1/cnt below the next one,
// more than the division's rounding error (half an ulp, at most 2^-17 below
// 256) for any cnt < 2^16.
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

constexpr int K3_RUN = 16;                 // output pixels a lane
constexpr int K3_ROWS = 8;                 // rows a block, one warp a row
constexpr int K3_STRIP = 32 * K3_RUN;      // columns a block
constexpr int K3_THREADS = 32 * K3_ROWS;

// 1 / x rounded to float32 as __frcp_rn rounds it (to nearest), for x in
// [1, 2^64), without the slow path that rcp.rn calls for other ranges (its
// call saves registers to local memory): two Newton steps in float64 from the
// hardware estimate leave a relative error below 2^-51, and 1/x lies at
// least 2^-49 (relative) from every midpoint m between two floats (x = X 2^a,
// m = M 2^b with X of 24 and M odd of 25 significant bits: 1 - x m is a
// nonzero multiple of 2^(a+b) >= 2^-49), so the float64 estimate rounds to
// the float nearest 1/x.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_rn(float x) {
  const double xd = x;
  double y = rcp_approx(x);
  y = fma(y, fma(-xd, y, 1.0), y);
  y = fma(y, fma(-xd, y, 1.0), y);
  return __double2float_rn(y);
}

// trunc(255 * sigmoid(z)): the level of one tile pixel; 1 + e >= 2^64 (and
// infinity) gives 0, as 255 / (1 + e) < 1 there
__device__ __forceinline__ uint32_t k3_level(float z) {
  const float x = __fadd_rn(1.0f, expf(-z));
  return x < 0x1p64f ? __float2uint_rz(__fmul_rn(rcp_rn(x), 255.0f)) : 0u;
}

// K3_RUN logits from a 16-byte aligned address
__device__ __forceinline__ void load_run(const float* p, float* z) {
#pragma unroll
  for (int k = 0; k < K3_RUN / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(p)[k];
    z[4 * k] = v.x;
    z[4 * k + 1] = v.y;
    z[4 * k + 2] = v.z;
    z[4 * k + 3] = v.w;
  }
}

// two bf16 values of a word -> float32, exactly
__device__ __forceinline__ void bf16x2(uint32_t w, float* z) {
  z[0] = __uint_as_float(w << 16);
  z[1] = __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float* z) {
#pragma unroll
  for (int k = 0; k < K3_RUN / 8; ++k) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[k];
    bf16x2(v.x, z + 8 * k);
    bf16x2(v.y, z + 8 * k + 2);
    bf16x2(v.z, z + 8 * k + 4);
    bf16x2(v.w, z + 8 * k + 6);
  }
}

// K3_RUN bytes, packed four a word, as wide as the address allows
__device__ __forceinline__ void store_run(uint8_t* p, const uint32_t* w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if ((a & 7) == 0) {
    reinterpret_cast<uint2*>(p)[0] = make_uint2(w[0], w[1]);
    reinterpret_cast<uint2*>(p)[1] = make_uint2(w[2], w[3]);
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) reinterpret_cast<uint32_t*>(p)[k] = w[k];
  } else {
#pragma unroll
    for (int k = 0; k < K3_RUN; ++k) p[k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
  }
}

// the mean of cnt covering levels (sum <= 255 cnt): the integer quotient
__device__ __forceinline__ uint32_t mean_level(uint32_t sum, uint32_t cnt) {
  if (cnt <= 1) return sum;
  return (cnt & (cnt - 1)) == 0 ? sum >> (31 - __clz(cnt)) : sum / cnt;
}

// K3: block (strip, band, frame) makes rows [band * K3_ROWS, + K3_ROWS) x
// columns [strip * K3_STRIP, + K3_STRIP) of frame blockIdx.z (and of every
// gridDim.z-th frame after it); warp = row, lane = run of K3_RUN columns
template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
sigmoid_stitch(const T* __restrict__ logits, int n_frames, int h, int w, int th, int tw, int nx,
               int ny, const int* __restrict__ xs, const int* __restrict__ ys,
               const int* __restrict__ row_lo, const int* __restrict__ row_hi,
               const int* __restrict__ col_lo, const int* __restrict__ col_hi,
               uint8_t* __restrict__ out) {
  // the strip's column ranges, and each column's offset in its first two
  // covering tiles (tile index * th * tw + column in the tile)
  __shared__ int s_lo[K3_STRIP], s_hi[K3_STRIP];
  __shared__ long long s_ca[K3_STRIP], s_cb[K3_STRIP];
  const long long tile = (long long)th * tw;
  const int c_strip = blockIdx.x * K3_STRIP;
  for (int k = threadIdx.x; k < K3_STRIP; k += K3_THREADS) {
    const int c = c_strip + k;
    const int j0 = c < w ? col_lo[c] : 0, j1 = c < w ? col_hi[c] : 0;
    s_lo[k] = j0;
    s_hi[k] = j1;
    s_ca[k] = j1 > j0 ? j0 * tile + (c - ys[j0]) : 0;
    s_cb[k] = j1 > j0 + 1 ? (j0 + 1) * tile + (c - ys[j0 + 1]) : 0;
  }
  __syncthreads();
  const int r = blockIdx.y * K3_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= h) return;  // the whole warp
  // the row's covering tiles and its offsets in the first two
  const int i0 = row_lo[r], i1 = row_hi[r], ni = i1 - i0;
  const long long ra = ni > 0 ? (long long)i0 * ny * tile + (long long)(r - xs[i0]) * tw : 0;
  const long long rb = ni > 1 ? (long long)(i0 + 1) * ny * tile + (long long)(r - xs[i0 + 1]) * tw
                              : 0;
  const int k0 = lane * K3_RUN, c0 = c_strip + k0;  // the lane's run

  for (int f = blockIdx.z; f < n_frames; f += gridDim.z) {
    const T* frame = logits + (long long)f * nx * ny * tile;
    uint8_t* orow = out + ((long long)f * h + r) * w;
    // a run in one tile that alone covers it, its logits 16-byte aligned
    bool fast = false;
    if (c0 + K3_RUN <= w && ni == 1) {
      const int j = s_lo[k0];
      if (s_hi[k0] == j + 1 && s_lo[k0 + K3_RUN - 1] == j && s_hi[k0 + K3_RUN - 1] == j + 1) {
        const T* src = frame + ra + s_ca[k0];
        if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          fast = true;
          float z[K3_RUN];
          load_run(src, z);
          uint32_t packed[K3_RUN / 4];
#pragma unroll
          for (int k = 0; k < K3_RUN / 4; ++k)
            packed[k] = __byte_perm(__byte_perm(k3_level(z[4 * k]), k3_level(z[4 * k + 1]), 0x0040),
                                    __byte_perm(k3_level(z[4 * k + 2]), k3_level(z[4 * k + 3]),
                                                0x0040),
                                    0x5410);
          store_run(orow + c0, packed);
        }
      }
    }
    // the other runs pixel by pixel, the lanes on consecutive pixels: up to
    // two covering tiles an axis in straight-line code, more in loops
    const unsigned slow = __ballot_sync(0xFFFFFFFFu, !fast && c0 < w);
    if (!slow) continue;
    for (int k = lane; k < K3_STRIP; k += 32) {
      const int c = c_strip + k;
      if (c >= w || !((slow >> (k / K3_RUN)) & 1)) continue;
      const int j0 = s_lo[k], nj = s_hi[k] - j0;
      uint32_t sum = 0;
      if (ni == 0 || nj == 0) {
        // no tile covers it
      } else if (ni <= 2 && nj <= 2) {
        // the loads at once; a level only for each cover (ni is the warp's)
        const long long ca = s_ca[k], cb = s_cb[k];
        const float z0 = load_f32(frame + ra + ca);
        const float z1 = nj > 1 ? load_f32(frame + ra + cb) : 0.0f;
        const float z2 = ni > 1 ? load_f32(frame + rb + ca) : 0.0f;
        const float z3 = ni > 1 && nj > 1 ? load_f32(frame + rb + cb) : 0.0f;
        sum = k3_level(z0);
        if (nj > 1) sum += k3_level(z1);
        if (ni > 1) {
          sum += k3_level(z2);
          if (nj > 1) sum += k3_level(z3);
        }
      } else {
        for (int i = i0; i < i1; ++i) {
          const T* trow = frame + (long long)i * ny * tile + (long long)(r - xs[i]) * tw + c;
          for (int j = j0; j < j0 + nj; ++j) sum += k3_level(load_f32(trow + j * tile - ys[j]));
        }
      }
      orow[c] = (uint8_t)mean_level(sum, (uint32_t)(ni * nj));
    }
  }
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
  if ((long long)n_frames * h * w == 0) return (int)cudaSuccess;
  const long long bands = (h + K3_ROWS - 1) / K3_ROWS;
  if (bands > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((w + K3_STRIP - 1) / K3_STRIP), (unsigned)bands,
                  (unsigned)(n_frames < 65535 ? n_frames : 65535));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    sigmoid_stitch<__nv_bfloat16><<<grid, K3_THREADS, 0, s>>>(
        (const __nv_bfloat16*)logits, n_frames, h, w, th, tw, nx, ny, (const int*)xs,
        (const int*)ys, (const int*)row_lo, (const int*)row_hi, (const int*)col_lo,
        (const int*)col_hi, (uint8_t*)out);
  else
    sigmoid_stitch<float><<<grid, K3_THREADS, 0, s>>>(
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
