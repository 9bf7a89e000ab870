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
// from L1/L2) and one byte written, against ~6 float operations a value: at
// 3.35 TB/s the (16, 256^2, 64) -> (16, 512^2, 64) main shape needs 0.100 ms.
// The design: a thread per (output pixel, vector of V channels), V = 16
// bytes where the channel count, the buffer's row stride, the channel
// offset and both addresses allow it (else 8, 4, 2 or 1): 4 (8) vector loads
// of its corner pixels (from a channel range of a wider buffer too: the
// UNet++ grid's row buffers), the blends in registers, one vector store into
// the concat buffer.  Neighbouring threads take neighbouring channel vectors and
// then neighbouring pixels, so loads and stores coalesce.
//
// Numbers, kept exactly as the reference computes them, so a kernel equals
// its plain version bit for bit:
// - K11 (JAX, align_corners=True): per axis coords = float(i) * ratio, ratio
//   the float32 of (n-1)/(2n-1) (0 for n = 1) from the host, lo = floor
//   clipped to [0, n-1], hi = min(lo + 1, n - 1), t = coords - lo, 1 - t; the
//   axis H blend first, then W, each x_lo * (1-t) + x_hi * t, which XLA's CPU
//   backend contracts to fma(x_lo, 1-t, x_hi * t) (measured against JAX):
//   __fmul_rn then __fmaf_rn (the build's -fmad=false contracts nothing else);
// - K11v (ATen's trilinear, align_corners=False, scale 1/2): source index
//   max(0.5 * (i + 0.5) - 0.5, 0), lo its floor, hi = lo + (lo < n-1),
//   weights l1 = index - lo and 1 - l1, blended W innermost, then H, then D.
//   Every weight is 0, 1/4, 3/4 or 1 and the values are integers below 128,
//   so every product and sum is a multiple of 1/64 under 128 and exact in
//   float32: any order gives the same bits;
// - then rintf (half to even, as jnp.round and torch.round) and the clip.

#include <cuda_runtime.h>
#include <stdint.h>

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

// K11: (n, h, w, C) int8 in rows of in_stride bytes -> channels [out_off,
// out_off + C) of rows of out_stride bytes, (n, 2h, 2w, out_stride); the host
// checks that the thread count is below 2^31
template <int V>
__global__ void __launch_bounds__(THREADS)
upsample2x_i8(const int8_t* __restrict__ x, int8_t* __restrict__ out, int n, int h, int wd,
              int C, int in_stride, int out_stride, int out_off, float ratio_h, float ratio_w) {
  const int cv = C / V, ho = 2 * h, wo = 2 * wd;
  const unsigned total = (unsigned)n * ho * wo * cv;
  const unsigned e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % cv) * V;
  unsigned p = e / cv;
  const int xo = (int)(p % wo);
  p /= wo;
  const int yo = (int)(p % ho);
  const int ni = (int)(p / ho);
  int y0, y1, x0, x1;
  float ty, oty, tx, otx;
  aligned_axis(yo, h, ratio_h, y0, y1, ty, oty);
  aligned_axis(xo, wd, ratio_w, x0, x1, tx, otx);
  const int8_t* base = x + (long long)ni * h * wd * in_stride + c;
  const Pack<V> a00 = load<V>(base + ((long long)y0 * wd + x0) * in_stride);
  const Pack<V> a01 = load<V>(base + ((long long)y0 * wd + x1) * in_stride);
  const Pack<V> a10 = load<V>(base + ((long long)y1 * wd + x0) * in_stride);
  const Pack<V> a11 = load<V>(base + ((long long)y1 * wd + x1) * in_stride);
  Pack<V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    // the H pass at columns x0 and x1, then the W pass
    const float lo = __fmaf_rn((float)a00.b[k], oty, __fmul_rn((float)a10.b[k], ty));
    const float hi = __fmaf_rn((float)a01.b[k], oty, __fmul_rn((float)a11.b[k], ty));
    r.b[k] = to_i8(__fmaf_rn(lo, otx, __fmul_rn(hi, tx)));
  }
  *reinterpret_cast<typename VecOf<V>::T*>(
      out + ((long long)(ni * ho + yo) * wo + xo) * out_stride + out_off + c) = r.v;
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

template <int V>
cudaError_t launch(const void* x, void* out, int n, int d, int h, int wd, int C, int in_stride,
                   int out_stride, int out_off, float ratio_h, float ratio_w, cudaStream_t st) {
  const long long total = (long long)n * (d ? 2 * d : 1) * 4 * h * wd * (C / V);
  if (total == 0) return cudaSuccess;
  if (total + THREADS > INT32_MAX) return cudaErrorInvalidValue;  // 32-bit thread indices
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  if (d)
    upsample2x_i8_3d<V><<<blocks, THREADS, 0, st>>>(xi, o, n, d, h, wd, C, in_stride, out_stride,
                                                    out_off);
  else
    upsample2x_i8<V><<<blocks, THREADS, 0, st>>>(xi, o, n, h, wd, C, in_stride, out_stride,
                                                 out_off, ratio_h, ratio_w);
  return cudaGetLastError();
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
