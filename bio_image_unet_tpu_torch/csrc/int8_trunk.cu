// K7-K10: the w8a8 int8 trunk of the 2D U-Net (opt-in quantized prediction),
// and K7v, K8v, K10v: their volumetric forms for the 3-level 3D U-Nets.
//
// Replaces bio_image_unet_tpu/predict/quant.py (build_int8_apply):
//   K7  :417 qconv       3x3 conv, SAME, dilation d, int8 x int8 -> int32, then
//                        dequant, bias, LeakyReLU(0.1) and requant to int8;
//   K8  :428 qtconv      2x2 stride-2 transposed conv, int8 -> int32, dequant,
//                        bias, requant (no activation), written into the first
//                        channels of the decoder's concat buffer;
//   K9  :223 _requant    elementwise rint(x * s_a / s_b) clipped to +-127 (the
//                        first conv's bf16 output at :441, the skip rescale
//                        into the concat buffer's second half at :487-488), and
//                        the dequant x * s_a -> bf16 before the head (:495);
//   K10 :278 _maxpool_i8 2x2 stride-2 max of int8.
// and bio_image_unet_tpu/predict/quant3d.py (build_int8_apply_3d):
//   K7v :269 qconv       3x3x3 conv, SAME, the same epilogue (the activation
//                        scales are folded into the weights: s_in = 1);
//   K8v :277 qtconv      2x2x2 stride-2 transposed conv into the concat buffer;
//   K10v :75 _maxpool_i8_3d  2x2x2 stride-2 max of int8.
// The JAX package leaves these to XLA's int8 convolution; PyTorch has no CUDA
// int8 convolution, so the port writes them by hand.  Tensors are NHWC or
// NDHWC int8.
//
// What bounds them on the card.  K7/K8 are int8 products: at the main path's
// shapes (a forward batch of 256 tiles of 256^2, n_filter 32) the full-
// resolution layers move ~1 GB and do ~0.6 TOP each, so at the tensor cores'
// int8 rate (1979 TOP/s) they are bound by bytes, and the 16^2 bottleneck
// layers by operations; the 3D layers (16 tiles of 32x128^2, 27 taps) do 27/9
// as many operations a byte, so more of them are bound by operations.  This
// first design does not use the tensor cores: it is an implicit GEMM on the
// CUDA cores with __dp4a (four int8 products and their sum into an int32 a
// lane), pixels (voxels) x output channels per block, the reduction over the
// 9 (27) taps x input channels staged 32 channels at a time through shared
// memory.  A volume is a batch of planes: a depth tap moves to the plane one
// before or after in the same volume.  Its ceiling is the dp4a rate (~130
// TOP/s), well below the bound; mma.sync / wgmma are later work.  K9 and K10
// are bound by bytes: one pass, a thread per output byte (K10v: per 16 bytes
// where the channels allow 16-byte loads).
//
// Numbers, kept exactly as XLA computes them on the CPU, so a kernel equals
// its plain version (and the JAX graph) bit for bit:
// - the int32 sums are exact (|sum| < 127^2 * 27 * 1024 < 2^31);
// - float(acc) rounds to nearest even (__int2float_rn);
// - s_in * s_w[o] is one float32 product, formed first (__fmul_rn; exact for
//   the 3D kernels' s_in = 1);
// - XLA contracts y * (s_in*s_w) + bias (3D: y * s_w + bias) into one fused
//   multiply-add on the CPU, so the dequant is __fmaf_rn (the build's
//   -fmad=false keeps nvcc from contracting anything else);
// - LeakyReLU is a >= 0 ? a : 0.1f * a;
// - the requant divides (IEEE __fdiv_rn, never __fdividef; no fast math) and
//   rounds half to even (rintf, never roundf: jnp.round is half-even), then
//   clips to [-127, 127];
// - K9's rescale is (x * s_a) / s_b, two roundings, as XLA leaves it.
// Channel counts need not be multiples of 4: the packed weights' input axis
// is zero-padded to a multiple of 32, and the activation loads fall back to
// byte loads (zero past the last channel) where a pixel's row is not 4-byte
// aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;        // input channels staged per step
constexpr int KW = KC / 4;    // ... as 32-bit words of four int8
constexpr int THREADS = 256;  // 16 channel lanes x 16 pixel lanes

// One block computes a (16*RM pixels) x (16*RN output channels) tile.
// Thread t takes channels (t % 16) + 16 j and pixels (t / 16) + 16 i, so the
// lanes of a warp write consecutive output bytes.  VOL: the input is (n, d, h,
// w, C), a batch of n*d planes of (h, w), 27 taps (or, transposed, 8).
template <bool TCONV, bool VOL, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
qconv(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ sw,
      const float* __restrict__ bias, int8_t* __restrict__ out, int n, int dd, int h, int wd,
      int cin, int cin_pad, int cout, int dil, int aligned, int out_stride, int out_off,
      float s_in, float s_out) {
  constexpr int TM = 16 * RM, TN = 16 * RN;
  constexpr int TAPS = TCONV ? 1 : (VOL ? 27 : 9);
  __shared__ int32_t As[KW][TM + 1];
  __shared__ int32_t Bs[KW][TN + 1];
  const int tid = threadIdx.x, lc = tid & 15, lp = tid >> 4;
  const long long M = (long long)n * dd * h * wd;
  const long long m0 = (long long)blockIdx.x * TM;
  const int o0 = blockIdx.y * TN;
  // TCONV: the tap (a, b[, c]) of out[2i+a, 2j+b] (out[2z+a, 2i+b, 2j+c])
  const int tap = TCONV ? (int)blockIdx.z : 0;
  const int hw = h * wd;

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int t = 0; t < TAPS; ++t) {
    const int tp = VOL ? t % 9 : t;  // the in-plane tap
    const int dz = (TCONV || !VOL) ? 0 : t / 9 - 1;
    const int dy = TCONV ? 0 : (tp / 3 - 1) * dil;
    const int dx = TCONV ? 0 : (tp % 3 - 1) * dil;
    for (int c0 = 0; c0 < cin_pad; c0 += KC) {
      // A: TM pixels x 8 words of the input (zero outside the frame or volume)
      for (int e = tid; e < TM * KW; e += THREADS) {
        const int p = e / KW, k = e - p * KW;
        const long long m = m0 + p;
        int v = 0;
        if (m < M) {
          const long long pl = m / hw;  // the plane: n*d + z (2D: n)
          const int r = (int)(m - pl * hw);
          const int y = r / wd + dy, xx = r - (r / wd) * wd + dx;
          const int c = c0 + 4 * k;
          bool inside = y >= 0 && y < h && xx >= 0 && xx < wd && c < cin;
          if (VOL) {
            const int z = (int)(pl % dd) + dz;
            inside = inside && z >= 0 && z < dd;
          }
          if (inside) {
            const int8_t* src = x + (((pl + dz) * h + y) * wd + xx) * cin + c;
            if (aligned) {
              v = *reinterpret_cast<const int*>(src);
            } else {
              uint32_t u = 0;
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (c + b < cin) u |= (uint32_t)(uint8_t)src[b] << (8 * b);
              v = (int)u;
            }
          }
        }
        As[k][p] = v;
      }
      // B: TN output channels x 8 words of the packed weights
      for (int e = tid; e < TN * KW; e += THREADS) {
        const int q = e / KW, k = e - q * KW;
        const int o = o0 + q;
        int v = 0;
        if (o < cout) {
          const long long row = TCONV ? ((long long)tap * cout + o) : ((long long)o * TAPS + t);
          v = *reinterpret_cast<const int*>(w + row * cin_pad + c0 + 4 * k);
        }
        Bs[k][q] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        int a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[k][lp + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = Bs[k][lc + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: dequant (one FMA), bias, LeakyReLU (K7), requant, clip
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long m = m0 + lp + 16 * i;
    if (m >= M) continue;
    long long dst = m;
    if (TCONV) {
      const long long pl = m / hw;
      const int r = (int)(m - pl * hw);
      const int y = r / wd, xx = r - (r / wd) * wd;
      if (VOL) {  // plane pl = ni * dd + z -> planes 2z + a of volume ni
        const long long ni = pl / dd;
        const int z = (int)(pl - ni * dd);
        dst = ((ni * 2 * dd + 2 * z + (tap >> 2)) * 2 * h + 2 * y + ((tap >> 1) & 1)) * (2 * wd)
              + 2 * xx + (tap & 1);
      } else {
        dst = (pl * 2 * h + 2 * y + (tap >> 1)) * (2 * wd) + 2 * xx + (tap & 1);
      }
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int o = o0 + lc + 16 * j;
      if (o >= cout) continue;
      float a = __fmaf_rn(__int2float_rn(acc[i][j]), __fmul_rn(s_in, sw[o]), bias[o]);
      if (!TCONV) a = a >= 0.0f ? a : __fmul_rn(0.1f, a);
      const float q = fminf(fmaxf(rintf(__fdiv_rn(a, s_out)), -127.0f), 127.0f);
      out[dst * out_stride + out_off + o] = (int8_t)q;
    }
  }
}

template <bool TCONV, bool VOL>
cudaError_t launch_qconv(const int8_t* x, const int8_t* w, const float* sw, const float* bias,
                         int8_t* out, int n, int dd, int h, int wd, int cin, int cin_pad,
                         int cout, int dil, int aligned, int out_stride, int out_off, float s_in,
                         float s_out, cudaStream_t st) {
  const long long M = (long long)n * dd * h * wd;
  const int taps = TCONV ? (VOL ? 8 : 4) : 1;
  if (M == 0) return cudaSuccess;
  if (cout <= 32) {  // 128 pixels x 32 channels: no block half idle on 32-wide layers
    dim3 grid((unsigned)((M + 127) / 128), (unsigned)((cout + 31) / 32), taps);
    qconv<TCONV, VOL, 8, 2><<<grid, THREADS, 0, st>>>(x, w, sw, bias, out, n, dd, h, wd, cin,
                                                      cin_pad, cout, dil, aligned, out_stride,
                                                      out_off, s_in, s_out);
  } else {
    dim3 grid((unsigned)((M + 63) / 64), (unsigned)((cout + 63) / 64), taps);
    qconv<TCONV, VOL, 4, 4><<<grid, THREADS, 0, st>>>(x, w, sw, bias, out, n, dd, h, wd, cin,
                                                      cin_pad, cout, dil, aligned, out_stride,
                                                      out_off, s_in, s_out);
  }
  return cudaGetLastError();
}

// K9: x (rows, C) of int8 / bf16 / float32 -> out rows of `out_stride`
// elements starting at `out_off`: int8 rint((x * s_a) / s_b) clipped, or (with
// to_bf16) the dequant bf16(x * s_a).
template <typename T>
__device__ __forceinline__ float as_float(const T* p, long long i);
template <>
__device__ __forceinline__ float as_float<int8_t>(const int8_t* p, long long i) {
  return (float)p[i];
}
template <>
__device__ __forceinline__ float as_float<__nv_bfloat16>(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float as_float<float>(const float* p, long long i) {
  return p[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
requant(const T* __restrict__ x, void* __restrict__ out, long long total, int C, int to_bf16,
        int out_stride, int out_off, float s_a, float s_b) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const long long r = e / C;
  const int c = (int)(e - r * C);
  const long long dst = r * out_stride + out_off + c;
  const float v = __fmul_rn(as_float<T>(x, e), s_a);
  if (to_bf16) {
    static_cast<__nv_bfloat16*>(out)[dst] = __float2bfloat16_rn(v);
  } else {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s_b)), -127.0f), 127.0f);
    static_cast<int8_t*>(out)[dst] = (int8_t)q;
  }
}

// K10: (n, h, w, C) int8 -> (n, h/2, w/2, C), a thread per output byte
__global__ void __launch_bounds__(THREADS)
maxpool_i8(const int8_t* __restrict__ x, int8_t* __restrict__ out, int n, int h, int wd,
           int C) {
  const int ho = h / 2, wo = wd / 2;
  const long long total = (long long)n * ho * wo * C;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % C);
  long long p = e / C;
  const int xo = (int)(p % wo);
  p /= wo;
  const int yo = (int)(p % ho);
  const long long ni = p / ho;
  const int8_t* src = x + ((ni * h + 2 * yo) * wd + 2 * xo) * C + c;
  int m = -128;
  m = max(m, (int)src[0]);
  m = max(m, (int)src[C]);
  m = max(m, (int)src[(long long)wd * C]);
  m = max(m, (int)src[(long long)wd * C + C]);
  out[e] = (int8_t)m;
}

// K10v: (n, d, h, w, C) int8 -> (n, d/2, h/2, w/2, C).  With C a multiple of
// 16 (and 16-byte aligned tensors) a thread takes 16 channels of an output
// voxel: eight 16-byte loads and a bytewise signed max (__vmaxs4); else a
// thread per output byte.
template <bool V16>
__global__ void __launch_bounds__(THREADS)
maxpool_i8_3d(const int8_t* __restrict__ x, int8_t* __restrict__ out, int n, int dd, int h,
              int wd, int C) {
  const int dout = dd / 2, ho = h / 2, wo = wd / 2;
  const int cv = V16 ? C / 16 : C;  // channel groups of 16 bytes, or channels
  const long long total = (long long)n * dout * ho * wo * cv;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % cv);
  long long p = e / cv;
  const int xo = (int)(p % wo);
  p /= wo;
  const int yo = (int)(p % ho);
  p /= ho;
  const int zo = (int)(p % dout);
  const long long ni = p / dout;
  const long long base = ((ni * dd + 2 * zo) * h + 2 * yo) * wd + 2 * xo;  // a voxel
  const long long sx = cv, sy = (long long)wd * cv, sz = (long long)h * wd * cv;
  if (V16) {
    const int4* src = reinterpret_cast<const int4*>(x) + base * cv + c;
    int4 m = src[0];
    const long long offs[7] = {sx, sy, sy + sx, sz, sz + sx, sz + sy, sz + sy + sx};
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int4 v = src[offs[k]];
      m.x = (int)__vmaxs4((unsigned)m.x, (unsigned)v.x);
      m.y = (int)__vmaxs4((unsigned)m.y, (unsigned)v.y);
      m.z = (int)__vmaxs4((unsigned)m.z, (unsigned)v.z);
      m.w = (int)__vmaxs4((unsigned)m.w, (unsigned)v.w);
    }
    reinterpret_cast<int4*>(out)[e] = m;
  } else {
    const int8_t* src = x + base * C + c;
    int m = src[0];
    m = max(m, (int)src[sx]);
    m = max(m, (int)src[sy]);
    m = max(m, (int)src[sy + sx]);
    m = max(m, (int)src[sz]);
    m = max(m, (int)src[sz + sx]);
    m = max(m, (int)src[sz + sy]);
    m = max(m, (int)src[sz + sy + sx]);
    out[e] = (int8_t)m;
  }
}

}  // namespace

extern "C" {

int k7_qconv3x3(const void* x, const void* w, const void* sw, const void* bias, void* out, int n,
                int h, int wd, int cin, int cin_pad, int cout, int dil, int aligned, float s_in,
                float s_out, void* stream) {
  return (int)launch_qconv<false, false>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      n, 1, h, wd, cin, cin_pad, cout, dil, aligned, cout, 0, s_in, s_out,
      static_cast<cudaStream_t>(stream));
}

int k8_qconvt2x2(const void* x, const void* w, const void* sw, const void* bias, void* out, int n,
                 int h, int wd, int cin, int cin_pad, int cout, int aligned, int out_stride,
                 int out_off, float s_in, float s_out, void* stream) {
  return (int)launch_qconv<true, false>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      n, 1, h, wd, cin, cin_pad, cout, 1, aligned, out_stride, out_off, s_in, s_out,
      static_cast<cudaStream_t>(stream));
}

// in_code: 0 int8, 1 bfloat16, 2 float32
int k9_requant(const void* x, int in_code, void* out, long long total, int C, int to_bf16,
               int out_stride, int out_off, float s_a, float s_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (total == 0) return 0;
  if (in_code == 0)
    requant<int8_t><<<blocks, THREADS, 0, st>>>(static_cast<const int8_t*>(x), out, total, C,
                                                 to_bf16, out_stride, out_off, s_a, s_b);
  else if (in_code == 1)
    requant<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                        out, total, C, to_bf16, out_stride,
                                                        out_off, s_a, s_b);
  else
    requant<float><<<blocks, THREADS, 0, st>>>(static_cast<const float*>(x), out, total, C,
                                                to_bf16, out_stride, out_off, s_a, s_b);
  return (int)cudaGetLastError();
}

int k10_maxpool_i8(const void* x, void* out, int n, int h, int wd, int C, void* stream) {
  const long long total = (long long)n * (h / 2) * (wd / 2) * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  maxpool_i8<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), n, h, wd, C);
  return (int)cudaGetLastError();
}

// K7v: weights (O, 3, 3, 3, I_pad), the activation scales folded in (s_in = 1);
// output channels [out_off, out_off + O) of rows of out_stride
int k7v_qconv3x3x3(const void* x, const void* w, const void* sw, const void* bias, void* out,
                   int n, int d, int h, int wd, int cin, int cin_pad, int cout, int aligned,
                   int out_stride, int out_off, float s_out, void* stream) {
  return (int)launch_qconv<false, true>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      n, d, h, wd, cin, cin_pad, cout, 1, aligned, out_stride, out_off, 1.0f, s_out,
      static_cast<cudaStream_t>(stream));
}

// K8v: weights (2, 2, 2, O, I_pad), the input scale folded in
int k8v_qconvt2x2x2(const void* x, const void* w, const void* sw, const void* bias, void* out,
                    int n, int d, int h, int wd, int cin, int cin_pad, int cout, int aligned,
                    int out_stride, int out_off, float s_out, void* stream) {
  return (int)launch_qconv<true, true>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      n, d, h, wd, cin, cin_pad, cout, 1, aligned, out_stride, out_off, 1.0f, s_out,
      static_cast<cudaStream_t>(stream));
}

int k10v_maxpool_i8_3d(const void* x, void* out, int n, int d, int h, int wd, int C, int v16,
                       void* stream) {
  const long long total = (long long)n * (d / 2) * (h / 2) * (wd / 2) * (v16 ? C / 16 : C);
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v16)
    maxpool_i8_3d<true><<<blocks, THREADS, 0, st>>>(static_cast<const int8_t*>(x),
                                                    static_cast<int8_t*>(out), n, d, h, wd, C);
  else
    maxpool_i8_3d<false><<<blocks, THREADS, 0, st>>>(static_cast<const int8_t*>(x),
                                                     static_cast<int8_t*>(out), n, d, h, wd, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
