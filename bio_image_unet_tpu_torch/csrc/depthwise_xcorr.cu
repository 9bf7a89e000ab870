// K6: depthwise cross-correlation of the Siam_UNet 'corr' join.
//
// Replaces bio_image_unet_tpu/ops/functional.py:95 depthwise_xcorr (the
// reference's grouped-conv trick, siam_unet/siam_unet.py:75-83): every
// (batch, channel) plane of the current frame's pooled bottleneck is
// correlated with the same plane of the previous frame's, used as the kernel,
// with torch 'same' padding ((k-1)//2 zeros before, k//2 after).  The JAX
// package folds (B, C) into the feature axis and runs one grouped
// conv_general_dilated.
//
// What bounds it on the card: operations.  At 256-pixel tiles the planes are
// 16x16 and a forward batch is (128, 256, 16, 16) bf16 channels_last: 1.21 G
// multiply-adds on real pixels against 25 MB in and out; at PredictSiam's
// default 512-pixel tiles in float32 they are 32x32, (32, 256, 32, 32) NCHW,
// 4.8 G.  They are scalar float32 products and sums, each rounded (no FMA:
// the plain version's rounding), so the CUDA cores' ceiling is half their FMA
// rate: 0.072 ms for the bf16 batch, 0.29 ms for the float32 one.
//
// Design: register tiles, so that shared memory is not what limits.
// - A block stages CG planes in shared memory as float32 with a zero halo,
//   and their kernels in the input type (bf16 kernels are unpacked in
//   registers: 16x16 planes then take 107 KB a block, two blocks an SM, one
//   staging while the other computes); ops/functional.py xcorr_geometry: CG
//   = 32 for 16x16 planes, 16 for 32x32.  Staging reads along the tensor's
//   fastest axis (channels for channels_last, the row for NCHW) in 16-byte
//   loads where the host allows (xcorr_stage_vector), a few in flight a
//   thread: with element loads, staging took a third of the bf16 batch's
//   time.
// - A thread makes R x S = 4 x 4 outputs of one plane.  Over each kernel row
//   u it slides a window of its R input rows along v in 16-byte shared-memory
//   loads: per 4 taps of a row, one load of the kernel's 4 values and one new
//   load per input row carry 64 products and sums (the old kernel: two loads
//   a product).
// - The lanes of a warp are CG planes x 32/CG tiles side by side in one tile
//   row (the warp's region); all walk the region's tap range, u exact, v
//   rounded out to multiples of 4: control flow is uniform, and every tap
//   left out lies on the zero pad for each of the region's outputs.  The
//   taps walked that fall on the pad for an output read the halo's zeros
//   (or, past kw, the kernel's zero padding), adding +0 or -0 to a sum that
//   started at +0, which never changes it.  Staged planes lie 4 mod 32
//   floats apart, so the lanes of a 16-byte access hit distinct banks.
//
// Numbers: products and sums are float32, separately rounded (__fmul_rn,
// __fadd_rn: no FMA), summed over the kernel rows then columns in order --
// the plain PyTorch version's order, so the two are equal bit for bit on
// finite inputs; the result is written in the input type (bfloat16 rounded
// to nearest even).
//
// Planes whose haloed staging does not fit a block's shared memory (above
// ~112x112 with a kernel as large) take xcorr_plane: one block a plane,
// staged as float32 without a halo (the plane and its kernel up to the
// card's 227 KB: ~170x170 with a 170x170 kernel), one output a thread at a
// time, its tap range clipped to the plane exactly and walked in the same
// order.  No Siam path at its tiles' sizes runs it (their planes are the
// tile / 16); the wrapper raises above it.
//
// K6b: the two gradients of K6, which the Siam trainer's corr join needs
// (JAX differentiates the grouped conv with jax.grad).  Given g = dL/dout
// (B, C, H, W) and the forward's padding (ph = (KH-1)/2 before):
// - grad input (xcorr_grad_input): dcur[y,x] = sum_{u,v} g[y+ph-u, x+pw-v]
//   prev[u,v], g correlated with the flipped kernel, the padding swapped
//   (KH/2 before, (KH-1)/2 after: for even kernels the two differ);
// - grad kernel (xcorr_grad_kernel): dprev[u,v] = sum_{y,x} g[y,x]
//   cur[y+u-ph, x+v-pw], a reduction over the whole plane for each tap.
// Both are the plane form's design: one block a (batch, channel) plane, g
// and the other operand staged as float32 in shared memory without a halo,
// one output a thread at a time, its range clipped to the plane exactly
// and walked in the plain versions' order (u then v; y then x), products
// and sums separately rounded: equal bit for bit to
// ops/functional.py depthwise_xcorr_grad_input_plain / _kernel_plain on
// finite inputs (a skipped tap adds a zero product to a sum that started
// at +0, which never changes it).  Bound on the card by operations: at the
// Siam trainer's (12, 256, 16, 16) a form makes 113 M products on real
// pixels; the launch and the staging dominate there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4, S = 4;    // a thread's outputs: rows x columns of one plane
constexpr int THREADS = 512;   // at most; small planes take fewer
constexpr int MAX_CG = 32;
// blocks an SM holds: bf16 blocks of 16x16 planes fit twice (registers capped
// at 64, shared memory 107 KB each), float32 blocks of 32x32 planes once (203
// KB) and keep ~96 registers; loads a thread keeps in flight when staging
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 2 ? 2 : 1;
template <typename T>
constexpr int STAGE_LOADS = sizeof(T) == 2 ? 8 : 16;
constexpr int STAGE_VECS = 4;  // 16-byte loads a thread keeps in flight when staging

struct Strides {
  long long b, c, h, w;
};

// ops/functional.py XcorrGeometry (lengths in floats)
struct Geometry {
  int cg, n, tpr, tiles, pad_t, pad_l, xp, xplane, kwp, kplane, smem;
};

struct Shape {
  int planes, C, H, W, KH, KW;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// a staged kernel value: float32 for float32 input, the bf16 itself for bf16
__device__ __forceinline__ float stage_value(const float* p, float) { return *p; }
__device__ __forceinline__ float stage_value(const __nv_bfloat16* p, float) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ __nv_bfloat16 stage_value(const __nv_bfloat16* p, __nv_bfloat16) {
  return *p;
}
// element k of 16 bytes of T (four words), staged as D
__device__ __forceinline__ float element(const uint4& q, int k, float, float) {
  return __uint_as_float((&q.x)[k]);
}
__device__ __forceinline__ float element(const uint4& q, int k, __nv_bfloat16, float) {
  const uint32_t w = (&q.x)[k >> 1];
  return __uint_as_float(k & 1 ? w & 0xFFFF0000u : w << 16);
}
__device__ __forceinline__ __nv_bfloat16 element(const uint4& q, int k, __nv_bfloat16,
                                                 __nv_bfloat16) {
  return __ushort_as_bfloat16((unsigned short)((&q.x)[k >> 1] >> (16 * (k & 1))));
}
// four staged kernel values as float32 (16 bytes, or 8 of bf16)
__device__ __forceinline__ float4 kernel4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 kernel4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the h x w planes of the block's ncg planes (plane c at src + base[c]) into
// dst[c * plane + y * pitch + x], STAGE_LOADS loads of a thread in flight at
// once; a warp reads one pixel's channels where they are the fastest axis
// (ncg <= 32: one a lane), else 32 columns of a row

// the same with 16-byte loads of V elements along the fastest axis (the host
// allows it where that axis is contiguous, the block's runs along it fill
// whole vectors and every vector is 16-byte aligned), STAGE_VECS in flight
template <typename T, typename D>
__device__ void stage16(const T* __restrict__ src, const Strides& st, const long long* base,
                        D* dst, int pitch, int plane, int ncg, int h, int w) {
  constexpr int V = 16 / sizeof(T);
  const bool cfast = st.c < st.w;
  const int per = cfast ? ncg / V : w / V;  // vectors a pixel, or a row
  const int units = cfast ? h * w * per : ncg * h * per;
  const int step = cfast ? plane : 1;  // between the staged elements of a vector
  for (int u0 = threadIdx.x; u0 < units; u0 += blockDim.x * STAGE_VECS) {
    uint4 q[STAGE_VECS];
    int at[STAGE_VECS];
#pragma unroll
    for (int i = 0; i < STAGE_VECS; ++i) {
      const int unit = u0 + i * blockDim.x;
      at[i] = -1;
      if (unit < units) {
        const int major = unit / per, vec = (unit - major * per) * V;
        int c, y, x;
        if (cfast) {
          c = vec;
          y = major / w;
          x = major - y * w;
        } else {
          c = major / h;
          y = major - c * h;
          x = vec;
        }
        q[i] = *reinterpret_cast<const uint4*>(src + base[c] + y * st.h + x * st.w);
        at[i] = c * plane + y * pitch + x;
      }
    }
#pragma unroll
    for (int i = 0; i < STAGE_VECS; ++i)
      if (at[i] >= 0)
#pragma unroll
        for (int k = 0; k < V; ++k) dst[at[i] + k * step] = element(q[i], k, T(), D());
  }
}

template <typename T, typename D>
__device__ void stage(const T* __restrict__ src, const Strides& st, const long long* base,
                      D* dst, int pitch, int plane, int ncg, int h, int w, int vec) {
  if (vec > 1) {
    stage16(src, st, base, dst, pitch, plane, ncg, h, w);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool cfast = st.c < st.w;
  // a warp's units: pixels (all channels), or (plane, row, 32 columns)
  const int wcols = (w + 31) / 32;
  const int units = cfast ? h * w : ncg * h * wcols;
  constexpr int NL = STAGE_LOADS<T>;
  for (int u0 = warp * NL; u0 < units; u0 += nw * NL) {
    D v[NL];
    int at[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int unit = u0 + i;
      int c, y, x;
      if (cfast) {
        c = lane;
        y = unit / w;
        x = unit - y * w;
      } else {
        const int row = unit / wcols;
        c = row / h;
        y = row - c * h;
        x = (unit - row * wcols) * 32 + lane;
      }
      const bool ok = unit < units && c < ncg && x < w;
      at[i] = ok ? c * plane + y * pitch + x : -1;
      if (ok) v[i] = stage_value(src + base[c] + y * st.h + x * st.w, D());
    }
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (at[i] >= 0) dst[at[i]] = v[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>)
xcorr(const T* __restrict__ cur, const T* __restrict__ ker, T* __restrict__ out, Shape sh,
      Geometry g, Strides sc, Strides sk, Strides so, int vx, int vk) {
  extern __shared__ __align__(16) float sm[];
  __shared__ long long base[3][MAX_CG];  // each plane's offset in cur, ker, out
  float* sx = sm;                               // [cg][pad_t + H + pad_t][xp]
  T* skr = reinterpret_cast<T*>(sm + g.cg * g.xplane);  // [cg][KH][kwp]
  const int p0 = blockIdx.x * g.cg;
  const int ncg = min(g.cg, sh.planes - p0);

  float4* z = reinterpret_cast<float4*>(sm);
  for (int e = threadIdx.x; e < g.smem / 16; e += blockDim.x)
    z[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x < ncg) {
    const int p = p0 + threadIdx.x, b = p / sh.C, c = p - b * sh.C;
    base[0][threadIdx.x] = b * sc.b + c * sc.c;
    base[1][threadIdx.x] = b * sk.b + c * sk.c;
    base[2][threadIdx.x] = b * so.b + c * so.c;
  }
  __syncthreads();
  stage(cur, sc, base[0], sx + g.pad_t * g.xp + g.pad_l, g.xp, g.xplane, ncg, sh.H, sh.W, vx);
  stage(ker, sk, base[1], skr, g.kwp, g.kplane, ncg, sh.KH, sh.KW, vk);
  __syncthreads();

  const int ph = (sh.KH - 1) / 2, pw = (sh.KW - 1) / 2;
  const int items = g.cg * g.tiles;  // a multiple of 32: whole warps
  for (int wi = threadIdx.x; wi < items; wi += blockDim.x) {  // uniform in a warp
    const int cl = wi & (g.cg - 1), t = wi / g.cg;  // plane of the block, tile
    const int tr = t / g.tpr, tc = t - tr * g.tpr;
    const int i0 = tr * R, j0 = tc * S;
    const int jr = (tc - tc % g.n) * S;  // the warp's region: columns [jr, jr + n S)
    // the region's taps: rows exact, columns rounded out to multiples of 4
    const int u_lo = max(0, ph - (i0 + R - 1)), u_hi = min(sh.KH, sh.H + ph - i0);
    const int v_lo = max(0, pw - (jr + g.n * S - 1)) & ~3;
    const int v_end = (min(sh.KW, sh.W + pw - jr) + 3) & ~3;

    float acc[R][S];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[r][s] = 0.0f;
    // input (i0 + r + u - ph, j0 + v - pw) of row r at tap (u, v): 16-byte
    // aligned at v = v_lo, as pad_l = pw mod 4
    const int xo = cl * g.xplane + (g.pad_t + i0 - ph) * g.xp + g.pad_l + j0 - pw + v_lo;
    const int ko = cl * g.kplane + v_lo;
    for (int u = u_lo; u < u_hi; ++u) {
      const float* xr = sx + (xo + u * g.xp);
      const T* kr = skr + (ko + u * g.kwp);
      float4 lo[R];
#pragma unroll
      for (int r = 0; r < R; ++r) lo[r] = *reinterpret_cast<const float4*>(xr + r * g.xp);
#pragma unroll 2
      for (int v = 0; v < v_end - v_lo; v += 4) {
        const float4 kq = kernel4(kr + v);
        float win[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hi = *reinterpret_cast<const float4*>(xr + r * g.xp + v + 4);
          win[r][0] = lo[r].x; win[r][1] = lo[r].y; win[r][2] = lo[r].z; win[r][3] = lo[r].w;
          win[r][4] = hi.x; win[r][5] = hi.y; win[r][6] = hi.z; win[r][7] = hi.w;
          lo[r] = hi;
        }
#pragma unroll
        for (int dv = 0; dv < 4; ++dv) {
          const float k = dv == 0 ? kq.x : dv == 1 ? kq.y : dv == 2 ? kq.z : kq.w;
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int s = 0; s < S; ++s)
              acc[r][s] = __fadd_rn(acc[r][s], __fmul_rn(win[r][s + dv], k));
        }
      }
    }
    if (cl < ncg) {
      T* o = out + base[2][cl];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (i0 + r < sh.H && j0 + s < sh.W)
            store(o + (i0 + r) * so.h + (j0 + s) * so.w, acc[r][s]);
    }
  }
}

// the plane form: one block a (batch, channel) plane, [H][W] and [KH][KW]
// float32 in shared memory, no static arrays (the whole 227 KB is the
// planes')
template <typename T>
__global__ void __launch_bounds__(THREADS)
xcorr_plane(const T* __restrict__ cur, const T* __restrict__ ker, T* __restrict__ out, Shape sh,
            Strides sc, Strides sk, Strides so) {
  extern __shared__ __align__(16) float sm[];
  const int hw = sh.H * sh.W, kk = sh.KH * sh.KW;
  float* sx = sm;       // [H][W]
  float* sk_ = sm + hw;  // [KH][KW]
  const int p = blockIdx.x, b = p / sh.C, c = p - b * sh.C;
  const T* x = cur + (b * sc.b + c * sc.c);
  const T* k = ker + (b * sk.b + c * sk.c);
  T* o = out + (b * so.b + c * so.c);
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const int y = e / sh.W;
    sx[e] = stage_value(x + (y * sc.h + (e - y * sh.W) * sc.w), float());
  }
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const int y = e / sh.KW;
    sk_[e] = stage_value(k + (y * sk.h + (e - y * sh.KW) * sk.w), float());
  }
  __syncthreads();

  const int ph = (sh.KH - 1) / 2, pw = (sh.KW - 1) / 2;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const int i = e / sh.W, j = e - i * sh.W;
    // the taps whose input lies inside the plane
    const int u0 = max(0, ph - i), u1 = min(sh.KH, sh.H + ph - i);
    const int v0 = max(0, pw - j), v1 = min(sh.KW, sh.W + pw - j);
    float acc = 0.0f;
    for (int u = u0; u < u1; ++u) {
      const int xr = (i + u - ph) * sh.W + j - pw, kr = u * sh.KW;
      for (int v = v0; v < v1; ++v) acc = __fadd_rn(acc, __fmul_rn(sx[xr + v], sk_[kr + v]));
    }
    store(o + (i * so.h + j * so.w), acc);
  }
}

// rows x cols of the (b, c) plane of src (element strides st) into dst as
// float32, row-major
template <typename T>
__device__ void stage_plane(const T* __restrict__ src, const Strides& st, int b, int c,
                            float* dst, int rows, int cols) {
  const T* x = src + (b * st.b + c * st.c);
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int y = e / cols;
    dst[e] = stage_value(x + (y * st.h + (e - y * cols) * st.w), float());
  }
}

// K6b grad input: g (B, C, H, W), ker (B, C, KH, KW) -> out (B, C, H, W)
template <typename T>
__global__ void __launch_bounds__(THREADS)
xcorr_grad_input(const T* __restrict__ g, const T* __restrict__ ker, T* __restrict__ out,
                 Shape sh, Strides sg, Strides sk, Strides so) {
  extern __shared__ __align__(16) float sm[];
  const int hw = sh.H * sh.W;
  float* sgr = sm;       // [H][W]
  float* skr = sm + hw;  // [KH][KW]
  const int p = blockIdx.x, b = p / sh.C, c = p - b * sh.C;
  stage_plane(g, sg, b, c, sgr, sh.H, sh.W);
  stage_plane(ker, sk, b, c, skr, sh.KH, sh.KW);
  __syncthreads();

  const int ph = (sh.KH - 1) / 2, pw = (sh.KW - 1) / 2;
  T* o = out + (b * so.b + c * so.c);
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const int i = e / sh.W, j = e - i * sh.W;
    // the taps whose g[i + ph - u, j + pw - v] lies inside the plane
    const int u0 = max(0, i + ph - sh.H + 1), u1 = min(sh.KH, i + ph + 1);
    const int v0 = max(0, j + pw - sh.W + 1), v1 = min(sh.KW, j + pw + 1);
    float acc = 0.0f;
    for (int u = u0; u < u1; ++u) {
      const int gr = (i + ph - u) * sh.W + j + pw, kr = u * sh.KW;
      for (int v = v0; v < v1; ++v) acc = __fadd_rn(acc, __fmul_rn(sgr[gr - v], skr[kr + v]));
    }
    store(o + (i * so.h + j * so.w), acc);
  }
}

// K6b grad kernel: g (B, C, H, W), cur (B, C, H, W) -> out (B, C, KH, KW)
template <typename T>
__global__ void __launch_bounds__(THREADS)
xcorr_grad_kernel(const T* __restrict__ g, const T* __restrict__ cur, T* __restrict__ out,
                  Shape sh, Strides sg, Strides sc, Strides so) {
  extern __shared__ __align__(16) float sm[];
  const int hw = sh.H * sh.W;
  float* sgr = sm;       // [H][W]
  float* scr = sm + hw;  // [H][W]
  const int p = blockIdx.x, b = p / sh.C, c = p - b * sh.C;
  stage_plane(g, sg, b, c, sgr, sh.H, sh.W);
  stage_plane(cur, sc, b, c, scr, sh.H, sh.W);
  __syncthreads();

  const int ph = (sh.KH - 1) / 2, pw = (sh.KW - 1) / 2;
  T* o = out + (b * so.b + c * so.c);
  for (int e = threadIdx.x; e < sh.KH * sh.KW; e += blockDim.x) {
    const int u = e / sh.KW, v = e - u * sh.KW;
    // the outputs whose cur[y + u - ph, x + v - pw] lies inside the plane
    const int y0 = max(0, ph - u), y1 = min(sh.H, sh.H + ph - u);
    const int x0 = max(0, pw - v), x1 = min(sh.W, sh.W + pw - v);
    float acc = 0.0f;
    for (int y = y0; y < y1; ++y) {
      const int gr = y * sh.W, cr = (y + u - ph) * sh.W + v - pw;
      for (int x = x0; x < x1; ++x) acc = __fadd_rn(acc, __fmul_rn(sgr[gr + x], scr[cr + x]));
    }
    store(o + (u * so.h + v * so.w), acc);
  }
}

template <typename T>
int launch_grad(int kernel_grad, const void* g, const void* other, void* out, const Shape& sh,
                const Strides& sg, const Strides& sx, const Strides& so, void* stream) {
  const int smem = (sh.H * sh.W + (kernel_grad ? sh.H * sh.W : sh.KH * sh.KW)) *
                   (int)sizeof(float);
  auto fn = kernel_grad ? xcorr_grad_kernel<T> : xcorr_grad_input<T>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<(unsigned)sh.planes, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)other, (T*)out, sh, sg, sx, so);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_plane(const void* cur, const void* ker, void* out, const Shape& sh,
                 const Strides& sc, const Strides& sk, const Strides& so, void* stream) {
  const int smem = (sh.H * sh.W + sh.KH * sh.KW) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(xcorr_plane<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  xcorr_plane<T><<<(unsigned)sh.planes, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)cur, (const T*)ker, (T*)out, sh, sc, sk, so);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* cur, const void* ker, void* out, const Shape& sh, const Geometry& g,
           int threads, int smem, const Strides& sc, const Strides& sk, const Strides& so,
           int vx, int vk, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(xcorr<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((sh.planes + g.cg - 1) / g.cg);
  xcorr<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)cur, (const T*)ker, (T*)out, sh, g, sc, sk, so, vx, vk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur (B, C, H, W), ker (B, C, KH, KW) and out (B, C, H, W) with element
// strides (b, c, h, w) each -- NCHW or channels_last; is_bf16: 0 = float32,
// 1 = bfloat16 (all three alike); cg ... kplane, threads and smem: the
// staging that ops/functional.py xcorr_geometry chose; vx, vk: elements one
// staging load of cur, ker moves (16 bytes' worth, or 1).  One launch.
int k6_depthwise_xcorr(const void* cur, const void* ker, void* out, int is_bf16, int B, int C,
                       int H, int W, int KH, int KW, int cg, int n, int tpr, int tiles,
                       int pad_t, int pad_l, int xp, int xplane, int kwp, int kplane,
                       int threads, int smem, int vx, int vk, long long cb, long long cc,
                       long long ch, long long cw, long long kb, long long kc, long long kh,
                       long long kw, long long ob, long long oc, long long oh, long long ow,
                       void* stream) {
  if (B * C == 0) return 0;
  if (cg < 1 || cg > MAX_CG || (cg & (cg - 1)) || cg * n != 32 || tpr % n || threads % 32 ||
      threads > THREADS || (pad_l - (KW - 1) / 2) % 4 || xp % 4 || xplane % 32 != 4 ||
      kwp % 4 || kplane % (is_bf16 ? 64 : 32) != 4 || smem % 16 ||
      (vx != 1 && vx != (is_bf16 ? 8 : 4)) || (vk != 1 && vk != (is_bf16 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  // the staging must be laid out for this file's R x S tiles: every tile, the
  // R - 1 halo rows, the region's n S + 2.. columns each side, whole planes
  if (tiles != (H + R - 1) / R * tpr || tpr * S < W || pad_t != R - 1 || pad_l < n * S + 2 ||
      xp < pad_l + W + (n - 1) * S + 7 || xplane < (H + 2 * pad_t) * xp || kwp < KW ||
      kplane < KH * kwp || smem < cg * (4 * xplane + (is_bf16 ? 2 : 4) * kplane))
    return (int)cudaErrorInvalidValue;
  const Shape sh{B * C, C, H, W, KH, KW};
  const Geometry g{cg, n, tpr, tiles, pad_t, pad_l, xp, xplane, kwp, kplane, smem};
  const Strides sc{cb, cc, ch, cw}, sk{kb, kc, kh, kw}, so{ob, oc, oh, ow};
  if (is_bf16)
    return launch<__nv_bfloat16>(cur, ker, out, sh, g, threads, smem, sc, sk, so, vx, vk,
                                 stream);
  return launch<float>(cur, ker, out, sh, g, threads, smem, sc, sk, so, vx, vk, stream);
}

// the same for planes whose haloed staging does not fit (xcorr_plane): the
// plane and its kernel, (H W + KH KW) float32, within the block's shared
// memory (cudaFuncSetAttribute refuses more).  One launch.
int k6_depthwise_xcorr_plane(const void* cur, const void* ker, void* out, int is_bf16, int B,
                             int C, int H, int W, int KH, int KW, long long cb, long long cc,
                             long long ch, long long cw, long long kb, long long kc,
                             long long kh, long long kw, long long ob, long long oc,
                             long long oh, long long ow, void* stream) {
  if (B * C == 0) return 0;
  const Shape sh{B * C, C, H, W, KH, KW};
  const Strides sc{cb, cc, ch, cw}, sk{kb, kc, kh, kw}, so{ob, oc, oh, ow};
  if (is_bf16)
    return launch_plane<__nv_bfloat16>(cur, ker, out, sh, sc, sk, so, stream);
  return launch_plane<float>(cur, ker, out, sh, sc, sk, so, stream);
}

// K6b: kernel_grad 0 = the input's gradient (other = the kernel (B, C, KH,
// KW), out (B, C, H, W)), 1 = the kernel's (other = cur (B, C, H, W), out
// (B, C, KH, KW)); g (B, C, H, W); element strides (b, c, h, w) each, any
// layout; the staged planes, (H W + KH KW) or 2 H W float32, within the
// block's shared memory (cudaFuncSetAttribute refuses more).  One launch.
int k6b_depthwise_xcorr_grad(int kernel_grad, const void* g, const void* other, void* out,
                             int is_bf16, int B, int C, int H, int W, int KH, int KW,
                             long long gb, long long gc, long long gh, long long gw,
                             long long xb, long long xc, long long xh, long long xw,
                             long long ob, long long oc, long long oh, long long ow,
                             void* stream) {
  if (B * C == 0) return 0;
  const Shape sh{B * C, C, H, W, KH, KW};
  const Strides sg{gb, gc, gh, gw}, sx{xb, xc, xh, xw}, so{ob, oc, oh, ow};
  if (is_bf16)
    return launch_grad<__nv_bfloat16>(kernel_grad, g, other, out, sh, sg, sx, so, stream);
  return launch_grad<float>(kernel_grad, g, other, out, sh, sg, sx, so, stream);
}

}  // extern "C"
