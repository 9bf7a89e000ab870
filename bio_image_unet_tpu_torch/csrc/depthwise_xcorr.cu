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
// 16x16 and a forward batch is (128, 256, 16, 16): each output sums up to
// 16*16 products, about 2.1 G multiply-adds (1.2 G of them on real pixels,
// the rest on the zero pad), against 25 MB of bf16 in and out.  They are
// scalar float32 multiply-adds on the CUDA cores (67 TFLOP/s), not a tensor
// core product.  Design: one block per (batch, group of CG channels) stages
// both planes of its channels in shared memory as float32, laid out
// [pixel][channel] so that consecutive threads take consecutive channels:
// the loads coalesce on the channels_last bf16 activations the folded
// forward holds, and the shared-memory reads of a warp hit distinct banks.
// Each thread then makes outputs of one channel, skipping the taps that fall
// on the zero pad (each output's tap range is clipped to the plane).  A
// tensor-core (Toeplitz / implicit-GEMM) formulation is later work.
//
// Numbers: products and sums are float32, separately rounded (__fmul_rn,
// __fadd_rn: no FMA), summed over the kernel rows then columns in order --
// the plain PyTorch version's order, so the two are equal in float32; the
// result is written in the input type (bfloat16 rounded to nearest even).
// Any plane size whose two staged planes fit the block's shared memory
// (227 KB for one channel) is taken; the wrapper raises above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct Strides {
  long long b, c, h, w;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256)
xcorr(const T* __restrict__ cur, const T* __restrict__ ker, T* __restrict__ out, int C,
      int H, int W, int KH, int KW, int CG, int groups, Strides sc, Strides sk, Strides so) {
  extern __shared__ float sm[];
  const int HW = H * W, KK = KH * KW;
  float* s_cur = sm;              // [HW][CG]
  float* s_ker = sm + HW * CG;    // [KK][CG]
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * CG;
  const int ncg = min(CG, C - c0);

  for (int e = threadIdx.x; e < HW * CG; e += blockDim.x) {
    const int p = e / CG, c = e - p * CG;
    float v = 0.0f;
    if (c < ncg) {
      const int y = p / W, x = p - y * W;
      v = load(cur + b * sc.b + (c0 + c) * sc.c + y * sc.h + x * sc.w);
    }
    s_cur[e] = v;
  }
  for (int e = threadIdx.x; e < KK * CG; e += blockDim.x) {
    const int p = e / CG, c = e - p * CG;
    float v = 0.0f;
    if (c < ncg) {
      const int y = p / KW, x = p - y * KW;
      v = load(ker + b * sk.b + (c0 + c) * sk.c + y * sk.h + x * sk.w);
    }
    s_ker[e] = v;
  }
  __syncthreads();

  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;
  for (int e = threadIdx.x; e < HW * CG; e += blockDim.x) {
    const int p = e / CG, c = e - p * CG;
    if (c >= ncg) continue;
    const int i = p / W, j = p - i * W;
    // taps whose source pixel lies inside the plane
    const int u0 = max(0, ph - i), u1 = min(KH, H + ph - i);
    const int v0 = max(0, pw - j), v1 = min(KW, W + pw - j);
    float acc = 0.0f;
    for (int u = u0; u < u1; ++u) {
      const int crow = (i + u - ph) * W + (j - pw);
      const int krow = u * KW;
      for (int v = v0; v < v1; ++v)
        acc = __fadd_rn(acc, __fmul_rn(s_cur[(crow + v) * CG + c], s_ker[(krow + v) * CG + c]));
    }
    store(out + b * so.b + (c0 + c) * so.c + i * so.h + j * so.w, acc);
  }
}

template <typename T>
static int launch(const void* cur, const void* ker, void* out, int B, int C, int H, int W,
                  int KH, int KW, int CG, Strides sc, Strides sk, Strides so, void* stream) {
  const int groups = (C + CG - 1) / CG;
  const size_t smem = (size_t)CG * (H * W + KH * KW) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(xcorr<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  xcorr<T><<<(unsigned)B * groups, 256, smem, (cudaStream_t)stream>>>(
      (const T*)cur, (const T*)ker, (T*)out, C, H, W, KH, KW, CG, groups, sc, sk, so);
  return (int)cudaGetLastError();
}

extern "C" {

// cur (B, C, H, W), ker (B, C, KH, KW) and out (B, C, H, W) with element
// strides (b, c, h, w) each -- NCHW or channels_last; is_bf16: 0 = float32,
// 1 = bfloat16 (all three alike).  CG channels per block: the caller keeps
// CG * (H*W + KH*KW) * 4 bytes within the block's shared memory.  One launch.
int k6_depthwise_xcorr(const void* cur, const void* ker, void* out, int is_bf16, int B, int C,
                       int H, int W, int KH, int KW, int CG, long long cb, long long cc,
                       long long ch, long long cw, long long kb, long long kc, long long kh,
                       long long kw, long long ob, long long oc, long long oh, long long ow,
                       void* stream) {
  const Strides sc{cb, cc, ch, cw}, sk{kb, kc, kh, kw}, so{ob, oc, oh, ow};
  if (is_bf16)
    return launch<__nv_bfloat16>(cur, ker, out, B, C, H, W, KH, KW, CG, sc, sk, so, stream);
  return launch<float>(cur, ker, out, B, C, H, W, KH, KW, CG, sc, sk, so, stream);
}

}  // extern "C"
