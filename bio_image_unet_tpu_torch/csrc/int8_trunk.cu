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
// What bounds K7/K8 on the card.  They are int8 products on the tensor cores
// (1979 TOP/s dense) fed from HBM (3.35 TB/s): the ridge is ~590 operations
// a byte.  A 3x3 conv does 2*9*cin operations per output byte it reads and
// writes once each, so the 2D full-resolution layers (cin 32 or 64 at 256^2,
// ~288 operations a byte) sit near the ridge and are held by bytes, while the
// 16^2..64^2 layers and the 3D layers (27 taps, cin up to 384) are held by
// operations.  K8 (the transposed conv: one input pixel, 4 or 8 output pixels)
// is held by bytes except at the narrowest level.
//
// The design: one implicit-GEMM template, qconv, for all four.
// - K7/K7v: M = output pixels (voxels), N = cout, K = taps x cin.  K8/K8v: M =
//   input pixels, N = taps x cout (all taps in one block, so an input tile is
//   read once), K = cin; the epilogue scatters tap (a, b[, c])'s columns to
//   output pixel (2i+a, 2j+b[, 2z+c]).  Both operands are K-major: the NHWC
//   activations are channel-contiguous per tap, the weight store (O, taps,
//   I_pad) / (taps, O, I_pad) is I_pad-contiguous.
// - Tensor cores through mma.sync.m16n8k32.s8.s8.s32 fed by ldmatrix from a
//   XOR-swizzled shared-memory tile (conflict-free for ldmatrix and for the
//   16-byte copies); each warp owns a (16 MT) x (8 NT) tile of the block's.
//   (wgmma would need the gathered A tile in its canonical swizzled layout and
//   a 64-row warpgroup tile per 8 rows of N; mma.sync keeps the gather simple
//   and reaches ~460-480 TOP/s on the deep layers on an H100.)
// - K is walked in 16-byte chunks, each (tap, 16 channels): a stage is 4
//   chunks (64 bytes, two k32 MMA steps) of BM pixel rows and BN weight rows.
//   A 16-channel layer thus packs taps 4 to a stage with no zero padding, and
//   the weights are read in place from the store (chunk c of tap t of row o at
//   (o * taps + t) * I_pad + c): no layout is derived.
// - A 4-stage ring of cp.async copies in dynamic shared memory: the copies of
//   stage k+3 are in flight while the MMAs of stage k run.  Borders (SAME
//   padding, depth taps, the ragged M edge, K past its end) are zero-filled by
//   cp.async's src-size 0, not branches around loads; each row's pixel
//   coordinates are computed once per block tile.  The input's copies are 16
//   bytes where cin and the tensor allow it (.ca: the 9 or 27 taps re-read a
//   pixel from L1), else 8 or 4 bytes with the chunk's tail past cin zeroed
//   the same way, else plain byte loads.
// - Block tiles: BM = 128 rows and BN = 16, 32, 64 or 128 columns, the
//   smallest that holds N (decode6's 16 outputs fill a 16-wide tile); 4
//   warps (8 for BN = 128), with registers capped for 4 blocks an SM (2 for
//   BN = 128): the 64-wide tile drops from 155 registers to 128 and runs
//   ~10% faster.  One tile a block: a persistent form (one ring across
//   several tiles, the next tile's copies under this one's epilogue)
//   measured 7-20% slower.
// - The epilogue converts the int32 sums in registers, stages the int8 tile in
//   shared memory and writes it 16 bytes a thread where the output row allows
//   (else 8, 4, 2 or 1), into any channel range of a wider concat buffer.
//   The input may be a channel range of a wider buffer too (in_stride bytes
//   between pixels): the UNet++ grid's cells read and write one buffer a row.
// What holds them now: the deep layers run at ~23-24% of the dense int8
// peak (the mma.sync rate and the ldmatrix traffic a 64x32 warp tile needs);
// the narrow full-resolution layers (cout 16 or 32, K = 9 or 27 x cin) at
// 8-18% of their byte bound, held by instruction issue: each output costs
// ~20 CUDA-core instructions of epilogue (the IEEE divide among them) beside
// the gather's address work, against only 9 x cin MACs on the tensor cores.
// K9 and K10 are bound by bytes.  Both move 16 bytes a thread where the
// channels allow (K9 with a lookup table for int8 input; K10 a 2x2 window of
// 16-byte loads and a bytewise max), one wave of blocks, 32-bit indices: their
// own sections below.  K10v is one pass, a thread per 16 bytes where the
// channels allow 16-byte loads (else per byte).
//
// Numbers, kept exactly as XLA computes them on the CPU, so a kernel equals
// its plain version (and the JAX graph) bit for bit:
// - the int32 sums are exact in any order (|sum| < 127^2 * 27 * 1024 < 2^31);
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
// - K9's rescale is (x * s_a) / s_b, two roundings, as XLA leaves it; from
//   float input it rounds by an add of 1.5*2^23 (rintf's result below 2^22,
//   and the same clip beyond).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;  // K10, K10v

// --- K7, K8, K7v, K8v: qconv ---------------------------------------------------

constexpr int BK = 64;         // K bytes a stage
constexpr int KCH = BK / 16;   // 16-byte chunks of a row a stage
constexpr int STAGES = 4;      // the cp.async ring

struct QConvArgs {
  const int8_t* x;    // (n, dd, h, wd, cin) in rows of in_stride bytes; 2D: dd = 1
  const int8_t* w;    // conv (cout, taps, cin_pad); transposed (taps, cout, cin_pad)
  const float* sw;    // (cout,)
  const float* bias;  // (cout,)
  int8_t* out;        // rows of out_stride, channels [out_off, out_off + cout)
  int n, dd, h, wd, cin, cin_pad, cout, dil;
  int in_stride;  // bytes between two pixels of x: cin, or more for a channel range
  int in_vec;   // bytes one copy of the input may move: 16, 8, 4, else 1 (byte loads)
  int out_vec;  // bytes one store of the output may write: 16, 8, 4, 2 or 1
  int out_stride, out_off;
  float s_in, s_out;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of rows of BK bytes: the
// 8 rows an ldmatrix phase reads (and 8 consecutive chunks a copy writes) fall
// on 8 distinct groups of 4 banks
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ ((r >> 1) & 3)) << 4); }

// cp.async of V bytes, zero-filled (nothing read) when !valid
template <int V>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
               "r"(valid ? V : 0));
}

__device__ __forceinline__ void cp_async_cg16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// D += A (16x32, row) * B (32x8, col), int8 -> int32
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the epilogue of one sum: dequant (one FMA), bias, LeakyReLU (K7), requant, clip
template <bool LEAKY>
__device__ __forceinline__ int requant_sum(int acc, float scale, float bias, float s_out) {
  float a = __fmaf_rn(__int2float_rn(acc), scale, bias);
  if (LEAKY) a = a >= 0.0f ? a : __fmul_rn(0.1f, a);
  return (int)fminf(fmaxf(rintf(__fdiv_rn(a, s_out)), -127.0f), 127.0f);
}

// One block computes a BM x BN tile of the product; warp (wm, wn) of the
// WARPS_M x WARPS_N grid a (BM / WARPS_M) x (BN / WARPS_N) part of it.
// TCONV: the 2x2 (2x2x2) stride-2 transposed conv; VOL: the input is (n, dd,
// h, wd, C), a batch of n*dd planes of (h, wd), 27 taps (transposed: 8).
template <bool TCONV, bool VOL, int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, MIN_BLOCKS) qconv(const QConvArgs p) {
  constexpr int NTHR = 32 * WARPS_M * WARPS_N;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "a warp takes whole 16x16 ldmatrix tiles");
  constexpr int A_BYTES = BM * BK, STAGE_BYTES = (BM + BN) * BK;
  constexpr int ROW_STEP = NTHR / KCH;  // rows between one thread's copy slots
  constexpr int A_ROWS = BM / ROW_STEP;
  constexpr int B_ROWS = (BN + ROW_STEP - 1) / ROW_STEP;
  constexpr int TAPS = TCONV ? 1 : (VOL ? 27 : 9);  // taps of the reduction
  constexpr int OUT_TAPS = VOL ? 8 : 4;              // TCONV: taps of the output
  constexpr int CS = BN + 16;                        // the staged output's row bytes
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  // pixel indices fit an int (the launch checks M < 2^31): 32-bit divisions
  const int hw = p.h * p.wd;
  const int M = p.n * p.dd * hw;
  const int N = TCONV ? OUT_TAPS * p.cout : p.cout;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int cpt = (p.cin + 15) >> 4;  // 16-byte chunks of a tap
  const int ksteps = (TAPS * cpt + KCH - 1) / KCH;

  // this thread's copy slots: chunk column kc of rows r0 + i * ROW_STEP
  const int kc = tid % KCH, r0 = tid / KCH;
  // each A row's first input byte and pixel coordinates (y far out of range
  // past the last row, so every tap of it reads zeros)
  long long a_off[A_ROWS];
  int a_z[A_ROWS], a_y[A_ROWS], a_x[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + r0 + i * ROW_STEP;
    a_off[i] = 0;
    a_z[i] = a_x[i] = 0;
    a_y[i] = -(1 << 28);
    if (m < M) {
      const int pl = m / hw;  // the plane: n*dd + z (2D: n)
      const int r = m - pl * hw;
      a_y[i] = r / p.wd;
      a_x[i] = r - a_y[i] * p.wd;
      a_z[i] = VOL ? pl % p.dd : 0;
      a_off[i] = (long long)m * p.in_stride;
    }
  }

  // the K position of the next stage this thread copies: tap ld_tap (>= TAPS
  // past the end of K), chunk ld_c of it; stages are copied in order
  int ld_tap = kc / cpt, ld_c = kc - ld_tap * cpt;
  auto load_stage = [&](int slot) {
    uint8_t* As = smem + slot * STAGE_BYTES;
    uint8_t* Bs = As + A_BYTES;
    const int tap = ld_tap, c = ld_c << 4;
    for (ld_c += KCH; ld_c >= cpt; ld_c -= cpt) ++ld_tap;
    int dz = 0, dy = 0, dx = 0;
    if (!TCONV) {
      const int tz = tap / 9, tr = tap - tz * 9;
      dz = VOL ? tz - 1 : 0;
      dy = (tr / 3 - 1) * p.dil;
      dx = (tr % 3 - 1) * p.dil;
    }
    const bool k_in = tap < TAPS;
    const long long shift = (((long long)dz * p.h + dy) * p.wd + dx) * p.in_stride + c;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int y = a_y[i] + dy, xx = a_x[i] + dx;
      bool ok = k_in && (unsigned)y < (unsigned)p.h && (unsigned)xx < (unsigned)p.wd;
      if (VOL) ok = ok && (unsigned)(a_z[i] + dz) < (unsigned)p.dd;
      const int8_t* src = p.x + (ok ? a_off[i] + shift : 0);
      const uint32_t dst = smem_addr(As + swz(r0 + i * ROW_STEP, kc));
      if (p.in_vec == 16) {
        cp_async_ca<16>(dst, src, ok);
      } else if (p.in_vec == 8) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool v = ok && c + 8 * q < p.cin;
          cp_async_ca<8>(dst + 8 * q, v ? src + 8 * q : p.x, v);
        }
      } else if (p.in_vec == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = ok && c + 4 * q < p.cin;
          cp_async_ca<4>(dst + 4 * q, v ? src + 4 * q : p.x, v);
        }
      } else {  // a pixel's channels not 4-byte aligned: byte loads, zero past cin
        uint32_t u[4] = {0u, 0u, 0u, 0u};
        if (ok) {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (c + b < p.cin) u[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(u[0]),
                     "r"(u[1]), "r"(u[2]), "r"(u[3]));
      }
    }
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int q = r0 + i * ROW_STEP;
      if (B_ROWS * ROW_STEP > BN && q >= BN) break;
      const int nn = n0 + q;
      const bool ok = k_in && nn < N;
      const int8_t* src = p.w + (ok ? ((long long)nn * TAPS + tap) * p.cin_pad + c : 0);
      cp_async_cg16(smem_addr(Bs + swz(q, kc)), src, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<STAGES - 2>();  // stage ks has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage ks-1's slot is free
    const int next = ks + STAGES - 1;
    if (next < ksteps) load_stage(next % STAGES);
    cp_async_commit();
    const uint8_t* As = smem + (ks % STAGES) * STAGE_BYTES;
    const uint8_t* Bs = As + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KCH / 2; ++kk) {  // two k32 steps a stage
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        // matrices: rows 0-7 / 8-15 x chunks 2kk / 2kk+1 (a0..a3)
        const int r = wm * WTM + mi * 16 + (lane & 15);
        ldsm_x4(smem_addr(As + swz(r, 2 * kk + (lane >> 4))), af[mi][0], af[mi][1], af[mi][2],
                af[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        // matrices: n 0-7 x chunk 2kk, 2kk+1, then n 8-15 (b0, b1 of two n8 tiles)
        const int r = wn * WTN + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_addr(Bs + swz(r, 2 * kk + ((lane >> 3) & 1))), bf[2 * nj][0],
                bf[2 * nj][1], bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the staged output now

  // epilogue, 1: the int8 results into a BM x BN tile (rows of CS bytes)
  int8_t* Cs = reinterpret_cast<int8_t*>(smem);
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn * WTN + ni * 8 + (lane & 3) * 2;
    float scale[2], bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nn = n0 + col + e;
      const int o = TCONV ? nn % p.cout : nn;
      scale[e] = nn < N ? __fmul_rn(p.s_in, p.sw[o]) : 0.0f;
      bias[e] = nn < N ? p.bias[o] : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * WTM + mi * 16 + (lane >> 2) + 8 * half;
        const int q0 = requant_sum<!TCONV>(acc[mi][ni][2 * half], scale[0], bias[0], p.s_out);
        const int q1 = requant_sum<!TCONV>(acc[mi][ni][2 * half + 1], scale[1], bias[1], p.s_out);
        *reinterpret_cast<uint16_t*>(Cs + r * CS + col) =
            (uint16_t)((uint32_t)(uint8_t)q0 | ((uint32_t)(uint8_t)q1 << 8));
      }
  }
  // TCONV: each row's output pixel of tap 0 (a tap adds a fixed offset)
  long long* row_pix = reinterpret_cast<long long*>(smem + BM * CS);
  if (TCONV) {
    for (int r = tid; r < BM; r += NTHR) {
      const int m = m0 + r;
      const int pl = m / hw;
      const int rr = m - pl * hw;
      const int y = rr / p.wd, xx = rr - y * p.wd;
      if (VOL) {  // plane pl = ni * dd + z -> planes 2z, 2z + 1 of volume ni
        const int ni = pl / p.dd;
        const int z = pl - ni * p.dd;
        row_pix[r] =
            (((long long)ni * 2 * p.dd + 2 * z) * 2 * p.h + 2 * y) * (2LL * p.wd) + 2 * xx;
      } else {
        row_pix[r] = ((long long)pl * 2 * p.h + 2 * y) * (2LL * p.wd) + 2 * xx;
      }
    }
  }
  __syncthreads();

  // epilogue, 2: out_vec bytes a store (a run of one pixel's channels)
  const int V = p.out_vec;
  const int per_row = BN / V, row_shift = 31 - __clz(per_row);  // powers of two
  const long long w2 = 2LL * p.wd, hw4 = 4LL * hw;
  for (int e = tid; e < BM * per_row; e += NTHR) {
    const int r = e >> row_shift, col = (e - (r << row_shift)) * V;
    const int m = m0 + r;
    const int nn = n0 + col;
    if (m >= M || nn >= N) continue;
    long long pix = m;
    int o = nn;
    if (TCONV) {
      const int tap = nn / p.cout;
      o = nn - tap * p.cout;
      pix = row_pix[r] + (VOL ? (tap >> 2) * hw4 + ((tap >> 1) & 1) * w2 + (tap & 1)
                              : (tap >> 1) * w2 + (tap & 1));
    }
    int8_t* dst = p.out + pix * p.out_stride + p.out_off + o;
    const int8_t* src = Cs + r * CS + col;
    if (V == 16) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else if (V == 8) {
      *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
    } else if (V == 4) {
      *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
    } else if (V == 2) {
      *reinterpret_cast<int16_t*>(dst) = *reinterpret_cast<const int16_t*>(src);
    } else {
      *dst = *src;
    }
  }
}

template <bool TCONV, bool VOL, int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
cudaError_t launch_tile(const QConvArgs& a, int M, int N, cudaStream_t st) {
  auto kernel = qconv<TCONV, VOL, BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS>;
  const int smem = STAGES * (BM + BN) * BK;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, st>>>(a);
  return cudaGetLastError();
}

// the block tile: 128 rows x the narrowest of 16, 32, 64, 128 columns that
// holds N (wider N: several blocks across it)
template <bool TCONV, bool VOL>
cudaError_t launch_qconv(const QConvArgs& a, cudaStream_t st) {
  const long long M = (long long)a.n * a.dd * a.h * a.wd;
  const int N = TCONV ? (VOL ? 8 : 4) * a.cout : a.cout;
  if (M == 0 || N == 0) return cudaSuccess;
  if (M + 256 > INT32_MAX) return cudaErrorInvalidValue;  // pixel indices are ints
  if (N <= 16) return launch_tile<TCONV, VOL, 128, 16, 4, 1, 4>(a, M, N, st);
  if (N <= 32) return launch_tile<TCONV, VOL, 128, 32, 4, 1, 4>(a, M, N, st);
  if (N <= 64) return launch_tile<TCONV, VOL, 128, 64, 2, 2, 4>(a, M, N, st);
  return launch_tile<TCONV, VOL, 128, 128, 2, 4, 2>(a, M, N, st);
}

QConvArgs qconv_args(const void* x, const void* w, const void* sw, const void* bias, void* out,
                     int n, int d, int h, int wd, int cin, int cin_pad, int cout, int dil,
                     int in_vec, int out_vec, int out_stride, int out_off, float s_in,
                     float s_out, int in_stride) {
  QConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.sw = static_cast<const float*>(sw);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<int8_t*>(out);
  a.n = n;
  a.dd = d;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.in_stride = in_stride;
  a.cin_pad = cin_pad;
  a.cout = cout;
  a.dil = dil;
  a.in_vec = in_vec;
  a.out_vec = out_vec;
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.s_in = s_in;
  a.s_out = s_out;
  return a;
}

// --- K9: requant -------------------------------------------------------------
//
// x: rows of `in_stride` elements (C of them read) of int8, bf16 or float32 ->
// rows of `out_stride` elements from `out_off` on: int8 rint((x * s_a) / s_b)
// clipped to +-127, or (TO_BF16) the dequant bf16(x * s_a).  Held by bytes
// (one read and one write an element), so the design keeps instruction issue
// under the byte rate:
// - a thread moves VE elements at once (16 where C, both row strides, the
//   offset and both addresses allow it, else 8, 4, 2 or 1: ops/int8.py
//   _vec_width): a 16-byte int8 vector, read as one, two or four 16-byte loads
//   of int8, bf16 or float32;
// - the rows x vectors-per-row space is walked in 32-bit indices (the host
//   launches at most 2^30 vectors at a time), row and column by a
//   multiply-high divide once a vector; only a row's base offset is 64-bit;
// - one wave of blocks over the SMs, each thread keeping U vectors' loads in
//   flight before their stores;
// - int8 input (the skip rescale and every dequant) has 256 possible values:
//   each block first computes all 256 results with the arithmetic below into
//   shared memory, and the body is byte lookups (bit-equal by construction).
//   Every lane reads its own copy of the table (entry u of lane l at word
//   u * 32 + l: one bank a lane), so the lookups never conflict;
// - bf16 and float32 input keep the per-element arithmetic: __fmul_rn, then
//   the IEEE __fdiv_rn (a reciprocal multiply would differ in the last bit),
//   and the rounding and clip as one add and two min/max (rint_clip_bits).

constexpr int K9_THREADS = 256;
constexpr unsigned K9_MAX_VECS = 1u << 30;  // vectors of one launch (32-bit indices)
constexpr float ROUND_MAGIC = 12582912.0f;  // 1.5 * 2^23

// n / d for 0 <= n < 2^31: umulhi(n, m) >> s, m = ceil(2^(31 + ceil(log2 d)) / d)
// (d = 1: m = 0, the quotient is n)
struct FastDiv {
  unsigned d, m, s;
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;
    f.m = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.s = l - 1;
  }
  return f;
}

__device__ __forceinline__ unsigned div_of(unsigned n, const FastDiv& f) {
  return f.m ? __umulhi(n, f.m) >> f.s : n;
}

// rint(v) clipped to [-127, 127] in the low byte of the result: v + 1.5*2^23
// is the integer nearest v (half to even: the ulp there is 1) for |v| < 2^22,
// and an integer k of [-127, 127] is the float 1.5*2^23 + k, bits 0x4B400000 +
// k.  Clipping in that domain also sends every larger |v| and NaN (fmaxf(NaN,
// lo) = lo) where rintf and the clip to +-127 do.
__device__ __forceinline__ uint32_t rint_clip_bits(float v) {
  const float f = fminf(fmaxf(__fadd_rn(v, ROUND_MAGIC), ROUND_MAGIC - 127.0f),
                        ROUND_MAGIC + 127.0f);
  return __float_as_uint(f);
}

// NB bytes at p (NB a power of two; p aligned to min(NB, 16)) as words
template <int NB>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NB == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint8_t*>(p);
  }
}

template <int NB>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                  w[4 * i + 3]);
  } else if constexpr (NB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (NB == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (NB == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
  } else {
    *reinterpret_cast<uint8_t*>(p) = (uint8_t)w[0];
  }
}

struct K9Args {
  const void* x;
  void* out;
  unsigned nv;              // vectors of this launch
  FastDiv vpr;              // vectors a row
  long long in_stride;      // elements between two rows of x
  long long out_stride;     // elements between two rows of out
  int out_off;              // out's first element of a row
  float s_a, s_b;
};

// vectors a thread keeps in flight: 64 bytes of input or more
template <typename T, int VE>
__host__ __device__ constexpr int k9_unroll() {
  return VE * (int)sizeof(T) >= 64 ? 2 : 4;
}

// the result of one element (the table's entries for int8 input): int8 in the
// low byte, or the bf16 bits in the low half
template <bool TO_BF16>
__device__ __forceinline__ uint32_t requant_one(float x, float s_a, float s_b) {
  const float v = __fmul_rn(x, s_a);
  if (TO_BF16) return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  return rint_clip_bits(__fdiv_rn(v, s_b)) & 0xFFu;
}

template <typename T, bool TO_BF16, int VE>
__global__ void __launch_bounds__(K9_THREADS) requant(const K9Args p) {
  constexpr int U = k9_unroll<T, VE>();
  constexpr int NB_IN = VE * (int)sizeof(T), NB_OUT = VE * (TO_BF16 ? 2 : 1);
  constexpr int W_IN = NB_IN >= 4 ? NB_IN / 4 : 1, W_OUT = NB_OUT >= 4 ? NB_OUT / 4 : 1;
  constexpr bool TABLE = sizeof(T) == 1;
  __shared__ uint32_t table[TABLE ? 256 * 32 : 1];
  const int lane = threadIdx.x & 31;
  if constexpr (TABLE) {
    // entry u (the int8 value (int8_t)u), written to the 32 lanes' copies
    // in a rotated order so that a warp's stores hit 32 banks
    const int u = threadIdx.x;
    const uint32_t e = TO_BF16 ? requant_one<true>((float)(int8_t)u, p.s_a, p.s_b)
                               : (uint32_t)(uint8_t)(int8_t)fminf(
                                     fmaxf(rintf(__fdiv_rn(__fmul_rn((float)(int8_t)u, p.s_a),
                                                           p.s_b)),
                                           -127.0f),
                                     127.0f);
#pragma unroll 8
    for (int l = 0; l < 32; ++l) table[u * 32 + ((l + lane) & 31)] = e;
    __syncthreads();
  }
  const unsigned step = gridDim.x * K9_THREADS;
  for (unsigned v0 = blockIdx.x * K9_THREADS + threadIdx.x; v0 < p.nv; v0 += U * step) {
    uint32_t in[U][W_IN];
    long long dst[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned v = v0 + i * step;
      if (v < p.nv) {
        const unsigned r = div_of(v, p.vpr);
        const unsigned c = (v - r * p.vpr.d) * VE;
        load_words<NB_IN>(static_cast<const T*>(p.x) + (r * p.in_stride + c), in[i]);
        dst[i] = r * p.out_stride + p.out_off + c;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (v0 + i * step >= p.nv) break;
      uint32_t o[W_OUT];
#pragma unroll
      for (int j = 0; j < W_OUT; ++j) o[j] = 0u;
#pragma unroll
      for (int k = 0; k < VE; ++k) {
        uint32_t e;
        if constexpr (TABLE) {
          e = table[((in[i][k >> 2] >> (8 * (k & 3))) & 0xFFu) * 32 + lane];
        } else if constexpr (sizeof(T) == 2) {  // bf16: the high half of a float
          e = requant_one<TO_BF16>(__uint_as_float((in[i][k >> 1] >> (16 * (k & 1))) << 16),
                                   p.s_a, p.s_b);
        } else {
          e = requant_one<TO_BF16>(__uint_as_float(in[i][k]), p.s_a, p.s_b);
        }
        if (TO_BF16)
          o[k >> 1] |= e << (16 * (k & 1));
        else
          o[k >> 2] |= e << (8 * (k & 3));
      }
      store_words<NB_OUT>(static_cast<uint8_t*>(p.out) + dst[i] * (TO_BF16 ? 2 : 1), o);
    }
  }
}

constexpr int K9_MAX_DEVICES = 64;

// the blocks of `kernel` the card holds at once (SMs x resident blocks), asked
// of the runtime once per device and kept in `waves` (one array per kernel)
template <typename Kernel>
cudaError_t wave_of(Kernel kernel, int threads, std::atomic<int>* waves, int* wave) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= K9_MAX_DEVICES) return cudaErrorInvalidDevice;
  *wave = waves[dev].load(std::memory_order_relaxed);
  if (*wave == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    *wave = sms * (per_sm > 0 ? per_sm : 1);
    waves[dev].store(*wave, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// one launch per 2^30 vectors, each a wave of blocks over the SMs (or fewer)
template <typename T, bool TO_BF16, int VE>
cudaError_t launch_requant(const void* x, void* out, long long rows, int C, long long in_stride,
                           long long out_stride, int out_off, float s_a, float s_b,
                           cudaStream_t st) {
  auto kernel = requant<T, TO_BF16, VE>;
  constexpr int U = k9_unroll<T, VE>();
  static std::atomic<int> waves[K9_MAX_DEVICES];
  int wave = 0;
  cudaError_t err = wave_of(kernel, K9_THREADS, waves, &wave);
  if (err != cudaSuccess) return err;
  const unsigned vpr = (unsigned)(C / VE);
  const long long rows_per_launch = K9_MAX_VECS / vpr;
  if (rows_per_launch == 0) return cudaErrorInvalidValue;
  const size_t out_bytes = TO_BF16 ? 2 : 1;
  for (long long r0 = 0; r0 < rows; r0 += rows_per_launch) {
    K9Args a;
    a.x = static_cast<const T*>(x) + r0 * in_stride;
    a.out = static_cast<uint8_t*>(out) + r0 * out_stride * out_bytes;
    a.nv = (unsigned)(rows - r0 < rows_per_launch ? rows - r0 : rows_per_launch) * vpr;
    a.vpr = fast_div(vpr);
    a.in_stride = in_stride;
    a.out_stride = out_stride;
    a.out_off = out_off;
    a.s_a = s_a;
    a.s_b = s_b;
    const long long need = ((long long)a.nv + K9_THREADS * U - 1) / (K9_THREADS * U);
    kernel<<<(unsigned)(need < wave ? need : wave), K9_THREADS, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool TO_BF16>
cudaError_t launch_requant_vec(int vec, const void* x, void* out, long long rows, int C,
                               long long in_stride, long long out_stride, int out_off,
                               float s_a, float s_b, cudaStream_t st) {
  switch (vec) {
    case 16:
      return launch_requant<T, TO_BF16, 16>(x, out, rows, C, in_stride, out_stride, out_off,
                                            s_a, s_b, st);
    case 8:
      return launch_requant<T, TO_BF16, 8>(x, out, rows, C, in_stride, out_stride, out_off,
                                           s_a, s_b, st);
    case 4:
      return launch_requant<T, TO_BF16, 4>(x, out, rows, C, in_stride, out_stride, out_off,
                                           s_a, s_b, st);
    case 2:
      return launch_requant<T, TO_BF16, 2>(x, out, rows, C, in_stride, out_stride, out_off,
                                           s_a, s_b, st);
    case 1:
      return launch_requant<T, TO_BF16, 1>(x, out, rows, C, in_stride, out_stride, out_off,
                                           s_a, s_b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_requant_out(int to_bf16, int vec, const void* x, void* out, long long rows,
                               int C, long long in_stride, long long out_stride, int out_off,
                               float s_a, float s_b, cudaStream_t st) {
  return to_bf16 ? launch_requant_vec<T, true>(vec, x, out, rows, C, in_stride, out_stride,
                                               out_off, s_a, s_b, st)
                 : launch_requant_vec<T, false>(vec, x, out, rows, C, in_stride, out_stride,
                                                out_off, s_a, s_b, st);
}

// --- K10: maxpool_i8 -------------------------------------------------------
//
// (n, h, w, C) int8 in pixels of in_stride bytes (a channel range of a wider
// buffer too) -> (n, h/2, w/2, C), odd extents floored.  Held by bytes (each
// input byte read once, each output byte written once), so, as K9:
// - a thread takes VE channels of one output pixel (16 where C, the input's
//   pixel stride and both addresses allow it, else 8, 4, 2 or 1: ops/int8.py
//   _vec_width): the 2x2 window is four VE-byte loads and a bytewise signed
//   max (__vmaxs4), then one VE-byte store;
// - the output-pixels x vectors space is walked in 32-bit indices (at most
//   2^30 vectors a launch), pixel, column and row by multiply-high divides;
//   only the input pixel's byte offset is 64-bit;
// - one wave of blocks over the SMs, each thread keeping U vectors' loads in
//   flight before their maxima and stores.

struct K10Args {
  const int8_t* x;     // the input's first pixel, channel 0 of the range
  int8_t* out;         // this launch's first output pixel
  unsigned nv;         // vectors of this launch
  unsigned r0;         // this launch's first output row (of n * ho rows)
  FastDiv vpp;         // vectors an output pixel (C / VE)
  FastDiv wo;          // output pixels a row
  FastDiv ho;          // output rows an image
  int h, wd;           // input extents
  long long in_stride; // bytes between two input pixels
};

// vectors a thread keeps in flight: two of 8 or 16 bytes (four loads each),
// else four (one, two or four 16-byte vectors in flight time alike on an H100)
template <int VE>
__host__ __device__ constexpr int k10_unroll() {
  return VE >= 8 ? 2 : 4;
}

template <int VE>
__global__ void __launch_bounds__(THREADS) maxpool_i8(const K10Args p) {
  constexpr int U = k10_unroll<VE>();
  constexpr int W = VE >= 4 ? VE / 4 : 1;  // words a vector
  const unsigned step = gridDim.x * THREADS;
  const long long S = p.in_stride, row = (long long)p.wd * S;
  for (unsigned v0 = blockIdx.x * THREADS + threadIdx.x; v0 < p.nv; v0 += U * step) {
    uint32_t in[U][4][W];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned v = v0 + i * step;
      if (v < p.nv) {
        const unsigned px = div_of(v, p.vpp);  // output pixel within the launch
        const unsigned c = (v - px * p.vpp.d) * VE;
        const unsigned rr = div_of(px, p.wo);
        const unsigned xo = px - rr * p.wo.d;
        const unsigned r = p.r0 + rr;  // output row of n * ho
        const unsigned ni = div_of(r, p.ho);
        const unsigned yo = r - ni * p.ho.d;
        const int8_t* src =
            p.x + (((long long)ni * p.h + 2 * yo) * p.wd + 2 * xo) * S + c;
        load_words<VE>(src, in[i][0]);
        load_words<VE>(src + S, in[i][1]);
        load_words<VE>(src + row, in[i][2]);
        load_words<VE>(src + row + S, in[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned v = v0 + i * step;
      if (v >= p.nv) break;
      uint32_t m[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        m[j] = __vmaxs4(__vmaxs4(in[i][0][j], in[i][1][j]), __vmaxs4(in[i][2][j], in[i][3][j]));
      store_words<VE>(p.out + (long long)v * VE, m);
    }
  }
}

// one launch per 2^30 vectors (whole output rows), each a wave of blocks
template <int VE>
cudaError_t launch_maxpool(const void* x, void* out, int n, int h, int wd, int C,
                           long long in_stride, cudaStream_t st) {
  auto kernel = maxpool_i8<VE>;
  static std::atomic<int> waves[K9_MAX_DEVICES];
  int wave = 0;
  cudaError_t err = wave_of(kernel, THREADS, waves, &wave);
  if (err != cudaSuccess) return err;
  const unsigned ho = (unsigned)(h / 2), wo = (unsigned)(wd / 2), vpp = (unsigned)(C / VE);
  const long long rows = (long long)n * ho;
  const long long vpr = (long long)wo * vpp;  // vectors an output row
  const long long rows_per_launch = K9_MAX_VECS / vpr;
  if (rows_per_launch == 0 || rows >= (1ll << 32)) return cudaErrorInvalidValue;
  for (long long r0 = 0; r0 < rows; r0 += rows_per_launch) {
    K10Args a;
    a.x = static_cast<const int8_t*>(x);
    a.out = static_cast<int8_t*>(out) + r0 * wo * C;
    a.nv = (unsigned)((rows - r0 < rows_per_launch ? rows - r0 : rows_per_launch) * vpr);
    a.r0 = (unsigned)r0;
    a.vpp = fast_div(vpp);
    a.wo = fast_div(wo);
    a.ho = fast_div(ho);
    a.h = h;
    a.wd = wd;
    a.in_stride = in_stride;
    constexpr int U = k10_unroll<VE>();
    const long long need = ((long long)a.nv + THREADS * U - 1) / (THREADS * U);
    kernel<<<(unsigned)(need < wave ? need : wave), THREADS, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// in_vec: bytes one copy of the input may move (16, 8 or 4 where cin, the
// input's row stride and its address allow it, else 1); out_vec: bytes one
// store of the output may write (16, 8, 4, 2 or 1 dividing cout, the row
// stride, the channel offset and the address).  K7 reads channels [0, cin) of
// rows of in_stride bytes and writes channels [out_off, out_off + cout) of
// rows of out_stride (the UNet++ grid's row buffers).
int k7_qconv3x3(const void* x, const void* w, const void* sw, const void* bias, void* out, int n,
                int h, int wd, int cin, int cin_pad, int cout, int dil, int in_vec, int out_vec,
                int in_stride, int out_stride, int out_off, float s_in, float s_out,
                void* stream) {
  return (int)launch_qconv<false, false>(
      qconv_args(x, w, sw, bias, out, n, 1, h, wd, cin, cin_pad, cout, dil, in_vec, out_vec,
                 out_stride, out_off, s_in, s_out, in_stride),
      static_cast<cudaStream_t>(stream));
}

int k8_qconvt2x2(const void* x, const void* w, const void* sw, const void* bias, void* out, int n,
                 int h, int wd, int cin, int cin_pad, int cout, int in_vec, int out_vec,
                 int out_stride, int out_off, float s_in, float s_out, void* stream) {
  return (int)launch_qconv<true, false>(
      qconv_args(x, w, sw, bias, out, n, 1, h, wd, cin, cin_pad, cout, 1, in_vec, out_vec,
                 out_stride, out_off, s_in, s_out, cin),
      static_cast<cudaStream_t>(stream));
}

// in_code: 0 int8, 1 bfloat16, 2 float32; in_stride: elements between two
// rows of x (C for a contiguous tensor, more for a channel range of a wider
// one); vec: elements a thread moves at once (16, 8, 4, 2 or 1, dividing C,
// both row strides and the offset, the addresses aligned to min(16, its
// bytes))
int k9_requant(const void* x, int in_code, void* out, long long total, int C, int in_stride,
               int to_bf16, int out_stride, int out_off, int vec, float s_a, float s_b,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total == 0) return 0;
  if (C <= 0 || vec <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  const long long rows = total / C;
  if (in_code == 0)
    return (int)launch_requant_out<int8_t>(to_bf16, vec, x, out, rows, C, in_stride, out_stride,
                                           out_off, s_a, s_b, st);
  if (in_code == 1)
    return (int)launch_requant_out<__nv_bfloat16>(to_bf16, vec, x, out, rows, C, in_stride,
                                                  out_stride, out_off, s_a, s_b, st);
  return (int)launch_requant_out<float>(to_bf16, vec, x, out, rows, C, in_stride, out_stride,
                                        out_off, s_a, s_b, st);
}

// in_stride: bytes between two input pixels (C for a contiguous tensor, more
// for a channel range of a wider one); vec: bytes a thread moves at once (16,
// 8, 4, 2 or 1, dividing C and in_stride, both addresses aligned to it)
int k10_maxpool_i8(const void* x, void* out, int n, int h, int wd, int C, int in_stride, int vec,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)n * (h / 2) * (wd / 2) * C == 0) return 0;
  if (C <= 0 || vec <= 0 || C % vec || in_stride % vec) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 16:
      return (int)launch_maxpool<16>(x, out, n, h, wd, C, in_stride, st);
    case 8:
      return (int)launch_maxpool<8>(x, out, n, h, wd, C, in_stride, st);
    case 4:
      return (int)launch_maxpool<4>(x, out, n, h, wd, C, in_stride, st);
    case 2:
      return (int)launch_maxpool<2>(x, out, n, h, wd, C, in_stride, st);
    case 1:
      return (int)launch_maxpool<1>(x, out, n, h, wd, C, in_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7v: weights (O, 3, 3, 3, I_pad), the activation scales folded in (s_in = 1);
// output channels [out_off, out_off + O) of rows of out_stride
int k7v_qconv3x3x3(const void* x, const void* w, const void* sw, const void* bias, void* out,
                   int n, int d, int h, int wd, int cin, int cin_pad, int cout, int in_vec,
                   int out_vec, int out_stride, int out_off, float s_out, void* stream) {
  return (int)launch_qconv<false, true>(
      qconv_args(x, w, sw, bias, out, n, d, h, wd, cin, cin_pad, cout, 1, in_vec, out_vec,
                 out_stride, out_off, 1.0f, s_out, cin),
      static_cast<cudaStream_t>(stream));
}

// K8v: weights (2, 2, 2, O, I_pad), the input scale folded in
int k8v_qconvt2x2x2(const void* x, const void* w, const void* sw, const void* bias, void* out,
                    int n, int d, int h, int wd, int cin, int cin_pad, int cout, int in_vec,
                    int out_vec, int out_stride, int out_off, float s_out, void* stream) {
  return (int)launch_qconv<true, true>(
      qconv_args(x, w, sw, bias, out, n, d, h, wd, cin, cin_pad, cout, 1, in_vec, out_vec,
                 out_stride, out_off, 1.0f, s_out, cin),
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
