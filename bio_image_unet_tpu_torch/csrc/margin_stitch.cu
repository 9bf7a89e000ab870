// K5: safe-margin weighted stitch of float16 head tiles; K5s: the sum of a
// chunk's real head tiles, for the uncovered-pixel fill; K5v: K5's 3D
// linear-blend form.
//
// K5 replaces bio_image_unet_tpu/ops/stitch.py:163 _stitch_factored_xla with
// the epilogue of predict/predictor.py:1130-1145 (fused path: weighted sum /
// weight sum, float16 out) and its host form ops/stitch.py:138
// _stitch_weighted_xla / :203 _stitch_weighted_frames (float32 out).  The JAX
// program scans the tiles of each frame in grid order n = i*ny + j, adding
// patch*w and w into float32 sum and weight planes with dynamic_update_slice;
// each tile's weight is the outer MIN of per-axis factor rows
// (predict/tiling.py:91 _margin_factors).  Each output pixel sums the tiles
// that cover it, i outer and j inner (the scan's order): w = min(fx[i][r -
// xs[i]], fy[j][q - ys[j]]), acc = acc + tile*w and wsum = wsum + w in
// float32 (__fmul_rn/__fadd_rn, -fmad=false), then acc / wsum rounded as
// IEEE division where wsum > 0, else 0 (the caller writes the fill there:
// the uncovered set depends on the grid and the margin only).
//
// K5v replaces ops/stitch.py:163 _stitch_factored_xla with the 3D factors of
// predict/tiling.py:113 _blend_factors and the epilogue of
// predictor.py:1354-1365 (fused path, float16 out), and the host form
// ops/stitch.py:138 / :204 with fill_mean=False (float32 out).  Each output
// voxel sums its covering tiles in the scan's order (z outer, then x, then
// y) with w = min(fz, fx, fy) and acc = fma(tile, w, acc), wsum = wsum + w:
// XLA contracts the scan's block + patch * w into one fused multiply-add, and
// the blend weights are fractions, so each step rounds as __fmaf_rn does
// (with -fmad=false nothing else is contracted).  acc / wsum where wsum > 0,
// elsewhere 0: the reference writes 0 into uncovered voxels.
//
// What bounds both on the card: bytes.  The least work reads each real tile
// value once and writes each output once (K5's exact grid: 64 tiles x C x
// 512^2 float16 in, 16 x C x 1024^2 out a chunk; K5v's 2 x 9 tiles of 64 x
// 256^2 in PredictMultiOutput3D's grid, starts 0, 230 and 256 an in-plane
// axis, cover every voxel of the (2, 64, 512^2) out once to four times,
// each tile value once).
//
// The design (both kernels share stitch_rows): a block makes a strip of
// K5_STRIP = 256 columns x K5_ROWS = 16 rows of K5_GROUP = 4 output planes of
// one z (frames and channels; K5v: volumes and channels), so the z cover, each
// warp's row cover and every factor are the same for all the block's outputs; a
// thread divides twice, for its block's first plane, and never for an output.
// Before its barrier the block stages in shared memory what the rows of all its
// planes share: the fy rows of the strip's column tiles (up to K5_STAGED) by
// output column, and for each row its (z, row) covers (up to K5_ITEMS), each as
// the tile row's offset from the plane's first tile and min(fz, fx); a strip or
// a row with more covers reads them from device memory.  So a row costs its
// tile loads and no chain of dependent table loads.  A lane owns a run of
// K5_RUN = 8 consecutive outputs of a row, for every tile that covers part of
// the run: it reads the run's 8 tile values with the 16-byte loads that hold
// them, from the aligned 16-byte chunk at or below the first value and, where
// the run crosses into it, the next one, and shifts the pair into place by
// selects and a funnel shift (a tile whose columns start at 230, 6 mod 8, costs
// two aligned loads and a few register moves, not 8 scalar loads).  Only chunks
// that hold a value of the tile's row are read; outputs of the run that the
// tile does not cover are masked out of its sums, so each output sums its own
// covering tiles in the scan's order and no other. The run is written with one
// 16-byte store (float16) or two (float32) where the address allows, narrower
// stores where it does not.  Indices are 32-bit within a tile and a plane,
// bases 64-bit; the C entry launches again past 65535 plane groups.
//
// The division: where wsum is a power of two (K5's binary weights give 1, 2
// or 4; K5v's interior 1, 2, 4 or 8), acc times its reciprocal, which is
// exact, is the IEEE quotient; elsewhere div_rn gives the IEEE quotient from
// a hardware reciprocal estimate, one Newton step in float64 and an exact
// residual, without the slow-path call of __fdiv_rn (a call saves registers
// to local memory).
//
// K5s replaces the jnp.mean fill of predictor.py:1133 / ops/stitch.py:208.
// The JAX program runs the whole movie at once and averages every real head
// tile; the port runs 16-frame chunks, so each chunk adds the sum of its real
// tiles (not the tail chunk's repeated frames, not the batch padding) into a
// float64 total and the mean is taken after the last chunk.  What bounds it:
// bytes (it reads the real tiles once: 33.5 MB for one channel of a chunk,
// 0.010 ms at 3.35 TB/s), and a reduction of one value a load keeps few of
// them in flight.  The design (tile_sum<LOADS>, one launch):
// - Wide loads, many in flight: a thread issues K5S_LOADS = 4 16-byte loads
//   (8 values each) before it adds any, in about four 256-thread blocks an SM
//   (>= 8 MB in flight across the card).  The head before the first 16-byte
//   boundary and the ragged tail (each under 8 values) go to a lane each of
//   the first threads (ops/stitch.py _k5s_geometry lays it out).
// - Exact in any order, cheap per value: a float16 value times 2^24 is an
//   integer below 2^40 with 11 significant bits.  Two float32 fused
//   multiply-adds and a subtraction split it exactly into a multiple of 2^20
//   and a remainder below 2^19, and float32 sums of 8 of each are exact; the
//   thread adds them into a float64 sum (exact: at most 4096 values a thread,
//   below 2^52), two conversions a vector in place of one a value (64-bit
//   conversions issue at a quarter of the float32 rate).  The threads' sums
//   meet in a fixed order (a butterfly a warp, the warps in order, the blocks
//   by a fixed share a thread), so the result is the exact sum wherever the
//   float64 sum is exact, bit-equal to tiles[:n].double().sum().
// - A non-finite value makes its vector's float32 sums non-finite; the vector
//   then adds flags (NaN, +inf, -inf) in place of its sum, and the result is
//   what IEEE addition gives: NaN, +inf or -inf.
// - One launch: the last block to arrive (an arrival count in per-stream
//   scratch, zero at rest and reset by that block, as K1's) adds the blocks'
//   partials in a fixed order; a second launch for them costs a few us.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K5_RUN = 8;                  // outputs a lane, consecutive columns
constexpr int K5_WARPS = 8;
constexpr int K5_THREADS = 32 * K5_WARPS;
constexpr int K5_STRIP = 32 * K5_RUN;      // columns a block
constexpr int K5_ROWS = 16;                // rows a block, K5_ROWS / K5_WARPS a warp
constexpr int K5_GROUP = 4;                // planes a block (of one z)
constexpr int K5_STAGED = 4;               // column tiles whose fy rows a block stages
constexpr int K5_ITEMS = 4;                // (z, row) covers a row the block stages
constexpr int K5_MAX_GROUPS = 65535;       // plane groups a launch (gridDim.z)
// resident blocks an SM the kernels are built for: at most 64 registers a
// thread (K5v needs 61 then, 75 when left free: the loads in flight of a
// fourth block are worth more than the registers)
constexpr int K5_BLOCKS_PER_SM = 4;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a / b rounded to the nearest float32, as IEEE division (__fdiv_rn) rounds
// it, for b > 0 normal and a / b normal or 0 (every stitch: wsum >= 1/margin
// where it is positive, acc 0 or at least 2^-24 * 2^-40 in magnitude); a
// non-finite a gives a non-finite quotient.  One Newton step in float64 from
// the hardware estimate (relative error below 2^-21) leaves y within 2^-41
// of 1/b, so q, the float nearest |a| * y, is the rounded quotient or a
// neighbour of it.  The residual r = |a| - b q is exact in float64 (b q has
// at most 48 significant bits, and |a| lies within a few ulps of it), and so
// are the half-gaps to q's neighbours times b (powers of two times b): q
// moves to the neighbour on whose side of the midpoint |a| / b lies.  A
// quotient of two floats is never a midpoint between floats (an odd 25-bit
// significand times b has more than 24 bits), so no tie arises.
__device__ __forceinline__ float div_rn(float a, float b) {
  const double m = fabs((double)a), bd = b;
  double y = rcp_approx(b);
  y = y * (2.0 - bd * y);
  float q = __double2float_rn(m * y);
  const double r = m - bd * (double)q;
  const float up = __uint_as_float(__float_as_uint(q) + 1u);
  const float dn = __uint_as_float(__float_as_uint(q) - 1u);
  if (r > bd * (0.5 * ((double)up - (double)q)))
    q = up;
  else if (-r > bd * (0.5 * ((double)q - (double)dn)))
    q = dn;
  return copysignf(q, a);
}

// acc / wsum for wsum > 0, rounded as IEEE division: a power of two (no
// mantissa bits) divides as a multiply by its exact reciprocal
__device__ __forceinline__ float quotient(float acc, float wsum) {
  const uint32_t b = __float_as_uint(wsum);
  if ((b & 0x7FFFFFu) == 0) return __fmul_rn(acc, __uint_as_float(0x7F000000u - b));
  return div_rn(acc, wsum);
}

__device__ __forceinline__ float half_lo(uint32_t v) {
  return __half2float(__ushort_as_half((unsigned short)(v & 0xFFFFu)));
}
__device__ __forceinline__ float half_hi(uint32_t v) {
  return __half2float(__ushort_as_half((unsigned short)(v >> 16)));
}

// the 8 float16 values at byte address a (2-byte aligned, 8 values on), of
// which those in [e0, e1) are read: the aligned 16-byte chunk at or below a
// and the next one, each only where it holds one of them, shifted by
// (a mod 16) / 2 values into v; the others are left undefined
__device__ __forceinline__ void load_run(uintptr_t a, int e0, int e1, float* v) {
  const uintptr_t lo = a & ~(uintptr_t)15;
  const int sh = (int)(a - lo) >> 1;
  uint4 A = make_uint4(0u, 0u, 0u, 0u), B = make_uint4(0u, 0u, 0u, 0u);
  if (sh + e0 < 8) A = __ldg(reinterpret_cast<const uint4*>(lo));
  if (sh + e1 > 8) B = __ldg(reinterpret_cast<const uint4*>(lo + 16));
  // words sh / 2 .. sh / 2 + 4 of the 8 by two select stages, then a half
  // word where sh is odd
  const bool s2 = sh & 4, s1 = sh & 2;
  const uint32_t t0 = s2 ? A.z : A.x, t1 = s2 ? A.w : A.y, t2 = s2 ? B.x : A.z,
                 t3 = s2 ? B.y : A.w, t4 = s2 ? B.z : B.x, t5 = s2 ? B.w : B.y;
  uint32_t u[5] = {s1 ? t1 : t0, s1 ? t2 : t1, s1 ? t3 : t2, s1 ? t4 : t3, s1 ? t5 : t4};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = (sh & 1) ? __funnelshift_r(u[k], u[k + 1], 16) : u[k];
    v[2 * k] = half_lo(x);
    v[2 * k + 1] = half_hi(x);
  }
}

// the first n (1..8) of a run's outputs, vector-wide where n = 8 and the
// address allows
__device__ __forceinline__ void store_run(__half* p, const float* v, int n) {
  if (n == K5_RUN) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__half_as_ushort(__float2half_rn(v[2 * k])) |
             ((uint32_t)__half_as_ushort(__float2half_rn(v[2 * k + 1])) << 16);
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
    if ((a & 7) == 0) {
      reinterpret_cast<uint2*>(p)[0] = make_uint2(w[0], w[1]);
      reinterpret_cast<uint2*>(p)[1] = make_uint2(w[2], w[3]);
      return;
    }
    if ((a & 3) == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) reinterpret_cast<uint32_t*>(p)[k] = w[k];
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < K5_RUN; ++e)
    if (e < n) p[e] = __float2half_rn(v[e]);
}

__device__ __forceinline__ void store_run(float* p, const float* v, int n) {
  if (n == K5_RUN) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
      return;
    }
    if ((a & 7) == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<float2*>(p)[k] = make_float2(v[2 * k], v[2 * k + 1]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < K5_RUN; ++e)
    if (e < n) p[e] = v[e];
}

// a run's sums over one covering tile row (z and row cover fixed, weight
// min(fz, fx) = wzx): each column tile jlo .. jhi - 1 of the run, in order,
// the outputs it does not cover masked out
template <bool VOL>
__device__ __forceinline__ void add_tile_row(const __half* trow, float wzx, int q0, int qq0,
                                             int n, int jlo, int jhi, int J0, bool staged,
                                             int ty, size_t tile_c, const int* __restrict__ ys,
                                             const float* __restrict__ fy, const int* s_ys,
                                             const float* s_fy, float* acc, float* wsum) {
  for (int j = jlo; j < jhi; ++j) {
    const int o = q0 - (staged ? s_ys[j - J0] : ys[j]);
    const int e0 = max(0, -o), e1 = min(n, ty - o);
    float v[K5_RUN], f[K5_RUN];
    load_run(reinterpret_cast<uintptr_t>(trow + (size_t)j * tile_c) + 2 * (intptr_t)o, e0, e1,
             v);
    if (staged) {
      const float4* sf = reinterpret_cast<const float4*>(s_fy + (j - J0) * K5_STRIP + qq0);
      const float4 a = sf[0], b = sf[1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < K5_RUN; ++e)
        f[e] = e >= e0 && e < e1 ? fy[(size_t)j * ty + o + e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < K5_RUN; ++e) {
      if (e >= e0 && e < e1) {
        const float wt = fminf(wzx, f[e]);
        acc[e] = VOL ? __fmaf_rn(v[e], wt, acc[e]) : __fadd_rn(acc[e], __fmul_rn(v[e], wt));
        wsum[e] = __fadd_rn(wsum[e], wt);
      }
    }
  }
}

// K5 (VOL = false; d = tz = nz = 1, no z tables) and K5v (VOL = true).
// tiles: (n_vc / C * nz * nx * ny, C, tz, tx, ty) float16 in grid order;
// out: n_vc * d planes of (h, w), plane (volume * C + channel) * d + z.  A
// block makes rows [blockIdx.y * K5_ROWS, + K5_ROWS) x columns
// [blockIdx.x * K5_STRIP, + K5_STRIP) of K5_GROUP planes of one z: group
// g = group0 + blockIdx.z is z = g mod d and volume-channels
// [g / d * K5_GROUP, + K5_GROUP), so what the block stages serves them all
template <bool VOL, typename O>
__device__ __forceinline__ void stitch_rows(
    const __half* __restrict__ tiles, int n_vc, int C, int d, int h, int w, int tz, int tx,
    int ty, int nz, int nx, int ny, const int* __restrict__ zs, const int* __restrict__ xs,
    const int* __restrict__ ys, const int* __restrict__ z_lo, const int* __restrict__ z_hi,
    const int* __restrict__ row_lo, const int* __restrict__ row_hi,
    const int* __restrict__ col_lo, const int* __restrict__ col_hi,
    const float* __restrict__ fz, const float* __restrict__ fx, const float* __restrict__ fy,
    int group0, O* __restrict__ out) {
  // the fy rows of the strip's column tiles J0 .. J1 - 1 by output column
  // (0 where a tile does not cover the column), and their starts
  __shared__ __align__(16) float s_fy[K5_STAGED][K5_STRIP];
  __shared__ int s_ys[K5_STAGED];
  // each row's (z, row) covers, z outer: the tile row's offset from the
  // plane's first tile and min(fz, fx)
  __shared__ long long s_off[K5_ROWS][K5_ITEMS];
  __shared__ float s_w[K5_ROWS][K5_ITEMS];
  __shared__ int s_items[K5_ROWS];
  const int q_strip = blockIdx.x * K5_STRIP, q_end = min(q_strip + K5_STRIP, w);
  const int r_band = blockIdx.y * K5_ROWS;
  const int g = group0 + blockIdx.z;
  const int vcg = VOL ? g / d : g, z = VOL ? g - vcg * d : 0;
  const int vc0 = vcg * K5_GROUP, vc1 = min(vc0 + K5_GROUP, n_vc);
  const size_t tile = (size_t)tz * tx * ty, tile_c = tile * C;
  const int k0 = VOL ? z_lo[z] : 0, k1 = VOL ? z_hi[z] : 1;

  const int J0 = col_lo[q_strip], J1 = col_hi[q_end - 1];
  const bool staged = J1 - J0 <= K5_STAGED;
  if (staged) {
    for (int k = threadIdx.x; k < K5_STAGED * K5_STRIP; k += K5_THREADS) {
      const int jj = k / K5_STRIP, qq = k % K5_STRIP;
      const int j = J0 + jj, q = q_strip + qq;
      float f = 0.0f;
      if (j < J1 && q < q_end) {
        const int o = q - ys[j];
        if (o >= 0 && o < ty) f = fy[(size_t)j * ty + o];
      }
      s_fy[jj][qq] = f;
      if (qq == 0) s_ys[jj] = j < J1 ? ys[j] : 0;
    }
  }
  bool over = false;
  if (threadIdx.x < K5_ROWS) {
    const int rr = threadIdx.x, r = r_band + rr;
    int items = 0;
    if (r < h) {
      const int i0 = row_lo[r], i1 = row_hi[r];
      items = (k1 - k0) * (i1 - i0);
      if (items <= K5_ITEMS) {
        int m = 0;
        for (int k = k0; k < k1; ++k) {
          const int tzo = VOL ? z - zs[k] : 0;
          const float wz = VOL ? fz[(size_t)k * tz + tzo] : 1.0f;
          for (int i = i0; i < i1; ++i, ++m) {
            const int txo = r - xs[i];
            const float wx = fx[(size_t)i * tx + txo];
            s_off[rr][m] = (long long)((k * nx + i) * ny) * (long long)tile_c +
                           (long long)(tzo * tx + txo) * ty;
            s_w[rr][m] = VOL ? fminf(wz, wx) : wx;
          }
        }
      }
    }
    s_items[rr] = items;
    over = items > K5_ITEMS;
  }
  // rows with more covers than K5_ITEMS read them from device memory
  const bool listed = !__syncthreads_or(over);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qq0 = lane * K5_RUN, q0 = q_strip + qq0;
  if (q0 >= w) return;
  const int n = min(K5_RUN, w - q0);
  const int jlo = col_lo[q0], jhi = col_hi[q0 + n - 1];
  // the first plane's tiles (volume vc0 / C, channel vc0 mod C); a volume's
  // channels lie a tile apart, and channel C - 1's next is the next volume's
  // channel 0, a volume's tiles less C - 1 tiles on
  const int vol0 = vc0 / C;
  int c = vc0 - vol0 * C;
  const __half* vbase = tiles + (size_t)vol0 * nz * nx * ny * tile_c + (size_t)c * tile;
  const size_t next_vol = (size_t)nz * nx * ny * tile_c - (size_t)(C - 1) * tile;
  for (int vc = vc0; vc < vc1; ++vc) {
    O* oplane = out + ((size_t)vc * d + z) * h * w;
    for (int rr = warp; rr < K5_ROWS && r_band + rr < h; rr += K5_WARPS) {
      const int r = r_band + rr;
      float acc[K5_RUN], wsum[K5_RUN];
#pragma unroll
      for (int e = 0; e < K5_RUN; ++e) acc[e] = wsum[e] = 0.0f;
      if (listed) {
        for (int m = 0; m < s_items[rr]; ++m)
          add_tile_row<VOL>(vbase + s_off[rr][m], s_w[rr][m], q0, qq0, n, jlo, jhi, J0, staged,
                            ty, tile_c, ys, fy, s_ys, &s_fy[0][0], acc, wsum);
      } else {
        for (int k = k0; k < k1; ++k) {
          const int tzo = VOL ? z - zs[k] : 0;
          const float wz = VOL ? fz[(size_t)k * tz + tzo] : 1.0f;
          for (int i = row_lo[r]; i < row_hi[r]; ++i) {
            const int txo = r - xs[i];
            const float wx = fx[(size_t)i * tx + txo];
            add_tile_row<VOL>(vbase + (size_t)((k * nx + i) * ny) * tile_c +
                                  (size_t)(tzo * tx + txo) * ty,
                              VOL ? fminf(wz, wx) : wx, q0, qq0, n, jlo, jhi, J0, staged, ty,
                              tile_c, ys, fy, s_ys, &s_fy[0][0], acc, wsum);
          }
        }
      }
      float res[K5_RUN];
#pragma unroll
      for (int e = 0; e < K5_RUN; ++e)
        res[e] = wsum[e] > 0.0f ? quotient(acc[e], wsum[e]) : 0.0f;
      store_run(oplane + (size_t)r * w + q0, res, n);
    }
    vbase += ++c < C ? tile : next_vol;
    if (c == C) c = 0;
  }
}

template <typename O>
__global__ void __launch_bounds__(K5_THREADS, K5_BLOCKS_PER_SM)
margin_stitch(const __half* __restrict__ tiles, int C, int h, int w, int th, int tw, int nx,
              int ny, const int* __restrict__ xs, const int* __restrict__ ys,
              const int* __restrict__ row_lo, const int* __restrict__ row_hi,
              const int* __restrict__ col_lo, const int* __restrict__ col_hi,
              const float* __restrict__ fx, const float* __restrict__ fy, int n_vc,
              int group0, O* __restrict__ out) {
  stitch_rows<false, O>(tiles, n_vc, C, 1, h, w, 1, th, tw, 1, nx, ny, nullptr, xs, ys, nullptr,
                        nullptr, row_lo, row_hi, col_lo, col_hi, nullptr, fx, fy, group0, out);
}

template <typename O>
__global__ void __launch_bounds__(K5_THREADS, K5_BLOCKS_PER_SM)
blend_stitch_3d(const __half* __restrict__ tiles, int C, int d, int h, int w, int tz, int tx,
                int ty, int nz, int nx, int ny, const int* __restrict__ zs,
                const int* __restrict__ xs, const int* __restrict__ ys,
                const int* __restrict__ z_lo, const int* __restrict__ z_hi,
                const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                const int* __restrict__ col_lo, const int* __restrict__ col_hi,
                const float* __restrict__ fz, const float* __restrict__ fx,
                const float* __restrict__ fy, int n_vc, int group0, O* __restrict__ out) {
  stitch_rows<true, O>(tiles, n_vc, C, d, h, w, tz, tx, ty, nz, nx, ny, zs, xs, ys, z_lo, z_hi,
                       row_lo, row_hi, col_lo, col_hi, fz, fx, fy, group0, out);
}

// the blocks of n_vc * d output planes of (h, w): grid.y row bands and, in
// launches of at most K5_MAX_GROUPS, grid.z plane groups; false where the
// rows need more than one launch can address
inline bool stitch_grid(long long n_vc, int d, int h, long long* bands, long long* groups) {
  *bands = (h + K5_ROWS - 1) / K5_ROWS;
  *groups = (long long)d * ((n_vc + K5_GROUP - 1) / K5_GROUP);
  return *bands <= 65535 && n_vc * d <= 0x7FFFFFFFLL;
}

// K5s: one launch, K5S_THREADS threads a block and `blocks` blocks (the
// wrapper's _k5s_geometry); a thread sums the 16-byte vectors k, k + stride,
// ... of the aligned body (stride = the launch's thread count), K5S_LOADS
// loads in flight, and at most one value of the unaligned head and one of the
// ragged tail.
constexpr int K5S_THREADS = 256;
constexpr int K5S_LOADS = 4;            // 16-byte loads in flight a thread
constexpr int K5S_MAX_VECTORS = 511;    // vectors a thread: 8 * 511 + 2 values < 4096
constexpr int K5S_NAN = 1, K5S_POS_INF = 2, K5S_NEG_INF = 4;  // non-finite values met
constexpr float K5S_C = 0x1.8p43f;      // C + X lies in [2^43, 2^44): ulp 2^20

// the flag of a float16 pattern (bits) with exponent 31, else 0
__device__ __forceinline__ int special_of(uint32_t bits) {
  if ((bits & 0x7C00u) != 0x7C00u) return 0;
  return (bits & 0x3FFu) ? K5S_NAN : ((bits & 0x8000u) ? K5S_NEG_INF : K5S_POS_INF);
}

__device__ __forceinline__ float2 halves(uint32_t u) {
  __half2_raw r;
  r.x = (unsigned short)(u & 0xFFFFu);
  r.y = (unsigned short)(u >> 16);
  return __half22float2(__half2(r));
}

// X = v * 2^24 (exact: an integer, |X| < 2^40, 11 significant bits) split
// exactly into h = X rounded to a multiple of 2^20 and l = X - h (|l| <=
// 2^19), added into float32 sums that stay exact over 8 values (|hs| <=
// 2^43 in units of 2^20, |ls| <= 2^22)
__device__ __forceinline__ void split_add(float v, float& hs, float& ls) {
  const float h = __fsub_rn(__fmaf_rn(v, 0x1p24f, K5S_C), K5S_C);
  ls = __fadd_rn(ls, __fmaf_rn(v, 0x1p24f, -h));
  hs = __fadd_rn(hs, h);
}

// 8 values into the thread's sum s (units of 2^-24, exact below 2^53); a
// vector that holds a non-finite value adds its flags instead (its float32
// sums are then not finite: finite values keep them below 2^45)
__device__ __forceinline__ void add_vector(const uint4& w, double& s, int& flags) {
  float hs = 0.0f, ls = 0.0f;
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = halves(u[i]);
    split_add(f.x, hs, ls);
    split_add(f.y, hs, ls);
  }
  if (fabsf(__fadd_rn(hs, ls)) <= 0x1p64f) {
    s += (double)hs;
    s += (double)ls;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) flags |= special_of(u[i] & 0xFFFFu) | special_of(u[i] >> 16);
  }
}

__device__ __forceinline__ void add_single(__half x, double& s, int& flags) {
  const int sp = special_of(__half_as_ushort(x));
  if (sp) {
    flags |= sp;
    return;
  }
  float hs = 0.0f, ls = 0.0f;
  split_add(__half2float(x), hs, ls);
  s += (double)hs;
  s += (double)ls;
}

// the block's sum and flags in thread 0, in a fixed order: a butterfly in
// each warp (every lane adds the same two values), then the warps in order
__device__ __forceinline__ void block_total(double& s, int& flags, double* ws, int* wf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  flags = __reduce_or_sync(0xFFFFFFFFu, (unsigned)flags);
  if ((threadIdx.x & 31) == 0) {
    ws[threadIdx.x >> 5] = s;
    wf[threadIdx.x >> 5] = flags;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = ws[0];
    flags = wf[0];
#pragma unroll
    for (int k = 1; k < K5S_THREADS / 32; ++k) {
      s += ws[k];
      flags |= wf[k];
    }
  }
}

// scratch[0]: the blocks arrived (zero at rest; the last block resets it);
// scratch[1 + b]: block b's flags; partials[b]: block b's sum
template <int LOADS>
__global__ void __launch_bounds__(K5S_THREADS, 4)
tile_sum(const __half* __restrict__ x, int head, long long n_vec, int tail,
         double* __restrict__ partials, int* __restrict__ scratch, double* __restrict__ out) {
  __shared__ double ws[K5S_THREADS / 32];
  __shared__ int wf[K5S_THREADS / 32];
  __shared__ int last;
  const uint4* vec = reinterpret_cast<const uint4*>(x + head);
  const long long stride = (long long)gridDim.x * K5S_THREADS;
  const long long g = (long long)blockIdx.x * K5S_THREADS + threadIdx.x;
  double s = 0.0;
  int flags = 0;
  for (long long k = g; k < n_vec; k += LOADS * stride) {
    uint4 w[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      w[u] = k + u * stride < n_vec ? __ldg(vec + k + u * stride) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < LOADS; ++u) add_vector(w[u], s, flags);
  }
  if (g < head) add_single(x[g], s, flags);
  if (g < tail) add_single(x[head + 8 * n_vec + g], s, flags);
  block_total(s, flags, ws, wf);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    scratch[1 + blockIdx.x] = flags;
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block adds the partials, each thread a fixed share, L1 bypassed
  __threadfence();
  s = 0.0;
  flags = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += K5S_THREADS) {
    s += __ldcg(partials + b);
    flags |= __ldcg(scratch + 1 + b);
  }
  block_total(s, flags, ws, wf);
  if (threadIdx.x == 0) {
    scratch[0] = 0;
    const double inf = __longlong_as_double(0x7FF0000000000000LL);
    if (flags & K5S_NAN || (flags & K5S_POS_INF && flags & K5S_NEG_INF))
      out[0] = __longlong_as_double(0x7FF8000000000000LL);
    else if (flags)
      out[0] = flags & K5S_POS_INF ? inf : -inf;
    else
      out[0] = s * 0x1p-24;
  }
}

extern "C" {

// tiles: (>= n_frames*nx*ny, C, th, tw) float16 (any float16 offset),
// frame-major grid order; xs (nx,), ys (ny,) int32 tile starts; row_lo/row_hi
// (h,), col_lo/col_hi (w,) int32 ranges of the tiles covering each row /
// column; fx (nx, th), fy (ny, tw) float32 factor tables; out is (n_frames,
// C, h, w) float16 (out_f32 = 0) or float32 (1).  One launch for each
// K5_MAX_GROUPS plane groups.
int k5_margin_stitch(const void* tiles, int n_frames, int C, int h, int w, int th, int tw,
                     int nx, int ny, const void* xs, const void* ys, const void* row_lo,
                     const void* row_hi, const void* col_lo, const void* col_hi,
                     const void* fx, const void* fy, int out_f32, void* out, void* stream) {
  const long long n_vc = (long long)n_frames * C;
  long long bands, groups;
  if (n_vc * h * w == 0) return (int)cudaSuccess;
  if (!stitch_grid(n_vc, 1, h, &bands, &groups)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < groups; g0 += K5_MAX_GROUPS) {
    const dim3 grid((unsigned)((w + K5_STRIP - 1) / K5_STRIP), (unsigned)bands,
                    (unsigned)(groups - g0 < K5_MAX_GROUPS ? groups - g0 : K5_MAX_GROUPS));
    if (out_f32)
      margin_stitch<float><<<grid, K5_THREADS, 0, s>>>(
          (const __half*)tiles, C, h, w, th, tw, nx, ny, (const int*)xs, (const int*)ys,
          (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
          (const float*)fx, (const float*)fy, (int)n_vc, (int)g0, (float*)out);
    else
      margin_stitch<__half><<<grid, K5_THREADS, 0, s>>>(
          (const __half*)tiles, C, h, w, th, tw, nx, ny, (const int*)xs, (const int*)ys,
          (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
          (const float*)fx, (const float*)fy, (int)n_vc, (int)g0, (__half*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// x: head + 8 * n_vec + tail float16 values, x + head 16-byte aligned where
// n_vec > 0 (ops/stitch.py _k5s_geometry); partials: blocks float64;
// scratch: 1 + blocks int32, scratch[0] zero at rest; out: one float64, the
// sum.  One launch.
int k5s_tile_sum(const void* x, int head, long long n_vec, int tail, int blocks,
                 void* partials, void* scratch, void* out, void* stream) {
  if (blocks < 1 || head < 0 || head > 7 || tail < 0 || tail > 7 || n_vec < 0 ||
      (n_vec > 0 && ((reinterpret_cast<uintptr_t>(x) + 2 * head) & 15)) ||
      (n_vec + (long long)blocks * K5S_THREADS - 1) / ((long long)blocks * K5S_THREADS) >
          K5S_MAX_VECTORS)
    return (int)cudaErrorInvalidValue;
  tile_sum<K5S_LOADS><<<blocks, K5S_THREADS, 0, (cudaStream_t)stream>>>(
      (const __half*)x, head, n_vec, tail, (double*)partials, (int*)scratch, (double*)out);
  return (int)cudaGetLastError();
}

// K5v: tiles (>= n_vols*nz*nx*ny, C, tz, tx, ty) float16 (any float16
// offset), volume-major z/x/y grid order; zs, xs, ys int32 tile starts;
// z_lo/z_hi (d,), row_lo/row_hi (h,), col_lo/col_hi (w,) int32 cover ranges;
// fz (nz, tz), fx (nx, tx), fy (ny, ty) float32 factor tables; out is
// (n_vols, C, d, h, w) float16 (out_f32 = 0) or float32 (1).  One launch for
// each K5_MAX_GROUPS plane groups.
int k5v_blend_stitch_3d(const void* tiles, int n_vols, int C, int d, int h, int w, int tz,
                        int tx, int ty, int nz, int nx, int ny, const void* zs, const void* xs,
                        const void* ys, const void* z_lo, const void* z_hi,
                        const void* row_lo, const void* row_hi, const void* col_lo,
                        const void* col_hi, const void* fz, const void* fx, const void* fy,
                        int out_f32, void* out, void* stream) {
  const long long n_vc = (long long)n_vols * C;
  long long bands, groups;
  if (n_vc * d * h * w == 0) return (int)cudaSuccess;
  if (!stitch_grid(n_vc, d, h, &bands, &groups)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (long long g0 = 0; g0 < groups; g0 += K5_MAX_GROUPS) {
    const dim3 grid((unsigned)((w + K5_STRIP - 1) / K5_STRIP), (unsigned)bands,
                    (unsigned)(groups - g0 < K5_MAX_GROUPS ? groups - g0 : K5_MAX_GROUPS));
    if (out_f32)
      blend_stitch_3d<float><<<grid, K5_THREADS, 0, s>>>(
          (const __half*)tiles, C, d, h, w, tz, tx, ty, nz, nx, ny, (const int*)zs,
          (const int*)xs, (const int*)ys, (const int*)z_lo, (const int*)z_hi,
          (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
          (const float*)fz, (const float*)fx, (const float*)fy, (int)n_vc, (int)g0,
          (float*)out);
    else
      blend_stitch_3d<__half><<<grid, K5_THREADS, 0, s>>>(
          (const __half*)tiles, C, d, h, w, tz, tx, ty, nz, nx, ny, (const int*)zs,
          (const int*)xs, (const int*)ys, (const int*)z_lo, (const int*)z_hi,
          (const int*)row_lo, (const int*)row_hi, (const int*)col_lo, (const int*)col_hi,
          (const float*)fz, (const float*)fx, (const float*)fy, (int)n_vc, (int)g0,
          (__half*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
