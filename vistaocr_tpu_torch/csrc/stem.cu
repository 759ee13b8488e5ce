// Fused input stem: preprocess + the first 3x3 convolution (C_in = 1), and
// the gradient of its kernel.
//
// Replaces experiments/stem_pallas.py::_stem_kernel (K7a, vo_stem_fwd) and
// ::_dk_kernel (K7b, vo_stem_dk).
//
// What K7a computes, per image b of uint8 images [B, H, W] with width w_b:
//   x      = (255 - img) / 255,  zeroed at columns >= w_b
//   (standardize) n = max(w_b * H, 1);  mean = sum(x) / n;
//          var = sum((x - mean)^2 * mask) / n   (as :58-61);
//          x = (x - mean) * rsqrt(var + 1e-6) * mask
//   xn[b]  = x rounded to T                                  [B, H, W]
//   out[b, co] = SAME 3x3 cross-correlation of the UNROUNDED f32 x with
//          kernel[co] (f32), rounded once to T                [B, CO, H, W]
// and K7b, from the stored (rounded) xn and dout [B, CO, H, W] in T:
//   dk[co][dh][dw] = sum_{b,h,w} dout[b,co,h,w] * pad(xn)[b, h+dh, w+dw]  (f32)
// T is float or bf16. kernel and dk are [CO, 1, 3, 3] (OIHW) float32.
//
// What bounds it on an H100: bytes. The forward reads 1 byte per pixel and
// writes CO outputs per pixel (268 MB in bf16 at B=32, W=2048, CO=64:
// about 80 us at 3.35 TB/s); its 9 * CO f32 FMAs per pixel (1.2 GFMA at
// that shape, about 40 us of the SMs' issue) fit under that. dK reads the
// same 268 MB of dout and reduces 2^21 positions into 9 * CO sums.
//
// What this design does about it:
// - Statistics that fill the card (stem_moments): one CTA per 4 KB of an
//   image, a 16-byte load a thread, the masked sums of x and x^2 in double
//   (each square exact, the sums good to about 2^-40 of themselves) in a
//   fixed order, one pair per CTA. The conv's CTAs add their image's pairs
//   in a fixed order: mean = sum(x) / n, and the two-pass sum
//   sum((x - mean)^2 * mask) = sum(x^2) - 2 mean sum(x) + c mean^2 (c the
//   masked pixels, mean the f32 value the normalisation subtracts), in
//   double from near-exact sums, so no float cancellation enters and
//   reruns give the same bits.
// - The conv (stem_conv) is launched behind the moments by programmatic
//   dependent launch: its CTAs stage their pixels (16-byte loads of a
//   34 x 288-byte tile into shared memory) and the weights while the
//   moments run, and one warp waits (griddepcontrol.wait) only to read
//   them. A CTA is 32 rows x 256 columns of one image (256 CTAs at either
//   flagship shape, two an SM: one wave). A lane owns 16 bytes of output
//   a row (4 rows x 8 columns in bf16, 8 x 4 in f32) with its f32 window
//   in registers, and for each channel writes them with one 16-byte store
//   a row: a warp store is 512 contiguous bytes of a channel plane, and
//   the stores of every channel stay in flight behind the next channel's
//   FMAs.
// - dK (stem_dk_partial) is persistent, two CTAs an SM, each a contiguous
//   range of CTA chunks (64 channels x 512 bytes of an image row: 256
//   pixels in bf16, 128 in f32) taken through a 3-stage ring in shared
//   memory filled by cp.async, one warp instruction a 512-byte channel
//   row, two chunks ahead of the one being multiplied. All 9 x 64 sums of
//   a pass of 64 channels stay in registers across the range. bf16:
//   mma.sync m16n8k16, a warp's 32-pixel slice of the chunk as A (64
//   channels), the nine shifted xn rows as B (taps 0-7 in one n8 tile,
//   tap 8 in a second); the k order of a lane's 8 pixels is permuted
//   identically in A and B. The bf16 products are exact and accumulate in
//   f32. f32: the same chunks on FMAs, a lane 4 channels x 8 pixels x 9
//   taps. One reduction a CTA (lanes, then warps in shared memory, in a
//   fixed order) writes one partial row; stem_dk_sum, launched behind it,
//   adds the rows in a fixed order. No float atomics: reruns are bit for
//   bit equal.
// Ragged H and W edges are masked, so any B, H, W >= 1; 16-byte loads and
// stores are used only where W and the pointers allow them (decided here
// from W and the pointers).

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "lstm_common.cuh"

namespace {

using vo_lstm::from_f32;

// --- K7a ----------------------------------------------------------------------
constexpr int MOM_THREADS = 256;
constexpr int MOM_BYTES = MOM_THREADS * 16;  // pixels a moments CTA
constexpr int CONV_THREADS = 256;
constexpr int TR = 32;                 // rows a conv CTA
constexpr int TC = 256;                // columns a conv CTA
constexpr int TILE_PITCH = TC + 32;    // 16 bytes of halo room each side
constexpr int KPAD = 12;               // a channel's 9 weights, padded

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the polarity flip and scale of stem_pallas.py:52 (and preprocess_images),
// rounded as there: a product the compiler may not fuse into the
// standardisation's subtraction (x - mean is then exactly 0 for an image
// of one value, as in the plain version)
__device__ __forceinline__ float ink(unsigned p) {
  return __fmul_rn(255.0f - static_cast<float>(p), 1.0f / 255.0f);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// moments[b][c] = (sum of x, sum of x^2) in double over the masked pixels
// of the c-th MOM_BYTES pixels of image b, x = ink(p) in f32: each square
// is exact in double and the sums keep every pixel to 2^-40 or so; the
// order is fixed (a thread's pixels in turn, then a shuffle tree and the
// warps in turn).
__global__ void __launch_bounds__(MOM_THREADS)
stem_moments(const unsigned char* __restrict__ images,
             const int* __restrict__ widths, int H, int W, int vec16,
             double* __restrict__ moments) {
  pdl_trigger();
  __shared__ double red[2][MOM_THREADS / 32];
  const int b = blockIdx.y;
  const long long P = (long long)H * W;
  const unsigned char* img = images + b * P;
  const int width = widths[b];
  const long long p0 = (long long)blockIdx.x * MOM_BYTES;
  const long long p1 = min(P, p0 + MOM_BYTES);
  double s1 = 0.0, s2 = 0.0;
  if (vec16) {  // W % 16 == 0: a 16-byte group lies in one row
    for (long long p = p0 + 16 * threadIdx.x; p < p1; p += 16 * MOM_THREADS) {
      const uint4 v = *reinterpret_cast<const uint4*>(img + p);
      const int col = static_cast<int>(p % W);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (col + j < width) {
          const double x = ink((w[j / 4] >> (8 * (j % 4))) & 0xffu);
          s1 += x;
          s2 = fma(x, x, s2);
        }
      }
    }
  } else {
    for (long long p = p0 + threadIdx.x; p < p1; p += MOM_THREADS) {
      if (static_cast<int>(p % W) < width) {
        const double x = ink(img[p]);
        s1 += x;
        s2 = fma(x, x, s2);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < MOM_THREADS / 32; ++k) s += red[threadIdx.x][k];
    moments[((long long)b * gridDim.x + blockIdx.x) * 2 + threadIdx.x] = s;
  }
}

// mean and rstd of an image from its moment pairs (one warp; lane 0's
// values are the result): mean = sum(x) / n, and the two-pass sum
// sum((x - mean)^2 * mask) = sum(x^2) - 2 mean sum(x) + c mean^2 over the
// c masked pixels, with the f32 mean the normalisation subtracts, in
// double from near-exact sums (no cancellation a float pass would feel).
__device__ void image_stats(const double* __restrict__ moments, int nchunk,
                            int width, int H, int W, float* mean,
                            float* rstd) {
  const int lane = threadIdx.x % 32;
  double s1 = 0.0, s2 = 0.0;
  for (int k = lane; k < nchunk; k += 32) {
    s1 += moments[2 * k];
    s2 += moments[2 * k + 1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float n = fmaxf(static_cast<float>(width) * static_cast<float>(H),
                        1.0f);
  const double c = static_cast<double>(min(max(width, 0), W)) * H;
  const float m = static_cast<float>(s1 / n);
  const double md = m;
  const double q = fmax(s2 - 2.0 * md * s1 + c * md * md, 0.0);
  const float var = static_cast<float>(q / n);
  *mean = m;
  *rstd = static_cast<float>(1.0 / sqrt(static_cast<double>(var + 1e-6f)));
}

// CT values of T at p[0..CT) of a row with `valid` in-bounds columns: one
// 16-byte store where `vec` (CT = 8 in bf16, 4 in f32).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store_row(float* p, const float (&v)[4],
                                          int valid, bool vec) {
  if (vec && valid >= 4) {
    const float4 u = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p) = u;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < valid) p[c] = v[c];
  }
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&v)[8], int valid,
                                          bool vec) {
  if (vec && valid >= 8) {
    const uint4 u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < valid) p[c] = __float2bfloat16(v[c]);
  }
}

// A CTA is TR x TC pixels of one image. A lane owns RT rows x CT columns,
// CT * sizeof(T) = 16 bytes, so that one warp store is 512 contiguous
// bytes of a channel row: bf16 4 x 8 (warps over 8 row groups), f32 8 x 4
// (warps over 4 row groups x 2 column halves).
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS, 2)
stem_conv(const unsigned char* __restrict__ images,
          const int* __restrict__ widths, const float* __restrict__ kernel,
          const double* __restrict__ moments, int nchunk, int standardize,
          int H, int W, int CO, int vec16, int vec, T* __restrict__ out,
          T* __restrict__ xn) {
  constexpr int CT = 16 / static_cast<int>(sizeof(T));
  constexpr int RT = CT == 8 ? 4 : 8;
  constexpr int RG = TR / RT;  // row groups
  extern __shared__ float4 ks4[];  // [CO][KPAD / 4]
  __shared__ __align__(16) unsigned char tile[TR + 2][TILE_PITCH];
  __shared__ float stats[2];
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TR, w0 = blockIdx.x * TC;
  const unsigned char* img = images + (long long)b * H * W;

  // the prologue: nothing here reads what the moments write
  float* ks = reinterpret_cast<float*>(ks4);
  for (int i = threadIdx.x; i < CO * KPAD; i += CONV_THREADS) {
    const int co = i / KPAD, j = i - co * KPAD;
    ks[i] = j < 9 ? kernel[co * 9 + j] : 0.0f;
  }
  // tile row r is image row h0 - 1 + r; byte 16 + j is column w0 + j
  for (int i = threadIdx.x; i < (TR + 2) * (TILE_PITCH / 16);
       i += CONV_THREADS) {
    const int r = i / (TILE_PITCH / 16), q = i - r * (TILE_PITCH / 16);
    const int h = h0 - 1 + r, wc = w0 - 16 + 16 * q;
    uint4* dst = reinterpret_cast<uint4*>(&tile[r][16 * q]);
    if (h >= 0 && h < H && vec16 && wc >= 0 && wc + 16 <= W) {
      *dst = *reinterpret_cast<const uint4*>(img + (long long)h * W + wc);
    } else {
      for (int j = 0; j < 16; ++j) {
        const int w = wc + j;
        tile[r][16 * q + j] =
            h >= 0 && h < H && w >= 0 && w < W ? img[(long long)h * W + w] : 0;
      }
    }
  }
  const int width = widths[b];
  if (standardize && threadIdx.x < 32) {
    pdl_wait();  // the moments are complete and visible
    float m, r;
    image_stats(moments + (long long)b * nchunk * 2, nchunk, width, H, W, &m,
                &r);
    if (threadIdx.x == 0) {
      stats[0] = m;
      stats[1] = r;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int hw = h0 + RT * (warp % RG);                 // the lane's rows
  const int wl = w0 + (warp / RG) * 32 * CT + CT * lane;  // and columns
  const int valid = W - wl;
  if (hw >= H || valid <= 0) return;  // no barrier follows
  const float mean = standardize ? stats[0] : 0.0f;
  const float rstd = standardize ? stats[1] : 1.0f;

  // the normalised f32 window: rows hw-1 .. hw+RT, columns wl-1 .. wl+CT,
  // zero outside the image and at columns >= width (the mask)
  float win[RT + 2][CT + 2];
#pragma unroll
  for (int rr = 0; rr < RT + 2; ++rr) {
    const int h = hw - 1 + rr;
    const unsigned char* row = &tile[hw - h0 + rr][16 + wl - w0];
    unsigned char px[CT + 2];
    px[0] = row[-1];
    if constexpr (CT == 8) {
      const uint2 mid = *reinterpret_cast<const uint2*>(row);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        px[1 + j] = (mid.x >> (8 * j)) & 0xff;
        px[5 + j] = (mid.y >> (8 * j)) & 0xff;
      }
    } else {
      const unsigned mid = *reinterpret_cast<const unsigned*>(row);
#pragma unroll
      for (int j = 0; j < 4; ++j) px[1 + j] = (mid >> (8 * j)) & 0xff;
    }
    px[CT + 1] = row[CT];
#pragma unroll
    for (int cc = 0; cc < CT + 2; ++cc) {
      const int w = wl - 1 + cc;
      const bool ok = h >= 0 && h < H && w >= 0 && w < W && w < width;
      const float x = ink(px[cc]);
      win[rr][cc] = ok ? (standardize ? (x - mean) * rstd : x) : 0.0f;
    }
  }
  T* xrow = xn + ((long long)b * H + hw) * W + wl;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (hw + r >= H) break;
    float v[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = win[r + 1][c + 1];
    store_row(xrow + (long long)r * W, v, valid, vec);
  }

  T* o = out + ((long long)b * CO * H + hw) * W + wl;
  const long long plane = (long long)H * W;
  for (int co = 0; co < CO; ++co, o += plane) {
    const float4 ka = ks4[co * 3], kb = ks4[co * 3 + 1], kc = ks4[co * 3 + 2];
    const float k[9] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w, kc.x};
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (hw + r >= H) break;
      float v[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            s = fmaf(k[dh * 3 + dw], win[r + dh][c + dw], s);
        v[c] = s;
      }
      store_row(o + (long long)r * W, v, valid, vec);
    }
  }
}

// --- K7b ----------------------------------------------------------------------
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

constexpr int DK_THREADS = 256;
constexpr int DK_CTAS_PER_SM = 2;
constexpr int CG = 64;          // channels a pass
constexpr int SLICE = 32;       // pixels a warp's slice of a CTA chunk
constexpr int ROW_BYTES = 512;  // a channel's bytes of a CTA chunk
constexpr int SUM_OUTS = 32;    // outputs a stem_dk_sum block (8 threads each)
// A CTA chunk is CG channels x ROW_BYTES of one image row (256 pixels in
// bf16, 128 in f32) and its three xn rows with 16 bytes more each side;
// the CTA's ring holds DK_STAGES of them, filled by cp.async with one
// warp instruction a 512-byte channel row. A channel's 16-byte pieces sit
// at piece ^ 4 in odd channels, so that a lane quad's reads of channels
// g and g + 1 fall in disjoint banks.
constexpr int DK_STAGES = 3;
constexpr int A_BYTES = CG * ROW_BYTES;
constexpr int X_ROW = ROW_BYTES + 32;
constexpr int STAGE_BYTES = A_BYTES + 3 * X_ROW;
constexpr int DK_SMEM = DK_STAGES * STAGE_BYTES;  // 103,200 bytes: 2 CTAs an SM

__device__ __forceinline__ int piece_at(int ch, int piece) {
  return ch * ROW_BYTES + ((piece ^ ((ch & 1) << 2)) << 4);
}

// Fill a stage with the CTA chunk (image b, row h, columns c0 ..) of
// channels cbase ..: by cp.async where `vec` (every 16-byte piece then
// lies wholly inside or outside the row), else by plain loads; zeros
// outside the image and past CO.
template <typename T>
__device__ __forceinline__ void dk_issue(unsigned char* stage,
                                         const T* __restrict__ xn,
                                         const T* __restrict__ dout, int b,
                                         int h, int c0, int cbase, int H,
                                         int W, int CO, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int PIECES = ROW_BYTES / 16;
  for (int i = threadIdx.x; i < CG * PIECES; i += DK_THREADS) {
    const int ch = i / PIECES, p = i % PIECES;
    const int co = cbase + ch, col = c0 + p * E;
    unsigned char* dst = stage + piece_at(ch, p);
    const T* src = dout + (((long long)b * CO + min(co, CO - 1)) * H + h) * W;
    if (vec) {
      vo_sm90::cp_async16_zfill(dst, src + (col < W ? col : 0),
                                co < CO && col < W);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int j = 0; j < E; ++j)
        d[j] = co < CO && col + j < W ? src[col + j] : from_f32<T>(0.0f);
    }
  }
  const T* plane = xn + (long long)b * H * W;
  for (int i = threadIdx.x; i < 3 * (PIECES + 2); i += DK_THREADS) {
    const int dh = i / (PIECES + 2), p = i % (PIECES + 2);
    const int hr = h + dh - 1, col = c0 - E + p * E;
    unsigned char* dst = stage + A_BYTES + dh * X_ROW + p * 16;
    const bool row_ok = hr >= 0 && hr < H;
    if (vec) {
      const bool ok = row_ok && col >= 0 && col < W;
      vo_sm90::cp_async16_zfill(dst, plane + (ok ? (long long)hr * W + col : 0),
                                ok);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int j = 0; j < E; ++j)
        d[j] = row_ok && col + j >= 0 && col + j < W
                   ? plane[(long long)hr * W + col + j]
                   : from_f32<T>(0.0f);
    }
  }
}

// The B words of one tap from a staged xn row x (x[8 + j] is column c + j
// for the lane's c): columns c + dw - 1 + [0, 8), packed as bf16 pairs.
// Branch-free in dw, which differs across a warp's lanes.
__device__ __forceinline__ void tap8(const __nv_bfloat16* x, int dw,
                                     unsigned (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(x + 8);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  const unsigned left = static_cast<unsigned>(bits(x[7])) << 16;
  const unsigned right = bits(x[16]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned prev = k == 0 ? left : u[k - 1];
    const unsigned next = k == 3 ? right : u[k + 1];
    const unsigned shl = __funnelshift_l(prev, u[k], 16);  // dw = 0
    const unsigned shr = __funnelshift_r(u[k], next, 16);  // dw = 2
    w[k] = dw == 0 ? shl : (dw == 1 ? u[k] : shr);
  }
}

// A warp's slice of a staged chunk on the tensor cores: lane (g, t) takes
// pixels 32 s + 8t .. + 7; in the mma of half j its k slots 2t, 2t+1,
// 2t+8, 2t+9 are its pixels 8t + 4j + 0..3, in A (its channels g and g + 8
// of each m16 tile) and in B (taps g and 8) alike.
__device__ __forceinline__ void dk_compute(const unsigned char* stage,
                                           float (&acc)[4][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const auto* xs = reinterpret_cast<const __nv_bfloat16*>(stage + A_BYTES);
  constexpr int XN = X_ROW / 2;
  const int dh = g / 3, dw = g - 3 * dh;  // tap g (0..7)
  unsigned bg[4], b8[4];                  // taps g and 8 (dh = dw = 2)
  tap8(xs + dh * XN + SLICE * warp + 8 * t, dw, bg);
  tap8(xs + 2 * XN + SLICE * warp + 8 * t, 2, b8);
  const int p = 4 * warp + t;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int ch = 16 * mt + g;
    const uint4 lo = *reinterpret_cast<const uint4*>(stage + piece_at(ch, p));
    const uint4 hi =
        *reinterpret_cast<const uint4*>(stage + piece_at(ch + 8, p));
    const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
    const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
    vo_sm90::mma_16816(acc[mt][0], a0, bg[0], bg[1]);
    vo_sm90::mma_16816(acc[mt][1], a0, b8[0], b8[1]);
    vo_sm90::mma_16816(acc[mt][0], a1, bg[2], bg[3]);
    vo_sm90::mma_16816(acc[mt][1], a1, b8[2], b8[3]);
  }
}

// A warp's slice of a staged chunk on the FMA units: lane (g, t), its 4
// channels 32 (w / 4) + 16 (e / 2) + g + 8 (e % 2) x pixels 32 s + 16 q +
// 4t .. + 3 (q in 0..1) x 9 taps; x[4 + j] of a staged xn row is column
// c0 + j.
__device__ __forceinline__ void dk_compute(const unsigned char* stage,
                                           float (&acc)[4][9]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, s = warp % 4;
  const float* xs = reinterpret_cast<const float*>(stage + A_BYTES);
  constexpr int XN = X_ROW / 4;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int px = SLICE * s + 16 * q + 4 * t;
    float x[3][6];  // xn rows h-1 .. h+1, columns c-1 .. c+4
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const float* row = xs + dh * XN + px;
      const float4 v = *reinterpret_cast<const float4*>(row + 4);
      x[dh][0] = row[3];
      x[dh][1] = v.x; x[dh][2] = v.y; x[dh][3] = v.z; x[dh][4] = v.w;
      x[dh][5] = row[8];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 32 * (warp / 4) + 16 * (e / 2) + g + 8 * (e % 2);
      const float4 d4 =
          *reinterpret_cast<const float4*>(stage + piece_at(ch, px / 4));
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            acc[e][dh * 3 + dw] = fmaf(d[j], x[dh][j + dw], acc[e][dh * 3 + dw]);
    }
  }
}

// the lane's sums of one pass into red[stream][channel][tap]: every
// (channel, tap) of the pass from exactly one lane of the stream
__device__ __forceinline__ void dk_stash(const float (&acc)[4][2][4],
                                         float (*red)[CG * 9]) {
  const int stream = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int co = 16 * mt + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      red[stream][co * 9 + 2 * t + i] = acc[mt][0][i];
      red[stream][(co + 8) * 9 + 2 * t + i] = acc[mt][0][2 + i];
    }
    if (t == 0) {
      red[stream][co * 9 + 8] = acc[mt][1][0];
      red[stream][(co + 8) * 9 + 8] = acc[mt][1][2];
    }
  }
}
__device__ __forceinline__ void dk_stash(float (&acc)[4][9],
                                         float (*red)[CG * 9]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, stream = warp % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {  // the four lanes of g, in a fixed order
      float v = acc[e][i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[e][i] = v;
    }
    const int co = 32 * (warp / 4) + 16 * (e / 2) + g + 8 * (e % 2);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) red[stream][co * 9 + i] = acc[e][i];
    }
  }
}

template <typename T>
using DkAcc = typename std::conditional<std::is_same<T, float>::value,
                                        float[4][9], float[4][2][4]>::type;

// partial[blockIdx.x][CO * 9]: the sums over this CTA's chunks, which are
// [nch * k / G, nch * (k + 1) / G) of the B * H * ceil(W / chunk) CTA
// chunks, taken through the ring DK_STAGES - 1 chunks ahead of the one
// the warps multiply.
template <typename T>
__global__ void __launch_bounds__(DK_THREADS, DK_CTAS_PER_SM)
stem_dk_partial(const T* __restrict__ xn, const T* __restrict__ dout, int B,
                int H, int W, int CO, int vec, float* __restrict__ partial) {
  // bf16: warp s takes pixels 32 s .. 32 s + 31 of the chunk and all 64
  // channels (4 m16 tiles); f32: warp w takes the slice w % 4 and the
  // channels 32 (w / 4) .. + 31 (2 m16 tiles)
  constexpr int STREAMS = sizeof(T) == 2 ? 8 : 4;  // slices a chunk
  constexpr int CP = ROW_BYTES / static_cast<int>(sizeof(T));  // chunk pixels
  extern __shared__ __align__(16) unsigned char dk_smem[];
  auto* red = reinterpret_cast<float(*)[CG * 9]>(dk_smem);  // after the ring
  const unsigned cpr = (W + CP - 1) / CP;
  const unsigned long long nch = (unsigned long long)B * H * cpr;
  const unsigned c_begin =
      static_cast<unsigned>(nch * blockIdx.x / gridDim.x);
  const unsigned n =
      static_cast<unsigned>(nch * (blockIdx.x + 1) / gridDim.x) - c_begin;
  auto issue = [&](unsigned k, int cbase) {
    const unsigned ch = c_begin + k;
    const unsigned row = ch / cpr;
    const int c0 = static_cast<int>(ch - row * cpr) * CP;
    const int b = static_cast<int>(row / H);
    const int h = static_cast<int>(row - static_cast<unsigned>(b) * H);
    dk_issue<T>(dk_smem + (k % DK_STAGES) * STAGE_BYTES, xn, dout, b, h, c0,
                cbase, H, W, CO, vec != 0);
  };
  for (int cbase = 0; cbase < CO; cbase += CG) {
    DkAcc<T> acc = {};
#pragma unroll
    for (int k = 0; k < DK_STAGES - 1; ++k) {
      if (k < static_cast<int>(n)) issue(k, cbase);
      vo_sm90::cp_async_commit();
    }
    for (unsigned k = 0; k < n; ++k) {
      vo_sm90::cp_async_wait_group<DK_STAGES - 2>();  // chunk k has landed
      __syncthreads();  // for every thread; chunk k - 1's stage is free
      if (k + DK_STAGES - 1 < n) issue(k + DK_STAGES - 1, cbase);
      vo_sm90::cp_async_commit();
      dk_compute(dk_smem + (k % DK_STAGES) * STAGE_BYTES, acc);
    }
    vo_sm90::cp_async_wait_all();
    __syncthreads();  // the ring is idle: red takes its place
    dk_stash(acc, red);
    __syncthreads();
    for (int i = threadIdx.x; i < CG * 9; i += DK_THREADS) {
      if (cbase + i / 9 >= CO) break;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < STREAMS; ++k) s += red[k][i];
      partial[(long long)blockIdx.x * CO * 9 + cbase * 9 + i] = s;
    }
    __syncthreads();
  }
  pdl_trigger();  // stem_dk_sum may launch; it waits for this grid's end
}

// dk[i] = sum over the CTAs k of partial[k][i]: 8 threads an output, each
// every 8th row, then their sums in a fixed tree.
__global__ void __launch_bounds__(SUM_OUTS * 8)
stem_dk_sum(const float* __restrict__ partial, int nblk, int n,
            float* __restrict__ dk) {
  pdl_wait();
  const int i = blockIdx.x * SUM_OUTS + threadIdx.x / 8, part = threadIdx.x % 8;
  float s = 0.0f;
  if (i < n) {
    for (int k = part; k < nblk; k += 8) s += partial[(long long)k * n + i];
  }
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (i < n && part == 0) dk[i] = s;
}

// --- launches -----------------------------------------------------------------
// a launch that may begin while the kernel before it on the stream runs;
// the kernel waits (griddepcontrol.wait) before it reads that kernel's
// output
template <typename... Params, typename... Args>
cudaError_t launch_behind(void (*kernel)(Params...), dim3 grid, dim3 block,
                          size_t smem, cudaStream_t s, bool behind,
                          Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = behind ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int moment_chunks(int H, int W) {
  return static_cast<int>(((long long)H * W + MOM_BYTES - 1) / MOM_BYTES);
}

template <typename T>
int run_fwd(int B, int H, int W, int CO, int standardize,
            const unsigned char* images, const int* widths,
            const float* kernel, double* moments, void* out,
            void* xn, cudaStream_t s) {
  const int vec16 = W % 16 == 0 && aligned16(images);
  const int vec = W % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  aligned16(out) && aligned16(xn);
  const int nchunk = moment_chunks(H, W);
  if (standardize) {
    stem_moments<<<dim3(nchunk, B), MOM_THREADS, 0, s>>>(images, widths, H, W,
                                                         vec16, moments);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = (size_t)CO * KPAD * sizeof(float);
  auto kernel_fn = stem_conv<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  cudaError_t err = launch_behind(
      kernel_fn, grid, dim3(CONV_THREADS), smem, s, standardize != 0, images,
      widths, kernel, moments, nchunk, standardize, H, W, CO, vec16, vec,
      static_cast<T*>(out), static_cast<T*>(xn));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// CTA chunks of K7b (bf16 chunks are 256 pixels: the more of the two)
long long dk_chunks(int B, int H, int W) {
  return (long long)B * H * ((W + 127) / 128);
}

int dk_grid(int B, int H, int W) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  return static_cast<int>(std::min<long long>(dk_chunks(B, H, W),
                                              (long long)sms * DK_CTAS_PER_SM));
}

template <typename T>
int run_dk(int B, int H, int W, int CO, const void* xn, const void* dout,
           float* partial, float* dk, cudaStream_t s) {
  const int vec = W % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  aligned16(xn) && aligned16(dout);
  const int grid = dk_grid(B, H, W);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stem_dk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_dk_partial<T><<<grid, DK_THREADS, DK_SMEM, s>>>(
      static_cast<const T*>(xn), static_cast<const T*>(dout), B, H, W, CO, vec,
      partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = CO * 9;
  err = launch_behind(stem_dk_sum, dim3((n + SUM_OUTS - 1) / SUM_OUTS),
                      dim3(SUM_OUTS * 8), 0, s, true,
                      static_cast<const float*>(partial), grid, n, dk);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

bool bad_shape(int B, int H, int W, int CO) {
  // the chunk index of K7b is 32-bit; CO * 9 weights within 48 KB
  return B < 1 || H < 1 || W < 1 || CO < 1 || CO * 9 * 4 > 48 * 1024 ||
         B > 65535 || (long long)H > 65535LL * TR ||
         dk_chunks(B, H, W) >= (1LL << 32);
}

}  // namespace

// Number of moment pairs an image for vo_stem_fwd's `moments` scratch
// ([B, vo_stem_moment_chunks(H, W), 2] float64).
extern "C" int vo_stem_moment_chunks(int H, int W) {
  return moment_chunks(H, W);
}

// Number of partial rows vo_stem_dk needs in its `partial` scratch
// ([partials, CO * 9] float32): its persistent CTAs on the current device.
extern "C" long long vo_stem_partials(int B, int H, int W) {
  return dk_grid(B, H, W);
}

// K7a. type_code: 0 = float, 1 = bf16 (out and xn). images [B,H,W] uint8,
// widths [B] int32, kernel [CO,1,3,3] float32, moments scratch (written
// when standardize), out [B,CO,H,W], xn [B,H,W]. Returns the first
// non-zero CUDA error of a launch, or 0.
extern "C" int vo_stem_fwd(int type_code, int B, int H, int W, int CO,
                           int standardize, const void* images,
                           const void* widths, const void* kernel,
                           void* moments, void* out, void* xn, void* stream) {
  if (bad_shape(B, H, W, CO)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* img = static_cast<const unsigned char*>(images);
  const auto* wid = static_cast<const int*>(widths);
  const auto* k = static_cast<const float*>(kernel);
  auto* mom = static_cast<double*>(moments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_fwd<float>(B, H, W, CO, standardize, img, wid, k, mom, out,
                            xn, s);
    case 1:
      return run_fwd<__nv_bfloat16>(B, H, W, CO, standardize, img, wid, k, mom,
                                    out, xn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7b. type_code as vo_stem_fwd (xn and dout). partial:
// [vo_stem_partials(B,H,W), CO*9] float32 scratch; dk [CO,1,3,3] float32,
// every element written.
extern "C" int vo_stem_dk(int type_code, int B, int H, int W, int CO,
                          const void* xn, const void* dout, void* partial,
                          void* dk, void* stream) {
  if (bad_shape(B, H, W, CO)) return static_cast<int>(cudaErrorInvalidValue);
  auto* part = static_cast<float*>(partial);
  auto* out = static_cast<float*>(dk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_dk<float>(B, H, W, CO, xn, dout, part, out, s);
    case 1:
      return run_dk<__nv_bfloat16>(B, H, W, CO, xn, dout, part, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
