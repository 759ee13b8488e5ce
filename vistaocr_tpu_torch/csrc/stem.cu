// Fused input stem: preprocess + the first 3x3 convolution (C_in = 1), and
// the gradient of its kernel.
//
// Replaces experiments/stem_pallas.py::_stem_kernel (K7a, vo_stem_fwd) and
// ::_dk_kernel (K7b, vo_stem_dk).
//
// What K7a computes, per image b of uint8 images [B, H, W] with width w_b:
//   x      = (255 - img) / 255,  zeroed at columns >= w_b
//   (standardize) n = max(w_b * H, 1);  mean = sum(x) / n;
//          var = sum((x - mean)^2 * mask) / n   (two passes, as :58-61);
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
// about 80 us at 3.35 TB/s); its 9 * CO FMAs per pixel (1.2 GFMA at that
// shape) are a fraction of the card's f32 rate. The dK pass reads the same
// 268 MB of dout and reduces 2^21 positions into 9 * CO sums.
//
// What this design does about it (the simple form):
// - The statistics need the whole image before any output pixel, so the
//   forward is two launches: stem_stats (one block per image: two passes
//   over its bytes, deterministic block sums) writes mean and rstd, then
//   stem_conv fills the card with blocks of TH rows x TW columns of one
//   image (512 blocks at either flagship shape). Each thread owns VEC
//   neighbouring columns: it normalises its (TH+2) x (VEC+2) byte window
//   into registers, writes its xn, and for each channel writes TH rows of
//   VEC outputs, 16 bytes (f32) or 8 bytes (bf16) per store, so a warp
//   writes 512 or 256 contiguous bytes of a channel plane at a time.
// - dK: stem_dk_partial keeps the same tiling; each thread holds its
//   window of xn in registers, and per channel accumulates its 9 sums,
//   reduces them across the warp with shuffles and across the block's warps
//   in shared memory, and writes one partial row per block; stem_dk_sum
//   then adds the partials of every block in a fixed order. No float
//   atomics: repeated runs are bit for bit equal.
// Ragged H and W edges are masked, so any B, H, W >= 1; vector loads and
// stores are used only when W is a multiple of VEC and the pointers are
// 16-byte aligned (the caller says so in `vec`).

#include "lstm_common.cuh"

namespace {

using vo_lstm::from_f32;
using vo_lstm::to_f32;

constexpr int STATS_THREADS = 512;
constexpr int CTHREADS = 128;
constexpr int VEC = 4;                 // columns per thread
constexpr int TW = CTHREADS * VEC;     // columns per block
constexpr int TH = 8;                  // rows per block
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float ink(unsigned char p) {
  return (255.0f - static_cast<float>(p)) * (1.0f / 255.0f);
}

// Sum of v over the block, the same order on every run; red holds 33
// floats. Every thread gets the sum.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float s = red[32];
  __syncthreads();  // red may be reused by the caller's next sum
  return s;
}

// stats[b] = (mean, rstd) of the masked ink values of image b.
__global__ void __launch_bounds__(STATS_THREADS)
stem_stats(const unsigned char* __restrict__ images,
           const int* __restrict__ widths, int H, int W, float* stats) {
  __shared__ float red[33];
  const int b = blockIdx.x;
  const unsigned char* img = images + (long long)b * H * W;
  const int width = widths[b];
  const int npix = H * W;
  float s = 0.0f;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    if (p % W < width) s += ink(img[p]);
  }
  const float n = fmaxf(static_cast<float>(width) * static_cast<float>(H), 1.0f);
  const float mean = block_sum(s, red) / n;
  float q = 0.0f;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    if (p % W < width) {
      const float d = ink(img[p]) - mean;
      q += d * d;
    }
  }
  const float var = block_sum(q, red) / n;
  if (threadIdx.x == 0) {
    stats[2 * b] = mean;
    stats[2 * b + 1] = rsqrtf(var + 1e-6f);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[VEC]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// VEC values at p[0..VEC) of a row with `valid` in-bounds columns.
template <typename T>
__device__ __forceinline__ void store_row(T* p, const float (&v)[VEC],
                                          int valid, bool vec) {
  if (vec && valid >= VEC) {
    store4(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (c < valid) p[c] = from_f32<T>(v[c]);
  }
}
template <typename T>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC],
                                         int valid, bool vec) {
  if (vec && valid >= VEC) {
    load4(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) v[c] = c < valid ? to_f32(p[c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS)
stem_conv(const unsigned char* __restrict__ images,
          const int* __restrict__ widths, const float* __restrict__ kernel,
          const float* __restrict__ stats, int standardize, int H, int W,
          int CO, int vec, T* __restrict__ out, T* __restrict__ xn) {
  extern __shared__ float ks[];  // [CO * 9]
  for (int i = threadIdx.x; i < CO * 9; i += blockDim.x) ks[i] = kernel[i];
  __syncthreads();

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW + VEC * threadIdx.x;
  const int width = widths[b];
  const float mean = standardize ? stats[2 * b] : 0.0f;
  const float rstd = standardize ? stats[2 * b + 1] : 1.0f;
  const unsigned char* img = images + (long long)b * H * W;

  // the normalised f32 window, rows h0-1 .. h0+TH, columns w0-1 .. w0+VEC;
  // zero outside the image and at columns >= width (the mask)
  float win[TH + 2][VEC + 2];
#pragma unroll
  for (int r = 0; r < TH + 2; ++r) {
    const int h = h0 - 1 + r;
#pragma unroll
    for (int c = 0; c < VEC + 2; ++c) {
      const int w = w0 - 1 + c;
      float v = 0.0f;
      if (h >= 0 && h < H && w >= 0 && w < W && w < width) {
        const float x = ink(img[(long long)h * W + w]);
        v = standardize ? (x - mean) * rstd : x;
      }
      win[r][c] = v;
    }
  }
  const int valid = W - w0;  // in-bounds columns of this thread (may be <= 0)
  if (valid > 0) {
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      if (h0 + r >= H) break;
      float v[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) v[c] = win[r + 1][c + 1];
      store_row(xn + ((long long)b * H + h0 + r) * W + w0, v, valid, vec);
    }
  }
  if (valid <= 0) return;  // no barrier follows

  for (int co = 0; co < CO; ++co) {
    float k[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = ks[co * 9 + i];
    T* o = out + (((long long)b * CO + co) * H + h0) * W + w0;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      if (h0 + r >= H) break;
      float v[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
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

// One partial [CO * 9] row per block of the tiling of stem_conv.
template <typename T>
__global__ void __launch_bounds__(CTHREADS)
stem_dk_partial(const T* __restrict__ xn, const T* __restrict__ dout, int H,
                int W, int CO, int vec, float* __restrict__ partial) {
  __shared__ float red[CTHREADS / 32][9];
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW + VEC * threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long blk =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int valid = W - w0;

  // pad(xn) window as stored (rounded to T), zero outside the image
  float win[TH + 2][VEC + 2];
#pragma unroll
  for (int r = 0; r < TH + 2; ++r) {
    const int h = h0 - 1 + r;
#pragma unroll
    for (int c = 0; c < VEC + 2; ++c) {
      const int w = w0 - 1 + c;
      win[r][c] = (h >= 0 && h < H && w >= 0 && w < W)
                      ? to_f32(xn[((long long)b * H + h) * W + w])
                      : 0.0f;
    }
  }

  for (int co = 0; co < CO; ++co) {
    float acc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = 0.0f;
    if (valid > 0) {
      const T* d = dout + (((long long)b * CO + co) * H + h0) * W + w0;
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        if (h0 + r >= H) break;
        float dv[VEC];
        load_row(d + (long long)r * W, dv, valid, vec);
#pragma unroll
        for (int c = 0; c < VEC; ++c)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
              acc[dh * 3 + dw] = fmaf(dv[c], win[r + dh][c + dw], acc[dh * 3 + dw]);
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[i] += __shfl_down_sync(0xffffffffu, acc[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) red[warp][i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < 9) {
      float s = 0.0f;
#pragma unroll
      for (int wp = 0; wp < CTHREADS / 32; ++wp) s += red[wp][threadIdx.x];
      partial[blk * CO * 9 + co * 9 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// dk[i] = sum over blocks k of partial[k][i], one block per output i.
__global__ void __launch_bounds__(SUM_THREADS)
stem_dk_sum(const float* __restrict__ partial, long long nblk, int n,
            float* __restrict__ dk) {
  __shared__ float red[33];
  const int i = blockIdx.x;
  float s = 0.0f;
  for (long long k = threadIdx.x; k < nblk; k += blockDim.x) s += partial[k * n + i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) dk[i] = s;
}

dim3 conv_grid(int B, int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B);
}

template <typename T>
int run_fwd(int B, int H, int W, int CO, int standardize, int vec,
            const unsigned char* images, const int* widths,
            const float* kernel, float* stats, void* out, void* xn,
            cudaStream_t s) {
  if (standardize) {
    stem_stats<<<B, STATS_THREADS, 0, s>>>(images, widths, H, W, stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stem_conv<T><<<conv_grid(B, H, W), CTHREADS, CO * 9 * sizeof(float), s>>>(
      images, widths, kernel, stats, standardize, H, W, CO, vec,
      static_cast<T*>(out), static_cast<T*>(xn));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_dk(int B, int H, int W, int CO, int vec, const void* xn,
           const void* dout, float* partial, float* dk, cudaStream_t s) {
  const dim3 grid = conv_grid(B, H, W);
  stem_dk_partial<T><<<grid, CTHREADS, 0, s>>>(
      static_cast<const T*>(xn), static_cast<const T*>(dout), H, W, CO, vec,
      partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nblk = (long long)grid.x * grid.y * grid.z;
  stem_dk_sum<<<CO * 9, SUM_THREADS, 0, s>>>(partial, nblk, CO * 9, dk);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int W, int CO) {
  // the kernel's CO * 9 floats must fit the default 48 KB of shared memory
  return B < 1 || H < 1 || W < 1 || CO < 1 || CO * 9 * 4 > 48 * 1024 ||
         B > 65535;
}

}  // namespace

// Number of partial rows vo_stem_dk needs in its `partial` scratch
// ([partials, CO * 9] float32): the blocks of the conv tiling.
extern "C" long long vo_stem_partials(int B, int H, int W) {
  const dim3 g = conv_grid(B, H, W);
  return (long long)g.x * g.y * g.z;
}

// K7a. type_code: 0 = float, 1 = bf16 (out and xn). images [B,H,W] uint8,
// widths [B] int32, kernel [CO,1,3,3] float32, stats [B,2] float32 scratch
// (written when standardize), out [B,CO,H,W], xn [B,H,W]. vec: W % 4 == 0
// and out, xn 16-byte aligned. Returns the first non-zero
// cudaGetLastError() after a launch, or 0.
extern "C" int vo_stem_fwd(int type_code, int B, int H, int W, int CO,
                           int standardize, int vec, const void* images,
                           const void* widths, const void* kernel,
                           void* stats, void* out, void* xn, void* stream) {
  if (bad_shape(B, H, W, CO)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* img = static_cast<const unsigned char*>(images);
  const auto* wid = static_cast<const int*>(widths);
  const auto* k = static_cast<const float*>(kernel);
  auto* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_fwd<float>(B, H, W, CO, standardize, vec, img, wid, k, st,
                            out, xn, s);
    case 1:
      return run_fwd<__nv_bfloat16>(B, H, W, CO, standardize, vec, img, wid,
                                    k, st, out, xn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7b. type_code as vo_stem_fwd (xn and dout). partial:
// [vo_stem_partials(B,H,W), CO*9] float32 scratch; dk [CO,1,3,3] float32,
// every element written. vec: W % 4 == 0 and xn, dout 16-byte aligned.
extern "C" int vo_stem_dk(int type_code, int B, int H, int W, int CO, int vec,
                          const void* xn, const void* dout, void* partial,
                          void* dk, void* stream) {
  if (bad_shape(B, H, W, CO)) return static_cast<int>(cudaErrorInvalidValue);
  auto* part = static_cast<float*>(partial);
  auto* out = static_cast<float*>(dk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_dk<float>(B, H, W, CO, vec, xn, dout, part, out, s);
    case 1:
      return run_dk<__nv_bfloat16>(B, H, W, CO, vec, xn, dout, part, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
