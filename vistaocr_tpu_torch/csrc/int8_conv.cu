// int8 3x3 SAME convolution with the activation quantize fused in front
// and the dequantize + bias + ReLU epilogue fused behind: one launch per
// quantized conv of the int8 serving path (models/quant.py).
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (vistaocr_tpu/models/quant.py:209-222, an int8 x int8 -> int32
// conv_general_dilated). It is written by hand because PyTorch has no
// int8 convolution on CUDA (F.conv2d refuses int8 tensors) and a float
// conv of the int8 values is not exact: at conv2_1 the int32 sums reach
// 9 * 256 * 127^2 ~ 3.7e7 > 2^24.
//
// What it computes, for x [B,H,W,CI] (NHWC, f32 or bf16), the packed
// weights wq [CO,KP] int8 (k = (kh*3 + kw)*CI + c, zero past K = 9*CI,
// KP = K rounded up to 32), scale, bias [CO] f32 and inv_s (f32):
//   xq  = clamp(rint(x * inv_s), -127, 127)           (int8; pad = 0)
//   acc = sum_k xq[patch(m), k] * wq[n, k]            (int32, exact)
//   y   = relu(round_to_T(acc * scale[n] + bias[n]))  (T = x's type)
// with each product and sum rounded once (__fmul_rn / __fadd_rn: no FMA
// contraction), as the plain version's separate torch ops round, so the
// two are bit-equal; rint rounds half to even like torch.round.
//
// What bounds it on an H100: an implicit GEMM with M = B*H*W pixels,
// N = CO, K = 9*CI. At the flagship's convs (B=32, W=2048) it is
// 19-154 GOP (int8 tensor cores: 1,979 TOP/s) against 0.13-0.54 GB of
// activations in and out (3.35 TB/s): bytes bound, 0.04-0.16 ms. The
// im2col gather re-reads each input element for 9 taps (through L1/L2)
// and quantizes it each time.
//
// What this design does about it (a first design, right before fast):
// - One block computes a 128-pixel x 64-channel tile with 8 warps (4
//   along M x 2 along N), each warp 32 x 32 outputs as 2 x 4
//   mma.sync.m16n8k32 s8 products with int32 accumulators in registers.
// - K steps of 32 bytes: the A tile (128 rows x 32 k) is gathered,
//   quantized and packed by the block (two threads a row, 16 k each),
//   the B tile (64 rows x 32 bytes of the packed weights) copied, both
//   into double-buffered shared memory with rows padded to 48 bytes
//   (the fragment loads of a warp then hit 32 distinct banks); the next
//   step's global loads are issued before the current step's products.
// - Where CI is a multiple of 32 (every flagship conv but conv0_0) a
//   K step lies inside one tap, so a thread's 16 values are contiguous
//   channels of one pixel: 16-byte vector loads. Otherwise (conv0_0:
//   CI = 1, K = 9, one zero-padded step) each value is gathered alone.
// - Ragged M, N and K edges are masked (zero operands, no stores).
// Not done: wgmma on s8, TMA, a persistent grid, and fusing the quantize
// into the previous layer's epilogue (ROADMAP, card work).
// No atomics: two runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // output pixels a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 32;        // K bytes a step (one mma k)
constexpr int LDS = 48;       // shared row stride in bytes
constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t quant(float x, float inv_s) {
  float v = rintf(__fmul_rn(x, inv_s));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
}

// 16 consecutive values of T at p (16-byte aligned) -> 16 int8 packed
// little-endian in 4 words.
__device__ __forceinline__ uint4 quant16(const float* p, float inv_s) {
  uint32_t w[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float4 f = reinterpret_cast<const float4*>(p)[v];
    w[v] = quant(f.x, inv_s) | (quant(f.y, inv_s) << 8) |
           (quant(f.z, inv_s) << 16) | (quant(f.w, inv_s) << 24);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 quant16(const __nv_bfloat16* p,
                                         float inv_s) {
  uint32_t w[4];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    uint4 raw = reinterpret_cast<const uint4*>(p)[v];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      w[2 * v + q] = quant(__bfloat162float(h[4 * q + 0]), inv_s) |
                     (quant(__bfloat162float(h[4 * q + 1]), inv_s) << 8) |
                     (quant(__bfloat162float(h[4 * q + 2]), inv_s) << 16) |
                     (quant(__bfloat162float(h[4 * q + 3]), inv_s) << 24);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_out(float* p, float v) {
  *p = v > 0.f ? v : 0.f;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  __nv_bfloat16 r = __float2bfloat16_rn(v);
  *p = __bfloat162float(r) > 0.f ? r : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC: CI % 32 == 0 (a K step inside one tap, 16-byte loads).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float inv_s,
                     T* __restrict__ y, int B, int H, int W, int CI, int CO,
                     int KP) {
  __shared__ __align__(16) uint8_t As[2][BM * LDS];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * CI;
  const int nk = KP / BK;

  // this thread's A row (pixel) and half of the K step
  const int ar = tid >> 1, ahalf = tid & 1;
  const long long am = m0 + ar;
  const bool am_ok = am < M;
  int ab = 0, ah = 0, aw = 0;
  if (am_ok) {
    ab = static_cast<int>(am / (static_cast<long long>(H) * W));
    const int rem = static_cast<int>(am - static_cast<long long>(ab) * H * W);
    ah = rem / W;
    aw = rem - ah * W;
  }
  // this thread's B row (output channel) and half, for tid < 128
  const int br = (tid & 127) >> 1, bhalf = tid & 1;
  const bool b_ok = tid < 128 && n0 + br < CO;

  auto load_a = [&](int kc) -> uint4 {
    uint4 out = make_uint4(0, 0, 0, 0);
    if (!am_ok) return out;
    const int k0 = kc * BK + ahalf * 16;
    if constexpr (VEC) {
      const int tap = (kc * BK) / CI;
      const int c0 = k0 - tap * CI;
      const int kh = tap / 3, kw = tap - kh * 3;
      const int hh = ah + kh - 1, ww = aw + kw - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) return out;
      const T* p = x + ((static_cast<long long>(ab) * H + hh) * W + ww) * CI +
                   c0;
      return quant16(p, inv_s);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j;
        if (k >= K) break;
        const int tap = k / CI;
        const int c = k - tap * CI;
        const int kh = tap / 3, kw = tap - kh * 3;
        const int hh = ah + kh - 1, ww = aw + kw - 1;
        if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
        const float v = to_f32(
            x[((static_cast<long long>(ab) * H + hh) * W + ww) * CI + c]);
        w[j >> 2] |= quant(v, inv_s) << (8 * (j & 3));
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
  auto load_b = [&](int kc) -> uint4 {
    if (!b_ok) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(
        wq + static_cast<long long>(n0 + br) * KP + kc * BK + bhalf * 16);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int wm0 = (warp & 3) * 32, wn0 = (warp >> 2) * 32;
  uint4 a_next = load_a(0), b_next = load_b(0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    *reinterpret_cast<uint4*>(&As[buf][ar * LDS + ahalf * 16]) = a_next;
    if (tid < 128) {
      *reinterpret_cast<uint4*>(&Bs[buf][br * LDS + bhalf * 16]) = b_next;
    }
    __syncthreads();
    if (kc + 1 < nk) {
      a_next = load_a(kc + 1);
      b_next = load_b(kc + 1);
    }
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = &As[buf][(wm0 + i * 16 + g) * LDS + t * 4];
      const uint8_t* r1 = r0 + 8 * LDS;
      af[i][0] = lds32(r0);
      af[i][1] = lds32(r1);
      af[i][2] = lds32(r0 + 16);
      af[i][3] = lds32(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* r = &Bs[buf][(wn0 + j * 8 + g) * LDS + t * 4];
      bf[j][0] = lds32(r);
      bf[j][1] = lds32(r + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + j * 8 + t * 2 + e;
      if (n >= CO) continue;
      const float sc = scale[n], bi = bias[n];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const long long m = m0 + wm0 + i * 16 + g + hi * 8;
          if (m >= M) continue;
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][hi * 2 + e]), sc), bi);
          store_out(y + m * CO + n, v);
        }
      }
    }
  }
}

template <typename T>
int launch(bool vec, const void* x, const void* wq, const void* scale,
           const void* bias, float inv_s, void* y, int B, int H, int W,
           int CI, int CO, int KP, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * H * W;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (CO + BN - 1) / BN);
  if (vec) {
    int8_conv_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        inv_s, static_cast<T*>(y), B, H, W, CI, CO, KP);
  } else {
    int8_conv_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        inv_s, static_cast<T*>(y), B, H, W, CI, CO, KP);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B,H,W,CO] (type code 0: f32, 1: bf16; x's type) from x [B,H,W,CI],
// the packed weights wq [CO,KP] int8, scale and bias [CO] f32 and inv_s.
// Returns the first CUDA error of the launch, or 0.
extern "C" int vo_int8_conv(int type_code, int B, int H, int W, int CI,
                            int CO, int KP, const void* x, const void* wq,
                            const void* scale, const void* bias, float inv_s,
                            void* y, void* stream) {
  if (B < 1 || H < 1 || W < 1 || CI < 1 || CO < 1 ||
      KP != (9 * CI + BK - 1) / BK * BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = CI % BK == 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return launch<float>(vec, x, wq, scale, bias, inv_s, y, B, H, W, CI,
                           CO, KP, s);
    case 1:
      return launch<__nv_bfloat16>(vec, x, wq, scale, bias, inv_s, y, B, H,
                                   W, CI, CO, KP, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
