// Pieces shared by the LSTM recurrence kernels (lstm_fwd.cu, lstm_bwd.cu,
// lstm_bi_stacked.cu): type conversions and roundings, the gate
// nonlinearities, and the per-step gate product
//   acc = round_to_W(h) @ wh          [TB rows x TJ units x 4 gates] per block
// with f32 accumulation, over shared-memory tiles of h and wh. The f32
// forward step and the stacked experiment's BPTT gate recompute run the
// same product; only the source of h differs (the f32 carry in the
// forward, the saved ys row of the scan predecessor in the backward).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vo_lstm {

constexpr int TB = 64;           // batch rows per block
constexpr int TJ = 16;           // hidden units per block (x4 gate columns)
constexpr int TK = 32;           // contraction chunk
constexpr int THREADS = 128;     // 16 row groups x 8 unit groups
constexpr int HS_LD = TB + 4;    // padded row of the transposed h tile
constexpr int H_LOADS = TB * TK / THREADS;      // h elements per thread/chunk
constexpr int W_LOADS = TK * 4 * TJ / THREADS;  // wh elements per thread/chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the type T and back to f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// four values rounded to the type T and back to f32 (no-op for float)
template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z),
                     round_to<T>(v.w));
}
template <>
__device__ __forceinline__ float4 round4<float>(float4 v) {
  return v;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the gate nonlinearities on the hardware exp2 and reciprocal units (the
// bf16-weight kernels): absolute error about 1e-6 against sigmoid and tanh
// in f32, far inside one bf16 ulp of the values the next product takes
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.0f * sigmoid_fast(2.0f * x) - 1.0f;
}

// the current device's SM count (0 when it cannot be read), cached a
// device
inline int device_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

struct Tiles {
  float hs[TK][HS_LD];   // h tile, transposed
  float ws[TK][4 * TJ];  // wh tile: 4 gates x TJ
};

// acc[r][s][g] = sum_k round_W(h[b][k]) * wh[k][g*H + j] for the thread's
// rows b = b0 + 4*tr + r and units j = j0 + 2*tu + s (tr = tid / 8,
// tu = tid % 8). h is [B, H] row-major in the type HT. The next K chunk
// is loaded into registers while the current one is multiplied, and
// converted (HT -> f32, rounding to R) only when stored to shared memory,
// so the loads stay in flight during the FMAs. R is the type h is rounded
// to: W, or bf16 where bf16 weights come widened to f32 (W = float).
template <typename HT, typename W, typename R = W>
__device__ __forceinline__ void gate_product(
    float (&acc)[4][2][4], const HT* __restrict__ h, const W* __restrict__ wh,
    int B, int H, int b0, int j0, Tiles& sm) {
  const int tid = threadIdx.x;
  const int tu = tid % 8;
  const int tr = tid / 8;
  const long long G = 4LL * H;
  // this thread's share of each chunk: h element (b0 + hb + 4i, k0 + hk),
  // wh element (k0 + wk + 2i, gate wg, unit j0 + wj)
  const int hk = tid % TK, hb = tid / TK;
  const int wcol = tid % (4 * TJ), wk = tid / (4 * TJ);
  const int wg = wcol / TJ, wj = wcol % TJ;

  HT hreg[H_LOADS];
  W wreg[W_LOADS];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < H_LOADS; ++i) {
      const int b = b0 + hb + (THREADS / TK) * i, k = k0 + hk;
      hreg[i] = (b < B && k < H) ? h[(long long)b * H + k] : from_f32<HT>(0.0f);
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int k = k0 + wk + (THREADS / (4 * TJ)) * i, j = j0 + wj;
      wreg[i] = (k < H && j < H) ? wh[(long long)k * G + (long long)wg * H + j]
                                 : from_f32<W>(0.0f);
    }
  };

  load_chunk(0);
  for (int k0 = 0; k0 < H; k0 += TK) {
#pragma unroll
    for (int i = 0; i < H_LOADS; ++i) {
      // h rounded to the compute type, as the reference rounds h to the
      // compute dtype before the product
      sm.hs[hk][hb + (THREADS / TK) * i] = round_to<R>(to_f32(hreg[i]));
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      sm.ws[wk + (THREADS / (4 * TJ)) * i][wcol] = to_f32(wreg[i]);
    }
    __syncthreads();
    if (k0 + TK < H) load_chunk(k0 + TK);  // in flight during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.hs[kk][4 * tr]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 w =
            *reinterpret_cast<const float2*>(&sm.ws[kk][g * TJ + 2 * tu]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0][g] = fmaf(av[r], w.x, acc[r][0][g]);
          acc[r][1][g] = fmaf(av[r], w.y, acc[r][1][g]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace vo_lstm
