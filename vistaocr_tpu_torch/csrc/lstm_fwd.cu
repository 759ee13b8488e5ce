// Masked LSTM recurrence over precomputed gate inputs, inference form.
//
// Replaces vistaocr_tpu/ops/lstm_pallas.py::_fwd_kernel with
// save_cell=False (the form lstm_recurrence_pallas runs at inference),
// in both directions.
//
// What it computes, per direction, with h0 = c0 = 0 and t walking
// 0..T-1 (T-1..0 when reverse):
//   gates = f32(xw[t]) + round_to_W(h) @ wh        (f32 accumulation)
//   i, f, o = sigmoid(.), g = tanh(.)              (i, f, g, o columns)
//   c' = f*c + i*g,  h' = o*tanh(c')
//   h = m*h' + (1-m)*h,  c = m*c' + (1-m)*c        (m = mask[t, b])
//   ys[t] = h in the stream type
// xw [T,B,4H] and ys [T,B,H] are in the stream type S (float or bf16),
// wh [H,4H] in the weight type W (float or bf16), mask [T,B] float. The
// carry (h, c) and all gate math stay float32.
//
// What bounds it on an H100: T strictly sequential steps. Each step
// re-reads all of wh (2 MiB in bf16, 4 MiB in f32; it stays resident in
// the 50 MB L2 across steps) plus [B,4H] of xw, and does one
// [B,H] x [H,4H] product: about 0.27 GFLOP at B=128, H=512. That is far
// too little work per step to fill the card's tensor cores or its memory
// bandwidth, so each step is latency-bound (launch, one pass over wh
// from L2, one reduction over H), not FLOP- or HBM-bound.
//
// What this design does about it (the simple form; mma/wgmma, persistent
// blocks that keep wh slices in shared memory across steps, and clusters
// exchanging h through distributed shared memory are later work):
// - one launch per step on the caller's stream, both directions of a
//   BLSTM layer in the same launch (blockIdx.z), so each launch fills
//   about one block per SM at the flagship shape (32 unit tiles x 2
//   batch tiles x 2 directions = 128 blocks of 128 threads);
// - each block owns TJ hidden units and TB batch rows and computes all
//   four gate columns {j, H+j, 2H+j, 3H+j} of its units, so the gate
//   math, the mask freeze and the ys store are the product's epilogue:
//   the [B,4H] gate pre-activations never leave registers;
// - the product runs over shared-memory tiles of h (rounded to W, as
//   the reference rounds h to the compute dtype) and wh, with f32 FMA
//   into a 4 rows x 2 units x 4 gates register tile per thread, fed by
//   one 128-bit and four 64-bit shared loads per 32 FMAs (a 2 x 2 x 4
//   tile was bound by shared-memory bandwidth and took 1.8x as long);
// - the next K chunk is loaded into registers while the current one is
//   multiplied, and converted (bf16 -> f32, h rounding) only when stored
//   to shared memory: converting right after the load made every bf16
//   load wait, and the bf16 kernel took 2x as long as the f32 one;
// - h ping-pongs between two f32 buffers (every block reads all of h of
//   step t-1 while writing its slice of step t); each c[b, j] is owned by
//   one thread and updated in place.
// Ragged B and H edges are masked in the kernel, so any B, T, H >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename S, typename W>
struct Dir {
  const S* xw;        // [T, B, 4H]
  const W* wh;        // [H, 4H]
  S* ys;              // [T, B, H]
  const float* h_in;  // [B, H] state after the previous step
  float* h_out;       // [B, H] state after this step
  float* c;           // [B, H] cell state, updated in place
  int t;              // frame index this step processes
};

template <typename S, typename W>
__global__ void __launch_bounds__(THREADS)
lstm_step(Dir<S, W> d0, Dir<S, W> d1, const float* __restrict__ mask,
          int B, int H) {
  const Dir<S, W> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) float hs[TK][HS_LD];    // h tile, transposed
  __shared__ __align__(16) float ws[TK][4 * TJ];   // wh tile: 4 gates x TJ

  const int tid = threadIdx.x;
  const int tu = tid % 8;   // unit group: units 2*tu, 2*tu+1 of the tile
  const int tr = tid / 8;   // row group: rows 4*tr .. 4*tr+3 of the tile
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const long long G = 4LL * H;
  // this thread's share of each chunk: h element (b0 + hb + 4i, k0 + hk),
  // wh element (k0 + wk + 2i, gate wg, unit j0 + wj)
  const int hk = tid % TK, hb = tid / TK;
  const int wcol = tid % (4 * TJ), wk = tid / (4 * TJ);
  const int wg = wcol / TJ, wj = wcol % TJ;

  float acc[4][2][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][s][g] = 0.0f;

  // Prefetched raw values of the next chunk. They are converted only when
  // stored to shared memory, after the FMAs, so the loads stay in flight
  // while the current chunk is multiplied.
  float hreg[H_LOADS];
  W wreg[W_LOADS];
#define VO_LOAD_CHUNK(k0)                                                   \
  {                                                                         \
    _Pragma("unroll") for (int i = 0; i < H_LOADS; ++i) {                  \
      const int b = b0 + hb + (THREADS / TK) * i, k = (k0) + hk;          \
      hreg[i] = (b < B && k < H) ? d.h_in[(long long)b * H + k] : 0.0f;   \
    }                                                                       \
    _Pragma("unroll") for (int i = 0; i < W_LOADS; ++i) {                  \
      const int k = (k0) + wk + (THREADS / (4 * TJ)) * i, j = j0 + wj;    \
      wreg[i] = (k < H && j < H)                                           \
          ? d.wh[(long long)k * G + (long long)wg * H + j]                 \
          : from_f32<W>(0.0f);                                             \
    }                                                                       \
  }

  VO_LOAD_CHUNK(0)
  for (int k0 = 0; k0 < H; k0 += TK) {
#pragma unroll
    for (int i = 0; i < H_LOADS; ++i) {
      // h rounded to the weight type, as the reference rounds h to the
      // compute dtype before the product
      hs[hk][hb + (THREADS / TK) * i] = to_f32(from_f32<W>(hreg[i]));
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      ws[wk + (THREADS / (4 * TJ)) * i][wcol] = to_f32(wreg[i]);
    }
    __syncthreads();
    if (k0 + TK < H) VO_LOAD_CHUNK(k0 + TK)  // in flight during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][4 * tr]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 w =
            *reinterpret_cast<const float2*>(&ws[kk][g * TJ + 2 * tu]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0][g] = fmaf(av[r], w.x, acc[r][0][g]);
          acc[r][1][g] = fmaf(av[r], w.y, acc[r][1][g]);
        }
      }
    }
    __syncthreads();
  }
#undef VO_LOAD_CHUNK

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * tr + r;
    if (b >= B) continue;
    const float m = mask[(long long)d.t * B + b];
    const S* x = d.xw + ((long long)d.t * B + b) * G;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = j0 + 2 * tu + s;
      if (j >= H) continue;
      const float gi = to_f32(x[j]) + acc[r][s][0];
      const float gf = to_f32(x[H + j]) + acc[r][s][1];
      const float gg = to_f32(x[2 * H + j]) + acc[r][s][2];
      const float go = to_f32(x[3 * H + j]) + acc[r][s][3];
      const float i = sigmoid_f32(gi);
      const float f = sigmoid_f32(gf);
      const float g = tanhf(gg);
      const float o = sigmoid_f32(go);
      const long long idx = (long long)b * H + j;
      const float c_old = d.c[idx];
      const float h_old = d.h_in[idx];
      const float c_new = f * c_old + i * g;
      const float h_new = o * tanhf(c_new);
      const float h = m * h_new + (1.0f - m) * h_old;
      const float c = m * c_new + (1.0f - m) * c_old;
      d.c[idx] = c;
      d.h_out[idx] = h;
      d.ys[((long long)d.t * B + b) * H + j] = from_f32<S>(h);
    }
  }
}

template <typename S, typename W>
int run(int T, int B, int H, int ndir, const float* mask,
        const void* const* xw, const void* const* wh, void* const* ys,
        float* const* scratch, const int* reverse, cudaStream_t stream) {
  Dir<S, W> d[2];
  const long long BH = (long long)B * H;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const W*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].c = scratch[i] + 2 * BH;
  }
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB, ndir);
  for (int step = 0; step < T; ++step) {
    for (int i = 0; i < ndir; ++i) {
      float* h_a = scratch[i];
      float* h_b = scratch[i] + BH;
      d[i].h_in = (step % 2 == 0) ? h_a : h_b;
      d[i].h_out = (step % 2 == 0) ? h_b : h_a;
      d[i].t = reverse[i] ? T - 1 - step : step;
    }
    if (ndir == 1) d[1] = d[0];
    lstm_step<S, W><<<grid, THREADS, 0, stream>>>(d[0], d[1], mask, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// One call runs the whole recurrence of one or two directions that share
// T, B, H, the types and the mask (the two directions of a BLSTM layer).
// type_code: 0 = S f32 / W f32, 1 = S bf16 / W bf16, 2 = S f32 / W bf16,
// 3 = S bf16 / W f32. scratch{0,1}: [3, B, H] f32, zeroed by the caller
// (h ping, h pong, c). Returns the first non-zero cudaGetLastError() after
// a launch, or 0.
extern "C" int vo_lstm_fwd(int type_code, int T, int B, int H, int ndir,
                           const void* mask,
                           const void* xw0, const void* wh0, void* ys0,
                           void* scratch0, int reverse0,
                           const void* xw1, const void* wh1, void* ys1,
                           void* scratch1, int reverse1, void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* xw[2] = {xw0, xw1};
  const void* wh[2] = {wh0, wh1};
  void* ys[2] = {ys0, ys1};
  float* scratch[2] = {static_cast<float*>(scratch0),
                       static_cast<float*>(scratch1)};
  const int reverse[2] = {reverse0, reverse1};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run<float, float>(T, B, H, ndir, m, xw, wh, ys, scratch, reverse, s);
    case 1:
      return run<__nv_bfloat16, __nv_bfloat16>(T, B, H, ndir, m, xw, wh, ys,
                                               scratch, reverse, s);
    case 2:
      return run<float, __nv_bfloat16>(T, B, H, ndir, m, xw, wh, ys, scratch,
                                       reverse, s);
    case 3:
      return run<__nv_bfloat16, float>(T, B, H, ndir, m, xw, wh, ys, scratch,
                                       reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
