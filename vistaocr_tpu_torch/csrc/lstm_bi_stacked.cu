// Direction-stacked BLSTM layer: both directions as the two planes of one
// [T, 2, B, *] layout, the recurrence (K6a) and its BPTT (K6b).
//
// Replaces experiments/lstm_bi_stacked.py::_bi_fwd_kernel (K6a,
// vo_bi_lstm_fwd) and ::_bi_bwd_kernel (K6b, vo_bi_lstm_bwd).
//
// The layout: xw [T,2,B,4H], ys and cs [T,2,B,H], dys [T,2,B,H] and dxw
// [T,2,B,4H] are float32; mask [T,2,B] float32 with a mask of its own per
// plane; wh [2,H,4H] in the compute type W (float or bf16). Plane 0 is the
// forward direction, plane 1 the backward one with its inputs flipped in
// time by the caller (its padding comes FIRST in its time order), so both
// planes walk t = 0..T-1 with the same math. Per plane p, h0 = c0 = 0:
//   gates = xw[t,p] + round_W(h) @ wh[p]                 (f32 accumulation)
//   c' = f*c + i*g,  h' = o*tanh(c'),  h = m*h' + (1-m)*h,  c likewise
//   ys[t,p] = h,  cs[t,p] = c                            (float32)
// and the BPTT, t = T-1..0, h_prev = ys[t-1,p], c_prev = cs[t-1,p] (zero
// at t = 0), dh = dc = 0 at the start:
//   dh_t = dh + dys[t,p];  dc_t = dc + dh_t*o*(1 - tanh(c_t)^2)
//   dxw[t,p] = [dc_t*g*i*(1-i), dc_t*c_prev*f*(1-f), dc_t*i*(1-g^2),
//               dh_t*tanh(c_t)*o*(1-o)] * m              (float32)
//   dh = round_W(dxw[t,p]) @ wh[p]^T + (1-m)*dh_t;  dc = m*dc_t*f + (1-m)*dc
//   dwh[p] = sum_t round_W(h_prev)^T @ round_W(dxw[t,p])  (float32)
//
// What bounds it on an H100: as the single-direction kernels (lstm_fwd.cu,
// lstm_bwd.cu), T strictly sequential frames of a [B,H] x [H,4H] product
// each, far too little work per frame to fill the card: each frame is
// latency-bound (a launch, a pass over wh from L2, a reduction over H or
// 4H). dwh is the one large product: H x 4H x (T-1)*B per plane.
//
// What this design does about it (the simple form; tensor cores and a
// persistent kernel are later work):
// - the plane is blockIdx.z, so one launch per frame runs both directions;
//   each block owns TJ units x TB rows of one plane and all four gate
//   columns of its units, with the gate product of lstm_common.cuh;
// - the forward keeps no carry of its own: ys and cs are float32 here, so
//   frame t reads h and c of frame t-1 straight from ys and cs, and needs
//   no ping-pong scratch;
// - the BPTT's dh product needs all 4H gate columns of a row, which other
//   blocks write, so a frame is two launches on one stream (bi_bwd_gates,
//   then bi_bwd_dh); the dh and dc carries [2,B,H] are updated in place,
//   one owner thread per element;
// - the TPU sums dwh frame by frame inside its loop; here it is one
//   product over (T-1)*B rows per plane after the loop (bi_dwh), the same
//   sum in another order.
// Ragged B and H edges are masked in the kernels, so any B, T, H >= 1.

#include <climits>

#include "lstm_common.cuh"

namespace {

using namespace vo_lstm;

// first row of plane p at frame t in a [T, 2, B, *] tensor
__device__ __forceinline__ long long plane_row(int t, int p, int B) {
  return ((long long)t * 2 + p) * B;
}

template <typename W>
struct BiArgs {
  const float* xw;    // [T, 2, B, 4H]
  const float* mask;  // [T, 2, B]
  const W* wh;        // [2, H, 4H]
  const float* dys;   // [T, 2, B, H] (BPTT)
  float* ys;          // [T, 2, B, H] (written by the forward)
  float* cs;          // [T, 2, B, H] (written by the forward)
  float* dxw;         // [T, 2, B, 4H] (BPTT)
  float* dh;          // [2, B, H] carry (BPTT)
  float* dc;          // [2, B, H] carry (BPTT)
};

__device__ __forceinline__ void zero(float (&acc)[4][2][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][s][g] = 0.0f;
}

// K6a, frame t of both planes.
template <typename W>
__global__ void __launch_bounds__(THREADS)
bi_fwd_step(BiArgs<W> a, int t, int B, int H) {
  __shared__ __align__(16) Tiles sm;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tu = tid % 8, tr = tid / 8;
  const int j0 = blockIdx.x * TJ, b0 = blockIdx.y * TB;
  const long long G = 4LL * H;
  const long long row = plane_row(t, p, B);
  const long long prev = t > 0 ? plane_row(t - 1, p, B) : 0;

  float acc[4][2][4];
  zero(acc);
  if (t > 0) {  // block-uniform: h0 = 0
    gate_product<float, W>(acc, a.ys + prev * H, a.wh + p * H * G, B, H, b0,
                           j0, sm);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * tr + r;
    if (b >= B) continue;
    const float m = a.mask[row + b];
    const float* x = a.xw + (row + b) * G;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = j0 + 2 * tu + s;
      if (j >= H) continue;
      const float i = sigmoid_f32(x[j] + acc[r][s][0]);
      const float f = sigmoid_f32(x[H + j] + acc[r][s][1]);
      const float g = tanhf(x[2 * H + j] + acc[r][s][2]);
      const float o = sigmoid_f32(x[3 * H + j] + acc[r][s][3]);
      const float c_old = t > 0 ? a.cs[(prev + b) * H + j] : 0.0f;
      const float h_old = t > 0 ? a.ys[(prev + b) * H + j] : 0.0f;
      const float c_new = f * c_old + i * g;
      const float h_new = o * tanhf(c_new);
      a.ys[(row + b) * H + j] = m * h_new + (1.0f - m) * h_old;
      a.cs[(row + b) * H + j] = m * c_new + (1.0f - m) * c_old;
    }
  }
}

// K6b phase 1 of frame t: gate recompute, dxw[t], dc carry.
template <typename W>
__global__ void __launch_bounds__(THREADS)
bi_bwd_gates(BiArgs<W> a, int t, int B, int H) {
  __shared__ __align__(16) Tiles sm;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tu = tid % 8, tr = tid / 8;
  const int j0 = blockIdx.x * TJ, b0 = blockIdx.y * TB;
  const long long G = 4LL * H;
  const long long row = plane_row(t, p, B);
  const long long prev = t > 0 ? plane_row(t - 1, p, B) : 0;

  float acc[4][2][4];
  zero(acc);
  if (t > 0) {
    gate_product<float, W>(acc, a.ys + prev * H, a.wh + p * H * G, B, H, b0,
                           j0, sm);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * tr + r;
    if (b >= B) continue;
    const float m = a.mask[row + b];
    const float* x = a.xw + (row + b) * G;
    float* dx = a.dxw + (row + b) * G;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = j0 + 2 * tu + s;
      if (j >= H) continue;
      const float i = sigmoid_f32(x[j] + acc[r][s][0]);
      const float f = sigmoid_f32(x[H + j] + acc[r][s][1]);
      const float g = tanhf(x[2 * H + j] + acc[r][s][2]);
      const float o = sigmoid_f32(x[3 * H + j] + acc[r][s][3]);
      const float tc = tanhf(a.cs[(row + b) * H + j]);
      const float c_prev = t > 0 ? a.cs[(prev + b) * H + j] : 0.0f;
      const long long idx = ((long long)p * B + b) * H + j;
      const float dh = a.dh[idx] + a.dys[(row + b) * H + j];
      const float dc = a.dc[idx];
      const float dc_t = dc + dh * o * (1.0f - tc * tc);
      dx[j] = (dc_t * g) * i * (1.0f - i) * m;
      dx[H + j] = (dc_t * c_prev) * f * (1.0f - f) * m;
      dx[2 * H + j] = (dc_t * i) * (1.0f - g * g) * m;
      dx[3 * H + j] = (dh * tc) * o * (1.0f - o) * m;
      a.dc[idx] = m * (dc_t * f) + (1.0f - m) * dc;
    }
  }
}

// K6b phase 2 of frame t: dh = round_W(dxw[t]) @ wh^T + (1-m)*(dh + dys[t]).
// Block tile RB rows x RU units, 128 threads of 2 rows x 4 units each,
// contraction over the 4H gate columns in chunks of RK.
constexpr int RB = 32;
constexpr int RU = 32;
constexpr int RK = 32;
constexpr int DS_LD = RB + 2;  // transposed dgates tile row (float2 reads)
constexpr int WT_LD = RU + 4;  // transposed wh tile row (float4 reads)

template <typename W>
__global__ void __launch_bounds__(THREADS)
bi_bwd_dh(BiArgs<W> a, int t, int B, int H) {
  __shared__ __align__(16) float ds[RK][DS_LD];  // ds[g][b]
  __shared__ __align__(16) float wt[RK][WT_LD];  // wt[g][k] = wh[p][k][g]
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tu = tid % 8;  // units 4*tu .. 4*tu+3 of the tile
  const int tr = tid / 8;  // rows 2*tr, 2*tr+1 of the tile
  const int k0 = blockIdx.x * RU;
  const int b0 = blockIdx.y * RB;
  const int G = 4 * H;
  const long long row = plane_row(t, p, B);
  const float* dg = a.dxw + row * G;
  const W* wh = a.wh + (long long)p * H * G;
  const int lg = tid % RK, lr = tid / RK;  // load mapping

  float acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.0f;

  for (int g0 = 0; g0 < G; g0 += RK) {
    const int g = g0 + lg;
#pragma unroll
    for (int i = 0; i < RB / (THREADS / RK); ++i) {
      const int b = b0 + lr + (THREADS / RK) * i;
      ds[lg][lr + (THREADS / RK) * i] =
          (b < B && g < G) ? round_to<W>(dg[(long long)b * G + g]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RU / (THREADS / RK); ++i) {
      const int k = k0 + lr + (THREADS / RK) * i;
      wt[lg][lr + (THREADS / RK) * i] =
          (k < H && g < G) ? to_f32(wh[(long long)k * G + g]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < RK; ++kk) {
      const float2 d2 = *reinterpret_cast<const float2*>(&ds[kk][2 * tr]);
      const float4 w = *reinterpret_cast<const float4*>(&wt[kk][4 * tu]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[0][u] = fmaf(d2.x, wv[u], acc[0][u]);
        acc[1][u] = fmaf(d2.y, wv[u], acc[1][u]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + 2 * tr + r;
    if (b >= B) continue;
    const float m = a.mask[row + b];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 4 * tu + u;
      if (k >= H) continue;
      const long long idx = ((long long)p * B + b) * H + k;
      const float dh = a.dh[idx] + a.dys[(row + b) * H + k];
      a.dh[idx] = acc[r][u] + (1.0f - m) * dh;
    }
  }
}

// dwh[p][k][g] = sum over frames t >= 1 and rows b of
// round_W(ys[t-1,p,b,k]) * round_W(dxw[t,p,b,g]): R = (T-1)*B rows per
// plane, row r = (t-1)*B + b. Block tile 64 x 64 of dwh, 256 threads of
// 4 x 4, chunks of DK rows.
constexpr int DM = 64;
constexpr int DN = 64;
constexpr int DK = 16;
constexpr int DTHREADS = 256;

template <typename W>
__global__ void __launch_bounds__(DTHREADS)
bi_dwh(const float* __restrict__ ys, const float* __restrict__ dxw,
       float* __restrict__ dwh, int T, int B, int H) {
  __shared__ __align__(16) float as[DK][DM];
  __shared__ __align__(16) float cs[DK][DN];
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid / 16;  // dwh rows 4*tm .. 4*tm+3 of the tile
  const int tn = tid % 16;  // dwh cols 4*tn .. 4*tn+3 of the tile
  const int m0 = blockIdx.y * DM;
  const int n0 = blockIdx.x * DN;
  const int G = 4 * H;
  const int R = (T - 1) * B;  // < 2^31, checked by vo_bi_lstm_bwd
  const int lc = tid % DM, lr = tid / DM;  // load mapping

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += DK) {
#pragma unroll
    for (int i = 0; i < DK / (DTHREADS / DM); ++i) {
      const int kr = lr + (DTHREADS / DM) * i;
      const int r = r0 + kr;
      const int k = m0 + lc, g = n0 + lc;
      float av = 0.0f, cv = 0.0f;
      if (r < R) {  // 32-bit division: a 64-bit one is emulated
        const int t = r / B + 1;
        const int b = r - (t - 1) * B;
        if (k < H) av = round_to<W>(ys[(plane_row(t - 1, p, B) + b) * H + k]);
        if (g < G) cv = round_to<W>(dxw[(plane_row(t, p, B) + b) * G + g]);
      }
      as[kr][lc] = av;
      cs[kr][lc] = cv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][4 * tm]);
      const float4 c4 = *reinterpret_cast<const float4*>(&cs[kk][4 * tn]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = dwh + (long long)p * H * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + 4 * tm + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = n0 + 4 * tn + j;
      if (g < G) out[(long long)k * G + g] = acc[i][j];
    }
  }
}

template <typename W>
int run_fwd(int T, int B, int H, const BiArgs<W>& a, cudaStream_t s) {
  const dim3 grid((H + TJ - 1) / TJ, (B + TB - 1) / TB, 2);
  for (int t = 0; t < T; ++t) {
    bi_fwd_step<W><<<grid, THREADS, 0, s>>>(a, t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename W>
int run_bwd(int T, int B, int H, const BiArgs<W>& a, float* dwh,
            cudaStream_t s) {
  const dim3 grid_g((H + TJ - 1) / TJ, (B + TB - 1) / TB, 2);
  const dim3 grid_h((H + RU - 1) / RU, (B + RB - 1) / RB, 2);
  for (int t = T - 1; t >= 0; --t) {
    bi_bwd_gates<W><<<grid_g, THREADS, 0, s>>>(a, t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t == 0) break;  // the carry after the first frame is not used
    bi_bwd_dh<W><<<grid_h, THREADS, 0, s>>>(a, t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_w((4 * H + DN - 1) / DN, (H + DM - 1) / DM, 2);
  bi_dwh<W><<<grid_w, DTHREADS, 0, s>>>(a.ys, a.dxw, dwh, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
BiArgs<W> args(const void* xw, const void* mask, const void* wh,
               const void* dys, void* ys, void* cs, void* dxw, void* scratch,
               int B, int H) {
  BiArgs<W> a;
  a.xw = static_cast<const float*>(xw);
  a.mask = static_cast<const float*>(mask);
  a.wh = static_cast<const W*>(wh);
  a.dys = static_cast<const float*>(dys);
  a.ys = static_cast<float*>(ys);
  a.cs = static_cast<float*>(cs);
  a.dxw = static_cast<float*>(dxw);
  a.dh = static_cast<float*>(scratch);
  a.dc = a.dh == nullptr ? nullptr : a.dh + 2LL * B * H;
  return a;
}

}  // namespace

// K6a: the recurrence of both planes. w_type: 0 = wh float32, 1 = wh bf16
// (the compute type h is rounded to). Writes ys, cs [T,2,B,H] float32.
// Returns the first non-zero cudaGetLastError() after a launch, or 0.
extern "C" int vo_bi_lstm_fwd(int w_type, int T, int B, int H, const void* xw,
                              const void* mask, const void* wh, void* ys,
                              void* cs, void* stream) {
  if (T < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_type) {
    case 0:
      return run_fwd<float>(T, B, H, args<float>(xw, mask, wh, nullptr, ys,
                                                 cs, nullptr, nullptr, B, H),
                            s);
    case 1:
      return run_fwd<__nv_bfloat16>(
          T, B, H, args<__nv_bfloat16>(xw, mask, wh, nullptr, ys, cs, nullptr,
                                       nullptr, B, H), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6b: the BPTT of both planes from the forward's ys and cs. w_type as
// vo_bi_lstm_fwd. scratch: [2, 2, B, H] float32, zeroed by the caller (dh,
// dc carries). Writes dxw [T,2,B,4H] and dwh [2,H,4H] float32 (every
// element; dwh is zero when T = 1).
extern "C" int vo_bi_lstm_bwd(int w_type, int T, int B, int H, const void* xw,
                              const void* mask, const void* wh,
                              const void* ys, const void* cs, const void* dys,
                              void* dxw, void* dwh, void* scratch,
                              void* stream) {
  if (T < 1 || B < 1 || H < 1 || (long long)(T - 1) * B > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* y = const_cast<void*>(ys);  // read only in the BPTT
  void* c = const_cast<void*>(cs);
  float* w = static_cast<float*>(dwh);
  switch (w_type) {
    case 0:
      return run_bwd<float>(T, B, H, args<float>(xw, mask, wh, dys, y, c, dxw,
                                                 scratch, B, H), w, s);
    case 1:
      return run_bwd<__nv_bfloat16>(
          T, B, H, args<__nv_bfloat16>(xw, mask, wh, dys, y, c, dxw, scratch,
                                       B, H), w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
