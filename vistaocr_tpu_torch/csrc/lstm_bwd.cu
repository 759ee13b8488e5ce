// BPTT of the masked LSTM recurrence, both directions.
//
// Replaces vistaocr_tpu/ops/lstm_pallas.py::_bwd_kernel (forward
// direction) and ::_bwd_kernel_rev (reverse direction), with their shared
// frame _bptt_frame: one code path, the direction a flag, both directions
// of a BLSTM layer in one launch (blockIdx.z), as lstm_fwd.cu does.
//
// What it computes, per direction, walking the forward scan's order
// backwards (t = T-1..0 for the forward direction, 0..T-1 for the reverse
// one), with dh = dc = 0 at the start and tp the scan predecessor of t
// (t-1, or t+1 in reverse; none at the edge, where h_prev = c_prev = 0):
//   gates  = f32(xw[t]) + round_W(ys[tp]) @ wh      (recomputed, f32 acc)
//   i, f, g, o from gates;  tc = tanh(f32(cs[t]));  m = mask[t, b]
//   dh_t   = dh + f32(dys[t]);  dc_t = dc + dh_t*o*(1 - tc^2)
//   dxw[t] = S([dc_t*g*i*(1-i), dc_t*c_prev*f*(1-f), dc_t*i*(1-g^2),
//               dh_t*tc*o*(1-o)] * m)
//   dh     = round_W(dxw[t]) @ wh^T + (1-m)*dh_t
//   dc     = m*dc_t*f + (1-m)*dc
// and, after the loop (vo_lstm_dwh),
//   dwh    = sum_t round_W(ys[tp])^T @ round_W(dxw[t])   (f32)
// xw, dxw [T,B,4H], ys, cs, dys [T,B,H] are in the stream type S (float or
// bf16), wh [H,4H] in the weight type W; the carries dh, dc and dwh are
// float32. h_prev is read from the SAVED stream-type ys row and rounded to
// W, as the reference does (no f32 carry of h in the backward).
//
// What bounds it on an H100: like the forward, T strictly sequential
// frames of too little work each ([B,H] x [H,4H] for the gate recompute,
// [B,4H] x [4H,H] for dh), so each frame is latency-bound: two launches,
// two passes over wh from L2 (it stays resident), and a reduction over H
// and over 4H. The dwh sum is the one large product of the backward:
// H x 4H x (T-1)*B multiply-adds, about 34 GFLOP per direction at T=512,
// B=32, H=512, compute-bound on the f32 FMA units in this simple form.
//
// What this design does about it (the simple form; tensor-core products,
// a persistent kernel with a grid-wide barrier instead of two launches per
// frame, and a split-K dwh are later work):
// - Frame t's dh product needs all 4H gate columns of a row, which other
//   blocks compute, so each frame is two launches on one stream (stream
//   order is the barrier): bptt_gates recomputes the gates with the
//   forward's tiled product (lstm_common.cuh) and writes dxw[t] and the
//   dc carry in its epilogue; bptt_dh multiplies the stream-rounded dxw[t]
//   by wh^T and writes the dh carry in its epilogue. Each carry element
//   belongs to one thread of each launch, so both are updated in place.
// - dwh is not summed frame by frame as on the TPU (where the kernel keeps
//   it in VMEM across the grid): it is one product over K = (T-1)*B rows
//   after the loop, taking ys and dxw at a one-frame offset (the rows of
//   the edge frame, whose h_prev is zero, are left out). That is the same
//   sum in another order, in f32.
// Ragged B and H edges are masked in the kernels, so any B, T, H >= 1.

#include "lstm_common.cuh"

namespace {

using namespace vo_lstm;

template <typename S, typename W>
struct BwdDir {
  const S* xw;    // [T, B, 4H]
  const W* wh;    // [H, 4H]
  const S* ys;    // [T, B, H]
  const S* cs;    // [T, B, H]
  const S* dys;   // [T, B, H]
  S* dxw;         // [T, B, 4H]
  float* dh;      // [B, H] carry, updated in place
  float* dc;      // [B, H] carry, updated in place
  int t;          // frame this step processes
  int tp;         // its scan predecessor, or -1 at the edge
};

// Phase 1 of a frame: gate recompute, dgates, dc carry.
template <typename S, typename W>
__global__ void __launch_bounds__(THREADS)
bptt_gates(BwdDir<S, W> d0, BwdDir<S, W> d1, const float* __restrict__ mask,
           int B, int H) {
  const BwdDir<S, W> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) Tiles sm;

  const int tid = threadIdx.x;
  const int tu = tid % 8;
  const int tr = tid / 8;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const long long G = 4LL * H;
  const long long BH = (long long)B * H;

  float acc[4][2][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][s][g] = 0.0f;
  if (d.tp >= 0) {  // block-uniform: the edge frame's h_prev is zero
    gate_product<S, W>(acc, d.ys + d.tp * BH, d.wh, B, H, b0, j0, sm);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * tr + r;
    if (b >= B) continue;
    const float m = mask[(long long)d.t * B + b];
    const long long row = (long long)d.t * B + b;
    const S* x = d.xw + row * G;
    S* dx = d.dxw + row * G;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = j0 + 2 * tu + s;
      if (j >= H) continue;
      const float i = sigmoid_f32(to_f32(x[j]) + acc[r][s][0]);
      const float f = sigmoid_f32(to_f32(x[H + j]) + acc[r][s][1]);
      const float g = tanhf(to_f32(x[2 * H + j]) + acc[r][s][2]);
      const float o = sigmoid_f32(to_f32(x[3 * H + j]) + acc[r][s][3]);
      const long long idx = (long long)b * H + j;
      const float tc = tanhf(to_f32(d.cs[row * H + j]));
      const float c_prev =
          d.tp >= 0 ? to_f32(d.cs[((long long)d.tp * B + b) * H + j]) : 0.0f;
      const float dh = d.dh[idx] + to_f32(d.dys[row * H + j]);
      const float dc = d.dc[idx];
      const float dout = dh * tc;
      const float dc_t = dc + dh * o * (1.0f - tc * tc);
      dx[j] = from_f32<S>((dc_t * g) * i * (1.0f - i) * m);
      dx[H + j] = from_f32<S>((dc_t * c_prev) * f * (1.0f - f) * m);
      dx[2 * H + j] = from_f32<S>((dc_t * i) * (1.0f - g * g) * m);
      dx[3 * H + j] = from_f32<S>(dout * o * (1.0f - o) * m);
      d.dc[idx] = m * (dc_t * f) + (1.0f - m) * dc;
    }
  }
}

// Phase 2 of a frame: dh = round_W(dxw[t]) @ wh^T + (1-m)*(dh + dys[t]).
// Block tile RB rows x RU units, 128 threads of 2 rows x 4 units each,
// contraction over the 4H gate columns in chunks of RK.
constexpr int RB = 32;
constexpr int RU = 32;
constexpr int RK = 32;
constexpr int DS_LD = RB + 2;  // transposed dgates tile row (float2 reads)
constexpr int WT_LD = RU + 4;  // transposed wh tile row (float4 reads)

template <typename S, typename W>
__global__ void __launch_bounds__(THREADS)
bptt_dh(BwdDir<S, W> d0, BwdDir<S, W> d1, const float* __restrict__ mask,
        int B, int H) {
  const BwdDir<S, W> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) float ds[RK][DS_LD];  // ds[g][b]
  __shared__ __align__(16) float wt[RK][WT_LD];  // wt[g][k] = wh[k][g]

  const int tid = threadIdx.x;
  const int tu = tid % 8;   // units 4*tu .. 4*tu+3 of the tile
  const int tr = tid / 8;   // rows 2*tr, 2*tr+1 of the tile
  const int k0 = blockIdx.x * RU;
  const int b0 = blockIdx.y * RB;
  const int G = 4 * H;
  const S* dg = d.dxw + (long long)d.t * B * G;
  // load mapping: column lg of the chunk, rows/units lr + 4*i
  const int lg = tid % RK, lr = tid / RK;

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
          (b < B && g < G) ? round_to<W>(to_f32(dg[(long long)b * G + g]))
                           : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RU / (THREADS / RK); ++i) {
      const int k = k0 + lr + (THREADS / RK) * i;
      wt[lg][lr + (THREADS / RK) * i] =
          (k < H && g < G) ? to_f32(d.wh[(long long)k * G + g]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < RK; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&ds[kk][2 * tr]);
      const float4 w = *reinterpret_cast<const float4*>(&wt[kk][4 * tu]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[0][u] = fmaf(a.x, wv[u], acc[0][u]);
        acc[1][u] = fmaf(a.y, wv[u], acc[1][u]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + 2 * tr + r;
    if (b >= B) continue;
    const float m = mask[(long long)d.t * B + b];
    const long long row = (long long)d.t * B + b;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 4 * tu + u;
      if (k >= H) continue;
      const long long idx = (long long)b * H + k;
      const float dh = d.dh[idx] + to_f32(d.dys[row * H + k]);
      d.dh[idx] = acc[r][u] + (1.0f - m) * dh;
    }
  }
}

// dwh[k][g] = sum_r round_W(a[r][k]) * round_W(c[r][g]) over R rows:
// a = ys rows of the predecessor frames, c = dxw rows of their successors.
// Block tile 64 x 64 of dwh, 256 threads of 4 x 4, K chunk 16 rows.
constexpr int DM = 64;
constexpr int DN = 64;
constexpr int DK = 16;
constexpr int DTHREADS = 256;

template <typename S, typename W>
struct DwhDir {
  const S* a;   // [R, H]
  const S* c;   // [R, 4H]
  float* out;   // [H, 4H]
};

template <typename S, typename W>
__global__ void __launch_bounds__(DTHREADS)
lstm_dwh(DwhDir<S, W> d0, DwhDir<S, W> d1, long long R, int H) {
  const DwhDir<S, W> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) float as[DK][DM];
  __shared__ __align__(16) float cs[DK][DN];

  const int tid = threadIdx.x;
  const int tm = tid / 16;  // dwh rows 4*tm .. 4*tm+3 of the tile
  const int tn = tid % 16;  // dwh cols 4*tn .. 4*tn+3 of the tile
  const int m0 = blockIdx.y * DM;
  const int n0 = blockIdx.x * DN;
  const int G = 4 * H;
  // load mapping: column lc of the tile, chunk rows lr + 4*i
  const int lc = tid % DM, lr = tid / DM;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long r0 = 0; r0 < R; r0 += DK) {
#pragma unroll
    for (int i = 0; i < DK / (DTHREADS / DM); ++i) {
      const int kr = lr + (DTHREADS / DM) * i;
      const long long r = r0 + kr;
      const int k = m0 + lc, g = n0 + lc;
      as[kr][lc] = (r < R && k < H)
                       ? round_to<W>(to_f32(d.a[r * H + k])) : 0.0f;
      cs[kr][lc] = (r < R && g < G)
                       ? round_to<W>(to_f32(d.c[r * G + g])) : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + 4 * tm + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = n0 + 4 * tn + j;
      if (g < G) d.out[(long long)k * G + g] = acc[i][j];
    }
  }
}

template <typename S, typename W>
int run_bptt(int T, int B, int H, int ndir, const float* mask,
             const void* const* xw, const void* const* wh,
             const void* const* ys, const void* const* cs,
             const void* const* dys, void* const* dxw,
             float* const* scratch, const int* reverse, cudaStream_t stream) {
  BwdDir<S, W> d[2];
  const long long BH = (long long)B * H;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const W*>(wh[i]);
    d[i].ys = static_cast<const S*>(ys[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].dh = scratch[i];
    d[i].dc = scratch[i] + BH;
  }
  const dim3 grid_g((H + TJ - 1) / TJ, (B + TB - 1) / TB, ndir);
  const dim3 grid_h((H + RU - 1) / RU, (B + RB - 1) / RB, ndir);
  for (int step = 0; step < T; ++step) {
    for (int i = 0; i < ndir; ++i) {
      // the forward scan's order, walked backwards
      if (reverse[i]) {
        d[i].t = step;
        d[i].tp = step + 1 < T ? step + 1 : -1;
      } else {
        d[i].t = T - 1 - step;
        d[i].tp = T - 2 - step;  // -1 at t = 0
      }
    }
    if (ndir == 1) d[1] = d[0];
    bptt_gates<S, W><<<grid_g, THREADS, 0, stream>>>(d[0], d[1], mask, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bptt_dh<S, W><<<grid_h, THREADS, 0, stream>>>(d[0], d[1], mask, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename S, typename W>
int run_dwh(int T, int B, int H, int ndir, const void* const* ys,
            const void* const* dxw, void* const* dwh, const int* reverse,
            cudaStream_t stream) {
  DwhDir<S, W> d[2];
  const long long BH = (long long)B * H;
  const long long R = (long long)(T - 1) * B;
  for (int i = 0; i < ndir; ++i) {
    const S* y = static_cast<const S*>(ys[i]);
    const S* g = static_cast<const S*>(dxw[i]);
    // forward: ys[0..T-2] with dxw[1..T-1]; reverse: ys[1..T-1] with
    // dxw[0..T-2]
    d[i].a = reverse[i] ? y + BH : y;
    d[i].c = reverse[i] ? g : g + 4 * BH;
    d[i].out = static_cast<float*>(dwh[i]);
  }
  if (ndir == 1) d[1] = d[0];
  const dim3 grid((4 * H + DN - 1) / DN, (H + DM - 1) / DM, ndir);
  lstm_dwh<S, W><<<grid, DTHREADS, 0, stream>>>(d[0], d[1], R, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The BPTT frames of one or two directions that share T, B, H, the types
// and the mask. type_code as vo_lstm_fwd. scratch{0,1}: [2, B, H] f32,
// zeroed by the caller (dh, dc carries). Writes dxw{0,1} [T, B, 4H] in S.
// Returns the first non-zero cudaGetLastError() after a launch, or 0.
extern "C" int vo_lstm_bwd(int type_code, int T, int B, int H, int ndir,
                           const void* mask,
                           const void* xw0, const void* wh0, const void* ys0,
                           const void* cs0, const void* dys0, void* dxw0,
                           void* scratch0, int reverse0,
                           const void* xw1, const void* wh1, const void* ys1,
                           const void* cs1, const void* dys1, void* dxw1,
                           void* scratch1, int reverse1, void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* xw[2] = {xw0, xw1};
  const void* wh[2] = {wh0, wh1};
  const void* ys[2] = {ys0, ys1};
  const void* cs[2] = {cs0, cs1};
  const void* dys[2] = {dys0, dys1};
  void* dxw[2] = {dxw0, dxw1};
  float* scratch[2] = {static_cast<float*>(scratch0),
                       static_cast<float*>(scratch1)};
  const int reverse[2] = {reverse0, reverse1};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_bptt<float, float>(T, B, H, ndir, m, xw, wh, ys, cs, dys,
                                    dxw, scratch, reverse, s);
    case 1:
      return run_bptt<__nv_bfloat16, __nv_bfloat16>(
          T, B, H, ndir, m, xw, wh, ys, cs, dys, dxw, scratch, reverse, s);
    case 2:
      return run_bptt<float, __nv_bfloat16>(T, B, H, ndir, m, xw, wh, ys, cs,
                                            dys, dxw, scratch, reverse, s);
    case 3:
      return run_bptt<__nv_bfloat16, float>(T, B, H, ndir, m, xw, wh, ys, cs,
                                            dys, dxw, scratch, reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dwh{0,1} [H, 4H] f32 from the saved ys and the dxw of vo_lstm_bwd, for
// one or two directions; every element is written (zeros when T = 1).
extern "C" int vo_lstm_dwh(int type_code, int T, int B, int H, int ndir,
                           const void* ys0, const void* dxw0, void* dwh0,
                           int reverse0,
                           const void* ys1, const void* dxw1, void* dwh1,
                           int reverse1, void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ys[2] = {ys0, ys1};
  const void* dxw[2] = {dxw0, dxw1};
  void* dwh[2] = {dwh0, dwh1};
  const int reverse[2] = {reverse0, reverse1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_dwh<float, float>(T, B, H, ndir, ys, dxw, dwh, reverse, s);
    case 1:
      return run_dwh<__nv_bfloat16, __nv_bfloat16>(T, B, H, ndir, ys, dxw,
                                                   dwh, reverse, s);
    case 2:
      return run_dwh<float, __nv_bfloat16>(T, B, H, ndir, ys, dxw, dwh,
                                           reverse, s);
    case 3:
      return run_dwh<__nv_bfloat16, float>(T, B, H, ndir, ys, dxw, dwh,
                                           reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
