// BPTT of the masked LSTM recurrence, both directions.
//
// Replaces vistaocr_tpu/ops/lstm_pallas.py::_bwd_kernel (forward
// direction) and ::_bwd_kernel_rev (reverse direction), with their shared
// frame _bptt_frame: one code path, the direction a flag, both directions
// of a BLSTM layer in one launch, as lstm_fwd.cu does.
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
// What bounds it on an H100: T strictly sequential frames of too little
// work each ([B,H] x [H,4H] for the gate recompute, [B,4H] x [4H,H] for
// dh: 134 MFLOP and 4 MB of bf16 wh for both directions at B=32, H=512,
// about 1.3 us of the card), so each frame is latency-bound: the launches,
// and how many SMs share a frame's product and how long each one's
// dependent chain is. The dwh sum is the one large product of the
// backward: H x 4H x (T-1)*B multiply-adds, 69 GFLOP for both directions
// at T=512, B=32, H=512: 69 us on the bf16 tensor cores, 1 ms on the f32
// FMA units.
//
// What this design does about it:
// - Frame t's dh product needs all 4H gate columns of a row, which other
//   blocks compute, so each frame is two launches on one stream (stream
//   order is the barrier): bptt_gates recomputes the gates with the
//   forward's tiled product (lstm_common.cuh) and writes dxw[t] and the
//   dc carry in its epilogue; bptt_dh multiplies the stream-rounded dxw[t]
//   by wh^T and writes the dh carry in its epilogue.
// - bptt_dh splits the 4H contraction 8 ways over a thread-block cluster
//   (8 CTAs x 64 hidden units x 32 or 64 batch rows, per direction: 128
//   CTAs at H=512, B=32). Each CTA multiplies its 64 x 4H/8 slice of wh by the
//   same columns of the dgates: with bf16 W on the tensor cores
//   (wgmma.m64nNk16, both operands K-major in 128B-swizzled shared memory,
//   dgates rounded to bf16 as they are stored there, never right after
//   their global load), with f32 W on the FMA units (64 x 32 tile, 4 x 4
//   per thread, a 256-long chain). The 8 partial tiles are summed through
//   distributed shared memory: CTA r of the cluster adds rows 8r..8r+7 of
//   all 8 partials in rank order and runs the epilogue for them, so each
//   dh element has one owner and the sum a fixed order (no atomics).
// - dwh is not summed frame by frame as on the TPU (where the kernel keeps
//   it in VMEM across the grid): it is one product over K = (T-1)*B rows
//   after the loop, taking ys and dxw at a one-frame offset (the rows of
//   the edge frame, whose h_prev is zero, are left out). That is the same
//   sum in another order, in f32. For a bf16 stream or weight type (where
//   rounding to W makes both operands bf16 values) it is a warp-specialised
//   wgmma GEMM: 128 x 128 output tiles (128 CTAs at H=512, both
//   directions), two consumer warpgroups of wgmma.m64n128k16 reading both
//   operands MN-major, one producer warp keeping a 4-stage ring of 64-row
//   K tiles full with TMA (bf16 streams) or with loads rounded to bf16 at
//   the shared-memory store (f32 streams, or rows TMA cannot describe).
//   f32/f32 stays on the f32 FMA units, so that no TF32 rounding changes
//   its numbers: 128 x 128 tiles, 8 x 8 per thread, double-buffered.
// Ragged B, H and 4H edges read as zeros, so any B, T, H >= 1; every
// output element is written, and two runs give the same bits.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "lstm_common.cuh"

namespace {

using namespace vo_lstm;
using namespace vo_sm90;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

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

// Eight consecutive elements of a row, as loaded (no conversion yet).
template <typename T>
struct Chunk8;
template <>
struct Chunk8<bf16> {
  uint4 v;
};
template <>
struct Chunk8<float> {
  float4 lo, hi;
};

// src[col .. col+7] of a row; elements at or past `end`, and every element
// of an invalid row, read as zero. `vec`: the row is 16-byte aligned and
// `end` a multiple of 8, so a chunk is wholly inside or wholly outside.
template <typename T>
__device__ __forceinline__ Chunk8<T> load8(const T* row, bool row_ok,
                                           long long col, long long end,
                                           bool vec) {
  Chunk8<T> c;
  if constexpr (std::is_same<T, bf16>::value) {
    c.v = make_uint4(0, 0, 0, 0);
    if (!row_ok || col >= end) return c;
    if (vec) {
      c.v = *reinterpret_cast<const uint4*>(row + col);
    } else {
      unsigned short* e = reinterpret_cast<unsigned short*>(&c.v);
      const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = col + j < end ? s[col + j] : 0;
    }
  } else {
    c.lo = c.hi = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!row_ok || col >= end) return c;
    if (vec) {
      c.lo = *reinterpret_cast<const float4*>(row + col);
      c.hi = *reinterpret_cast<const float4*>(row + col + 4);
    } else {
      float* e = &c.lo.x;
      float* f = &c.hi.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = col + j < end ? row[col + j] : 0.f;
        f[j] = col + 4 + j < end ? row[col + 4 + j] : 0.f;
      }
    }
  }
  return c;
}

// the chunk as eight bf16 (round to nearest even from f32)
__device__ __forceinline__ uint4 to_bf16x8(const Chunk8<bf16>& c) {
  return c.v;
}
__device__ __forceinline__ uint4 to_bf16x8(const Chunk8<float>& c) {
  uint4 r;
  __nv_bfloat162 p[4] = {__floats2bfloat162_rn(c.lo.x, c.lo.y),
                         __floats2bfloat162_rn(c.lo.z, c.lo.w),
                         __floats2bfloat162_rn(c.hi.x, c.hi.y),
                         __floats2bfloat162_rn(c.hi.z, c.hi.w)};
  r.x = *reinterpret_cast<uint32_t*>(&p[0]);
  r.y = *reinterpret_cast<uint32_t*>(&p[1]);
  r.z = *reinterpret_cast<uint32_t*>(&p[2]);
  r.w = *reinterpret_cast<uint32_t*>(&p[3]);
  return r;
}

// Fill `nblk` blocks of `rows` x 64 bf16 (128B-swizzled, block j at
// dst + j*rows*128) with src[(row0 + r)*ld + col0 + 64j + c], rows
// row0 + r >= nrows and columns >= end as zeros. bf16 sources with `vec`
// go by cp.async (the caller waits); others are loaded a batch of chunks
// at a time and rounded to bf16 only as they are stored, so the loads of
// a batch are in flight together.
template <typename T>
__device__ __forceinline__ void fill_tile(uint8_t* dst, int rows, const T* src,
                                          long long ld, long long row0,
                                          long long nrows, long long col0,
                                          long long end, int nblk, bool vec,
                                          int tid, int nthreads) {
  constexpr int BATCH = 8;
  const int per_blk = rows * 8;
  const int total = nblk * per_blk;
  for (int base = tid; base < total; base += BATCH * nthreads) {
    Chunk8<T> ch[BATCH];
    uint32_t off[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = base + i * nthreads;
      if (q >= total) break;
      const int j = q / per_blk, rem = q % per_blk;
      const int r = rem / 8, c = rem % 8;
      off[i] = j * rows * 128 + swz128(r, c);
      const long long gr = row0 + r, col = col0 + 64 * j + 8 * c;
      const bool ok = gr < nrows;
      const T* row = src + (ok ? gr : 0) * ld;
      if constexpr (std::is_same<T, bf16>::value) {
        if (vec) {
          if (ok && col < end) {
            cp_async16(dst + off[i], row + col);
          } else {
            *reinterpret_cast<uint4*>(dst + off[i]) = make_uint4(0, 0, 0, 0);
          }
          continue;
        }
      }
      ch[i] = load8<T>(row, ok, col, end, vec);
    }
    if (std::is_same<T, bf16>::value && vec) continue;
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (base + i * nthreads >= total) break;
      *reinterpret_cast<uint4*>(dst + off[i]) = to_bf16x8(ch[i]);
    }
  }
}

// Phase 2 of a frame: dh = round_W(dxw[t]) @ wh^T + (1-m)*(dh + dys[t]),
// split-K over a cluster of DH_SPLIT CTAs. Grid (DH_SPLIT, ceil(H/DH_M),
// ndir * nbt): cluster rank = contraction slice [rank*ks, rank*ks + ks)
// of the 4H columns, y = 64 hidden units, z = direction and NT batch rows.
constexpr int DH_M = 64;
constexpr int DH_SPLIT = 8;
constexpr int DH_KC = 256;  // contraction columns per pass (bf16 route)
constexpr int DH_THREADS = 128;
constexpr int SIMT_K = 32;  // contraction chunk (f32 route)

template <typename W, int NT>
constexpr int dh_smem_bytes() {
  return 1024 + (std::is_same<W, bf16>::value
                     ? std::max(DH_M * DH_KC * 2 + NT * DH_KC * 2,
                                DH_M * (NT + 4) * 4)
                     : std::max(SIMT_K * (DH_M + 4) * 4 + SIMT_K * (NT + 4) * 4,
                                DH_M * (NT + 4) * 4));
}

template <int NT>
__device__ __forceinline__ void wgmma_kk(float (&d)[NT / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (NT == 32) {
    wgmma_m64n32<0, 0>(d, da, db);
  } else {
    wgmma_m64n64<0, 0>(d, da, db);
  }
}

template <typename S, typename W, int NT>
__global__ void __launch_bounds__(DH_THREADS)
bptt_dh(BwdDir<S, W> d0, BwdDir<S, W> d1, const float* __restrict__ mask,
        int B, int H, int nbt, int ks, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const BwdDir<S, W> d = blockIdx.z / nbt == 0 ? d0 : d1;
  const int n0 = (blockIdx.z % nbt) * NT;  // batch rows
  const int m0 = blockIdx.y * DH_M;        // hidden units
  const int G = 4 * H;
  const int k_lo = rank * ks;
  const int k_hi = min(G, k_lo + ks);
  const S* dg = d.dxw + (long long)d.t * B * G;
  extern __shared__ uint8_t dh_raw[];
  uint8_t* sm = align1024(dh_raw);
  constexpr int LD = NT + 4;
  float* red = reinterpret_cast<float*>(sm);  // [DH_M][LD] partial tile
  const int tid = threadIdx.x;

  if constexpr (std::is_same<W, bf16>::value) {
    // D[k][b] = sum_g wh[k][g] * dg[b][g]: A = wh rows, B = dgate rows,
    // both K-major, in 64-column blocks of the slice
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    uint8_t* as = sm;
    uint8_t* bs = sm + DH_M * DH_KC * 2;
    constexpr int NBLK = DH_KC / 64;
    for (int g0 = k_lo; g0 < k_hi; g0 += DH_KC) {
      // columns past the slice are zeros: every pass runs the same wgmma
      // sequence (no data-dependent branch between them)
      fill_tile<W>(as, DH_M, d.wh, G, m0, H, g0, k_hi, NBLK, vec, tid,
                   DH_THREADS);
      fill_tile<S>(bs, NT, dg, G, n0, B, g0, k_hi, NBLK, vec, tid,
                   DH_THREADS);
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
      const uint32_t a0 = smem_u32(as), b0 = smem_u32(bs);
#pragma unroll
      for (int j = 0; j < NBLK; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 columns = 32 bytes each
          wgmma_kk<NT>(acc, wgmma_desc(a0 + j * DH_M * 128 + kk * 32, 16, 1024),
                       wgmma_desc(b0 + j * NT * 128 + kk * 32, 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncthreads();  // the operand tiles are free again
    }
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * warp + lane / 4 + 8 * (q / 2);
        red[r * LD + 8 * j + 2 * (lane % 4) + q % 2] = acc[4 * j + q];
      }
  } else {
    // f32 W: 64 units x 32 rows per CTA, 4 x 4 per thread
    static_assert(NT == 32, "the f32 route takes 32 batch rows per CTA");
    float* ws = reinterpret_cast<float*>(sm);  // ws[g][k] = wh[k][g]
    float* ds = ws + SIMT_K * (DH_M + 4);      // ds[g][b] = dg[b][g]
    const int tu = tid % 8;                    // rows 4*tu .. 4*tu+3
    const int tr = tid / 8;                    // units 4*tr .. 4*tr+3
    const int lg = tid % SIMT_K, lr = tid / SIMT_K;
    constexpr int WL = DH_M * SIMT_K / DH_THREADS;  // 16
    constexpr int SL = NT * SIMT_K / DH_THREADS;    // 8
    W wreg[WL];
    S sreg[SL];
    auto load = [&](int g0) {
      const int g = g0 + lg;
#pragma unroll
      for (int i = 0; i < WL; ++i) {
        const int k = m0 + lr + 4 * i;
        wreg[i] = (k < H && g < k_hi) ? d.wh[(long long)k * G + g]
                                      : from_f32<W>(0.0f);
      }
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        const int b = n0 + lr + 4 * i;
        sreg[i] = (b < B && g < k_hi) ? dg[(long long)b * G + g]
                                      : from_f32<S>(0.0f);
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if (k_lo < k_hi) load(k_lo);
    for (int g0 = k_lo; g0 < k_hi; g0 += SIMT_K) {
      // converted at the store, so the next chunk's loads overlap the FMAs
#pragma unroll
      for (int i = 0; i < WL; ++i) ws[lg * (DH_M + 4) + lr + 4 * i] = wreg[i];
#pragma unroll
      for (int i = 0; i < SL; ++i)
        ds[lg * (NT + 4) + lr + 4 * i] = round_to<W>(to_f32(sreg[i]));
      __syncthreads();
      if (g0 + SIMT_K < k_hi) load(g0 + SIMT_K);
#pragma unroll 8
      for (int kk = 0; kk < SIMT_K; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            &ws[kk * (DH_M + 4) + 4 * tr]);
        const float4 b = *reinterpret_cast<const float4*>(
            &ds[kk * (NT + 4) + 4 * tu]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(4 * tr + i) * LD + 4 * tu + j] = acc[i][j];
      }
  }

  // rank r sums rows 8r..8r+7 of the cluster's partials in rank order and
  // owns their epilogue (the unit index fastest, for coalesced stores)
  cluster.sync();
  constexpr int ROWS = DH_M / DH_SPLIT;
  for (int e = tid; e < ROWS * NT; e += DH_THREADS) {
    const int r = rank * ROWS + e % ROWS, c = e / ROWS;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < DH_SPLIT; ++q) {
      sum += cluster.map_shared_rank(red, q)[r * LD + c];
    }
    const int k = m0 + r, b = n0 + c;
    if (k < H && b < B) {
      const float m = mask[(long long)d.t * B + b];
      const long long idx = (long long)b * H + k;
      const float dh = d.dh[idx] + to_f32(d.dys[(long long)d.t * B * H + idx]);
      d.dh[idx] = sum + (1.0f - m) * dh;
    }
  }
  cluster.sync();  // the partials stay in place until every rank has read
}

template <typename S, typename W, int NT>
cudaError_t launch_dh(const BwdDir<S, W>& d0, const BwdDir<S, W>& d1,
                      const float* mask, int B, int H, int ndir, int ks,
                      int vec, cudaStream_t stream) {
  constexpr int smem = dh_smem_bytes<W, NT>();
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bptt_dh<S, W, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int nbt = (B + NT - 1) / NT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DH_SPLIT, (H + DH_M - 1) / DH_M, ndir * nbt);
  cfg.blockDim = dim3(DH_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DH_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bptt_dh<S, W, NT>, d0, d1, mask, B, H, nbt,
                            ks, vec);
}

// dwh[k][g] = sum_r round_W(a[r][k]) * round_W(c[r][g]) over R rows:
// a = ys rows of the predecessor frames, c = dxw rows of their successors.
template <typename S>
struct DwhDir {
  const S* a;   // [R, H]
  const S* c;   // [R, 4H]
  float* out;   // [H, 4H]
};

// f32/f32: block tile 128 x 128 of dwh, 256 threads of 8 x 8 (rows
// 4*tm + {0..3, 64..67}, columns 4*tn + {0..3, 64..67}), contraction in
// chunks of 8 rows, the next chunk loaded into registers during the FMAs
// and stored to the other of two shared-memory buffers.
constexpr int FM = 128;
constexpr int FN = 128;
constexpr int FK = 8;
constexpr int FTHREADS = 256;

__device__ __forceinline__ float4 load4(const float* row, long long col,
                                        long long end, bool ok, bool vec) {
  if (!ok || col >= end) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(row + col);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < end ? row[col + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(FTHREADS)
lstm_dwh_f32(DwhDir<float> d0, DwhDir<float> d1, long long R, int H,
             int vec) {
  const DwhDir<float> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) float as[2][FK][FM];  // as[k][m] = a[r0 + k][m]
  __shared__ __align__(16) float cs[2][FK][FN];

  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const int G = 4 * H;
  // load mapping: row lr of the chunk, columns lc .. lc+3
  const int lr = tid / 32, lc = (tid % 32) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto load = [&](long long r0, float4& a, float4& c) {
    const long long r = r0 + lr;
    const bool ok = r < R;
    a = load4(d.a + (ok ? r : 0) * H, m0 + lc, H, ok, vec);
    c = load4(d.c + (ok ? r : 0) * G, n0 + lc, G, ok, vec);
  };
  float4 a4, c4;
  load(0, a4, c4);
  int buf = 0;
  for (long long r0 = 0; r0 < R; r0 += FK) {
    *reinterpret_cast<float4*>(&as[buf][lr][lc]) = a4;
    *reinterpret_cast<float4*>(&cs[buf][lr][lc]) = c4;
    __syncthreads();
    if (r0 + FK < R) load(r0 + FK, a4, c4);  // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][4 * tm]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + 4 * tm]);
      const float4 c0 = *reinterpret_cast<const float4*>(&cs[buf][k][4 * tn]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&cs[buf][k][64 + 4 * tn]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    buf ^= 1;  // the other buffer's readers passed this chunk's barrier
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = m0 + 4 * tm + (i % 4) + 64 * (i / 4);
    if (k >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = n0 + 4 * tn + 64 * h;  // G and g are multiples of 4
      if (g < G) {
        *reinterpret_cast<float4*>(&d.out[(long long)k * G + g]) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
}

// bf16 operands (any stream type with bf16 W, or bf16 streams): 128 x 128
// tiles of dwh on the tensor cores. A stage holds 64 contraction rows as
// four [64 rows][64] boxes: a columns m0..m0+63 (warpgroup 0's M half),
// m0+64..m0+127 (warpgroup 1's), c columns n0..n0+63 and n0+64..n0+127.
// Both operands are MN-major: a row of a box is 64 M (or N) values.
constexpr int GK = 64;
constexpr int GSTAGES = 4;
constexpr int GBOX = 64 * 128;
constexpr int GSTAGE = 4 * GBOX;
constexpr int GTHREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int GSMEM = 1024 + GSTAGES * GSTAGE + 2 * GSTAGES * 8;

struct DwhMaps {
  CUtensorMap a[2];  // per direction: ys rows [R, H], 64 x 64 boxes
  CUtensorMap c[2];  // dxw rows [R, 4H]
};

template <typename S, bool kTma>
__global__ void __launch_bounds__(GTHREADS, 1)
lstm_dwh_tc(const __grid_constant__ DwhMaps maps, DwhDir<S> d0, DwhDir<S> d1,
            int R, int H, int vec) {
  const int dir = blockIdx.z;
  const DwhDir<S> d = dir == 0 ? d0 : d1;
  extern __shared__ uint8_t dwh_raw[];
  uint8_t* sm = align1024(dwh_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GSTAGES * GSTAGE);
  uint64_t* empty = full + GSTAGES;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int G = 4 * H;
  const int nk = (R + GK - 1) / GK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // producer
    const int tid = threadIdx.x - 256;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % GSTAGES, n = kt / GSTAGES;
      uint8_t* st = sm + s * GSTAGE;
      const int r0 = kt * GK;
      if constexpr (kTma) {
        if (tid != 0) break;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&full[s], GSTAGE);
        tma_load_2d(st, &maps.a[dir], &full[s], m0, r0);
        tma_load_2d(st + GBOX, &maps.a[dir], &full[s], m0 + 64, r0);
        tma_load_2d(st + 2 * GBOX, &maps.c[dir], &full[s], n0, r0);
        tma_load_2d(st + 3 * GBOX, &maps.c[dir], &full[s], n0 + 64, r0);
      } else {
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        for (int h = 0; h < 2; ++h) {
          fill_tile<S>(st + h * GBOX, 64, d.a, H, r0, R, m0 + 64 * h, H, 1,
                       vec, tid, 128);
          fill_tile<S>(st + (2 + h) * GBOX, 64, d.c, G, r0, R, n0 + 64 * h, G,
                       1, vec, tid, 128);
        }
        cp_async_wait_all();
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumers: rows m0 + 64*wg .. +63 of the tile
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % GSTAGES;
      mbar_wait(&full[s], (kt / GSTAGES) & 1);
      const uint32_t a = smem_u32(sm + s * GSTAGE + wg * GBOX);
      const uint32_t b = smem_u32(sm + s * GSTAGE + 2 * GBOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < GK / 16; ++j) {  // 16 rows = two 8-row atoms
        // MN-major: LBO steps between 64-wide M/N blocks, SBO between
        // 8-row groups of the contraction
        wgmma_m64n128<1, 1>(acc, wgmma_desc(a + j * 2048, GBOX, 1024),
                            wgmma_desc(b + j * 2048, GBOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive(&empty[(kt - 1) % GSTAGES]);
      }
    }
    wgmma_wait<0>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int k = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * (q / 2);
        const int g = n0 + 8 * j + 2 * (lane % 4);
        if (k < H && g < G) {  // G and g are even
          *reinterpret_cast<float2*>(&d.out[(long long)k * G + g]) =
              make_float2(acc[4 * j + q], acc[4 * j + q + 1]);
        }
      }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a [rows, cols] row-major bf16 matrix in 64 x 64 boxes, 128B swizzle;
// boxes past the edges read as zeros
cudaError_t encode_rows(CUtensorMap* map, const void* base, long long cols,
                        long long rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename S, typename W>
int run_bptt(int T, int B, int H, int ndir, const float* mask,
             const void* const* xw, const void* const* wh,
             const void* const* ys, const void* const* cs,
             const void* const* dys, void* const* dxw,
             float* const* scratch, const int* reverse, cudaStream_t stream) {
  BwdDir<S, W> d[2];
  const long long BH = (long long)B * H;
  // the 16-byte chunks of wh and dgate rows: whole and aligned
  int vec = H % 8 == 0;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const W*>(wh[i]);
    d[i].ys = static_cast<const S*>(ys[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].dh = scratch[i];
    d[i].dc = scratch[i] + BH;
    vec = vec && aligned16(wh[i]) && aligned16(dxw[i]);
  }
  const int G = 4 * H;
  const int ks = ((G + DH_SPLIT - 1) / DH_SPLIT + 63) / 64 * 64;
  const dim3 grid_g((H + TJ - 1) / TJ, (B + TB - 1) / TB, ndir);
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
    // bf16 W: 32 batch rows a CTA up to B = 64, then 64 (more CTAs beat
    // wider products at B = 128); f32 W: 32
    if constexpr (std::is_same<W, bf16>::value) {
      err = B > 64 ? launch_dh<S, W, 64>(d[0], d[1], mask, B, H, ndir, ks,
                                         vec, stream)
                   : launch_dh<S, W, 32>(d[0], d[1], mask, B, H, ndir, ks,
                                         vec, stream);
    } else {
      err = launch_dh<S, W, 32>(d[0], d[1], mask, B, H, ndir, ks, vec,
                                stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename S, bool kTma>
cudaError_t launch_dwh_tc(const DwhMaps& maps, const DwhDir<S>* d, int R,
                          int H, int vec, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_dwh_tc<S, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GSMEM);
  if (err != cudaSuccess) return err;
  lstm_dwh_tc<S, kTma><<<grid, GTHREADS, GSMEM, stream>>>(maps, d[0], d[1], R,
                                                         H, vec);
  return cudaGetLastError();
}

template <typename S, typename W>
int run_dwh(int T, int B, int H, int ndir, const void* const* ys,
            const void* const* dxw, void* const* dwh, const int* reverse,
            cudaStream_t stream) {
  DwhDir<S> d[2];
  const long long BH = (long long)B * H;
  const long long R = (long long)(T - 1) * B;
  const int G = 4 * H;
  for (int i = 0; i < ndir; ++i) {
    const S* y = static_cast<const S*>(ys[i]);
    const S* g = static_cast<const S*>(dxw[i]);
    // forward: ys[0..T-2] with dxw[1..T-1]; reverse: ys[1..T-1] with
    // dxw[0..T-2]
    d[i].a = reverse[i] ? y + BH : y;
    d[i].c = reverse[i] ? g : g + 4 * BH;
    d[i].out = static_cast<float*>(dwh[i]);
  }
  if (R == 0) {  // T = 1: no frame has a predecessor
    for (int i = 0; i < ndir; ++i) {
      const cudaError_t err = cudaMemsetAsync(
          d[i].out, 0, sizeof(float) * H * (size_t)G, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  if (ndir == 1) d[1] = d[0];
  bool aligned = true;
  for (int i = 0; i < ndir; ++i) {
    aligned = aligned && aligned16(d[i].a) && aligned16(d[i].c);
  }
  if constexpr (std::is_same<S, float>::value &&
                std::is_same<W, float>::value) {
    const int vec = aligned && H % 4 == 0;  // rows of whole float4s
    const dim3 grid((G + FN - 1) / FN, (H + FM - 1) / FM, ndir);
    lstm_dwh_f32<<<grid, FTHREADS, 0, stream>>>(d[0], d[1], R, H, vec);
    return static_cast<int>(cudaGetLastError());
  } else {
    if (R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = aligned && H % 8 == 0;  // rows of whole 8-value chunks
    const dim3 grid((G + 127) / 128, (H + 127) / 128, ndir);
    DwhMaps maps = {};
    if constexpr (std::is_same<S, bf16>::value) {
      if (vec) {  // TMA: bf16 rows whose strides and bases are 16-byte aligned
        for (int i = 0; i < ndir; ++i) {
          cudaError_t err = encode_rows(&maps.a[i], d[i].a, H, R);
          if (err == cudaSuccess) err = encode_rows(&maps.c[i], d[i].c, G, R);
          if (err != cudaSuccess) return static_cast<int>(err);
        }
        if (ndir == 1) {
          maps.a[1] = maps.a[0];
          maps.c[1] = maps.c[0];
        }
        return static_cast<int>(launch_dwh_tc<S, true>(
            maps, d, static_cast<int>(R), H, vec, grid, stream));
      }
    }
    return static_cast<int>(launch_dwh_tc<S, false>(
        maps, d, static_cast<int>(R), H, vec, grid, stream));
  }
}

}  // namespace

// The BPTT frames of one or two directions that share T, B, H, the types
// and the mask. type_code as vo_lstm_fwd. scratch{0,1}: [2, B, H] f32,
// zeroed by the caller (dh, dc carries). Writes dxw{0,1} [T, B, 4H] in S.
// Returns the first non-zero CUDA error of a launch, or 0.
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
      return run_bptt<bf16, bf16>(T, B, H, ndir, m, xw, wh, ys, cs, dys, dxw,
                                  scratch, reverse, s);
    case 2:
      return run_bptt<float, bf16>(T, B, H, ndir, m, xw, wh, ys, cs, dys, dxw,
                                   scratch, reverse, s);
    case 3:
      return run_bptt<bf16, float>(T, B, H, ndir, m, xw, wh, ys, cs, dys, dxw,
                                   scratch, reverse, s);
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
      return run_dwh<bf16, bf16>(T, B, H, ndir, ys, dxw, dwh, reverse, s);
    case 2:
      return run_dwh<float, bf16>(T, B, H, ndir, ys, dxw, dwh, reverse, s);
    case 3:
      return run_dwh<bf16, float>(T, B, H, ndir, ys, dxw, dwh, reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
