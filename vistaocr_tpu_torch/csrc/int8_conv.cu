// The int8 3x3 SAME convolutions of the int8 serving path
// (models/quant.py), each with its epilogue fused: dequantize + bias +
// round to the compute type + ReLU, the stage's pool, and, where another
// int8 conv follows, that conv's quantize, so that every activation
// between two int8 convs travels once, as int8, pooled.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (vistaocr_tpu/models/quant.py:209-222, an int8 x int8 -> int32
// conv_general_dilated, then the pool, then the next conv's quantize). It
// is written by hand because PyTorch has no int8 convolution on CUDA
// (F.conv2d refuses int8 tensors) and a float conv of the int8 values is
// not exact: at conv2_1 the int32 sums reach 9 * 256 * 127^2 ~ 3.7e7 >
// 2^24.
//
// What a conv computes, for x [B,H,W,CI] NHWC (int8 already quantized, or
// f32/bf16 quantized here with inv_s), the packed weights wq [CO,KP] int8
// (k = (kh*3 + kw)*CI + c, zero past K = 9*CI, KP = K rounded up to 32),
// scale, bias [CO] f32:
//   xq  = clamp(rint(x * inv_s), -127, 127)           (int8; pad = 0)
//   acc = sum_k xq[patch(m), k] * wq[n, k]            (int32, exact)
//   y   = relu(round_to_T(acc * scale[n] + bias[n]))  (T: the compute type)
//   z   = pool(y)      (ph x pw, ph, pw in {1, 2}: flax's SAME max-pool,
//                       ceil(H/ph) x ceil(W/pw), or the subsample)
//   out = z in T, or clamp(rint(z * inv_next), -127, 127) as int8
// with each product and sum rounded once (__fmul_rn / __fadd_rn: no FMA
// contraction), as the plain version's separate torch ops round, so the
// two are bit-equal; rint rounds half to even like torch.round. Quantizing
// before or after the max gives the same int8 values (the quantize is
// monotone and a SAME window holds at least one real pixel), and every y
// is >= +0, so a window's pixels past the edge enter the max as +0.
//
// What bounds it on an H100: an implicit GEMM with M = B*H*W pixels,
// N = CO, K = 9*CI. The flagship's stack at B=128, W=512 is 621 G int8
// operations (0.31 ms at 1,979 TOP/s) against 0.61 GB of activations and
// weights in and out (0.18 ms at 3.35 TB/s), once each activation
// travels as int8 and pooled: operations bound. What a conv's time goes
// to (profile_int8_conv.py, copies with work cut out): the epilogue
// (dequantize, round, pool, quantize: some 40 instructions a quad of
// outputs) runs on the 8 warps that also issue the products, and the
// per-tap operand loads read each input pixel 9 times from L2.
//
// What the designs do about it:
// - int8_conv_tc (int8 input, CI % 64 == 0, CO in {64, 128, 256}): a
//   persistent grid, one CTA an SM walking tiles of 8 rows x 16 columns of
//   one image (two 8 x 8 slabs). A producer warp feeds a ring of stages
//   by TMA: for each tap (kh, kw) and 64- or 128-byte chunk of channels,
//   the two slabs' boxes at (c0, w0 + kw - 1, h0 + kh - 1, b) from a 4-D
//   map over the int8 NHWC activation (zero fill past the edges: SAME
//   padding and ragged tiles for free, never a neighbour image's rows),
//   swizzled as wide as the chunk; the weights' [CO x chunk] slice from a
//   2-D map, or, where all of B fits beside the ring, the whole of B once
//   a CTA. wgmma.m64nCOk32 s8 x s8 -> s32 takes all of CO at once, so a
//   pixel's channels are loaded once a tap. At CO = 64 the two consumer
//   warpgroups take whole tiles in turns (ping-pong), each from a ring of
//   its own, so that one's epilogue runs under the other's products;
//   above it both take each tile, a slab each. The epilogue
//   runs from the accumulators without branches: a thread holds two
//   vertically adjacent pixels and its horizontal neighbour sits 4 lanes
//   away, so a 2 x 2 or 2 x 1 pool is a max in registers and a shuffle;
//   the pooled tile is staged in shared memory (64- or 128-byte rows,
//   swizzled: conflict-free) and written by TMA stores, which clip the
//   ragged edges, while the next tile's products run.
// - int8_conv_direct (any CI and CO; conv0_0's CI = 1, K = 9 is no GEMM
//   for wgmma, and TMA cannot take its 1-byte rows): a block a tile, the
//   tile's halo quantized once into shared memory (a float input is
//   quantized there), the patches gathered from it into
//   mma.sync.m16n8k32 fragments, 64 output channels a pass, the same
//   epilogue into a staging buffer copied out in 16-byte stores.
// - int8_quantize: the one quantize pass in front of the first tc conv
//   that takes a float input (after a float prefix).
// Which design a conv takes is tc_plan's answer (the launcher's ring and
// residency), exported as vo_int8_conv_design for the Python wrapper.
// No atomics: two runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace vo_sm90;
using bf16 = __nv_bfloat16;

// --- shared arithmetic -------------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quant(float x, float inv_s) {
  float v = rintf(__fmul_rn(x, inv_s));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<int>(v);
}

__device__ __forceinline__ int load_q(int8_t v, float) { return v; }
__device__ __forceinline__ int load_q(float v, float inv_s) {
  return quant(v, inv_s);
}
__device__ __forceinline__ int load_q(bf16 v, float inv_s) {
  return quant(__bfloat162float(v), inv_s);
}

// the epilogue's output and pool
struct Epi {
  const float* scale;
  const float* bias;
  void* y;
  float inv_next;  // the next conv's quantize (int8 output)
  int out_kind;    // 0: f32, 1: bf16, 2: int8
  int round_bf;    // the compute type is bf16
  int H, W;        // the conv's rows and columns
  int Ho, Wo;      // the output's rows and columns (after the pool)
  int ph, pw;      // the pool window, 1 or 2 each
  int stride;      // 1: subsample instead of max
};

constexpr int TILE_H = 8, TILE_W = 16;  // a tile: 8 rows x 16 columns
constexpr int SMEM_LIMIT = 232448;      // a block's dynamic shared memory

__host__ __device__ __forceinline__ int out_size(int out_kind) {
  return out_kind == 2 ? 1 : out_kind == 1 ? 2 : 4;
}

// a tile's pooled output staged in shared memory: [TILE_H/ph][TILE_W/pw]
// pixels of `channels` values of the output type, in whole 64- or
// 128-byte rows
__host__ __device__ __forceinline__ int staging_bytes(const Epi& e,
                                                      int channels) {
  const int row = channels * out_size(e.out_kind);
  const int rb = 1 << (row <= 64 ? 6 : 7);
  return (TILE_H / e.ph) * (TILE_W / e.pw) * ((row + rb - 1) / rb) * rb;
}

// relu(round_T(acc * scale + bias)) as an f32 value (+0 for <= 0)
__device__ __forceinline__ float epi(int acc, float sc, float bi,
                                     int round_bf) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bi);
  if (round_bf) v = __bfloat162float(__float2bfloat16_rn(v));
  return v > 0.f ? v : 0.f;
}

// the quantize of a value >= +0: rint (half to even) and the upper clamp
__device__ __forceinline__ uint32_t quant_pos(float v, float inv_s) {
  return static_cast<uint32_t>(min(__float2int_rn(__fmul_rn(v, inv_s)), 127));
}

// A tile's pooled output staged in shared memory for the copy out: rows of
// 2^rbs bytes (64 or 128), a pixel's channels spread over regions of P
// rows each, the 16-byte chunks of a row swizzled as TMA's 64- or
// 128-byte swizzle lays them (so a warp's stores to 8 pixels hit 8 banks)
struct Stg {
  uint8_t* base;
  int P;    // pixels: (TILE_H / ph) x (TILE_W / pw)
  int rbs;  // log2 of the row's bytes
};

__host__ __device__ __forceinline__ int row_shift(int bytes_a_pixel) {
  return bytes_a_pixel <= 64 ? 6 : 7;
}

// byte o of pixel p's output row
__device__ __forceinline__ uint8_t* stg_at(const Stg& st, int p, int o) {
  const int c = (o >> 4) & ((1 << (st.rbs - 4)) - 1);
  const int swz = st.rbs == 7 ? (p & 7) : ((p >> 1) & 3);
  return st.base + (((o >> st.rbs) * st.P + p) << st.rbs) +
         ((c ^ swz) << 4) + (o & 15);
}

// two adjacent channels of the output type at p, if `on`: every form is
// computed and the stores predicated, so the epilogue has no branches
__device__ __forceinline__ void put2(const Epi& e, uint8_t* p, float v0,
                                     float v1, bool on) {
  const uint32_t q = quant_pos(v0, e.inv_next) |
                     (quant_pos(v1, e.inv_next) << 8);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  if (on && e.out_kind == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q);
  }
  if (on && e.out_kind == 1) *reinterpret_cast<__nv_bfloat162*>(p) = h;
  if (on && e.out_kind == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

// where a thread's pixels (hA, wA) and (hA + 1, wA) land, the same for
// every channel of a tile: the pool window is 1 or 2 each way, so the
// tile's pooled grid is indexed by shifts
struct EpiPos {
  bool ok0, ok1;  // the pixels lie inside the image
  bool keep;      // this lane stores (the even column of a 2-wide window)
  int p0, p1;     // staging rows of the (pooled) pixels; p1: ph == 1 only
};

__device__ __forceinline__ EpiPos epi_pos(const Epi& e, int h0, int w0,
                                          int hA, int wA, int lane) {
  EpiPos q;
  q.ok0 = wA < e.W && hA < e.H;
  q.ok1 = wA < e.W && hA + 1 < e.H;
  q.keep = e.pw == 1 || (lane & 4) == 0;
  const int tws = 5 - e.pw;  // log2(TILE_W / pw)
  q.p0 = (((hA - h0) >> (e.ph - 1)) << tws) + ((wA - w0) >> (e.pw - 1));
  q.p1 = q.p0 + (1 << tws);
  return q;
}

// One thread's four accumulators: the two pixels of `q`, channels at byte
// o and o + es of a pixel's output row, with sb = (scale, scale', bias,
// bias') of the two channels; the thread holding the column to the right
// is 4 lanes away. Pixels past the edge enter the pool as +0 (every y is
// >= +0). Every lane of the warp calls it (the 2-wide pool shuffles).
__device__ __forceinline__ void epi_quad(const Epi& e, const Stg& st,
                                         const EpiPos& q, float4 sb, int o,
                                         int a00, int a01, int a10,
                                         int a11) {
  float v00 = q.ok0 ? epi(a00, sb.x, sb.z, e.round_bf) : 0.f;
  float v01 = q.ok0 ? epi(a01, sb.y, sb.w, e.round_bf) : 0.f;
  float v10 = q.ok1 ? epi(a10, sb.x, sb.z, e.round_bf) : 0.f;
  float v11 = q.ok1 ? epi(a11, sb.y, sb.w, e.round_bf) : 0.f;
  // the pool by selects, the shuffles taken either way
  const bool mh = e.ph == 2 && !e.stride, mw = e.pw == 2 && !e.stride;
  const float m0 = fmaxf(v00, v10), m1 = fmaxf(v01, v11);
  v00 = mh ? m0 : v00;
  v01 = mh ? m1 : v01;
  const float u00 = __shfl_xor_sync(0xffffffffu, v00, 4);
  const float u01 = __shfl_xor_sync(0xffffffffu, v01, 4);
  const float u10 = __shfl_xor_sync(0xffffffffu, v10, 4);
  const float u11 = __shfl_xor_sync(0xffffffffu, v11, 4);
  v00 = mw ? fmaxf(v00, u00) : v00;
  v01 = mw ? fmaxf(v01, u01) : v01;
  v10 = mw ? fmaxf(v10, u10) : v10;
  v11 = mw ? fmaxf(v11, u11) : v11;
  put2(e, stg_at(st, q.p0, o), v00, v01, q.keep);
  put2(e, stg_at(st, q.p1, o), v10, v11, q.keep && e.ph == 1);
}

// (scale, scale', bias, bias') of channel pairs n0 + 2i, n0 + 2i + 1 for
// i < pairs, the channels past CO reading the last one's
__device__ __forceinline__ void fill_sb(float4* sbt, const Epi& e, int n0,
                                        int CO, int pairs, int tid,
                                        int threads) {
  for (int i = tid; i < pairs; i += threads) {
    const int n = min(n0 + 2 * i, CO - 1), n1 = min(n0 + 2 * i + 1, CO - 1);
    sbt[i] = make_float4(e.scale[n], e.scale[n1], e.bias[n], e.bias[n1]);
  }
}

// --- the tensor-core design --------------------------------------------------
constexpr int TC_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TC_MAX_STAGES = 8;

struct TcArgs {
  int CI;
  int nk;        // K stages a tile: 9 taps x CI / KC chunks
  int tiles_h, tiles_w, tiles;
  int stages;    // the ring's depth
  int resident;  // all of B in shared memory, loaded once
  int staging;   // bytes of the output tile's staging buffer
  int rbs;       // log2 of its rows' bytes (64 or 128)
  Epi e;
};

inline int tc_stage_bytes(int N, int KC, int resident) {
  return 128 * KC + (resident ? 0 : N * KC);
}

// CO = 64: each consumer warpgroup takes whole tiles, in turns with the
// other, so that one's epilogue runs under the other's products; CO = 128
// and 256: both take each tile, a slab each (at 128 ping-pong measured
// slower: each ring half as deep; at 256 two slabs' accumulators would
// not fit)
__host__ __device__ constexpr bool tc_pingpong(int N) { return N == 64; }

// the ring, resident B, the staging buffer (one a warpgroup in ping-pong),
// the (scale, bias) table and the mbarriers
inline int tc_smem(int N, int KC, int nk, int stages, int resident,
                   int staging) {
  return 1024 + stages * tc_stage_bytes(N, KC, resident) +
         (resident ? nk * N * KC : 0) + (tc_pingpong(N) ? 2 : 1) * staging +
         N * 8 + (2 * TC_MAX_STAGES + 1) * 8;
}

// the plan of the launch: all of B resident where that leaves a ring of
// 4, the ring as deep as the rest of shared memory allows, up to
// TC_MAX_STAGES (even in ping-pong: two rings of half of them); false
// where no ring of 2 (4 in ping-pong) fits. The one rule the launcher and
// vo_int8_conv_design share.
inline bool tc_plan(int N, int KC, int nk, int staging, int* resident,
                    int* stages) {
  *resident = tc_smem(N, KC, nk, 4, 1, staging) <= SMEM_LIMIT;
  int s = std::min(TC_MAX_STAGES,
                   (SMEM_LIMIT - tc_smem(N, KC, nk, 0, *resident, staging)) /
                       tc_stage_bytes(N, KC, *resident));
  if (tc_pingpong(N)) s &= ~1;
  *stages = s;
  return s >= (tc_pingpong(N) ? 4 : 2);
}

inline bool tc_takes(int CI, int CO) {
  return CI % 64 == 0 && (CO == 64 || CO == 128 || CO == 256);
}
inline int tc_chunk(int CI) { return CI % 128 == 0 ? 128 : 64; }
inline int tc_staging(const Epi& e, int CO) {
  return (staging_bytes(e, CO) + 1023) / 1024 * 1024;
}



template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 256) {
    wgmma_s8_m64n256(d, da, db, accumulate);
  } else if constexpr (N == 128) {
    wgmma_s8_m64n128(d, da, db, accumulate);
  } else {
    static_assert(N == 64, "int8_conv_tc takes CO = 64, 128 or 256");
    wgmma_s8_m64n64(d, da, db, accumulate);
  }
}

__device__ __forceinline__ void tile_origin(int t, int tiles_h, int tiles_w,
                                            int& b, int& h0, int& w0) {
  const int tw = t % tiles_w;
  const int r = t / tiles_w;
  b = r / tiles_h;
  h0 = (r - b * tiles_h) * TILE_H;
  w0 = tw * TILE_W;
}

// N: CO; KC: the bytes of channels a stage (64 or 128, the swizzle)
template <int N, int KC>
__global__ void __launch_bounds__(TC_THREADS, 1)
    int8_conv_tc(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap ymap, const TcArgs a) {
  extern __shared__ uint8_t tc_raw[];
  uint8_t* sm = align1024(tc_raw);
  constexpr int A_BYTES = 128 * KC;  // a stage's two slabs
  constexpr int B_BYTES = N * KC;    // one (tap, chunk) slice of B
  const int stage = A_BYTES + (a.resident ? 0 : B_BYTES);
  uint8_t* bres = sm + a.stages * stage;  // resident B: nk slices
  uint8_t* stg = bres + (a.resident ? a.nk * B_BYTES : 0);
  constexpr bool PP = tc_pingpong(N);
  float4* sbt = reinterpret_cast<float4*>(stg + (PP ? 2 : 1) * a.staging);
  uint64_t* full = reinterpret_cast<uint64_t*>(sbt + N / 2);
  uint64_t* empty = full + TC_MAX_STAGES;
  uint64_t* bfull = empty + TC_MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PP ? 1 : 2);  // an arrival per consumer
    }
    mbar_init(bfull, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (threadIdx.x != 256) return;
    if (a.resident) {
      mbar_arrive_expect_tx(bfull, a.nk * B_BYTES);
      for (int i = 0; i < a.nk; ++i) {
        tma_load_2d(bres + i * B_BYTES, &wmap, bfull, i * KC, 0);
      }
    }
    // in ping-pong the CTA's tiles alternate between two rings of half the
    // stages, one a warpgroup, so that each ring's phases are waited on in
    // order; a ring's slot, and how often it wrapped
    const int ring = PP ? a.stages / 2 : a.stages;
    int rs[2] = {0, 0}, rpass[2] = {0, 0};
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {
      int b, h0, w0;
      tile_origin(t, a.tiles_h, a.tiles_w, b, h0, w0);
      const int r = PP ? it & 1 : 0;
      int s = rs[r], pass = rpass[r];
      int kt = 0;
      for (int kh = 0; kh < 3; ++kh) {
        for (int kw = 0; kw < 3; ++kw) {
          for (int c0 = 0; c0 < a.CI; c0 += KC, ++kt) {
            const int slot = r * ring + s;
            if (pass > 0) grid_wait(&empty[slot], (pass & 1) ^ 1);
            uint8_t* st = sm + slot * stage;
            mbar_arrive_expect_tx(&full[slot], stage);
            tma_load_4d(st, &xmap, &full[slot], c0, w0 + kw - 1, h0 + kh - 1,
                        b);
            tma_load_4d(st + A_BYTES / 2, &xmap, &full[slot], c0,
                        w0 + 7 + kw, h0 + kh - 1, b);
            if (!a.resident) {
              tma_load_2d(st + A_BYTES, &wmap, &full[slot], kt * KC, 0);
            }
            if (++s == ring) {
              s = 0;
              ++pass;
            }
          }
        }
      }
      rs[r] = s;
      rpass[r] = pass;
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  constexpr uint64_t LAYOUT = KC == 128 ? 1 : 2;
  constexpr uint32_t SBO = 8 * KC;  // 8 rows: one swizzle atom
  const Epi& e = a.e;
  const int es = out_size(e.out_kind);
  fill_sb(sbt, e, 0, N, N / 2, threadIdx.x, 256);
  named_barrier_sync(3, 256);
  if constexpr (PP) {
    // warpgroup wg takes the CTA's tiles wg, wg + 2, ..., both slabs
    // (acc[sl]: columns w0 + 8 sl .. + 7)
    const int tid = threadIdx.x % 128;
    uint8_t* mine = stg + wg * a.staging;
    const Stg sg = {mine, (TILE_H / e.ph) * (TILE_W / e.pw), a.rbs};
    int acc[2][N / 2];
    if (a.resident) grid_wait(bfull, 0);
    const int ring = a.stages / 2, base = wg * ring;  // this one's ring
    int s = 0, pass = 0;
    for (int t = blockIdx.x + wg * gridDim.x; t < a.tiles;
         t += 2 * gridDim.x) {
      int b, h0, w0;
      tile_origin(t, a.tiles_h, a.tiles_w, b, h0, w0);
      int prev = 0;
      for (int kt = 0; kt < a.nk; ++kt) {
        grid_wait(&full[base + s], pass & 1);
        uint8_t* st = sm + (base + s) * stage;
        const uint32_t pa = smem_u32(st);
        const uint32_t pb =
            smem_u32(a.resident ? bres + kt * B_BYTES : st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KC / 32; ++j) {
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            wgmma_s8<N>(acc[sl],
                        wgmma_desc(pa + sl * (A_BYTES / 2) + 32 * j, 16, SBO,
                                   LAYOUT),
                        wgmma_desc(pb + 32 * j, 16, SBO, LAYOUT),
                        kt > 0 || j > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0 && tid == 0) mbar_arrive(&empty[base + prev]);
        prev = s;
        if (++s == ring) {
          s = 0;
          ++pass;
        }
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[base + prev]);
      if (tid == 0) bulk_wait_read();  // this warpgroup's last store
      named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const EpiPos q = epi_pos(e, h0, w0, h0 + 2 * warp,
                                 w0 + 8 * sl + lane / 4, lane);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = 8 * j + 2 * (lane % 4);
          epi_quad(e, sg, q, sbt[n / 2], n * es, acc[sl][4 * j],
                   acc[sl][4 * j + 1], acc[sl][4 * j + 2],
                   acc[sl][4 * j + 3]);
        }
      }
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      if (tid == 0) {
        const int per = (1 << a.rbs) / es;
        for (int r = 0; r * per < N; ++r) {
          tma_store_4d(&ymap, mine + ((r * sg.P) << a.rbs), r * per,
                       w0 / e.pw, h0 / e.ph, b);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();
  } else {
    // CO = 256: warpgroup wg computes slab wg (columns w0 + 8 wg .. + 7)
    // of every tile
    const Stg sg = {stg, (TILE_H / e.ph) * (TILE_W / e.pw), a.rbs};
    int acc[N / 2];
    if (a.resident) grid_wait(bfull, 0);
    int s = 0, pass = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      int b, h0, w0;
      tile_origin(t, a.tiles_h, a.tiles_w, b, h0, w0);
      int prev = 0;
      for (int kt = 0; kt < a.nk; ++kt) {
        grid_wait(&full[s], pass & 1);
        uint8_t* st = sm + s * stage;
        const uint32_t pa = smem_u32(st + wg * (A_BYTES / 2));
        const uint32_t pb =
            smem_u32(a.resident ? bres + kt * B_BYTES : st + A_BYTES);
        wgmma_fence();
  #pragma unroll
        for (int j = 0; j < KC / 32; ++j) {
          // K-major rows of KC bytes: 32 bytes (one k32) further each step
          wgmma_s8<N>(acc, wgmma_desc(pa + 32 * j, 16, SBO, LAYOUT),
                      wgmma_desc(pb + 32 * j, 16, SBO, LAYOUT),
                      kt > 0 || j > 0);  // a tile starts at zero
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == a.stages) {
          s = 0;
          ++pass;
        }
      }
      wgmma_wait<0>();
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);

      // the staging buffer is free once the last tile's store has read it
      if (threadIdx.x == 0) bulk_wait_read();
      named_barrier_sync(1, 256);
      // slab row m = 16 warp + lane/4 + 8 (q/2) is pixel (h0 + m/8, w0 + 8
      // wg + m%8)
      const EpiPos q = epi_pos(e, h0, w0, h0 + 2 * warp, w0 + 8 * wg + lane / 4,
                               lane);
  #pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * (lane % 4);
        epi_quad(e, sg, q, sbt[n / 2], n * es, acc[4 * j], acc[4 * j + 1],
                 acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_proxy_async();  // the writes, visible to the TMA store
      named_barrier_sync(1, 256);
      if (threadIdx.x == 0) {  // a box a region of 2^rbs-byte rows
        const int per = (1 << a.rbs) / es;
        for (int r = 0; r * per < N; ++r) {
          tma_store_4d(&ymap, stg + ((r * sg.P) << a.rbs), r * per,
                       w0 / e.pw, h0 / e.ph, b);
        }
        bulk_commit();
      }
    }
    if (threadIdx.x == 0) bulk_wait_all();
  }
}

inline CUtensorMapSwizzle swizzle_of(int KC) {
  return KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// a 4-D map over [d3, d2, d1, d0] (d0 innermost, dense) of `es`-byte
// elements in boxes of box[0..3]
cudaError_t encode_4d(CUtensorMap* map, const void* base,
                      CUtensorMapDataType type, int es, const int (&dims)[4],
                      const int (&box)[4], CUtensorMapSwizzle swz,
                      CUtensorMapL2promotion promo) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[4] = {static_cast<cuuint64_t>(dims[0]),
                           static_cast<cuuint64_t>(dims[1]),
                           static_cast<cuuint64_t>(dims[2]),
                           static_cast<cuuint64_t>(dims[3])};
  const cuuint64_t st[3] = {d[0] * es, d[0] * d[1] * es,
                            d[0] * d[1] * d[2] * es};
  const cuuint32_t bx[4] = {static_cast<cuuint32_t>(box[0]),
                            static_cast<cuuint32_t>(box[1]),
                            static_cast<cuuint32_t>(box[2]),
                            static_cast<cuuint32_t>(box[3])};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), d, st, bx,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, promo,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the TMA maps: the int8 activation [B, H, W, CI] in boxes of [KC, 8, 8,
// 1] and the packed weights [CO, KP] in boxes of [KC, CO], swizzled KC
// bytes wide, boxes past the edges reading as zeros; the output [B, Ho,
// Wo, CO] in boxes of the pooled tile and 64 or 128 bytes of channels,
// swizzled as wide, the parts past the edges not written
cudaError_t encode_maps(CUtensorMap* xmap, CUtensorMap* wmap,
                        CUtensorMap* ymap, const void* x, const void* wq,
                        int B, int H, int W, int CI, int CO, int KP, int KC,
                        const Epi& e) {
  cudaError_t err = encode_4d(xmap, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              {CI, W, H, B}, {KC, 8, 8, 1}, swizzle_of(KC),
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != cudaSuccess) return err;
  const CUtensorMapDataType ytype =
      e.out_kind == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : e.out_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = out_size(e.out_kind);
  const int rbs = row_shift(CO * es);
  err = encode_4d(ymap, e.y, ytype, es, {CO, e.Wo, e.Ho, B},
                  {(1 << rbs) / es, TILE_W / e.pw, TILE_H / e.ph, 1},
                  rbs == 7 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (err != cudaSuccess) return err;
  EncodeTiled fn = encode_tiled();
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(KP),
                               static_cast<cuuint64_t>(CO)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(KP)};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(KC),
                              static_cast<cuuint32_t>(CO)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(wq), wdims, wstrides, wbox, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(KC),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, int KC>
cudaError_t launch_tc(const CUtensorMap& xmap, const CUtensorMap& wmap,
                      const CUtensorMap& ymap, TcArgs a,
                      cudaStream_t stream) {
  if (!tc_plan(N, KC, a.nk, a.staging, &a.resident, &a.stages)) {
    return cudaErrorInvalidValue;
  }
  const int smem = tc_smem(N, KC, a.nk, a.stages, a.resident, a.staging);
  auto kernel = int8_conv_tc<N, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int grid = std::min(a.tiles, sms);  // one CTA an SM walks the tiles
  kernel<<<grid, TC_THREADS, smem, stream>>>(xmap, wmap, ymap, a);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_tc_n(const CUtensorMap& xmap, const CUtensorMap& wmap,
                     const CUtensorMap& ymap, const TcArgs& a, int KC,
                     cudaStream_t stream) {
  return KC == 128 ? launch_tc<N, 128>(xmap, wmap, ymap, a, stream)
                   : launch_tc<N, 64>(xmap, wmap, ymap, a, stream);
}

cudaError_t run_tc(int B, int H, int W, int CI, int CO, int KP,
                   const void* x, const void* wq, const Epi& e,
                   cudaStream_t stream) {
  if (!tc_takes(CI, CO) || KP != 9 * CI || !aligned16(x) || !aligned16(wq) ||
      !aligned16(e.y)) {
    return cudaErrorInvalidValue;
  }
  const int KC = tc_chunk(CI);
  TcArgs a;
  a.CI = CI;
  a.nk = 9 * (CI / KC);
  a.tiles_h = (H + TILE_H - 1) / TILE_H;
  a.tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long tiles = static_cast<long long>(B) * a.tiles_h * a.tiles_w;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.tiles = static_cast<int>(tiles);
  a.e = e;
  a.staging = tc_staging(e, CO);
  a.rbs = row_shift(CO * out_size(e.out_kind));
  CUtensorMap xmap, wmap, ymap;
  const cudaError_t err =
      encode_maps(&xmap, &wmap, &ymap, x, wq, B, H, W, CI, CO, KP, KC, e);
  if (err != cudaSuccess) return err;
  switch (CO) {
    case 256: return run_tc_n<256>(xmap, wmap, ymap, a, KC, stream);
    case 128: return run_tc_n<128>(xmap, wmap, ymap, a, KC, stream);
    default: return run_tc_n<64>(xmap, wmap, ymap, a, KC, stream);
  }
}

// --- the direct design (mma.sync on gathered patches) ------------------------
constexpr int D_THREADS = 128;  // 4 warps, each two m16 tiles of pixels
constexpr int D_NCH = 64;       // output channels a pass
constexpr int HALO_H = TILE_H + 2, HALO_W = TILE_W + 2;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four K values k .. k + 3 of the patch of halo pixel (hh, ww): the halo
// [HALO_H][HALO_W][CI] starts one row and column before the tile
template <bool CI1>
__device__ __forceinline__ uint32_t patch4(const int8_t* xs, int CI, int hh,
                                           int ww, int k) {
  uint32_t w = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int kk = k + u;
    const int tap = CI1 ? kk : kk / CI;
    if (tap < 9) {
      const int c = CI1 ? 0 : kk - tap * CI;
      const int kh = tap / 3, kw = tap - kh * 3;
      w |= static_cast<uint32_t>(static_cast<uint8_t>(
               xs[((hh + kh) * HALO_W + ww + kw) * CI + c]))
           << (8 * u);
    }
  }
  return w;
}

// CI1: CI == 1 (conv0_0), the patch's K index is its tap
template <typename TIn, bool CI1>
__global__ void __launch_bounds__(D_THREADS)
    int8_conv_direct(const TIn* __restrict__ x, const int8_t* __restrict__ wq,
                     int KP, float inv_s, int CI, int CO, int tiles_h,
                     int tiles_w, const Epi e) {
  extern __shared__ __align__(16) uint8_t d_raw[];
  uint8_t* stg = d_raw;  // the pooled tile, D_NCH channels
  float4* sbt = reinterpret_cast<float4*>(d_raw + staging_bytes(e, D_NCH));
  int8_t* xs = reinterpret_cast<int8_t*>(sbt + D_NCH / 2);
  int b, h0, w0;
  tile_origin(blockIdx.x, tiles_h, tiles_w, b, h0, w0);
  const int n = HALO_H * HALO_W * CI;
  for (int i = threadIdx.x; i < n; i += D_THREADS) {  // quantized once
    const int c = i % CI, p = i / CI;
    const int h = h0 + p / HALO_W - 1, w = w0 + p % HALO_W - 1;
    int v = 0;
    if (h >= 0 && h < e.H && w >= 0 && w < e.W) {
      v = load_q(
          x[((static_cast<long long>(b) * e.H + h) * e.W + w) * CI + c],
          inv_s);
    }
    xs[i] = static_cast<int8_t>(v);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // m16 tile q = 2 warp + i: rows 2 (q % 4) and 2 (q % 4) + 1 of the tile
  // (fragment rows g and g + 8), columns 8 (q / 4) + g
  int hh[2], ww[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = 2 * warp + i;
    hh[i] = 2 * (q % 4);
    ww[i] = 8 * (q / 4) + g;
  }
  const int es = out_size(e.out_kind);
  const int TWo = TILE_W / e.pw;
  const Stg sg = {stg, (TILE_H / e.ph) * TWo, row_shift(D_NCH * es)};
  EpiPos pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pos[i] = epi_pos(e, h0, w0, h0 + hh[i], w0 + ww[i], lane);
  }
  for (int n0 = 0; n0 < CO; n0 += D_NCH) {
    int acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    for (int k0 = 0; k0 < KP; k0 += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int k = k0 + 16 * half + 4 * t;
            af[i][r + 2 * half] =
                CI1 && k >= 9 ? 0u : patch4<CI1>(xs, CI, hh[i] + r, ww[i], k);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = n0 + 8 * j + g;
        uint32_t b0 = 0, b1 = 0;
        if (nn < CO) {
          const int8_t* wr = wq + static_cast<long long>(nn) * KP + k0 + 4 * t;
          b0 = __ldg(reinterpret_cast<const unsigned int*>(wr));
          b1 = __ldg(reinterpret_cast<const unsigned int*>(wr + 16));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();  // the last copy-out has read the staging buffer
    fill_sb(sbt, e, n0, CO, D_NCH / 2, threadIdx.x, D_THREADS);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nl = 8 * j + 2 * t;  // channels past CO are not copied
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        epi_quad(e, sg, pos[i], sbt[nl / 2], nl * es, acc[i][j][0],
                 acc[i][j][1], acc[i][j][2], acc[i][j][3]);
      }
    }
    __syncthreads();
    // copy the pooled tile out: a pixel's channels n0 .. n0 + nc - 1
    const int nc = CO - n0 < D_NCH ? CO - n0 : D_NCH;
    const int row = nc * es;  // bytes a pixel
    const bool vec = row % 16 == 0 && (CO * es) % 16 == 0 &&
                     (n0 * es) % 16 == 0;
    const int unit = vec ? 16 : 1;
    const int per = row / unit, total = sg.P * per;
    for (int i = threadIdx.x; i < total; i += D_THREADS) {
      const int p = i / per, o = (i - p * per) * unit;
      const int ho = h0 / e.ph + p / TWo, wo = w0 / e.pw + p % TWo;
      if (ho >= e.Ho || wo >= e.Wo) continue;
      const uint8_t* src = stg_at(sg, p, o);
      uint8_t* dst = static_cast<uint8_t*>(e.y) +
                     (((static_cast<long long>(b) * e.Ho + ho) * e.Wo + wo) *
                          CO + n0) * es + o;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        *dst = *src;
      }
    }
  }
}

template <typename TIn>
cudaError_t run_direct(int B, int H, int W, int CI, int CO, int KP,
                       const void* x, const void* wq, float inv_s,
                       const Epi& e, cudaStream_t stream) {
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long tiles = static_cast<long long>(B) * tiles_h * tiles_w;
  const int smem = staging_bytes(e, D_NCH) + D_NCH * 8 + HALO_H * HALO_W * CI;
  if (tiles > 0x7fffffffLL || smem > SMEM_LIMIT || !aligned16(e.y)) {
    return cudaErrorInvalidValue;
  }
  const auto* xt = static_cast<const TIn*>(x);
  const auto* w = static_cast<const int8_t*>(wq);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (CI == 1) {
    auto kernel = int8_conv_direct<TIn, true>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, D_THREADS, smem, stream>>>(xt, w, KP, inv_s, CI, CO,
                                              tiles_h, tiles_w, e);
  } else {
    auto kernel = int8_conv_direct<TIn, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, D_THREADS, smem, stream>>>(xt, w, KP, inv_s, CI, CO,
                                              tiles_h, tiles_w, e);
  }
  return cudaGetLastError();
}

// --- the quantize pass -------------------------------------------------------
template <typename T>
__global__ void int8_quantize(const T* __restrict__ x, int8_t* __restrict__ y,
                              long long n, float inv_s) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * 16;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * 16;
       i < n; i += step) {
    if (i + 16 <= n) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          w[k] |= static_cast<uint32_t>(
                      quant(to_f32(x[i + 4 * k + u]), inv_s) & 0xff)
                  << (8 * u);
        }
      }
      *reinterpret_cast<uint4*>(y + i) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (long long k = i; k < n; ++k) {
        y[k] = static_cast<int8_t>(quant(to_f32(x[k]), inv_s));
      }
    }
  }
}

}  // namespace

// y [n] int8 = clamp(rint(x * inv_s), -127, 127), x f32 (type code 0) or
// bf16 (1), both 16-byte aligned. Returns the launch's CUDA error, or 0.
extern "C" int vo_int8_quantize(int type_code, long long n, const void* x,
                                float inv_s, void* y, void* stream) {
  if (n < 1 || !aligned16(x) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = std::min((n + 16 * 256 - 1) / (16 * 256),
                                    static_cast<long long>(1 << 16));
  auto s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      int8_quantize<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(y), n, inv_s);
      break;
    case 1:
      int8_quantize<bf16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<int8_t*>(y), n, inv_s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The design vo_int8_conv_fused takes for a conv of CI -> CO channels
// writing type out_code (as there) pooled by ph x pw: 1 (int8_conv_tc)
// where the tc kernel takes the widths and its launch plan fits in shared
// memory, else 0 (int8_conv_direct); -1 for arguments no design takes.
extern "C" int vo_int8_conv_design(int CI, int CO, int out_code, int ph,
                                   int pw) {
  if (CI < 1 || CO < 1 || out_code < 0 || out_code > 2 ||
      (ph != 1 && ph != 2) || (pw != 1 && pw != 2)) {
    return -1;
  }
  if (!tc_takes(CI, CO)) return 0;
  Epi e{};
  e.out_kind = out_code;
  e.ph = ph;
  e.pw = pw;
  const int KC = tc_chunk(CI);
  int resident = 0, stages = 0;
  return tc_plan(CO, KC, 9 * (CI / KC), tc_staging(e, CO), &resident,
                 &stages)
             ? 1
             : 0;
}

// One fused int8 conv (see the header): design 1 = int8_conv_tc (x int8,
// CI % 64 == 0, CO in {64, 128, 256}), 0 = int8_conv_direct (any CI, CO);
// x's type code in_code (0: f32, 1: bf16, 2: int8; a float x is quantized
// with inv_s), round_bf: the compute type is bf16; y [B, Ho, Wo, CO] of
// type out_code (0: f32, 1: bf16, 2: int8 quantized with inv_next), Ho =
// ceil(H / ph), Wo = ceil(W / pw), ph and pw 1 or 2, pool_stride: the
// subsample. Returns the first CUDA error of the launch, or 0.
extern "C" int vo_int8_conv_fused(int design, int in_code, int round_bf,
                                  int out_code, int B, int H, int W, int CI,
                                  int CO, int KP, int ph, int pw,
                                  int pool_stride, const void* x,
                                  const void* wq, const void* scale,
                                  const void* bias, float inv_s,
                                  float inv_next, void* y, void* stream) {
  if (B < 1 || H < 1 || W < 1 || CI < 1 || CO < 1 ||
      KP != (9 * CI + 31) / 32 * 32 || (ph != 1 && ph != 2) ||
      (pw != 1 && pw != 2) || out_code < 0 || out_code > 2 ||
      in_code < 0 || in_code > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Epi e;
  e.scale = static_cast<const float*>(scale);
  e.bias = static_cast<const float*>(bias);
  e.y = y;
  e.H = H;
  e.W = W;
  e.inv_next = inv_next;
  e.out_kind = out_code;
  e.round_bf = round_bf;
  e.Ho = (H + ph - 1) / ph;
  e.Wo = (W + pw - 1) / pw;
  e.ph = ph;
  e.pw = pw;
  e.stride = pool_stride;
  auto s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (in_code != 2) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run_tc(B, H, W, CI, CO, KP, x, wq, e, s));
  }
  if (design != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_code) {
    case 0:
      return static_cast<int>(run_direct<float>(B, H, W, CI, CO, KP, x, wq,
                                                inv_s, e, s));
    case 1:
      return static_cast<int>(run_direct<bf16>(B, H, W, CI, CO, KP, x, wq,
                                               inv_s, e, s));
    default:
      return static_cast<int>(run_direct<int8_t>(B, H, W, CI, CO, KP, x, wq,
                                                 inv_s, e, s));
  }
}
