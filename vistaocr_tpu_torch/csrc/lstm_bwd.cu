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
// W, as the reference does (no f32 carry of h in the backward). Every
// design reads a direction's frames of xw, ys, cs, dys and dxw `pitch`
// rows apart with a mask of its own (Frames, lstm_common.cuh): the layer
// passes pitch = B and one mask; the planes of the direction-stacked
// layout pass 2B and a mask each (vo_lstm_bwd_frames, vo_lstm_dwh_frames,
// lstm_bi_stacked.cu). The recomputed gates and the loops' carries and
// exchanges stay dense; the GEMMs over rows (the gate recompute, dwh) map
// each dense row to its frame's row (FrameRows / TileRows: the identity
// at pitch = B, and dense TMA maps only there). lstm_bwd_persistent,
// lstm_bwd_rows and the f32 GEMMs take the pitch and the masks as a
// template flag (kP), so the layer's instantiations are the code they
// were; the other designs read them at run time (PERF.md: their times).
//
// What bounds it on an H100: T strictly sequential frames of too little
// work each ([B,H] x [H,4H] for the gate recompute, [B,4H] x [4H,H] for
// dh: 134 MFLOP and 4 MB of bf16 wh for both directions at B=32, H=512,
// about 1.3 us of the card), so a frame launched on its own is
// latency-bound: the launches, a pass over all of wh from L2, and the
// dependent chain of its product. The dwh sum is the one large product of
// the backward: H x 4H x (T-1)*B multiply-adds, 69 GFLOP for both
// directions at T=512, B=32, H=512: 69 us on the bf16 tensor cores, 1 ms
// on the f32 FMA units.
//
// What this design does about it:
// - The gate recompute is not on the recurrence's chain: its h_prev is
//   the SAVED ys row of the forward, all known before the backward
//   starts. Only dgates(t) -> dh -> dgates(t-1) is sequential.
// - bf16 W (type codes 1 and 2): the gates of every frame recomputed as
//   one GEMM on the tensor cores, pre [T*B, 4H] f32 = f32(xw) +
//   round_W(ys shifted one frame) @ wh (the edge frame's rows read
//   zeros), by bptt_gates_gemm_wide: its operands are bf16 values (the
//   TPU kernel's jnp.dot(h.astype(dtype), wh) is a bf16 product with f32
//   accumulation, which is what wgmma computes). At B=32, T=512 the
//   product's FLOP bound and its bytes bound (xw, ys, wh in, pre out) are
//   of one size (0.131 ms of bytes against 0.069 of products at H=512;
//   0.26 against 0.265 at F2's H=1000), so the stream of pre has to run
//   under the products: one CTA an SM walks 128 x 256 tiles, columns
//   fastest; a producer warp's TMA ring (3 stages of 48 KB: A = ys rows
//   K-major, B = wh rows MN-major) runs across tile boundaries, so the
//   next tile's first stages land during this tile's epilogue, and it
//   brings the tile's bf16 xw (64 KB) by TMA during the main loop; two
//   consumer warpgroups of wgmma.m64n256k16 add xw from shared memory
//   (128B-swizzled: no bank conflicts in the fragment order) and store pre
//   from the fragments (whole 32-byte sectors), and those stores drain
//   under the next tile's wgmma. f32 streams, and rows TMA cannot describe,
//   are loaded by the producer warpgroup and rounded at the store. The
//   maps promote L2 fetches to 128 bytes on rows that are not whole
//   128-byte lines. (It replaced a grid of 128 x 128 tiles, whose epilogue
//   ran after its products, and, above H=512, the FMA form below: times
//   on an NVIDIA H100 80GB HBM3 at 700 W in PERF.md.) Then, up to H=512,
//   lstm_bwd_persistent walks all T frames
//   in one launch: a thread-block cluster of ceil(H/32) CTAs (16 at
//   H=512, a non-portable size checked with cudaOccupancyMaxActiveClusters)
//   per direction and BN batch rows; CTA r owns units 32r..32r+31 and
//   their 128 gate columns, so a unit's dgates are its own CTA's
//   epilogue (pre, cs, dys and the mask arrive by cp.async during the
//   previous frame's product; the f32 dh and dc carries stay in
//   registers; dxw[t] is staged in shared memory and stored under the
//   product). Its dh product is split over the cluster by those
//   columns: P_r[k][b] = sum over own columns g of wh[k][g] * dg[b][g],
//   M = every unit, K = 128, N = BN, with A (wh[:, own columns]) held in
//   registers for all T frames, as lstm_fwd_persistent holds its slice of
//   wh, and B the round_W(dgates) tile in shared memory. Rows 32p..32p+31
//   of P_r are staged in shared memory and go to CTA p as one bulk copy
//   that completes on p's mbarrier (double-buffered receive slots: arrival
//   alone orders the frames, as in lstm_fwd.cu; a sender stages in the
//   buffer it has just summed, which no peer writes before it has received
//   the copy); CTA p sums the C partials of its units in rank order, so
//   each dh element has one owner and a fixed order, no atomics, and two
//   runs give the same bits. At H=512 an H100 holds 7 such clusters at
//   once, and a cluster's frame is one dependent chain (cell backward,
//   product, copies, the peers' copies, the sum), so the rows a cluster
//   take, BN = 32, 16 or 8 (the wgmma N), are chosen by B: the fewest
//   waves of clusters times a frame's time on the card (BWD_ROWS). The
//   partials went as 16-byte st.async stores before, 4096 a CTA and frame
//   at BN = 32, whose issue took 40% of the frame (PERF.md). H <= 512.
// - f32 W (type codes 0 and 3, the parity route): wgmma has no exact f32
//   product (TF32 would change the numbers), so both stages stay on the
//   FMA units, 2, 1 + T or 1 + 2T launches a call. bptt_gates_gemm (the f32 form)
//   recomputes every frame's gates as one GEMM into the same pre as the
//   bf16 form: 128 x 128 tiles, 256 threads of 8 x 8, two CTAs an SM, a
//   4-stage ring of 16-column stages filled by 16-byte cp.async (bf16 ys
//   converted to f32 as shared memory is read), the epilogue adding
//   f32(xw). Then the frame loop, in one of three designs chosen by B and
//   H (loop_design; timed side by side on an H100 in PERF.md):
//   - folded, up to 32 rows: bptt_frame, one launch a frame, folds the
//     cell backward into the dh product. The 4H contraction is split by
//     unit into 8 slices, and a cluster holds the CTAs of one slice and up
//     to 8 blocks of 64 dh units. Its CTAs split the slice's cell backward
//     (dgates, dxw[t], the dc carry), gather the dgates from each other
//     through distributed shared memory, and each multiplies them by its
//     rows of wh (in shared memory by cp.async since the launch began).
//     Each slice's partial dh goes to global memory and the next frame
//     sums the 8 in slice order: a fixed order, no atomics. The carries
//     ping-pong by frame parity.
//   - rows, beyond B=32 for two directions where the card holds two row
//     groups (H <= 528; it fits up to H=688 and is named there):
//     lstm_bwd_rows, one cooperative launch a call, lstm_fwd.cu's
//     lstm_fwd_rows turned around. A direction is A = ceil(H/16) unit
//     groups x G row groups of co-resident CTAs; CTA (a, g) keeps its 16
//     rows of wh ([16, 4H] f32, 128 KB at H=512) in shared memory for all
//     T frames and owns those units' cells over its group's row tiles.
//     Each frame it multiplies every unit's dgates of its rows (8 warps, a
//     gate half each: 4H split 8 ways, each lane 8 or 4 rows x 4 units)
//     into its units' dh, sums the 8 slices' partials in slice order,
//     runs the cell backward of its cells (dxw[t], the dc and (1-m)*dh_t
//     carries), and publishes those dgates, rounded as the product reads
//     them, into an exchange buffer by frame parity, then releases its
//     row group's frame counter; the next frame's CTAs of that group
//     stream the rows through per-warp rings (cp.async, 16 bytes a lane).
//     The exchange is what bounds it: a direction reads A x B x 4H x 4
//     bytes of dgates a frame (32 MB at B=128 for both directions), and
//     the product reads 1.5 to 2 floats of shared memory an FMA.
//   - split, where the rule does not take rows: bptt_cell (the cell
//     backward alone, a thread a unit and row) then bptt_dh (the dh product, the 4H
//     contraction split 8 ways over a cluster, each rank summing its rows
//     of the 8 partial tiles in rank order), two launches a frame, stream
//     order the barrier between frames. (The fold's CTAs each reload their
//     64 KB wh tile and walk one dependent chain a 32-row batch tile.)
//   Any H.
// - bf16 W above H=512 (type codes 1 and 2; F2): no cluster holds wh, so
//   the frame loop is one cooperative launch over the whole card on the
//   tensor cores (lstm_bwd_tc), lstm_fwd.cu's lstm_fwd_tc skeleton turned
//   around: a direction is N = ceil(H/16) co-resident CTAs (63 at H=1000,
//   126 for two directions), CTA r owning units 16r..16r+15, their four
//   gate columns' cell backward over every batch row in 32-row tiles (its
//   epilogue) and their f32 dh and dc carries (one owner an element). Its
//   bf16 rows of wh, wh[16r..16r+15, 0:4H] (125 KB at H=1000), stay in
//   registers for all T frames as mma.sync.m16n8k16 B fragments (8 warps,
//   one a contraction slice: a gate and half of H; 128 registers a
//   thread). The product is dh[rows, own units] = dg[rows, 0:4H] @ wh[own
//   units, :]^T, f32 accumulation, the slices' partials summed in slice
//   order: a fixed order, no atomics, bit-equal reruns. dg = round_bf16(
//   dxw[t]), exactly what the product reads (code 2 stores dxw in f32 and
//   exchanges its rounding), crosses CTAs through L2 once a frame: each
//   CTA writes its 64 columns into one of two parity buffers laid out as
//   the chunks the readers copy (rows padded to an odd number of 16-byte
//   words, so that ldmatrix reads them without bank conflicts), then
//   releases a per-direction frame counter (red.release.gpu after a CTA
//   barrier); a reader acquires it (ld.acquire.gpu) and each warp brings
//   its slice by bulk copies through a private 3-stage ring. Every CTA
//   reads all B x 4H of dg a frame (256 KB at B=32, H=1000; 32 MB across
//   the card), which made that stream about half of the frame; so CTAs
//   run as clusters of two, and each chunk comes once a pair, by one
//   multicast bulk copy issued by rank 0 once both CTAs have read the
//   stage's last chunk (an empty mbarrier of two arrivals). dxw[t] and
//   the carries of a frame's last tile are stored after its release,
//   off the next frame's path. Up to H=1056 for two directions on 132 SMs
//   (bwd_tc_fits); beyond, the frame loop is the f32-weight one above,
//   reading wh widened to f32 (exact; the caller passes both forms), with
//   f32 streams the dxw read back for dh rounded to bf16. The gate GEMM is
//   bptt_gates_gemm_wide and dwh lstm_dwh_tc's 128 x 256 tiles (below).
// - dwh is not summed frame by frame as on the TPU (where the kernel keeps
//   it in VMEM across the grid): it is one product over K = (T-1)*B rows
//   after the loop, taking ys and dxw at a one-frame offset (the rows of
//   the edge frame, whose h_prev is zero, are left out). That is the same
//   sum in another order, in f32. For a bf16 stream or weight type (where
//   rounding to W makes both operands bf16 values) it is lstm_dwh_tc, a
//   warp-specialised wgmma GEMM: one producer warp keeps a 4-stage ring of
//   64-row K tiles full with TMA (bf16 streams) or the producer
//   warpgroup's loads rounded to bf16 at the shared-memory store (f32
//   streams, or rows TMA cannot describe), both operands MN-major, a CTA's
//   rows summed in order in one accumulator chain. Its tiles are
//   128 x 128 up to H=512 (one wave of 128 CTAs there) and 128 x 256
//   above (dwh_design). At F2's H=1000 (B=32, T=512: 262 GFLOP for both
//   directions) what bounds it is the L2: the rows (2000 and 8000 bytes)
//   are not whole 128-byte lines, so a TMA box row spans two, and the
//   128 x 128 grid's rate an SM falls as more SMs run, where on whole
//   lines (H=1024) it holds.
//   The wide tiles ask the L2 for a third fewer bytes and boxes a
//   product, the grid runs the M tiles fastest so that the CTAs of a wave
//   share dxw's columns, and the maps promote L2 fetches to 128 bytes on
//   such rows, not 256 (times on an H100 in PERF.md). The wide tiles also
//   split the rows into ranges of at most 4096, each summed by its own
//   CTA: one accumulator chain over all 16352 rows of B=32, T=512 stood
//   twice as far from the exact sum as cuBLAS at H=520. Each CTA stores
//   its partial tile to a workspace and takes a ticket; the tile's last
//   CTA adds the partials in split order and writes dwh (one launch, a
//   fixed order).
//   f32/f32 (type code 0, the parity route) stays on the f32 FMA units, so
//   that no TF32 rounding changes its numbers: lstm_dwh_fma, 69 GFLOP at
//   B=32, T=512, H=512 against 67 TFLOP/s (1.02 ms). One CTA a 128 x 128
//   tile over all rows (the design before it) was 128 CTAs on 132 SMs,
//   two warps a scheduler, one 16352-row chain an element. So the rows
//   are split into ranges of at most 2048 (8 at the train buckets: 1024
//   CTAs, two an SM), each summed by its own CTA and folded like the wide
//   tiles' splits (a ticket a tile, the last CTA adds the partials in
//   split order: one launch, a fixed order), with a 3-stage ring of 32-row
//   stages by 16-byte cp.async (one barrier a 32 rows) and 8 x 8 a
//   thread. It runs near 69% of the FMA peak (below).
// Ragged B, H and 4H edges read as zeros, so any B, T >= 1 and H >= 1;
// every output element is written, and two runs give the same bits. Times
// on an H100 (NVIDIA H100 80GB HBM3, 700 W) are in PERF.md.

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
// dst + j*rows*128) with src[at(row0 + r - at0)*ld + col0 + 64j + c],
// rows row0 + r outside [0, nrows) and columns >= end as zeros. at: where
// a frame-structured source holds its dense rows from row at0 on (a tile
// of FrameRows; the identity by default). bf16 sources
// with `vec` go by cp.async (the caller waits); others are loaded a batch
// of chunks at a time and rounded to bf16 only as they are stored, so the
// loads of a batch are in flight together.
template <typename T>
__device__ __forceinline__ void fill_tile(uint8_t* dst, int rows, const T* src,
                                          long long ld, long long row0,
                                          long long nrows, long long col0,
                                          long long end, int nblk, bool vec,
                                          int tid, int nthreads,
                                          const TileRows& at = TileRows(),
                                          long long at0 = 0) {
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
      const bool ok = gr >= 0 && gr < nrows;
      const T* row = src + (ok ? at(static_cast<unsigned>(gr - at0)) : 0) * ld;
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

// dwh[k][g] = sum_r round_W(a[r][k]) * round_W(c[r][g]) over R rows:
// a = ys rows of the predecessor frames, c = dxw rows of their successors.
template <typename S>
struct DwhDir {
  const S* a;   // [R, H] (dense row r at FrameRows(B, pitch)(r))
  const S* c;   // [R, 4H] (likewise)
  float* out;   // [H, 4H]
  int B;        // rows of a frame
  int pitch;    // rows between frames of a and c
};

// f32/f32 (type code 0, the parity route): exact f32 FMAs on the FMA units
// (TF32 would change the numbers). Tiles of 128 x 128 of dwh, 256 threads
// of 8 x 8 (rows 4*tm + {0..3, 64..67}, columns 4*tn + {0..3, 64..67}); a
// warp's lanes are 4 tm by 8 tn. The contraction runs in stages of DQ rows
// through a DSTAGES-deep ring filled by 16-byte cp.async (one running
// pointer an operand: per-copy addresses, which the compiler hoisted out
// of the loop, cost registers and about 7%), one barrier a stage. The rows
// are split into ranges (dwh_f32_splits) so that the card holds a wave of
// DLB CTAs an SM and no accumulator chain sums more than DWH_F32_CHAIN
// stages (at 4096 rows it stood as far from the exact sum as one cuBLAS
// call, at 2048 about 0.6 of it); the ranges' partial tiles are folded by
// dwh_fold, as lstm_dwh_tc's splits are: one launch, a fixed order. Near
// 69% of the FMA peak: cut-down copies (profile_lstm_dwh_fma.py) show the
// fragment reads from shared memory cost about 6%, and the copies,
// barriers and fold alone take 59% of the FMA bound (each 128 columns
// of a are read by 4H/128 CTAs, of c by H/128) without fully hiding under
// the FMAs. 8 x 16 a thread took 255 registers in CUDA C, spilled and ran
// slower, as did 64-row tiles, 16-row stages, register double-buffering
// and other unrollings (times on an H100 in PERF.md).
constexpr int DQ = 32;
constexpr int DSTAGES = 3;
constexpr int DLB = 2;  // CTAs an SM (the launch bounds)
constexpr int DTHREADS = 256;
constexpr int DWH_F32_CHAIN = 2048 / DQ;  // stages: chains of <= 2048 rows
constexpr int DWH_F32_MIN = 8;  // the fewest stages a split made to fill
                                // the card takes

constexpr int dwh_f32_smem() { return DSTAGES * DQ * 256 * 4; }

// The fold of a dwh tile whose rows were split over `splits` CTAs
// (lstm_dwh_fma, lstm_dwh_tc's wide tiles): each of the `nt` threads
// taking part (thread t) holds NV float4s of the partial tile, acc[4j ..
// 4j + 3], and stores them to ws at [tile][split][j][t]; once the CTA's
// stores are visible it takes the tile's ticket, and the tile's last CTA
// adds the partials in split order (its own from registers) into acc.
// Returns whether this CTA is that last one (the others are done). The
// threads taking part meet at named barrier 1.
template <int NV>
__device__ __forceinline__ bool dwh_fold(float* acc, float4* ws, int* tickets,
                                         long long tile, int split,
                                         int splits, int t, int nt) {
  __shared__ int last;
  float4* mine = ws + (tile * splits + split) * NV * nt + t;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    mine[j * nt] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                               acc[4 * j + 3]);
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
  if (t == 0) last = atomicAdd(&tickets[tile], 1) == splits - 1;
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
  if (!last) return false;
  __threadfence();
  const float4* base = ws + tile * splits * NV * nt + t;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 p =
          q == split ? make_float4(acc[4 * j], acc[4 * j + 1],
                                   acc[4 * j + 2], acc[4 * j + 3])
                     : __ldcg(base + (q * NV + j) * nt);
      if (q == 0) {
        v = p;
      } else {
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    acc[4 * j] = v.x;
    acc[4 * j + 1] = v.y;
    acc[4 * j + 2] = v.z;
    acc[4 * j + 3] = v.w;
  }
  return true;
}

// Grid (ceil(4H/128), ceil(H/128), ndir * splits), the split slowest, as
// lstm_dwh_tc's. Each CTA sums its range of stages; with splits > 1 it
// stores its partial tile to `ws`, takes the tile's ticket, and the
// tile's last CTA adds the partials in split order (its own from
// registers) and writes dwh. `vec`: rows of whole, aligned float4s (16-byte
// copies); else value by value. kP: the frames of a and c lie d.pitch
// rows apart (FrameRows), so each copy finds its row's address; without
// it the rows are dense and one running pointer an operand walks them.
template <bool kP>
__global__ void __launch_bounds__(DTHREADS, DLB)
lstm_dwh_fma(DwhDir<float> d0, DwhDir<float> d1, long long R, int H, int vec,
             int splits, float4* ws, int* tickets) {
  const int ndir = gridDim.z / splits;
  const int dir = blockIdx.z % ndir, split = blockIdx.z / ndir;
  const DwhDir<float> d = dir == 0 ? d0 : d1;
  const FrameRows rows_at(d.B, d.pitch);
  extern __shared__ __align__(16) float dwh_f32_raw[];
  float* as = dwh_f32_raw;               // [DSTAGES][DQ][128]
  float* cs = as + DSTAGES * DQ * 128;   // [DSTAGES][DQ][128]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = 4 * (warp / 2) + lane / 8;  // 0 .. 15
  const int tn = 8 * (warp % 2) + lane % 8;  // 0 .. 15
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const long long G = 4LL * H;
  const long long nk = (R + DQ - 1) / DQ;
  const long long per = (nk + splits - 1) / splits;
  const long long k0 = split * per;
  const int n = static_cast<int>(max(0LL, min(nk, k0 + per) - k0));
  // a stage's copies: this thread's float4 at column lc of rows lr +
  // RSTEP * j of a's and of c's 128-value rows (the same place in both)
  constexpr int RSTEP = DTHREADS / 32;
  const int lr = tid / 32, lc = 4 * (tid % 32);
  const bool oka = m0 + lc < H, okc = n0 + lc < G;  // whole float4s (vec)
  // the split's rows (at most DWH_F32_CHAIN stages) from its first
  const TileRows at_split = rows_at.tile(k0 * DQ);
  const float* pa0 = d.a + (oka ? m0 + lc : 0);
  const float* pc0 = d.c + (okc ? n0 + lc : 0);
  auto stage = [&](int i) {
    const int s = i % DSTAGES;
    long long r = (k0 + i) * DQ + lr;
    float* sa = as + s * DQ * 128 + lr * 128 + lc;
    float* sc = cs + s * DQ * 128 + lr * 128 + lc;
    if (kP && vec) {  // a copy's address a row
#pragma unroll
      for (int j = 0; j < DQ / RSTEP; ++j, r += RSTEP) {
        const bool ok = r < R;
        const long long fr = at_split(i * DQ + lr + j * RSTEP);
        cp_async16_zfill(sa + j * RSTEP * 128, ok && oka ? pa0 + fr * H : d.a,
                         ok && oka);
        cp_async16_zfill(sc + j * RSTEP * 128, ok && okc ? pc0 + fr * G : d.c,
                         ok && okc);
      }
    } else if (vec) {  // one running pointer an operand: nothing for the
                       // compiler to hoist into registers a chunk
      const float* pa = pa0 + r * H;
      const float* pc = pc0 + r * G;
#pragma unroll
      for (int j = 0; j < DQ / RSTEP; ++j) {
        const bool ok = r < R;
        cp_async16_zfill(sa + j * RSTEP * 128, ok && oka ? pa : d.a,
                         ok && oka);
        cp_async16_zfill(sc + j * RSTEP * 128, ok && okc ? pc : d.c,
                         ok && okc);
        r += RSTEP;
        pa += RSTEP * H;
        pc += RSTEP * G;
      }
    } else {
      for (int j = 0; j < DQ / RSTEP; ++j, r += RSTEP) {
        const long long fr = kP ? rows_at(r) : r;
        for (int e = 0; e < 4; ++e) {
          sa[j * RSTEP * 128 + e] =
              r < R && m0 + lc + e < H ? d.a[fr * H + m0 + lc + e] : 0.0f;
          sc[j * RSTEP * 128 + e] =
              r < R && n0 + lc + e < G ? d.c[fr * G + n0 + lc + e] : 0.0f;
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < DSTAGES - 1; ++i) {
    if (i < n) stage(i);
    cp_async_commit();  // one group a stage, empty past n
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_group<DSTAGES - 2>();  // this thread's copies of stage i
    __syncthreads();  // ... and everyone's; stage i-1's readers are done
    if (i + DSTAGES - 1 < n) stage(i + DSTAGES - 1);  // into i-1's slot
    cp_async_commit();
    const float* a = as + (i % DSTAGES) * DQ * 128 + 4 * tm;
    const float* c = cs + (i % DSTAGES) * DQ * 128 + 4 * tn;
#pragma unroll
    for (int k = 0; k < DQ; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * 128);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * 128 + 64);
      const float4 c0 = *reinterpret_cast<const float4*>(c + k * 128);
      const float4 c1 = *reinterpret_cast<const float4*>(c + k * 128 + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[ii][j] = fmaf(av[ii], cv[j], acc[ii][j]);
    }
  }

  if (splits > 1) {  // a thread's acc[i][4h .. 4h + 3] is float4 2i + h
    const long long tile =
        ((long long)dir * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!dwh_fold<16>(&acc[0][0], ws, tickets, tile, split, splits, tid,
                      DTHREADS)) {
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = m0 + 4 * tm + (i % 4) + 64 * (i / 4);
    if (k >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long g = n0 + 4 * tn + 64 * h;  // G and g: multiples of 4
      if (g < G) {
        *reinterpret_cast<float4*>(&d.out[(long long)k * G + g]) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
}

// bf16 operands (any stream type with bf16 W, or bf16 streams): tiles of
// 128 x TN of dwh on the tensor cores (TN = 128 or 256), each consumer
// warpgroup 64 x TN, one wgmma.m64n{TN}k16 a 16-deep step. A stage holds
// 64 contraction rows as 64 x 64 boxes: two of a (columns m0..m0+63,
// warpgroup 0's M half, and m0+64..m0+127, warpgroup 1's) and TN/64 of c
// (columns n0..n0+TN-1). Both operands are MN-major: a row of a box is 64
// M (or N) values.
constexpr int GK = 64;
constexpr int GSTAGES = 4;
constexpr int GBOX = 64 * 128;
constexpr int GTHREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int WN = 256;        // the wide tiles' N (dwh and the gate GEMM)
constexpr int WSTAGE = 6 * GBOX;
constexpr int TILES_MAX_H = 512;  // dwh_design's wide tiles are above it
// The longest chain of stages one accumulator sums in the wide design
// (4096 rows): the tensor cores' f32 accumulator loses more on each
// addition than a round-to-nearest add, and one chain over the 16352 rows
// of B=32, T=512 stood about twice as far from the exact sum as one
// cuBLAS call at H=520 (chip_smoke.py's F2 phase, PERF.md).
constexpr int DWH_CHAIN = 64;

template <int TN>
__host__ __device__ constexpr int dwh_stage() {
  return (2 + TN / 64) * GBOX;
}

template <int TN>
constexpr int dwh_smem() {
  return 1024 + GSTAGES * dwh_stage<TN>() + 2 * GSTAGES * 8;
}

struct DwhMaps {
  CUtensorMap a[2];  // per direction: ys rows [R, H], 64 x 64 boxes
  CUtensorMap c[2];  // dxw rows [R, 4H]
};

// Grid (ceil(H/128), ceil(4H/TN), ndir * splits): the M tiles fastest, so
// the CTAs that run together read the same columns of c, the larger
// operand, and each c row is fetched into L2 about once a wave; the
// contraction's split slowest, so that a wave sums one range of rows. The
// 128 x 256 tiles split the rows into `splits` ranges (see DWH_CHAIN):
// each CTA sums its range, stores that partial tile to `ws` and counts
// itself in the tile's ticket; the tile's last CTA adds the partials in
// split order (its own from registers) and writes dwh, so the order is
// fixed whichever CTA ends last, and two runs give the same bits. (A sum
// that stored its chains from inside the K loop, in one CTA, was slower:
// an access to the accumulators there costs the wgmma pipeline.)
template <typename S, bool kTma, int TN>
__global__ void __launch_bounds__(GTHREADS, 1)
lstm_dwh_tc(const __grid_constant__ DwhMaps maps, DwhDir<S> d0, DwhDir<S> d1,
            int R, int H, int vec, int splits, float4* ws, int* tickets) {
  constexpr int STAGE = dwh_stage<TN>();
  const int ndir = gridDim.z / splits;
  const int dir = blockIdx.z % ndir, split = blockIdx.z / ndir;
  const DwhDir<S> d = dir == 0 ? d0 : d1;
  extern __shared__ uint8_t dwh_raw[];
  uint8_t* sm = align1024(dwh_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GSTAGES * STAGE);
  uint64_t* empty = full + GSTAGES;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * TN;
  const int G = 4 * H;
  const int nk = (R + GK - 1) / GK;
  const int per = (nk + splits - 1) / splits;
  const int k0 = split * per, k1 = min(nk, k0 + per);
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
    // the split's rows from its first (TMA reads dense rows)
    const TileRows at =
        kTma ? TileRows() : FrameRows(d.B, d.pitch).tile((long long)k0 * GK);
    for (int kt = k0; kt < k1; ++kt) {
      const int s = (kt - k0) % GSTAGES, n = (kt - k0) / GSTAGES;
      uint8_t* st = sm + s * STAGE;
      const int r0 = kt * GK;
      if constexpr (kTma) {
        if (tid != 0) break;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE);
        for (int h = 0; h < 2; ++h) {
          tma_load_2d(st + h * GBOX, &maps.a[dir], &full[s], m0 + 64 * h, r0);
        }
        for (int c = 0; c < TN / 64; ++c) {
          tma_load_2d(st + (2 + c) * GBOX, &maps.c[dir], &full[s],
                      n0 + 64 * c, r0);
        }
      } else {
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        fill_tile<S>(st, 64, d.a, H, r0, R, m0, H, 2, vec, tid, 128, at,
                     (long long)k0 * GK);
        fill_tile<S>(st + 2 * GBOX, 64, d.c, G, r0, R, n0, G, TN / 64, vec,
                     tid, 128, at, (long long)k0 * GK);
        cp_async_wait_all();
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumers: rows m0 + 64*wg .. +63 of the tile
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
    for (int kt = k0; kt < k1; ++kt) {
      const int s = (kt - k0) % GSTAGES;
      mbar_wait(&full[s], ((kt - k0) / GSTAGES) & 1);
      const uint32_t a = smem_u32(sm + s * STAGE + wg * GBOX);
      const uint32_t b = smem_u32(sm + s * STAGE + 2 * GBOX);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < GK / 16; ++j) {  // 16 rows = two 8-row atoms
        // MN-major: LBO steps between 64-wide M/N blocks, SBO between
        // 8-row groups of the contraction
        if constexpr (TN == 128) {
          wgmma_m64n128<1, 1>(acc, wgmma_desc(a + j * 2048, GBOX, 1024),
                              wgmma_desc(b + j * 2048, GBOX, 1024));
        } else {
          wgmma_m64n256<1, 1>(acc, wgmma_desc(a + j * 2048, GBOX, 1024),
                              wgmma_desc(b + j * 2048, GBOX, 1024), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > k0 && threadIdx.x % 128 == 0) {
        mbar_arrive(&empty[(kt - k0 - 1) % GSTAGES]);
      }
    }
    wgmma_wait<0>();
    if constexpr (TN == WN) {
      if (splits > 1) {  // the 256 consumer threads take part
        const long long tile =
            ((long long)dir * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x;
        if (!dwh_fold<TN / 8>(acc, ws, tickets, tile, split, splits,
                              threadIdx.x, 256)) {
          return;
        }
      }
    }
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
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

// a [rows, cols] row-major bf16 matrix in 64 x 64 boxes, 128B swizzle;
// boxes past the edges read as zeros
cudaError_t encode_rows(CUtensorMap* map, const void* base, long long cols,
                        long long rows, CUtensorMapL2promotion promotion) {
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
                        CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tickets' bytes, rounded up so that the partial tiles behind them
// are 16-byte aligned
inline long long dwh_ticket_bytes(long long tiles) {
  return (tiles * 4 + 15) / 16 * 16;
}

template <typename S, bool kTma, int TN>
cudaError_t launch_dwh_tc(const DwhMaps& maps, const DwhDir<S>* d, int R,
                          int H, int ndir, int vec, int splits, void* work,
                          cudaStream_t stream) {
  constexpr int smem = dwh_smem<TN>();
  auto kernel = lstm_dwh_tc<S, kTma, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long nt = (4LL * H + TN - 1) / TN, mt = (H + 127) / 128;
  if (nt > 65535 || (long long)splits * ndir > 65535 ||
      (splits > 1 && (TN != WN || work == nullptr))) {
    return cudaErrorInvalidValue;
  }
  int* tickets = nullptr;
  float4* ws = nullptr;
  if (splits > 1) {
    const long long tiles = ndir * nt * mt;
    tickets = static_cast<int*>(work);
    ws = reinterpret_cast<float4*>(static_cast<char*>(work) +
                                   dwh_ticket_bytes(tiles));
    err = cudaMemsetAsync(tickets, 0, sizeof(int) * tiles, stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt),
                  splits * ndir);
  kernel<<<grid, GTHREADS, smem, stream>>>(maps, d[0], d[1], R, H, vec,
                                           splits, ws, tickets);
  return cudaGetLastError();
}

template <typename S, bool kTma>
cudaError_t launch_dwh(const DwhMaps& maps, const DwhDir<S>* d, int R, int H,
                       int ndir, int vec, bool wide, int splits, void* work,
                       cudaStream_t stream) {
  return wide ? launch_dwh_tc<S, kTma, WN>(maps, d, R, H, ndir, vec, splits,
                                           work, stream)
              : launch_dwh_tc<S, kTma, 128>(maps, d, R, H, ndir, vec, splits,
                                            work, stream);
}

// The TMA maps' L2 promotion: 128 bytes where the rows are not whole
// 128-byte lines (H % 64 != 0), where a box row spans two lines and the
// wider promotion costs lstm_dwh_tc and bptt_gates_gemm_wide time
// (profile_lstm_bwd_gemms.py; PERF.md); 256 elsewhere.
inline CUtensorMapL2promotion l2_promotion(int H) {
  return H % 64 != 0 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                     : CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
}

// dwh's designs for bf16 operands: lstm_dwh_tc in 128 x 128 tiles
// (DWH_TILES) or 128 x 256 (DWH_WIDE). The library's (dwh_design, chosen
// on an H100: PERF.md): the 128 x 128 tiles up to H=512, where the wide
// grid would leave half the SMs idle (64 CTAs at H=512); the wide tiles
// above it, which ask for a third fewer L2 bytes a product.
constexpr int DWH_TILES = 0;
constexpr int DWH_WIDE = 1;
inline int dwh_design(int H) {
  return H > TILES_MAX_H ? DWH_WIDE : DWH_TILES;
}

// The wide design splits the contraction of R rows into ranges of at
// most DWH_CHAIN stages, each summed by its own CTA; the 128 x 128 tiles
// keep one (at the flagship's H=512 they stand as near the exact sum as
// cuBLAS, and a split would cost them their one wave).
inline int dwh_splits(int design, long long R) {
  const long long nk = (R + GK - 1) / GK;
  return design == DWH_WIDE && nk > DWH_CHAIN
             ? static_cast<int>((nk + DWH_CHAIN - 1) / DWH_CHAIN)
             : 1;
}

// The workspace a bf16 design needs (bytes; 0 with one split): a ticket a
// tile, then a partial tile a split.
long long dwh_workspace(int design, int T, int B, int H, int ndir) {
  const int splits = dwh_splits(design, (long long)(T - 1) * B);
  if (splits == 1) return 0;
  const long long tiles = ndir * ((4LL * H + WN - 1) / WN) * ((H + 127) / 128);
  return dwh_ticket_bytes(tiles) + tiles * splits * 128LL * WN * 4;
}

// lstm_dwh_fma's split of R rows over `tiles` tiles of 128 x 128: ranges
// of at most DWH_F32_CHAIN stages, and enough of them for a wave of DLB
// CTAs an SM where each still takes DWH_F32_MIN stages.
inline int dwh_f32_splits(long long R, long long tiles, int sms) {
  const long long nk = (R + DQ - 1) / DQ;
  const long long chains = (nk + DWH_F32_CHAIN - 1) / DWH_F32_CHAIN;
  const long long fill = std::min((1LL * DLB * sms + tiles - 1) / tiles,
                                  std::max(1LL, nk / DWH_F32_MIN));
  return static_cast<int>(std::max({1LL, chains, fill}));
}

inline long long dwh_f32_tiles(int H, int ndir) {
  return ndir * ((4LL * H + 127) / 128) * ((H + 127) / 128);
}

// The workspace lstm_dwh_fma needs (bytes; 0 with one split): a ticket a
// tile, then a partial tile a split.
long long dwh_f32_workspace(int T, int B, int H, int ndir) {
  const long long tiles = dwh_f32_tiles(H, ndir);
  const int splits =
      dwh_f32_splits((long long)(T - 1) * B, tiles, device_sms());
  if (splits == 1) return 0;
  return dwh_ticket_bytes(tiles) + tiles * splits * 128LL * 128 * 4;
}

template <bool kP>
cudaError_t launch_dwh_f32(const DwhDir<float>* d, long long R, int H,
                           int ndir, int vec, void* work,
                           cudaStream_t stream) {
  constexpr int smem = dwh_f32_smem();
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_dwh_fma<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long nt = (4LL * H + 127) / 128, mt = (H + 127) / 128;
  const long long tiles = dwh_f32_tiles(H, ndir);
  const int splits = dwh_f32_splits(R, tiles, device_sms());
  if (nt > 0x7fffffffLL || mt > 65535 || (long long)splits * ndir > 65535 ||
      (splits > 1 && work == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int* tickets = nullptr;
  float4* ws = nullptr;
  if (splits > 1) {
    tickets = static_cast<int*>(work);
    ws = reinterpret_cast<float4*>(static_cast<char*>(work) +
                                   dwh_ticket_bytes(tiles));
    const cudaError_t err =
        cudaMemsetAsync(tickets, 0, sizeof(int) * tiles, stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(mt),
                  splits * ndir);
  lstm_dwh_fma<kP><<<grid, DTHREADS, smem, stream>>>(d[0], d[1], R, H, vec,
                                                     splits, ws, tickets);
  return cudaGetLastError();
}

template <typename S, typename W>
int run_dwh(int design, int T, int B, int H, int ndir, int pitch,
            const void* const* ys, const void* const* dxw, void* const* dwh,
            const int* reverse, void* work, cudaStream_t stream) {
  constexpr bool f32 =
      std::is_same<S, float>::value && std::is_same<W, float>::value;
  if (design < -1 || design > DWH_WIDE || (f32 && design != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (design == -1) design = dwh_design(H);
  DwhDir<S> d[2];
  const long long PH = (long long)pitch * H;  // a frame of ys
  const long long R = (long long)(T - 1) * B;
  const int G = 4 * H;
  for (int i = 0; i < ndir; ++i) {
    const S* y = static_cast<const S*>(ys[i]);
    const S* g = static_cast<const S*>(dxw[i]);
    // forward: ys[0..T-2] with dxw[1..T-1]; reverse: ys[1..T-1] with
    // dxw[0..T-2]
    d[i].a = reverse[i] ? y + PH : y;
    d[i].c = reverse[i] ? g : g + 4 * PH;
    d[i].out = static_cast<float*>(dwh[i]);
    d[i].B = B;
    d[i].pitch = pitch;
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
  if constexpr (f32) {
    const int vec = aligned && H % 4 == 0;  // rows of whole float4s
    return static_cast<int>(
        pitch == B ? launch_dwh_f32<false>(d, R, H, ndir, vec, work, stream)
                   : launch_dwh_f32<true>(d, R, H, ndir, vec, work, stream));
  } else {
    if (R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = aligned && H % 8 == 0;  // rows of whole 8-value chunks
    const bool wide = design == DWH_WIDE;
    const int splits = dwh_splits(design, R);
    const CUtensorMapL2promotion promo = l2_promotion(H);
    DwhMaps maps = {};
    if constexpr (std::is_same<S, bf16>::value) {
      // TMA: dense bf16 rows whose strides and bases are 16-byte aligned
      if (vec && pitch == B) {
        for (int i = 0; i < ndir; ++i) {
          cudaError_t err = encode_rows(&maps.a[i], d[i].a, H, R, promo);
          if (err == cudaSuccess) {
            err = encode_rows(&maps.c[i], d[i].c, G, R, promo);
          }
          if (err != cudaSuccess) return static_cast<int>(err);
        }
        if (ndir == 1) {
          maps.a[1] = maps.a[0];
          maps.c[1] = maps.c[0];
        }
        return static_cast<int>(launch_dwh<S, true>(
            maps, d, static_cast<int>(R), H, ndir, vec, wide, splits, work,
            stream));
      }
    }
    return static_cast<int>(launch_dwh<S, false>(
        maps, d, static_cast<int>(R), H, ndir, vec, wide, splits, work,
        stream));
  }
}

// --- bf16 weights: the gate recompute as one persistent GEMM ----------------

// pre[r][n] = f32(xw[r][n]) + sum_k round_W(ys[r + off][k]) * wh[k][n] over
// the R = T*B rows of one direction; ys rows outside [0, R) read as zeros
// (the edge frame, whose h_prev is zero, gets f32(xw) alone). Rows are
// dense frame rows r = t*B + b: xw and ys hold row r at FrameRows(B,
// pitch)(r) (so off is a frame of pitch rows there), pre is dense.
struct GatesDir {
  const void* xw;  // [R, 4H] in S
  const void* ys;  // [R, H] in S
  const bf16* wh;  // [H, 4H]
  float* pre;      // [R, 4H]
  long long off;   // -B (forward: h_prev = ys[t-1]) or +B (reverse: ys[t+1])
  int pitch;       // rows between frames of xw and ys
};

// bptt_gates_gemm_wide, for bf16 W at every H. Where the time goes: at
// B=32, T=512, H=1000 (F2) the product is
// 262 GFLOP for both directions and pre alone 524 MB of f32, so the bytes
// bound (xw, ys, wh in, pre out: 0.26 ms) and the FLOP bound (0.265 ms) are
// about equal, and the epilogue's stream has to run under the next tile's
// products. So: one CTA an SM walks the tiles (128 rows x 256 columns,
// columns fastest, so a wave shares its ys rows and all of wh in L2); the
// producer keeps a 3-stage ring of 48 KB stages full by TMA across tile
// boundaries, so the next tile's first stages land during this tile's
// epilogue, and brings this tile's xw (bf16, 64 KB, 128B-swizzled) by TMA
// during its main loop; the consumers add it from shared memory (bank-
// conflict free in the fragment order) and store pre straight from the
// fragments (8 rows x 32 bytes a warp store: whole sectors), and those
// stores drain under the next tile's wgmma.
// Tiles never start before the first ys row: a direction's rows are split
// into its inner rows, which have a predecessor frame (forward: rows
// B..R-1 read ys row r - B; reverse: rows 0..R-B-1 read row r + B), tiled
// from the region's first row, and the edge frame's B rows (pre = f32(xw),
// no product), tiled last.
struct GatesWideMaps {
  CUtensorMap a[2];  // per direction: ys rows [R, H], 64 x 64 boxes
  CUtensorMap b[2];  // wh rows [H, 4H]
  CUtensorMap x[2];  // xw rows [R, 4H] (bf16 streams)
};

constexpr int GW_STAGES = 3;
constexpr int GW_XW = 8 * GBOX;  // xw tile: 2 row halves x 4 column boxes

template <bool kTma>
constexpr int gates_wide_smem() {
  return 1024 + GW_STAGES * WSTAGE + (kTma ? GW_XW : 0) +
         (2 * GW_STAGES + 2) * 8;
}

struct WideTile {
  int dir;
  int nk;   // contraction stages; 0 for an edge tile
  int m0;   // first pre row
  int a0;   // first ys row (inner tiles)
  int end;  // the region's end row: rows from it on are not stored
  int n0;   // first column
};

// tile t: the inner tiles of direction 0, then of direction 1, then the
// edge tiles of each, columns fastest
__device__ __forceinline__ WideTile wide_tile(int t, int ndir, int R, int B,
                                              int nk, int nt, int mi, int me,
                                              const GatesDir& d0,
                                              const GatesDir& d1) {
  WideTile w;
  const int inner = ndir * mi * nt;
  const bool edge = t >= inner;
  const int per = edge ? me * nt : mi * nt;
  const int u = edge ? t - inner : t;
  w.dir = u / per;
  const int m = (u % per) / nt;
  w.n0 = (u % nt) * WN;
  const bool rev = (w.dir == 0 ? d0 : d1).off > 0;
  if (!edge) {
    w.nk = nk;
    w.m0 = (rev ? 0 : B) + 128 * m;
    w.a0 = (rev ? B : 0) + 128 * m;
    w.end = rev ? R - B : R;
  } else {
    w.nk = 0;
    w.m0 = (rev ? R - B : 0) + 128 * m;
    w.a0 = 0;
    w.end = rev ? R : B;
  }
  return w;
}

template <typename S, bool kTma>
__global__ void __launch_bounds__(GTHREADS, 1)
bptt_gates_gemm_wide(const __grid_constant__ GatesWideMaps maps, GatesDir d0,
                     GatesDir d1, int R, int B, int H, int ndir, int vec) {
  extern __shared__ uint8_t gw_raw[];
  uint8_t* sm = align1024(gw_raw);
  uint8_t* xs = sm + GW_STAGES * WSTAGE;  // the tile's xw (kTma)
  uint64_t* full =
      reinterpret_cast<uint64_t*>(xs + (kTma ? GW_XW : 0));
  uint64_t* empty = full + GW_STAGES;
  uint64_t* xw_full = empty + GW_STAGES;
  uint64_t* xw_empty = xw_full + 1;
  const int G = 4 * H;
  const int nk = (H + GK - 1) / GK;
  const int nt = (G + WN - 1) / WN;
  const int mi = (R - B + 127) / 128, me = (B + 127) / 128;
  const int tiles = ndir * (mi + me) * nt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(xw_full, 1);
    mbar_init(xw_empty, 256);  // every consumer thread, after its reads
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  // both directions' layout (TMA reads dense rows: no map to build)
  const FrameRows rows_at = kTma ? FrameRows() : FrameRows(B, d0.pitch);

  if (wg == 2) {  // producer
    const int tid = threadIdx.x - 256;
    if (kTma && tid != 0) return;
    int pc = 0;  // stages produced, over all of this CTA's tiles
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const WideTile w = wide_tile(t, ndir, R, B, nk, nt, mi, me, d0, d1);
      const GatesDir d = w.dir == 0 ? d0 : d1;
      const int nx = w.nk < GW_STAGES ? w.nk : GW_STAGES;
      const TileRows at = rows_at.tile(w.a0);  // the tile's ys rows
      for (int kt = 0; kt <= w.nk; ++kt) {
        if (kTma && kt == nx) {
          // this tile's xw, once the consumers have read the last tile's:
          // after the first ring's worth of stages, which the consumers
          // take during the last tile's epilogue
          if (it > 0) mbar_wait(xw_empty, (it - 1) & 1);
          mbar_arrive_expect_tx(xw_full, GW_XW);
          for (int h = 0; h < 2; ++h) {
            for (int c = 0; c < 4; ++c) {
              tma_load_2d(xs + (4 * h + c) * GBOX, &maps.x[w.dir], xw_full,
                          w.n0 + 64 * c, w.m0 + 64 * h);
            }
          }
        }
        if (kt == w.nk) break;
        const int s = pc % GW_STAGES, n = pc / GW_STAGES;
        ++pc;
        uint8_t* st = sm + s * WSTAGE;
        const int k0 = kt * GK;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        if constexpr (kTma) {
          mbar_arrive_expect_tx(&full[s], WSTAGE);
          for (int h = 0; h < 2; ++h) {
            tma_load_2d(st + h * GBOX, &maps.a[w.dir], &full[s], k0,
                        w.a0 + 64 * h);
          }
          for (int c = 0; c < 4; ++c) {
            tma_load_2d(st + (2 + c) * GBOX, &maps.b[w.dir], &full[s],
                        w.n0 + 64 * c, k0);
          }
        } else {
          for (int h = 0; h < 2; ++h) {
            fill_tile<S>(st + h * GBOX, 64, static_cast<const S*>(d.ys), H,
                         w.a0 + 64 * h, R, k0, H, 1, vec, tid, 128, at, w.a0);
          }
          fill_tile<bf16>(st + 2 * GBOX, 64, d.wh, G, k0, H, w.n0, G, 4, vec,
                          tid, 128);
          cp_async_wait_all();
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers: rows m0 + 64*wg .. +63 of each tile
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[128];
    int cc = 0;  // stages consumed
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const WideTile w = wide_tile(t, ndir, R, B, nk, nt, mi, me, d0, d1);
      const GatesDir d = w.dir == 0 ? d0 : d1;
      for (int kt = 0; kt < w.nk; ++kt, ++cc) {
        const int s = cc % GW_STAGES;
        mbar_wait(&full[s], (cc / GW_STAGES) & 1);
        const uint32_t a = smem_u32(sm + s * WSTAGE + wg * GBOX);
        const uint32_t b = smem_u32(sm + s * WSTAGE + 2 * GBOX);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < GK / 16; ++j) {
          // A K-major: 16 columns = 32 bytes of each swizzled row; B
          // MN-major: 16 contraction rows, LBO between the 64-wide N boxes
          wgmma_m64n256<0, 1>(acc, wgmma_desc(a + j * 32, 16, 1024),
                              wgmma_desc(b + j * 2048, GBOX, 1024),
                              kt > 0 || j > 0);  // a tile starts at zero
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0 && threadIdx.x % 128 == 0) {
          mbar_arrive(&empty[(cc - 1) % GW_STAGES]);
        }
      }
      wgmma_wait<0>();
      if (w.nk > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive(&empty[(cc - 1) % GW_STAGES]);
      }
      if constexpr (kTma) mbar_wait(xw_full, it & 1);
      const S* xw = static_cast<const S*>(d.xw);
      const TileRows at = rows_at.tile(w.m0 + 64 * wg);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int r = 16 * warp + lane / 4 + 8 * (q / 2);  // in the half
          const long long row = w.m0 + 64 * wg + r;
          const int n = w.n0 + 8 * j + 2 * (lane % 4);
          float x0, x1;
          if constexpr (kTma) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                xs + (4 * wg + j / 8) * GBOX + swz128(r, j % 8) +
                4 * (lane % 4));
            x0 = __uint_as_float(v << 16);
            x1 = __uint_as_float(v & 0xffff0000u);
          } else {
            const bool ok = row < w.end && n < G;
            const S* x = xw + (ok ? at(r) * G + n : 0);
            x0 = to_f32(x[0]);
            x1 = to_f32(x[1]);
          }
          if (row < w.end && n < G) {  // G and n are even; an edge tile
            const bool p = w.nk > 0;  // has no product
            *reinterpret_cast<float2*>(&d.pre[row * G + n]) =
                make_float2((p ? acc[4 * j + q] : 0.0f) + x0,
                            (p ? acc[4 * j + q + 1] : 0.0f) + x1);
          }
        }
      if constexpr (kTma) mbar_arrive(xw_empty);
    }
  }
}

template <typename S, bool kTma>
cudaError_t launch_gates_wide(const GatesWideMaps& maps, const GatesDir* d,
                              int R, int B, int H, int ndir, int vec,
                              int tiles, cudaStream_t stream) {
  constexpr int smem = gates_wide_smem<kTma>();
  const cudaError_t err = cudaFuncSetAttribute(
      bptt_gates_gemm_wide<S, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const int grid = std::min(tiles, sms);  // one CTA an SM walks the tiles
  bptt_gates_gemm_wide<S, kTma><<<grid, GTHREADS, smem, stream>>>(
      maps, d[0], d[1], R, B, H, ndir, vec);
  return cudaGetLastError();
}

template <typename S>
cudaError_t run_gates_wide(int T, int B, int H, int ndir, int pitch,
                           const void* const* xw, const void* const* wh,
                           const void* const* ys, float* const* pre,
                           const int* reverse, cudaStream_t stream) {
  const CUtensorMapL2promotion promo = l2_promotion(H);
  const long long R = (long long)T * B;
  const int G = 4 * H;
  const long long nt = (G + WN - 1) / WN;
  const long long tiles =
      ndir * ((R - B + 127) / 128 + (B + 127) / 128) * nt;
  if (R > 0x7fffff00LL || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  GatesDir d[2];
  bool aligned = true;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = xw[i];
    d[i].ys = ys[i];
    d[i].wh = static_cast<const bf16*>(wh[i]);
    d[i].pre = pre[i];
    d[i].off = reverse[i] ? B : -B;
    d[i].pitch = pitch;
    aligned = aligned && aligned16(xw[i]) && aligned16(ys[i]) &&
              aligned16(wh[i]);
  }
  if (ndir == 1) d[1] = d[0];
  const int vec = aligned && H % 8 == 0;  // rows of whole 16-byte chunks
  GatesWideMaps maps = {};
  if constexpr (std::is_same<S, bf16>::value) {
    if (vec && pitch == B) {  // TMA: dense bf16 rows
      for (int i = 0; i < ndir; ++i) {
        cudaError_t err = encode_rows(&maps.a[i], d[i].ys, H, R, promo);
        if (err == cudaSuccess) {
          err = encode_rows(&maps.b[i], d[i].wh, G, H, promo);
        }
        if (err == cudaSuccess) {
          err = encode_rows(&maps.x[i], d[i].xw, G, R, promo);
        }
        if (err != cudaSuccess) return err;
      }
      if (ndir == 1) {
        maps.a[1] = maps.a[0];
        maps.b[1] = maps.b[0];
        maps.x[1] = maps.x[0];
      }
      return launch_gates_wide<S, true>(maps, d, static_cast<int>(R), B, H,
                                        ndir, vec, static_cast<int>(tiles),
                                        stream);
    }
  }
  return launch_gates_wide<S, false>(maps, d, static_cast<int>(R), B, H, ndir,
                                     vec, static_cast<int>(tiles), stream);
}

// The frame loop (lstm_bwd_persistent). Grid (C = ceil(H/32), ceil(B/BN),
// ndir), cluster (C, 1, 1): CTA r owns hidden units 32r..32r+31 and their
// 128 gate columns {g*H + 32r + u}, ordered kc = 32g + u, for the BN batch
// rows of its cluster (the wgmma N: 32, 16 or 8, the library's choice by
// B, bwd_persistent_rows).
constexpr int BU = 32;           // hidden units per CTA
constexpr int BTHREADS = 256;    // two warpgroups
constexpr int BMAX_CLUSTER = 16;
constexpr int BMAX_H = BU * BMAX_CLUSTER;
static_assert(BMAX_H == TILES_MAX_H, "the wide designs serve F2's H");

// the dg tile (two 64-column blocks of BN rows, 128B-swizzled), two
// receive buffers of 16 slots (a slot: one sender's partial for this CTA's
// units, [BU][BN] f32), the frame's pre tile [4][BN][BU] f32, the cs[t],
// cs[tp] and dys[t] tiles and the dxw[t] tile by gate, [3 + 4][BN][BU] in
// S, the mask [BN] and two mbarriers
template <typename S, int BN>
constexpr int bwd_persistent_smem() {
  return 1024 + 2 * BN * 128 + 2 * BMAX_CLUSTER * BU * BN * 4 +
         4 * BN * BU * 4 + 7 * BN * BU * static_cast<int>(sizeof(S)) +
         BN * 4 + 16;
}

template <typename S>
struct BwdSeqDir {
  const float* pre;   // [T, B, 4H] from bptt_gates_gemm
  const bf16* wh;     // [H, 4H]
  const S* cs;        // [T, B, H]
  const S* dys;       // [T, B, H]
  S* dxw;             // [T, B, 4H]
  const float* mask;  // [T, pitch] rows
  int pitch;          // rows between frames of cs, dys, dxw and the mask
  int reverse;
};

// the group (RPT = BN/8 consecutive batch rows) c of unit uu's row in a
// partial slot lies at group c ^ (uu / (32/BN)) % 8, so that the sum (a
// warp reads one group of 32 units) and the staging run without bank
// conflicts
template <int BN>
__device__ __forceinline__ int bwd_group(int c, int uu) {
  return c ^ ((uu / (32 / BN)) % 8);
}

// MT: m64 tiles of the product per warpgroup (2*MT*64 >= 32*C rows). A
// thread (warp w of 8, lane l) runs the cell backward of unit 32r + l and
// rows RPT*w .. RPT*w + RPT-1 (RPT = BN/8), keeping their f32 dh and dc
// carries in registers. `vec`: rows of pre, cs, dys and dxw are whole,
// aligned 16-byte chunks. kP: each direction's frames lie d.pitch rows
// apart with its own d.mask (Frames); else they are the layer's, B rows
// apart with `mask` (the kernel as it ran before frames had a pitch).
template <typename S, int MT, int BN, bool kP = false>
__global__ void __launch_bounds__(BTHREADS, 1)
lstm_bwd_persistent(BwdSeqDir<S> d0, BwdSeqDir<S> d1,
                    const float* __restrict__ mask, int T, int B, int H,
                    int vec) {
  constexpr int RPT = BN / 8;                // rows of a thread
  constexpr int SLOT = BU * BN * 4;          // a sender's partial block
  constexpr int RXB = BMAX_CLUSTER * SLOT;   // a receive buffer
  constexpr int ES = static_cast<int>(sizeof(S));
  constexpr int CH = 16 / ES;                // elements of a 16-byte chunk
  constexpr int NCH = BU / CH;               // chunks of a 32-unit row
  constexpr int NACC = BN <= 16 ? 2 : 1;     // tiles of the product in flight
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  const BwdSeqDir<S> d = blockIdx.z == 0 ? d0 : d1;
  const int fpitch = kP ? d.pitch : B;
  const float* fmask = kP ? d.mask : mask;
  const int b0 = blockIdx.y * BN;
  const int j0 = rank * BU;
  const long long G = 4LL * H;
  const int tid = threadIdx.x;
  extern __shared__ uint8_t bwd_raw[];
  uint8_t* dg_s = align1024(bwd_raw);  // [2][BN][64] bf16, 128B swizzle
  uint8_t* rx_s = dg_s + 2 * BN * 128;  // [2][16] slots
  float* pre_s = reinterpret_cast<float*>(rx_s + 2 * RXB);  // [4][BN][BU]
  S* io_s = reinterpret_cast<S*>(pre_s + 4 * BN * BU);  // [7][BN][BU]
  float* m_s = reinterpret_cast<float*>(io_s + 7 * BN * BU);  // [BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(m_s + BN);  // [2]

  // this thread's fragments of A = wh[:, own columns] for all T frames:
  // tile mt covers units 64*(MT*wg + mt) .., register j of k-step kk holds
  // unit 16w + l/4 + 8(j%2) of the tile and own columns kc, kc + 1 with
  // kc = 16kk + 2(l%4) + 8(j/2) (gate kc/32, unit 32r + kc%32)
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(d.wh);
  uint32_t af[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 64 * (MT * wg + mt) + 16 * warp + lane / 4 + 8 * (j % 2);
        const int kc = 16 * kk + 2 * (lane % 4) + 8 * (j / 2);
        const int u = j0 + kc % 32;
        uint32_t v = 0;
        if (m < H) {
          const unsigned short* w =
              w16 + (long long)m * G + (long long)(kc / 32) * H + u;
          v = (u < H ? w[0] : 0u) | ((u + 1 < H ? w[1] : 0u) << 16);
        }
        af[mt][kk][j] = v;
      }

  // frame t's pre, cs[t], cs[tp] (zeros at the edge, tp < 0), dys[t] and
  // mask into shared memory: asynchronous copies, zeros past B and H
  auto load_inputs = [&](int t, int tp) {
    if (vec) {
      for (int q = tid; q < 4 * BN * 8; q += BTHREADS) {
        const int g = q / (BN * 8), r = (q / 8) % BN, c = q % 8;
        const bool ok = b0 + r < B && j0 + 4 * c < H;
        const float* src =
            d.pre + (ok ? ((long long)t * B + b0 + r) * G + (long long)g * H +
                              j0 + 4 * c
                        : 0);
        cp_async16_zfill(pre_s + (g * BN + r) * BU + 4 * c, src, ok);
      }
      for (int q = tid; q < 3 * BN * NCH; q += BTHREADS) {
        const int which = q / (BN * NCH), r = (q / NCH) % BN, c = q % NCH;
        const int tt = which == 1 ? tp : t;
        const bool ok = tt >= 0 && b0 + r < B && j0 + c * CH < H;
        const S* src =
            (which == 2 ? d.dys : d.cs) +
            (ok ? ((long long)tt * fpitch + b0 + r) * H + j0 + c * CH : 0);
        cp_async16_zfill(io_s + (which * BN + r) * BU + c * CH, src, ok);
      }
    } else {  // synchronous: shapes outside the main path
      for (int q = tid; q < 4 * BN * BU; q += BTHREADS) {
        const int g = q / (BN * BU), r = (q / BU) % BN, uu = q % BU;
        const bool ok = b0 + r < B && j0 + uu < H;
        pre_s[q] = ok ? d.pre[((long long)t * B + b0 + r) * G +
                              (long long)g * H + j0 + uu]
                      : 0.0f;
      }
      for (int q = tid; q < 3 * BN * BU; q += BTHREADS) {
        const int which = q / (BN * BU), r = (q / BU) % BN, uu = q % BU;
        const int tt = which == 1 ? tp : t;
        const bool ok = tt >= 0 && b0 + r < B && j0 + uu < H;
        io_s[q] = ok ? (which == 2 ? d.dys : d.cs)[((long long)tt * fpitch +
                                                    b0 + r) * H + j0 + uu]
                     : from_f32<S>(0.0f);
      }
    }
    if (tid < BN) {
      const bool ok = b0 + tid < B;
      cp_async4_zfill(m_s + tid,
                      fmask + (ok ? (long long)t * fpitch + b0 + tid : 0),
                      ok);
    }
  };

  // the staged dxw[t] to global memory
  auto store_dxw = [&](int t) {
    const S* x_s = io_s + 3 * BN * BU;  // [4][BN][BU]
    if (vec) {
      for (int q = tid; q < 4 * BN * NCH; q += BTHREADS) {
        const int g = q / (BN * NCH), r = (q / NCH) % BN, c = q % NCH;
        if (b0 + r < B && j0 + c * CH < H) {
          *reinterpret_cast<uint4*>(d.dxw +
                                    ((long long)t * fpitch + b0 + r) * G +
                                    (long long)g * H + j0 + c * CH) =
              *reinterpret_cast<const uint4*>(x_s + (g * BN + r) * BU +
                                              c * CH);
        }
      }
    } else {
      for (int q = tid; q < 4 * BN * BU; q += BTHREADS) {
        const int g = q / (BN * BU), r = (q / BU) % BN, uu = q % BU;
        if (b0 + r < B && j0 + uu < H) {
          d.dxw[((long long)t * fpitch + b0 + r) * G + (long long)g * H +
                j0 + uu] = x_s[q];
        }
      }
    }
  };

  if (tid == 0) {  // full[b]: the C partial blocks in receive buffer b
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  // every CTA's barriers are in place before any peer copies into it
  cluster_arrive_release();
  cluster_wait_acquire();

  const int u = lane;        // this thread's unit in the CTA
  const int w8 = tid / 32;   // and its rows RPT*w8 .. RPT*w8 + RPT-1
  float dh[RPT], dc[RPT], keep[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) dh[i] = dc[i] = keep[i] = 0.0f;
  auto frame = [&](int step, int& t, int& tp) {  // the scan order, backwards
    t = d.reverse ? step : T - 1 - step;
    tp = d.reverse ? (t + 1 < T ? t + 1 : -1) : t - 1;
  };
  int t, tp;
  frame(0, t, tp);
  load_inputs(t, tp);
  const uint32_t dg_a = smem_u32(dg_s);
  for (int step = 0; step < T; ++step) {
    frame(step, t, tp);
    const int buf = step & 1;
    if (step > 0) {
      // dh of this frame: the C partials of the last one summed in rank
      // order 0..C-1, plus (1-m)*dh_t
      mbar_wait(&full[buf ^ 1], ((step - 1) >> 1) & 1);
      const float* rx = reinterpret_cast<const float*>(
                            rx_s + (buf ^ 1) * RXB + u * BN * 4) +
                        bwd_group<BN>(w8, u) * RPT;
      float sum[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sum[i] = 0.0f;
      for (int q = 0; q < nrank; ++q) {
        const float* v = rx + q * (SLOT / 4);
        if constexpr (RPT == 4) {
          const float4 x = *reinterpret_cast<const float4*>(v);
          sum[0] += x.x;
          sum[1] += x.y;
          sum[2] += x.z;
          sum[3] += x.w;
        } else if constexpr (RPT == 2) {
          const float2 x = *reinterpret_cast<const float2*>(v);
          sum[0] += x.x;
          sum[1] += x.y;
        } else {
          sum[0] += v[0];
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) dh[i] = sum[i] + keep[i];
    }
    cp_async_wait_all();
    // the inputs arrived; the last product read dg_s, and the buffer the
    // partials are staged in below was summed
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = RPT * w8 + i;
      const float m = m_s[b];
      const float* p = pre_s + b * BU + u;
      const float gi = sigmoid_fast(p[0]);
      const float gf = sigmoid_fast(p[BN * BU]);
      const float gg = tanh_fast(p[2 * BN * BU]);
      const float go = sigmoid_fast(p[3 * BN * BU]);
      const float tc = tanh_fast(to_f32(io_s[b * BU + u]));
      const float c_prev = to_f32(io_s[(BN + b) * BU + u]);
      const float dh_t = dh[i] + to_f32(io_s[(2 * BN + b) * BU + u]);
      const float dc_t = dc[i] + dh_t * go * (1.0f - tc * tc);
      const S v[4] = {from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * m),
                      from_f32<S>((dc_t * c_prev) * gf * (1.0f - gf) * m),
                      from_f32<S>((dc_t * gi) * (1.0f - gg * gg) * m),
                      from_f32<S>((dh_t * tc) * go * (1.0f - go) * m)};
      dc[i] = m * (dc_t * gf) + (1.0f - m) * dc[i];
      keep[i] = (1.0f - m) * dh_t;
#pragma unroll
      for (int g = 0; g < 4; ++g) {  // dxw[t], and round_W(dgates): the
        const int kc = 32 * g + u;   // product's B
        io_s[((3 + g) * BN + b) * BU + u] = v[g];
        *reinterpret_cast<bf16*>(dg_s + (kc / 64) * BN * 128 +
                                 swz128(b, (kc % 64) / 8) + (kc % 8) * 2) =
            __float2bfloat16(to_f32(v[g]));
      }
    }
    fence_proxy_async();  // dg_s is read by the tensor cores
    __syncthreads();      // ... and the input tiles are free again
    if (step + 1 == T) {  // nobody reads the last frame's dh
      store_dxw(t);
      break;
    }
    {
      int tn, tpn;
      frame(step + 1, tn, tpn);
      load_inputs(tn, tpn);  // lands during the product and the exchange
    }
    if (tid == 0) mbar_arrive_expect_tx(&full[buf], nrank * SLOT);
    // P[k][b] = sum over own columns kc of wh[k][kc] * dg[b][kc]: M = all
    // units (MT tiles a warpgroup, NACC of them in flight), N = BN rows,
    // K = 128. Tile rows 32p..32p+31 (warps 2i, 2i+1 of a warpgroup) are
    // peer p's block: staged in the buffer summed above, slot p, then one
    // bulk copy into slot `rank` of p's buffer buf
    uint8_t* out = rx_s + (buf ^ 1) * RXB;
    const uint32_t dst = smem_u32(rx_s + buf * RXB + rank * SLOT);
    const uint32_t bar = smem_u32(&full[buf]);
    float acc[NACC][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT + NACC - 1; ++mt) {
      if (mt < MT) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_rs<BN>(acc[mt % NACC], af[mt][kk],
                       wgmma_desc(dg_a + (kk / 4) * BN * 128 + (kk % 4) * 32,
                                  16, 1024),
                       kk > 0 ? 1 : 0);
        }
        wgmma_commit();
      }
      if (mt == 0) store_dxw(t);  // under the first tile's product
      const int done = mt - (NACC - 1);
      if (done < 0) continue;
      if (mt < MT) {
        wgmma_wait<NACC - 1>();
      } else {
        wgmma_wait<0>();
      }
      const float(&a)[BN / 2] = acc[done % NACC];
      const int p = 2 * (MT * wg + done) + warp / 2;
      const int uu0 = 16 * (warp % 2) + lane / 4;  // units uu0, uu0 + 8
      if (p < nrank) {
        float* blk = reinterpret_cast<float*>(out + p * SLOT);
        if constexpr (RPT == 4) {
          // lanes l, l^1 swap halves so that each holds 4 consecutive rows
          // of one unit
          const bool odd = lane & 1;
          const int uu = uu0 + 8 * odd;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float y0 = __shfl_xor_sync(
                0xffffffffu, odd ? a[4 * j] : a[4 * j + 2], 1);
            const float y1 = __shfl_xor_sync(
                0xffffffffu, odd ? a[4 * j + 1] : a[4 * j + 3], 1);
            const int c = 2 * j + (lane % 4) / 2;  // rows 4c .. 4c+3
            *reinterpret_cast<float4*>(blk + uu * BN +
                                       bwd_group<BN>(c, uu) * 4) =
                make_float4(odd ? y0 : a[4 * j], odd ? y1 : a[4 * j + 1],
                            odd ? a[4 * j + 2] : y0, odd ? a[4 * j + 3] : y1);
          }
        } else if constexpr (RPT == 2) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // rows 2c, 2c+1 of unit uu
              const int uu = uu0 + 8 * e, c = 4 * j + lane % 4;
              *reinterpret_cast<float2*>(blk + uu * BN +
                                         bwd_group<BN>(c, uu) * 2) =
                  make_float2(a[4 * j + 2 * e], a[4 * j + 2 * e + 1]);
            }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int uu = uu0 + 8 * (q / 2), b = 2 * (lane % 4) + q % 2;
            blk[uu * BN + bwd_group<BN>(b, uu)] = a[q];
          }
        }
      }
      fence_proxy_async();  // the block is read by the bulk copy
      named_barrier_sync(1 + tid / 64, 64);
      if (tid % 64 == 0 && p < nrank) {
        bulk_copy_to_peer(cluster_addr(dst, p), out + p * SLOT, SLOT,
                          cluster_addr(bar, p));
        bulk_commit();
      }
    }
  }
  // no CTA leaves while a copy from or to its shared memory is in flight
  bulk_wait_read();
  cluster_arrive_release();
  cluster_wait_acquire();
}

// lstm_bwd_persistent<S, MT, BN, kP>'s launch configuration at B, H, ndir
// (its attributes set once)
template <typename S, int MT, int BN, bool kP = false>
cudaError_t bwd_persistent_cfg(int B, int H, int ndir, cudaStream_t stream,
                               cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  constexpr int smem = bwd_persistent_smem<S, BN>();
  auto kernel = lstm_bwd_persistent<S, MT, BN, kP>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int csize = (H + BU - 1) / BU;
  const int nbt = (B + BN - 1) / BN;
  if (nbt > 65535) return cudaErrorInvalidValue;
  *cfg = {};
  cfg->gridDim = dim3(csize, nbt, ndir);
  cfg->blockDim = dim3(BTHREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// the clusters of lstm_bwd_persistent<S, MT, BN> at H the current card
// holds at once (cudaOccupancyMaxActiveClusters), asked once a device and
// cluster size
template <typename S, int MT, int BN>
cudaError_t bwd_persistent_resident(int H, int* clusters) {
  static int known[64][BMAX_CLUSTER + 1] = {};  // the count + 1; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int csize = (H + BU - 1) / BU;
  if (dev < 64 && known[dev][csize] > 0) {
    *clusters = known[dev][csize] - 1;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = bwd_persistent_cfg<S, MT, BN>(1, H, 1, nullptr, &cfg, attr);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_bwd_persistent<S, MT, BN>,
                                       &cfg);
  if (err != cudaSuccess) return err;
  if (dev < 64) known[dev][csize] = n + 1;
  *clusters = n;
  return cudaSuccess;
}

// The batch rows a cluster takes (BN, the wgmma N), and a frame's time of
// each at H=512 on a wave of clusters: the frame at B=32, T=512 over the
// waves it takes there (ns; NVIDIA H100 80GB HBM3 at 700 W,
// profile_lstm_bwd_persistent.py, PERF.md). The library takes the rows
// whose waves (the clusters of both directions over those the card holds
// at once) times that frame is least, the first of equals.
struct BwdRows {
  int bn, frame_ns;
};
constexpr BwdRows BWD_ROWS[] = {{32, 5360}, {16, 3070}, {8, 1920}};
constexpr int BWD_NROWS = sizeof(BWD_ROWS) / sizeof(BWD_ROWS[0]);

// f(std::integral_constant MT) for the tiles a warpgroup takes at H
template <typename F>
cudaError_t with_bwd_tiles(int H, F&& f) {
  const int csize = (H + BU - 1) / BU;
  if (csize <= 4) return f(std::integral_constant<int, 1>());
  if (csize <= 8) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 4>());
}

// f(std::integral_constant BN) for BWD_ROWS[k]
template <typename F>
cudaError_t with_bwd_rows(int k, F&& f) {
  static_assert(BWD_NROWS == 3, "one case a row count");
  switch (k) {
    case 0:
      return f(std::integral_constant<int, BWD_ROWS[0].bn>());
    case 1:
      return f(std::integral_constant<int, BWD_ROWS[1].bn>());
    case 2:
      return f(std::integral_constant<int, BWD_ROWS[2].bn>());
  }
  return cudaErrorInvalidValue;
}

// the library's rows a cluster at B, H, ndir (an index of BWD_ROWS), and
// the clusters the card holds at once for it
template <typename S>
cudaError_t bwd_persistent_rows(int B, int H, int ndir, int* rows,
                                int* resident) {
  long long best = -1;
  for (int k = 0; k < BWD_NROWS; ++k) {
    int res = 0;
    const cudaError_t err = with_bwd_tiles(H, [&](auto mt) {
      return with_bwd_rows(k, [&](auto bn) {
        return bwd_persistent_resident<S, decltype(mt)::value,
                                       decltype(bn)::value>(H, &res);
      });
    });
    if (err != cudaSuccess) return err;
    if (res < 1) continue;
    const long long clusters =
        ndir * ((B + BWD_ROWS[k].bn - 1) / BWD_ROWS[k].bn);
    const long long cost = (clusters + res - 1) / res * BWD_ROWS[k].frame_ns;
    if (best < 0 || cost < best) {
      best = cost;
      *rows = k;
      *resident = res;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// bf16 W (type codes 1 and 2) up to H=512: the frame loop behind the gate
// GEMM as one lstm_bwd_persistent launch for all T frames, on `pre`, at the
// library's rows a cluster
template <typename S>
cudaError_t run_loop_persistent(int T, int B, int H, int ndir,
                                const Frames& fr, const void* const* wh,
                                const void* const* cs, const void* const* dys,
                                void* const* dxw, float* const* pre,
                                const int* reverse, cudaStream_t stream) {
  if (H > BMAX_H) return cudaErrorInvalidValue;
  BwdSeqDir<S> d[2];
  int vec = H % 8 == 0;  // rows of pre, cs, dys, dxw in whole 16-byte chunks
  for (int i = 0; i < ndir; ++i) {
    d[i].pre = pre[i];
    d[i].wh = static_cast<const bf16*>(wh[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
    vec = vec && aligned16(pre[i]) && aligned16(cs[i]) && aligned16(dys[i]) &&
          aligned16(dxw[i]);
  }
  if (ndir == 1) d[1] = d[0];
  int rows = 0, resident = 0;
  cudaError_t err = bwd_persistent_rows<S>(B, H, ndir, &rows, &resident);
  if (err != cudaSuccess) return err;
  // the layer's frames (one mask, pitch B) on the instantiations without
  // frames
  const bool layer = fr.pitch == B && fr.mask[0] == fr.mask[ndir - 1];
  auto launch = [&](auto kp) {
    constexpr bool kP = decltype(kp)::value;
    return with_bwd_tiles(H, [&](auto mt) {
      return with_bwd_rows(rows, [&](auto bn) {
        constexpr int MT = decltype(mt)::value, BN = decltype(bn)::value;
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cudaError_t e =
            bwd_persistent_cfg<S, MT, BN, kP>(B, H, ndir, stream, &cfg, attr);
        if (e != cudaSuccess) return e;
        e = cudaLaunchKernelEx(&cfg, lstm_bwd_persistent<S, MT, BN, kP>,
                               d[0], d[1], fr.mask[0], T, B, H, vec);
        return e != cudaSuccess ? e : cudaGetLastError();
      });
    });
  };
  return layer ? launch(std::false_type()) : launch(std::true_type());
}

// --- bf16 weights above H=512 (F2): the frame loop on the tensor cores -------

// One cooperative launch for all T frames and both directions
// (lstm_bwd_tc): a direction is N = ceil(H/XU) co-resident CTAs over every
// batch row (rounded up to whole clusters of XCL). CTA r owns units XU*r
// .. XU*r + XU-1: their four gate columns of the cell backward (the
// epilogue) and their dh, the product
//   dh[b][own units] = dg[b][0:4H] @ wh[own units][0:4H]^T   (f32 acc)
// with dg = round_bf16(dxw[t]) of every unit, which crosses CTAs through
// L2 once a frame.
constexpr int XU = 16;              // hidden units a CTA
constexpr int XCL = 2;              // CTAs a cluster: they share dg copies
constexpr int XROWS = 32;           // batch rows of a tile (two m16 tiles)
constexpr int XSL = 8;              // contraction slices: 4 gates x 2 halves
constexpr int XTHREADS = 32 * XSL;  // a warp a slice
constexpr int XKC = 8;              // k16 steps of a chunk (one bulk copy)
constexpr int XSTAGES = 3;          // a warp's ring of chunks
constexpr int XMAX_KSTEPS = 33;     // k16 steps a slice holds: H <= 1056
constexpr int XRLD = XU + 4;        // padded row of the partial sums (floats)
// bytes of a chunk row: XKC k16 steps of bf16 and 16 bytes of padding, an
// odd number of 16-byte words, so that the 8 rows of an ldmatrix 8 x 8
// matrix fall in 8 distinct bank groups
constexpr int XPITCH = (2 * XKC + 1) * 16;
constexpr int XCHUNK = XROWS * XPITCH;  // a ring stage

// k16 steps of a slice: the half of H it covers, padded to 16 (Hh = 16 *
// xks, so that a CTA's 16 units lie in one half)
__host__ __device__ constexpr int xks(int H) { return (H + 31) / 32; }
__host__ __device__ constexpr int xnch(int H) {  // chunks of a slice
  return (xks(H) + XKC - 1) / XKC;
}
// the row pitch of a slice's last chunk (its k16 steps and 16 bytes)
__host__ __device__ constexpr int xpitch_last(int H) {
  return (2 * (xks(H) - XKC * (xnch(H) - 1)) + 1) * 16;
}
// bytes of a (tile, slice) block of the exchange: its chunks one after the
// other, each XROWS rows at its pitch
__host__ __device__ constexpr int xslice_bytes(int H) {
  return XROWS * (XPITCH * (xnch(H) - 1) + xpitch_last(H));
}
// CTAs of a direction: whole clusters
inline int bwd_tc_ctas(int H) {
  return ((H + XU - 1) / XU + XCL - 1) / XCL * XCL;
}
// the rings, the slices' partial sums, two mbarriers a stage (full: the
// chunk landed; empty: both CTAs of the cluster read it)
constexpr int bwd_tc_smem() {
  return XSL * XSTAGES * XCHUNK + XSL * XROWS * XRLD * 4 +
         2 * XSL * XSTAGES * 8;
}
static_assert(bwd_tc_smem() <= 232448, "one CTA an SM");
// bytes of one parity of the dg exchange: a block a tile and slice
inline long long bwd_tc_exchange(int B, int H) {
  return (long long)((B + XROWS - 1) / XROWS) * XSL * xslice_bytes(H);
}
// lstm_bwd_tc's scratch behind pre: the frame counter (16 bytes), two
// parities of the exchange (both zeroed before the launch), the f32 dc
// and (1-m)*dh_t carries [B, H]
inline long long bwd_tc_scratch(int B, int H) {
  return 16 + 2 * bwd_tc_exchange(B, H) + 2LL * B * H * 4;
}

template <typename S>
struct TcBwdDir {
  const float* pre;     // [T, B, 4H] from the gate GEMM
  const bf16* wh;       // [H, 4H]
  const S* cs;          // [T, B, H]
  const S* dys;         // [T, B, H]
  S* dxw;               // [T, B, 4H]
  unsigned int* count;  // frames released x CTAs, zeroed
  uint8_t* dgx;         // 2 parities of bwd_tc_exchange, zeroed
  float* dc;            // [B, H] dc carry
  float* keep;          // [B, H] (1-m)*dh_t carry
  const float* mask;    // [T, pitch] rows
  int pitch;            // rows between frames of cs, dys, dxw and the mask
  int reverse;
};

// Grid (N, ndir), clusters (XCL, 1), cooperative. Warp w multiplies
// contraction slice w: gate w/2, columns (w%2)*Hh .. +Hh-1 of it (Hh = 16
// * xks(H)), for all 16 units of the CTA, holding those wh rows and
// columns as mma B fragments in registers for the whole launch; it
// streams its slice of dg through a private ring of XSTAGES chunks of XKC
// k16 steps (chunk c of tile q, the rows that exist), which cluster rank
// 0's warp brings into both CTAs of the cluster by one multicast bulk
// copy once both have read the stage's last chunk; so no warp waits for
// another's data. The slices' partial sums meet in shared memory and each
// (row, unit) cell sums them in slice order: fixed order, one writer per
// dxw, dh and dc element, so two runs give the same bits.
template <typename S>
__global__ void __launch_bounds__(XTHREADS, 1)
lstm_bwd_tc(TcBwdDir<S> d0, TcBwdDir<S> d1, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const bool issuer = cluster.block_rank() == 0;
  const TcBwdDir<S> d = blockIdx.y == 0 ? d0 : d1;
  const unsigned int N = gridDim.x;
  const int j0 = blockIdx.x * XU;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ks = xks(H), Hh = 16 * ks, nch = xnch(H), plast = xpitch_last(H);
  const int sbytes = xslice_bytes(H);
  const int nq = (B + XROWS - 1) / XROWS;
  const int per_step = nq * nch;  // chunks a warp brings a frame
  const long long G = 4LL * H;
  const long long xbytes = (long long)nq * XSL * sbytes;  // one parity
  extern __shared__ __align__(16) uint8_t xtc_raw[];
  uint8_t* ring = xtc_raw;  // [XSL][XSTAGES] chunks
  float* red = reinterpret_cast<float*>(ring + XSL * XSTAGES * XCHUNK);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + XSL * XROWS * XRLD);
  uint64_t* empty = full + XSL * XSTAGES;  // rank 0's are the ones used

  // bw[kk][n][j]: rows k, k + 1 of B = wh[own units][slice columns]^T with
  // k = 16kk + 2(l%4) + 8j in the slice (column g*H + half*Hh + k of wh)
  // and column n*8 + l/4 (unit j0 + 8n + l/4); zeros past H
  const int sl = warp, g = sl / 2, half = sl % 2;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(d.wh);
  uint32_t bw[XMAX_KSTEPS][2][2];
#pragma unroll
  for (int kk = 0; kk < XMAX_KSTEPS; ++kk)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = half * Hh + 16 * kk + 2 * (lane % 4) + 8 * j;
        const int u = j0 + 8 * n + lane / 4;
        uint32_t v = 0;
        if (kk < ks && u < H && k < H) {
          const unsigned short* w = w16 + (long long)u * G + (long long)g * H + k;
          v = static_cast<uint32_t>(w[0]) |
              (k + 1 < H ? static_cast<uint32_t>(w[1]) << 16 : 0u);
        }
        bw[kk][n][j] = v;
      }
  if (lane == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      mbar_init(&full[sl * XSTAGES + s], 1);
      mbar_init(&empty[sl * XSTAGES + s], XCL);
    }
    mbar_fence_init();
  }
  // every CTA's barriers are in place before a peer copies or arrives
  cluster_arrive_release();
  cluster_wait_acquire();
  const uint32_t empty0 = cluster_addr(smem_u32(&empty[sl * XSTAGES]), 0);

  // the cells of the tile at row b0 this thread updates (cell tid + 256e:
  // row cell / XU, unit cell % XU): pre, cs[t], cs[tp], dys, the mask and
  // its carries, loaded at the tile's start, in flight during the product
  constexpr int NC = XROWS * XU / XTHREADS;
  float pv[NC][4], tv[NC], cpv[NC], dyv[NC], mv[NC], dcv[NC], kv[NC];
  auto load_cells = [&](int t, int tp, int b0, bool carry) {
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int cell = tid + e * XTHREADS;
      const int b = b0 + cell / XU, j = j0 + cell % XU;
      if (b < B && j < H) {
        const float* p = d.pre + ((long long)t * B + b) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) pv[e][q] = p[q * H];
        const long long own = (long long)b * H + j;
        const long long row = (long long)t * d.pitch + b;
        tv[e] = to_f32(d.cs[row * H + j]);
        cpv[e] = tp >= 0 ? to_f32(d.cs[((long long)tp * d.pitch + b) * H + j])
                         : 0.0f;
        dyv[e] = to_f32(d.dys[row * H + j]);
        mv[e] = d.mask[row];
        dcv[e] = carry ? d.dc[own] : 0.0f;
        kv[e] = carry ? d.keep[own] : 0.0f;
      }
    }
  };

  int used = 0;  // chunks this warp took before this frame (ring phases)
  for (int step = 0; step < T; ++step) {  // the scan order, backwards
    const int t = d.reverse ? step : T - 1 - step;
    const int tp = d.reverse ? (t + 1 < T ? t + 1 : -1) : t - 1;
    // dg of the previous frame, and this frame's
    const uint8_t* cur = d.dgx + ((step + 1) & 1) * xbytes;
    uint8_t* nxt = d.dgx + (step & 1) * xbytes;
    // lane 0: chunk i of the frame (tile i / nch, chunk i % nch of the
    // warp's slice) into its ring stage in both CTAs of the cluster: each
    // expects its bytes; rank 0, once both have read the stage's last
    // chunk (its empty barrier), brings it by one multicast bulk copy of
    // the tile's rows (through L2: L1 is not coherent, and the buffers are
    // rewritten every other frame)
    auto post = [&](int i) {
      const int q = i / nch, c = i % nch, seq = used + i;
      const int st = seq % XSTAGES;
      const uint32_t bytes =
          min(XROWS, B - q * XROWS) * (c == nch - 1 ? plast : XPITCH);
      uint64_t* bar = &full[sl * XSTAGES + st];
      mbar_arrive_expect_tx(bar, bytes);
      if (!issuer) return;
      if (seq >= XSTAGES) {
        grid_wait(&empty[sl * XSTAGES + st], (seq / XSTAGES - 1) & 1);
      }
      bulk_load_multicast(ring + (sl * XSTAGES + st) * XCHUNK,
                          cur + ((long long)q * XSL + sl) * sbytes +
                              (long long)c * XROWS * XPITCH,
                          bytes, bar, (1u << XCL) - 1);
    };
    if (step > 0) {
      if (tid == 0) {
        // dg of the previous frame complete: every CTA of the direction
        // has released it (co-residency makes the wait finite; a fault
        // traps after ~10 s)
        const long long start = clock64();
        while (ld_acquire_gpu(d.count) < N * step) {
          if (clock64() - start > (1LL << 34)) __trap();
        }
      }
      __syncthreads();
      if (lane == 0) {
        fence_proxy_async_global();  // the copies read other CTAs' stores
        for (int i = 0; i < XSTAGES && i < per_step; ++i) post(i);
      }
      __syncwarp();
    }
    for (int q = 0; q < nq; ++q) {
      const int b0 = q * XROWS;
      const bool last = q == nq - 1;
      load_cells(t, tp, b0, step > 0);
      float dhp[NC] = {};  // the product's dh of the cells
      if (step > 0) {
        float acc[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
        uint32_t a0 = 0;
        int pitch = XPITCH, st = 0;
#pragma unroll
        for (int kk = 0; kk < XMAX_KSTEPS; ++kk) {
          if (kk >= ks) break;
          const int i = q * nch + kk / XKC;  // the chunk's index in the frame
          if (kk % XKC == 0) {
            const int seq = used + i;
            st = seq % XSTAGES;
            grid_wait(&full[sl * XSTAGES + st], (seq / XSTAGES) & 1);
            pitch = kk / XKC == nch - 1 ? plast : XPITCH;
            // A fragments by ldmatrix: lanes 8i..8i+7 address the rows of
            // 8 x 8 matrix i (rows 0-7 / 8-15 of the m16 tile, k words 0 / 1)
            a0 = smem_u32(ring + (sl * XSTAGES + st) * XCHUNK) +
                 ((lane % 8) + 8 * ((lane / 8) % 2)) * pitch + (lane / 16) * 16;
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t a[4];
            ldmatrix_x4(a, a0 + 16 * m * pitch + 32 * (kk % XKC));
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              mma_16816(acc[m][n], a, bw[kk][n][0], bw[kk][n][1]);
            }
          }
          if (kk % XKC == XKC - 1 || kk == ks - 1) {
            __syncwarp();  // every lane read the chunk: free its stage
            if (lane == 0) {
              mbar_arrive_cluster(empty0 + 8 * st);
              if (i + XSTAGES < per_step) post(i + XSTAGES);
            }
            __syncwarp();
          }
        }
        // the slice's partial sums: c0,c1 at (row l/4, units 2(l%4)+0,1 of
        // the n8 tile), c2,c3 eight rows below
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * m + lane / 4 + 8 * h;
              const int col = 8 * n + 2 * (lane % 4);
              *reinterpret_cast<float2*>(red + (sl * XROWS + row) * XRLD +
                                         col) =
                  make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
            }
        __syncthreads();  // the partials are in
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int cell = tid + e * XTHREADS;
          const int rr = cell / XU, u = cell % XU;
          float sum = red[rr * XRLD + u];
#pragma unroll
          for (int s = 1; s < XSL; ++s) sum += red[(s * XROWS + rr) * XRLD + u];
          dhp[e] = sum;
        }
      }
      // the cell backward; dg(t) goes to the exchange at once, dxw[t] and
      // the carries of the frame's last tile only after its release (they
      // are not on the next frame's path)
      S v[NC][4];
      float dc_n[NC], keep_n[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int cell = tid + e * XTHREADS;
        const int rr = cell / XU, u = cell % XU;
        const int b = b0 + rr, j = j0 + u;
        const float gi = sigmoid_fast(pv[e][0]);
        const float gf = sigmoid_fast(pv[e][1]);
        const float gg = tanh_fast(pv[e][2]);
        const float go = sigmoid_fast(pv[e][3]);
        const float tc = tanh_fast(tv[e]);
        const float m = mv[e];
        const float dh_t = (dhp[e] + kv[e]) + dyv[e];
        const float dc_t = dcv[e] + dh_t * go * (1.0f - tc * tc);
        v[e][0] = from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * m);
        v[e][1] = from_f32<S>((dc_t * cpv[e]) * gf * (1.0f - gf) * m);
        v[e][2] = from_f32<S>((dc_t * gi) * (1.0f - gg * gg) * m);
        v[e][3] = from_f32<S>((dh_t * tc) * go * (1.0f - go) * m);
        dc_n[e] = m * (dc_t * gf) + (1.0f - m) * dcv[e];
        keep_n[e] = (1.0f - m) * dh_t;
        if (b >= B || j >= H || step + 1 == T) continue;
        // round_bf16(dxw[t]) where the next frame's product reads it:
        // column g*H + j is in slice 2g + j / Hh, at k = j % Hh of it
        const int k = j % Hh, c = k / (16 * XKC), kc = k % (16 * XKC);
        uint8_t* at = nxt + (long long)q * XSL * sbytes +
                      (long long)c * XROWS * XPITCH +
                      rr * (c == nch - 1 ? plast : XPITCH) + 2 * kc +
                      (long long)(j / Hh) * sbytes;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          *reinterpret_cast<bf16*>(at + (long long)(2 * q4) * sbytes) =
              __float2bfloat16(to_f32(v[e][q4]));
        }
      }
      auto store = [&]() {  // dxw[t] and the carries of the tile's cells
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int cell = tid + e * XTHREADS;
          const int b = b0 + cell / XU, j = j0 + cell % XU;
          if (b >= B || j >= H) continue;
          S* dx = d.dxw + ((long long)t * d.pitch + b) * G + j;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) dx[q4 * H] = v[e][q4];
          if (step + 1 == T) continue;  // nobody reads the last carries
          const long long own = (long long)b * H + j;
          d.dc[own] = dc_n[e];
          d.keep[own] = keep_n[e];
        }
      };
      if (!last) store();
      if (last && step + 1 < T) fence_proxy_async_global();
      __syncthreads();  // the partials are read (the next tile rewrites
                        // them) and every dg of the frame is stored
      if (last && tid == 0 && step + 1 < T) {  // release dg(t): one count
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                     :: "l"(d.count) : "memory");
      }
      if (last) store();
    }
    if (step > 0) used += per_step;
  }
  // no CTA leaves while its peer may still arrive on its barriers
  cluster_arrive_release();
  cluster_wait_acquire();
}

// whether lstm_bwd_tc takes ndir directions at H: a slice's wh rows in
// registers (XMAX_KSTEPS) and every cluster co-resident, one CTA an SM
// (H <= 1056 for two directions on 132 SMs)
template <typename S>
cudaError_t bwd_tc_config(int H, int ndir, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  auto kernel = lstm_bwd_tc<S>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_tc_smem());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  *cfg = {};
  cfg->gridDim = dim3(bwd_tc_ctas(H), ndir);
  cfg->blockDim = dim3(XTHREADS);
  cfg->dynamicSmemBytes = bwd_tc_smem();
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = XCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

// the clusters of lstm_bwd_tc the card holds at once (0 when it cannot
// say), asked once
inline int bwd_tc_max_clusters() {
  static int clusters = -1;
  if (clusters < 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    int n = 0;
    const bool ok = bwd_tc_config<bf16>(16 * XCL, 1, &cfg, attr) ==
                    cudaSuccess;
    cfg.numAttrs = 1;  // the cluster shape alone
    if (!ok || cudaOccupancyMaxActiveClusters(&n, lstm_bwd_tc<bf16>, &cfg) !=
                   cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    clusters = n;
  }
  return clusters;
}

inline bool bwd_tc_fits(int H, int ndir) {
  return xks(H) <= XMAX_KSTEPS &&
         (long long)ndir * bwd_tc_ctas(H) <= (long long)XCL *
                                                 bwd_tc_max_clusters();
}

template <typename S>
cudaError_t run_loop_tc(int T, int B, int H, int ndir, const Frames& fr,
                        const void* const* wh, const void* const* cs,
                        const void* const* dys, void* const* dxw,
                        float* const* scratch, const int* reverse,
                        cudaStream_t stream) {
  if (!bwd_tc_fits(H, ndir)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = bwd_tc_config<S>(H, ndir, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  const long long n_pre = (long long)T * B * 4 * H;
  const long long xb = bwd_tc_exchange(B, H);
  TcBwdDir<S> d[2];
  for (int i = 0; i < ndir; ++i) {
    uint8_t* tail = reinterpret_cast<uint8_t*>(scratch[i] + n_pre);
    // the counter and the exchange start at zero: columns no CTA owns
    // (past H) are read by the product as zeros
    err = cudaMemsetAsync(tail, 0, 16 + 2 * xb, stream);
    if (err != cudaSuccess) return err;
    d[i].pre = scratch[i];
    d[i].wh = static_cast<const bf16*>(wh[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].count = reinterpret_cast<unsigned int*>(tail);
    d[i].dgx = tail + 16;
    d[i].dc = reinterpret_cast<float*>(tail + 16 + 2 * xb);
    d[i].keep = d[i].dc + (long long)B * H;
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
  }
  if (ndir == 1) d[1] = d[0];
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_tc<S>, d[0], d[1], T, B, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// --- f32 weights: the gate recompute as one GEMM on the FMA units, then one
// launch a frame ---------------------------------------------------------------

// pre[r][n] = f32(xw[r][n]) + sum_k f32(ys[r + off][k]) * wh[k][n] over the
// R = T*B rows of one direction, ys rows outside [0, R) read as zeros. With
// W = f32, round_W is the identity and bf16 -> f32 is exact, so the
// function is GatesDir's with f32 wh (and its rows: xw and ys hold dense
// row r at FrameRows(B, pitch)(r), pre is dense).
struct GatesF32Dir {
  const void* xw;   // [R, 4H] in S
  const void* ys;   // [R, H] in S
  const float* wh;  // [H, 4H]
  float* pre;       // [R, 4H]
  long long off;    // -B (forward: h_prev = ys[t-1]) or +B (reverse: ys[t+1])
  int B;            // rows of a frame
  int pitch;        // rows between frames of xw and ys
};

// 128 x 128 tiles of pre, 256 threads of 8 x 8 (rows 4*tm + {0..3, 64..67},
// columns 4*tn + {0..3, 64..67}), two CTAs an SM. The
// contraction runs in stages of QK columns, QSTAGES - 1 of them in flight
// ahead of the FMAs: 16-byte cp.async into a ring in shared memory, one
// barrier a stage. A stage holds A = ys rows [128][QK] in S (converted to
// f32 as they are read) and B = wh rows [QK][128] f32.
constexpr int QK = 16;
constexpr int QSTAGES = 4;
constexpr int QTHREADS = 256;

template <typename S>
constexpr int gemm_f32_smem() {
  return QSTAGES * (128 * QK * static_cast<int>(sizeof(S)) + QK * 128 * 4);
}

// four consecutive values as f32 (p 16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 ld4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4_f32(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// stage k0 .. k0 + QK - 1 of the tile (m0, n0) into as [128][QK] and
// bs [QK][128], zeros past R, H and 4H. `vec`: 16-byte copies (rows of
// whole, aligned chunks); else value by value (shapes off the main path).
// kP: ys rows lie at `at` (the tile's rows; else dense).
template <typename S, bool kP>
__device__ __forceinline__ void gemm_f32_stage(S* as, float* bs,
                                               const GatesF32Dir& d,
                                               const TileRows& at,
                                               long long R, int H, int m0,
                                               int n0, int k0, int vec,
                                               int tid) {
  const S* ys = static_cast<const S*>(d.ys);
  const long long G = 4LL * H;
  constexpr int CH = 16 / static_cast<int>(sizeof(S));  // values a chunk
  // h_prev's row: the tile row's frame moved by one (off = -B or +B)
  const long long frame = d.off > 0 ? d.pitch : -d.pitch;
  for (int q = tid; q < 128 * (QK / CH); q += QTHREADS) {
    const int r = q / (QK / CH), c = (q % (QK / CH)) * CH;
    const long long gr = m0 + r + d.off;
    const int k = k0 + c;
    const bool rok = gr >= 0 && gr < R;
    const long long yr = kP && rok ? at(r) + frame : gr;
    S* dst = as + r * QK + c;
    if (vec) {
      const bool ok = rok && k < H;
      cp_async16_zfill(dst, ys + (ok ? yr * H + k : 0), ok);
    } else {
      for (int e = 0; e < CH; ++e) {
        dst[e] = rok && k + e < H ? ys[yr * H + k + e] : from_f32<S>(0.0f);
      }
    }
  }
  for (int q = tid; q < QK * 32; q += QTHREADS) {
    const int kr = q / 32, c = (q % 32) * 4;
    const long long k = k0 + kr, n = n0 + c;
    const bool ok = k < H && n < G;  // G and n are multiples of 4
    float* dst = bs + kr * 128 + c;
    if (vec) {
      cp_async16_zfill(dst, d.wh + (ok ? k * G + n : 0), ok);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = ok ? d.wh[k * G + n + e] : 0.0f;
    }
  }
}

// RT: the type the ys operand is rounded to (float: none; bf16 for f32
// streams with bf16 weights widened to f32: type code 2, as F2 ran it
// before bptt_gates_gemm_wide and as gemm 0 names it). kP: xw and ys
// rows lie at FrameRows (frames pitch rows apart), else they are dense.
template <typename S, typename RT, bool kP>
__global__ void __launch_bounds__(QTHREADS, 2)
bptt_gates_gemm(GatesF32Dir d0, GatesF32Dir d1, int R, int H, int vec) {
  const GatesF32Dir d = blockIdx.z == 0 ? d0 : d1;
  extern __shared__ __align__(16) uint8_t gf_raw[];
  S* as = reinterpret_cast<S*>(gf_raw);  // [QSTAGES][128][QK]
  float* bs = reinterpret_cast<float*>(as + QSTAGES * 128 * QK);
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int nk = (H + QK - 1) / QK;
  const TileRows at = FrameRows(d.B, d.pitch).tile(m0);  // the tile's rows
  auto stage = [&](int kt) {
    const int s = kt % QSTAGES;
    gemm_f32_stage<S, kP>(as + s * 128 * QK, bs + s * QK * 128, d, at, R, H,
                          m0, n0, kt * QK, vec, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < QSTAGES - 1; ++kt) {
    if (kt < nk) stage(kt);
    cp_async_commit();  // one group a stage, empty past nk
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_group<QSTAGES - 2>();  // this thread's copies of stage kt
    __syncthreads();  // ... and everyone's; stage kt-1's readers are done
    if (kt + QSTAGES - 1 < nk) stage(kt + QSTAGES - 1);  // into kt-1's slot
    cp_async_commit();
    const S* a = as + (kt % QSTAGES) * 128 * QK;
    const float* b = bs + (kt % QSTAGES) * QK * 128;
#pragma unroll
    for (int q = 0; q < QK / 4; ++q) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = round4<RT>(
            ld4_f32(a + (4 * tm + i % 4 + 64 * (i / 4)) * QK + 4 * q));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* br = b + (4 * q + kk) * 128 + 4 * tn;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = kk == 0   ? av[i].x
                          : kk == 1 ? av[i].y
                          : kk == 2 ? av[i].z
                                    : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }

  const S* xw = static_cast<const S*>(d.xw);
  const long long G = 4LL * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = 4 * tm + i % 4 + 64 * (i / 4);
    const long long r = m0 + rr;
    if (r >= R) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + 4 * tn + 64 * h;  // G and n are multiples of 4
      if (n >= G) continue;
      const S* x = xw + (kP ? at(rr) : r) * G + n;
      const float4 xv =
          vec ? ld4_f32(x)
              : make_float4(to_f32(x[0]), to_f32(x[1]), to_f32(x[2]),
                            to_f32(x[3]));
      *reinterpret_cast<float4*>(&d.pre[r * G + n]) =
          make_float4(acc[i][4 * h] + xv.x, acc[i][4 * h + 1] + xv.y,
                      acc[i][4 * h + 2] + xv.z, acc[i][4 * h + 3] + xv.w);
    }
  }
}

template <typename S, typename RT>
cudaError_t run_gates_gemm_f32(int T, int B, int H, int ndir, int pitch,
                               const void* const* xw, const void* const* wh,
                               const void* const* ys, float* const* pre,
                               const int* reverse, cudaStream_t stream) {
  const long long R = (long long)T * B;
  if (R > 0x7fffff00LL || (R + 127) / 128 > 65535) {
    return cudaErrorInvalidValue;
  }
  GatesF32Dir d[2];
  bool aligned = true;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = xw[i];
    d[i].ys = ys[i];
    d[i].wh = static_cast<const float*>(wh[i]);
    d[i].pre = pre[i];
    d[i].off = reverse[i] ? B : -B;
    d[i].B = B;
    d[i].pitch = pitch;
    aligned = aligned && aligned16(xw[i]) && aligned16(ys[i]) &&
              aligned16(wh[i]) && aligned16(pre[i]);
  }
  if (ndir == 1) d[1] = d[0];
  // ys rows of whole 16-byte chunks (wh's rows, 16H bytes, always are)
  const int vec = aligned && H % (16 / static_cast<int>(sizeof(S))) == 0;
  constexpr int smem = gemm_f32_smem<S>();
  void (*kernel)(GatesF32Dir, GatesF32Dir, int, int, int) =
      pitch == B ? bptt_gates_gemm<S, RT, false>
                 : bptt_gates_gemm<S, RT, true>;
  static bool configured[2] = {};  // per instantiation
  if (!configured[pitch != B]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[pitch != B] = true;
  }
  const dim3 grid((4 * H + 127) / 128, static_cast<unsigned>((R + 127) / 128),
                  ndir);
  kernel<<<grid, QTHREADS, smem, stream>>>(d[0], d[1], static_cast<int>(R), H,
                                          vec);
  return cudaGetLastError();
}

// The folded frame loop with f32 W (the library's up to B=32): one launch
// a frame, stream order the barrier between frames. The 4H contraction of dh = dgates @ wh^T is split by
// unit into FR_SLICES slices of `us` units (ceil(H/8) rounded up to 8;
// each slice's four gate columns a unit), and the dh units into blocks of
// FR_M. Grid (ceil(Y/CY)*CY, FR_SLICES, ndir * ceil(B/FR_B)), Y =
// ceil(H/FR_M) blocks, cluster (CY = min(8, Y), 1, 1): a cluster holds the
// CTAs of one slice and CY dh blocks, for FR_B batch rows.
// - The slice runs in chunks of FR_U units. The cell backward of a chunk
//   is split over the cluster: CTA q computes the dgates of pw =
//   ceil(FR_U/CY) of its units (one unit and row a thread at CY = 8), from
//   pre[t], cs[t], cs[tp], dys[t], the mask and the carries, into its
//   shared memory; the cluster at x < CY writes dxw[t] and the carries for
//   them (with Y > 8 the other clusters of a slice compute the same dgates
//   and write nothing).
// - After a cluster barrier every CTA gathers the chunk's dgates from its
//   peers and multiplies them by its FR_M rows of wh, brought in by
//   cp.async during the cell backward: P_r[m][b] = sum
//   over the slice's columns of wh[m0 + m][col] * dg[b][col], 8 x 8 a
//   thread, each warp over 32 columns of a chunk, the 8 warps' partials
//   summed in order. The product's operand is
//   round_W(S(dgate)) = f32(dxw[t]), as the reference reads dxw back.
// - P_r goes to global memory; the next frame's cell backward sums the
//   FR_SLICES partials of its units in slice order, then adds (1-m)*dh_t
//   kept from this frame: one fixed order for each dh element, no
//   atomics, no reduction inside the launch.
// The carries ping-pong by frame parity in scratch [2][FR_PARTS + 1][B, H]
// (a parity's partials, (1-m)*dh_t, dc), since one cluster writes what
// another reads in the same launch; step 0 reads zeros instead. About
// 103 KB of shared memory at H <= 512, so two CTAs share an SM.
constexpr int FR_SLICES = 8;
constexpr int FR_PARTS = FR_SLICES + 1;  // the slices' partials, (1-m)*dh_t
constexpr int FR_CL = 8;                 // largest cluster
constexpr int FR_U = 64;                 // units a product chunk
constexpr int FR_M = 64;                 // dh units a CTA
constexpr int FR_B = 32;                 // batch rows a cluster
constexpr int FR_THREADS = 256;
constexpr int FR_WLD = 4 * FR_U + 4;  // padded row of the wh tile
constexpr int FR_RLD = FR_M + 2;      // padded row of the partial tiles
static_assert(8 * FR_B * FR_RLD <= FR_M * FR_WLD + 4 * FR_U * FR_B,
              "the warps' partial tiles fit over the wh and dgates tiles");
static_assert(FR_THREADS == 8 * 32 && 4 * FR_U == 8 * 32,
              "8 warps, 32 columns of a chunk each");

template <typename S>
struct FrameDir {
  const float* pre;  // [T, B, 4H] from bptt_gates_gemm
  const float* wh;   // [H, 4H]
  const S* cs;       // [T, B, H]
  const S* dys;      // [T, B, H]
  S* dxw;            // [T, B, 4H]
  float* carry;      // [2][FR_PARTS + 1][B, H]
  const float* mask;  // [T, pitch] rows
  int pitch;          // rows between frames of cs, dys, dxw and the mask
  int t;             // frame this launch processes
  int tp;            // its scan predecessor, or -1 at the edge
};

// wh tile [FR_M][FR_WLD], a chunk's gathered dgates [4*FR_U][FR_B] (a
// row's 16-byte chunk c at c ^ (row % 8); over both, the warps' partial
// tiles [8][FR_B][FR_RLD] after the product), this CTA's dgates of the
// chunk [4][pw][FR_B]
inline int frame_smem(int pw) {
  return (FR_M * FR_WLD + 4 * FR_U * FR_B + 4 * pw * FR_B) * 4;
}

template <typename S, typename RT>
__global__ void __launch_bounds__(FR_THREADS, 2)
bptt_frame(FrameDir<S> d0, FrameDir<S> d1, int B, int H, int nbt, int us,
           int pw, int step, int last, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = static_cast<int>(cluster.num_blocks());
  const bool writer = blockIdx.x < ncl;
  if (last && !writer) return;  // the last frame's dh is not read
  const int q = static_cast<int>(cluster.block_rank());
  const FrameDir<S> d = blockIdx.z / nbt == 0 ? d0 : d1;
  const int b0 = (blockIdx.z % nbt) * FR_B;
  const int m0 = blockIdx.x * FR_M;  // this CTA's dh units
  const bool rows = m0 < H;          // else it only runs a cell piece
  const int u_lo = blockIdx.y * us, u_hi = min(H, u_lo + us);
  const int nus = max(0, u_hi - u_lo);  // the slice's units
  const long long G = 4LL * H, BH = (long long)B * H;
  const long long row_t = (long long)d.t * B;  // frame t's first pre row
  const long long srow_t = (long long)d.t * d.pitch;  // ... stream row
  const int tid = threadIdx.x;
  const bool first = step == 0;
  const float* in = d.carry + (step & 1) * (FR_PARTS + 1) * BH;
  float* out = d.carry + (1 - (step & 1)) * (FR_PARTS + 1) * BH;

  extern __shared__ __align__(16) uint8_t fr_raw[];
  float* ws = reinterpret_cast<float*>(fr_raw);
  float* ds = ws + FR_M * FR_WLD;
  float* piece = ds + 4 * FR_U * FR_B;  // [4][pw][FR_B]

  // wh[m0 + m][g*H + ub + c] of a chunk, by cp.async (zeros past H)
  auto load_wh = [&](int ub) {
    const int nu = min(FR_U, u_hi - ub);
    for (int e = tid; e < FR_M * 4 * (FR_U / 4); e += FR_THREADS) {
      const int m = e / FR_U, g = (e / (FR_U / 4)) % 4;
      const int c = (e % (FR_U / 4)) * 4;
      const bool mok = m0 + m < H;
      float* dst = ws + m * FR_WLD + g * FR_U + c;
      const float* src = d.wh + (mok ? (long long)(m0 + m) * G : 0) +
                         (long long)g * H + ub + c;
      if (vec) {  // H, ub and nu are multiples of 4
        const bool ok = mok && c < nu;
        cp_async16_zfill(dst, ok ? src : d.wh, ok);
      } else {
        for (int k = 0; k < 4; ++k) dst[k] = mok && c + k < nu ? src[k] : 0.0f;
      }
    }
  };
  if (!last && rows && nus > 0) load_wh(u_lo);  // lands during the cell

  // the product: warp kg takes columns 32kg .. 32kg + 31 of each chunk,
  // lane (tm, tn) dh units tm + 8i and rows 4tn + {0..3}, 16 + 4tn + {0..3}
  const int kg = tid / 32, tm = tid % 8, tn = (tid % 32) / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int nch = (nus + FR_U - 1) / FR_U;
  for (int ch = 0; ch < nch; ++ch) {
    const int cu_lo = u_lo + ch * FR_U, cu_hi = min(u_hi, cu_lo + FR_U);
    if (ch > 0 && !last) cluster_wait_acquire();  // peers read the pieces
    // the cell backward of this CTA's pw units of the chunk, unit fastest
    const int p_lo = cu_lo + q * pw, p_hi = min(cu_hi, p_lo + pw);
    for (int e = tid; e < pw * FR_B; e += FR_THREADS) {
      const int uu = e % pw, b = e / pw;
      const int u = p_lo + uu;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (u < p_hi && b0 + b < B) {
        const long long row = srow_t + b0 + b;
        const long long idx = (long long)(b0 + b) * H + u;
        const float* pr = d.pre + (row_t + b0 + b) * G + u;
        const float gi = sigmoid_f32(pr[0]);
        const float gf = sigmoid_f32(pr[H]);
        const float gg = tanhf(pr[2LL * H]);
        const float go = sigmoid_f32(pr[3LL * H]);
        const float m = d.mask[row];
        const float tc = tanhf(to_f32(d.cs[row * H + u]));
        const float c_prev =
            d.tp >= 0
                ? to_f32(d.cs[((long long)d.tp * d.pitch + b0 + b) * H + u])
                : 0.0f;
        float dh = 0.0f, dc = 0.0f;
        if (!first) {
#pragma unroll
          for (int k = 0; k < FR_PARTS; ++k) dh += in[k * BH + idx];
          dc = in[FR_PARTS * BH + idx];
        }
        const float dh_t = dh + to_f32(d.dys[row * H + u]);
        const float dc_t = dc + dh_t * go * (1.0f - tc * tc);
        const S g4[4] = {from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * m),
                         from_f32<S>((dc_t * c_prev) * gf * (1.0f - gf) * m),
                         from_f32<S>((dc_t * gi) * (1.0f - gg * gg) * m),
                         from_f32<S>((dh_t * tc) * go * (1.0f - go) * m)};
        if (writer) {
          S* dx = d.dxw + row * G + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) dx[(long long)g * H] = g4[g];
          out[FR_SLICES * BH + idx] = (1.0f - m) * dh_t;
          out[FR_PARTS * BH + idx] = m * (dc_t * gf) + (1.0f - m) * dc;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) v[g] = round_to<RT>(to_f32(g4[g]));
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) piece[(g * pw + uu) * FR_B + b] = v[g];
    }
    if (last) continue;
    cluster_arrive_release();  // every piece of the chunk is in place
    cluster_wait_acquire();
    // the chunk's dgates from their owners, float4 (4 rows) at a time
    for (int e = tid; e < 4 * FR_U * (FR_B / 4); e += FR_THREADS) {
      const int j = e % (FR_B / 4), uc = (e / (FR_B / 4)) % FR_U;
      const int g = e / (FR_U * FR_B / 4);
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (cu_lo + uc < cu_hi) {
        const float* src = cluster.map_shared_rank(piece, uc / pw);
        x = *reinterpret_cast<const float4*>(
            src + (g * pw + uc % pw) * FR_B + 4 * j);
      }
      *reinterpret_cast<float4*>(ds + (g * FR_U + uc) * FR_B +
                                 4 * (j ^ (uc % 8))) = x;
    }
    cluster_arrive_release();  // done with the peers' pieces
    cp_async_wait_all();
    __syncthreads();  // the dgates and wh tiles are complete
    if (rows) {
      for (int k4 = 32 * kg; k4 < 32 * kg + 32; k4 += 4) {
        float4 a[8];  // wh[m0 + tm + 8i][k4 .. k4 + 3]
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] = *reinterpret_cast<const float4*>(ws + (tm + 8 * i) * FR_WLD +
                                                  k4);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* dr = ds + (k4 + k) * FR_B;
          const int sw = (k4 + k) % 8;
          const float4 b0 = *reinterpret_cast<const float4*>(dr + 4 * (tn ^ sw));
          const float4 b1 =
              *reinterpret_cast<const float4*>(dr + 4 * ((4 + tn) ^ sw));
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = k == 0   ? a[i].x
                            : k == 1 ? a[i].y
                            : k == 2 ? a[i].z
                                     : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // the tiles are free for the next chunk
    if (ch + 1 < nch && rows) load_wh(cu_lo + FR_U);
  }
  if (last) return;

  if (rows) {  // P_r: the 8 warps' partials summed in order, to global
    float* red = ws;  // [8][FR_B][FR_RLD], over the wh and dgates tiles
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = 4 * tn + (j % 4) + 16 * (j / 4);
        red[(kg * FR_B + b) * FR_RLD + tm + 8 * i] = acc[i][j];
      }
    __syncthreads();
    float* part = out + (long long)blockIdx.y * BH;
    for (int e = tid; e < FR_M * FR_B; e += FR_THREADS) {
      const int m = e % FR_M, b = e / FR_M;
      float sum = red[b * FR_RLD + m];
#pragma unroll
      for (int k = 1; k < 8; ++k) sum += red[(k * FR_B + b) * FR_RLD + m];
      if (m0 + m < H && b0 + b < B) {
        part[(long long)(b0 + b) * H + m0 + m] = sum;
      }
    }
  }
  // no CTA leaves while a peer may read its piece
  if (nch > 0) cluster_wait_acquire();
}

template <typename S, typename RT>
cudaError_t launch_frame(const FrameDir<S>* d, int B, int H, int ndir,
                         int us, int step, int last, int vec,
                         cudaStream_t stream) {
  const int Y = (H + FR_M - 1) / FR_M;
  const int ncl = std::min(FR_CL, Y);
  const int pw = (FR_U + ncl - 1) / ncl;  // a CTA's units of a chunk
  const int smem = frame_smem(pw);
  static int configured = 0;  // per instantiation: the largest opt-in yet
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        bptt_frame<S, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const int nbt = (B + FR_B - 1) / FR_B;
  if ((long long)ndir * nbt > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Y + ncl - 1) / ncl * ncl, FR_SLICES, ndir * nbt);
  cfg.blockDim = dim3(FR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, bptt_frame<S, RT>, d[0], d[1], B, H, nbt, us,
                         pw, step, last, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The split f32 frame loop, two launches a frame (the library's beyond
// B=32 where lstm_bwd_rows does not fit, and before it everywhere beyond
// B=32): bptt_cell, the cell
// backward alone (one thread a unit and row: the dgates into dxw[t] and
// the dc carry, from pre[t], cs, dys, the mask and the dh carry), then
// bptt_dh, the dh product dh = round_W(dxw[t]) @ wh^T + (1-m)*dh_t with
// the 4H contraction split over a cluster of DH_SPLIT CTAs, each rank
// summing its rows of the partial tiles in rank order. The carries dh and
// dc [B, H] are updated in place: each element has one owner a launch.
template <typename S>
struct SplitDir {
  const float* pre;  // [T, B, 4H] from bptt_gates_gemm
  const float* wh;   // [H, 4H]
  const S* cs;       // [T, B, H]
  const S* dys;      // [T, B, H]
  S* dxw;            // [T, B, 4H]
  float* dh;         // [B, H] carry
  float* dc;         // [B, H] carry
  const float* mask;  // [T, pitch] rows
  int pitch;          // rows between frames of cs, dys, dxw and the mask
  int t;             // frame this launch processes
  int tp;            // its scan predecessor, or -1 at the edge
};

constexpr int CELL_THREADS = 256;

// step 0 reads zero carries and zeroes dh for bptt_dh, which reads it
template <typename S>
__global__ void __launch_bounds__(CELL_THREADS)
bptt_cell(SplitDir<S> d0, SplitDir<S> d1, int B, int H, int first) {
  const SplitDir<S> d = blockIdx.y == 0 ? d0 : d1;
  const long long idx = (long long)blockIdx.x * CELL_THREADS + threadIdx.x;
  if (idx >= (long long)B * H) return;
  const long long b = idx / H, u = idx % H, G = 4LL * H;
  const long long row = (long long)d.t * d.pitch + b;  // of the streams
  const float* pr = d.pre + ((long long)d.t * B + b) * G + u;
  const float gi = sigmoid_f32(pr[0]);
  const float gf = sigmoid_f32(pr[H]);
  const float gg = tanhf(pr[2LL * H]);
  const float go = sigmoid_f32(pr[3LL * H]);
  const float m = d.mask[row];
  const float tc = tanhf(to_f32(d.cs[row * H + u]));
  const float c_prev =
      d.tp >= 0 ? to_f32(d.cs[((long long)d.tp * d.pitch + b) * H + u])
                : 0.0f;
  float dh = 0.0f, dc = 0.0f;
  if (first) {
    d.dh[idx] = 0.0f;
  } else {
    dh = d.dh[idx];
    dc = d.dc[idx];
  }
  const float dh_t = dh + to_f32(d.dys[row * H + u]);
  const float dc_t = dc + dh_t * go * (1.0f - tc * tc);
  S* dx = d.dxw + row * G + u;
  dx[0] = from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * m);
  dx[H] = from_f32<S>((dc_t * c_prev) * gf * (1.0f - gf) * m);
  dx[2LL * H] = from_f32<S>((dc_t * gi) * (1.0f - gg * gg) * m);
  dx[3LL * H] = from_f32<S>((dh_t * tc) * go * (1.0f - go) * m);
  d.dc[idx] = m * (dc_t * gf) + (1.0f - m) * dc;
}

// bptt_dh: grid (DH_SPLIT, ceil(H/DH_M), ndir * ceil(B/DH_NT)), cluster
// (DH_SPLIT, 1, 1). Rank r contracts 4H columns [r*ks, (r+1)*ks) for
// DH_M units and DH_NT batch rows, 4 x 4 a thread, the next SIMT_K
// columns loaded into registers during the FMAs.
constexpr int DH_M = 64;
constexpr int DH_NT = 32;
constexpr int DH_SPLIT = 8;
constexpr int DH_THREADS = 128;
constexpr int SIMT_K = 32;  // contraction chunk
constexpr int DH_LD = DH_NT + 4;
constexpr int DH_SMEM =
    1024 + std::max(SIMT_K * (DH_M + 4) * 4 + SIMT_K * DH_LD * 4,
                    DH_M * DH_LD * 4);

template <typename S, typename RT>
__global__ void __launch_bounds__(DH_THREADS)
bptt_dh(SplitDir<S> d0, SplitDir<S> d1, int B, int H, int nbt, int ks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const SplitDir<S> d = blockIdx.z / nbt == 0 ? d0 : d1;
  const int n0 = (blockIdx.z % nbt) * DH_NT;  // batch rows
  const int m0 = blockIdx.y * DH_M;           // hidden units
  const int G = 4 * H;
  const int k_lo = rank * ks;
  const int k_hi = min(G, k_lo + ks);
  const S* dg = d.dxw + (long long)d.t * d.pitch * G;
  extern __shared__ uint8_t dh_raw[];
  uint8_t* sm = align1024(dh_raw);
  float* red = reinterpret_cast<float*>(sm);  // [DH_M][DH_LD] partial tile
  const int tid = threadIdx.x;

  float* ws = reinterpret_cast<float*>(sm);  // ws[g][k] = wh[k][g]
  float* ds = ws + SIMT_K * (DH_M + 4);      // ds[g][b] = dg[b][g]
  const int tu = tid % 8;                    // rows 4*tu .. 4*tu+3
  const int tr = tid / 8;                    // units 4*tr .. 4*tr+3
  const int lg = tid % SIMT_K, lr = tid / SIMT_K;
  constexpr int WL = DH_M * SIMT_K / DH_THREADS;   // 16
  constexpr int SL = DH_NT * SIMT_K / DH_THREADS;  // 8
  float wreg[WL];
  S sreg[SL];
  auto load = [&](int g0) {
    const int g = g0 + lg;
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int k = m0 + lr + 4 * i;
      wreg[i] = (k < H && g < k_hi) ? d.wh[(long long)k * G + g] : 0.0f;
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
    for (int i = 0; i < SL; ++i) {
      ds[lg * DH_LD + lr + 4 * i] = round_to<RT>(to_f32(sreg[i]));
    }
    __syncthreads();
    if (g0 + SIMT_K < k_hi) load(g0 + SIMT_K);
#pragma unroll 8
    for (int kk = 0; kk < SIMT_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          &ws[kk * (DH_M + 4) + 4 * tr]);
      const float4 b = *reinterpret_cast<const float4*>(
          &ds[kk * DH_LD + 4 * tu]);
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
      red[(4 * tr + i) * DH_LD + 4 * tu + j] = acc[i][j];
    }

  // rank r sums rows 8r..8r+7 of the cluster's partials in rank order and
  // owns their epilogue (the unit index fastest, for coalesced stores)
  cluster.sync();
  constexpr int ROWS = DH_M / DH_SPLIT;
  for (int e = tid; e < ROWS * DH_NT; e += DH_THREADS) {
    const int r = rank * ROWS + e % ROWS, c = e / ROWS;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < DH_SPLIT; ++q) {
      sum += cluster.map_shared_rank(red, q)[r * DH_LD + c];
    }
    const int k = m0 + r, b = n0 + c;
    if (k < H && b < B) {
      const long long row = (long long)d.t * d.pitch + b;
      const long long idx = (long long)b * H + k;
      const float m = d.mask[row];
      const float dh = d.dh[idx] + to_f32(d.dys[row * H + k]);
      d.dh[idx] = sum + (1.0f - m) * dh;
    }
  }
  cluster.sync();  // the partials stay in place until every rank has read
}

template <typename S, typename RT>
cudaError_t launch_split(const SplitDir<S>* d, int B, int H, int ndir,
                         int ks, int first, cudaStream_t stream) {
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        bptt_dh<S, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DH_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long cells = ((long long)B * H + CELL_THREADS - 1) / CELL_THREADS;
  const int nbt = (B + DH_NT - 1) / DH_NT;
  if (cells > 0x7fffffff || (long long)ndir * nbt > 65535 ||
      (H + DH_M - 1) / DH_M > 65535) {
    return cudaErrorInvalidValue;
  }
  bptt_cell<S><<<dim3(static_cast<unsigned>(cells), ndir), CELL_THREADS, 0,
                 stream>>>(d[0], d[1], B, H, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DH_SPLIT, (H + DH_M - 1) / DH_M, ndir * nbt);
  cfg.blockDim = dim3(DH_THREADS);
  cfg.dynamicSmemBytes = DH_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DH_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bptt_dh<S, RT>, d[0], d[1], B, H, nbt, ks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The per-frame f32 loops by batch size, chosen on an H100 at H=512
// (PERF.md): the fold for one 32-row batch tile; beyond it lstm_bwd_rows
// where the rule takes it, else the split (loop_design).
constexpr int F32_FOLD_MAX_B = 32;
inline bool f32_folds(int B) { return B <= F32_FOLD_MAX_B; }

// the scan's frame t and its predecessor tp at loop step `step`
inline void frame_at(int step, int T, int reverse, int* t, int* tp) {
  if (reverse) {
    *t = step;
    *tp = step + 1 < T ? step + 1 : -1;
  } else {
    *t = T - 1 - step;
    *tp = T - 2 - step;  // -1 at t = 0
  }
}

// The f32-weight frame loop behind the gate GEMM, on the pre at the front
// of scratch ([T, B, 4H]): folded, one bptt_frame launch a frame with the
// carries in [2][FR_PARTS + 1][B, H] behind it; or split, bptt_cell and
// bptt_dh a frame with the carries dh, dc in [2][B, H]. wh in f32 (bf16
// weights widened). RT: the type the dh product's operand (dxw read back)
// is rounded to: float, or bf16 for f32 streams with bf16 weights (bf16
// streams are bf16 values already).
template <typename S, typename RT>
int run_loop_f32(int T, int B, int H, int ndir, const Frames& fr,
                 const void* const* wh, const void* const* cs,
                 const void* const* dys, void* const* dxw,
                 float* const* scratch, const int* reverse, int fold,
                 cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const long long n_pre = (long long)T * B * 4 * H;
  if (!fold) {
    SplitDir<S> d[2];
    for (int i = 0; i < ndir; ++i) {
      d[i].pre = scratch[i];
      d[i].wh = static_cast<const float*>(wh[i]);
      d[i].cs = static_cast<const S*>(cs[i]);
      d[i].dys = static_cast<const S*>(dys[i]);
      d[i].dxw = static_cast<S*>(dxw[i]);
      d[i].dh = scratch[i] + n_pre;
      d[i].dc = d[i].dh + (long long)B * H;
      d[i].mask = fr.mask[i];
      d[i].pitch = fr.pitch;
    }
    const int G = 4 * H;
    const int ks = ((G + DH_SPLIT - 1) / DH_SPLIT + 63) / 64 * 64;
    for (int step = 0; step < T; ++step) {
      for (int i = 0; i < ndir; ++i) {
        frame_at(step, T, reverse[i], &d[i].t, &d[i].tp);
      }
      if (ndir == 1) d[1] = d[0];
      err = launch_split<S, RT>(d, B, H, ndir, ks, step == 0, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  FrameDir<S> d[2];
  int vec = H % 4 == 0;  // wh rows of whole 16-byte chunks
  for (int i = 0; i < ndir; ++i) {
    d[i].pre = scratch[i];
    d[i].wh = static_cast<const float*>(wh[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].carry = scratch[i] + n_pre;
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    vec = vec && aligned16(wh[i]);
  }
  const int us = ((H + FR_SLICES - 1) / FR_SLICES + 7) / 8 * 8;
  for (int step = 0; step < T; ++step) {
    for (int i = 0; i < ndir; ++i) {
      frame_at(step, T, reverse[i], &d[i].t, &d[i].tp);
    }
    if (ndir == 1) d[1] = d[0];
    err = launch_frame<S, RT>(d, B, H, ndir, us, step, step + 1 == T, vec,
                              stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// --- f32 weights at B > 32: the frame loop as one cooperative launch --------

// lstm_bwd_rows: a direction is A = ceil(H/U) unit groups x G row groups
// of co-resident CTAs. CTA (a, g) owns units U*a .. U*a + U-1 over the
// rows of its row group's tiles (TR rows each): the cell backward of
// those cells (their four gate columns of dxw[t] and their carries) and
// their dh, the product
//   dh[b][own units] = dg[b][0:4H] @ wh[own units][0:4H]^T   (f32 FMAs)
// with dg = round_RT(S(dgate)) = f32(dxw[t]) of every unit of the rows,
// which crosses CTAs through L2 once a frame; each row group waits only on
// the A CTAs that share its rows.
constexpr int YTHREADS = 256;    // 8 warps: a contraction slice each
constexpr int YSL = 8;           // slices: 4 gates x 2 halves of H
constexpr int YKC = 8;           // contraction columns of a chunk
constexpr int YCOUNT = 1024;     // bytes of the row groups' frame counters
constexpr int YMAX_GROUPS = YCOUNT / 4;

// How lstm_bwd_rows<RPL> lays out its work: a CTA owns U units; a lane
// multiplies RPL rows by 4 units over its warp's slice; a warp's lanes are
// NRG row groups x NUG unit groups, so a tile is TR rows by all U units,
// and the 8 slices' partial sums meet in shared memory. Each 16-byte
// shared-memory load feeds 4 rows or 4 units of FMAs, so the product
// reads (RPL + 4) / (4 * RPL) floats of shared memory an FMA: at 4 rows a
// lane twice what the SM's shared memory feeds its FMA units, at 8 rows
// 1.5 times.
template <int RPL>  // 4 or 8
struct LoopShape {
  static constexpr int U = 16;
  static constexpr int NUG = U / 4;
  static constexpr int NRG = 32 / NUG;
  static constexpr int TR = RPL * NRG;                // rows of a tile
  static constexpr int CHUNK = TR * YKC;              // floats: one copy
  static constexpr int STAGES = TR == 32 ? 4 : 3;     // a warp's ring
  static constexpr int RLD = U + 4;                   // padded partial row
  static constexpr int NC = TR * U / YTHREADS;        // cells a thread
};

// contraction columns of a slice: half of H, padded to whole chunks
__host__ __device__ constexpr int yhh(int H) {
  return ((H + 1) / 2 + YKC - 1) / YKC * YKC;
}

// shared memory of lstm_bwd_rows<RPL>: the warps' rings, the slices'
// partial sums and the CTA's rows of wh, [YSL][Hh][U]
template <int RPL>
__host__ __device__ constexpr int loop_rows_smem(int H) {
  using L = LoopShape<RPL>;
  return 4 * (YSL * L::STAGES * L::CHUNK + YSL * L::TR * L::RLD +
              YSL * yhh(H) * L::U);
}

// bytes of one parity of a dg exchange of tiles of TR rows: whole tiles,
// each row the 8 slices' Hh columns
inline long long loop_rows_exchange(int TR, int B, int H) {
  return (long long)(B + TR - 1) / TR * TR * YSL * yhh(H) * 4;
}

// where dg[b][column k of slice sl] lies in a dg buffer: [tile b / TR]
// [slice][chunk k / 8][row b % TR][8 columns], so that a warp's ring stage
// (one chunk of its slice for one tile) is one contiguous block, 16 bytes
// a lane and copy; rows with bit 2 set hold their two 4-column halves
// swapped, so that the 8 rows a warp reads at once fall in distinct banks
template <int TR>
__device__ __forceinline__ long long loop_dg_at(int b, int sl, int k,
                                                int nch) {
  const int r = b % TR;
  return ((((long long)(b / TR) * YSL + sl) * nch + k / YKC) * TR + r) * YKC +
         ((k % YKC) ^ (((r >> 2) & 1) << 2));
}

template <typename S>
struct RowsBwdDir {
  const float* pre;     // [T, B, 4H] from the gate GEMM
  const float* wh;      // [H, 4H]
  const S* cs;          // [T, B, H]
  const S* dys;         // [T, B, H]
  S* dxw;               // [T, B, 4H]
  unsigned int* count;  // [row groups] frames released x CTAs, zeroed
  float* dgx;           // 2 parities of loop_rows_exchange, zeroed
  float* dc;            // [B, H] dc carry
  float* keep;          // [B, H] (1-m)*dh_t carry
  const float* mask;    // [T, pitch] rows
  int pitch;            // rows between frames of cs, dys, dxw and the mask
  int reverse;
};

// Grid (A, G, ndir), cooperative. Warp w multiplies slice w: gate w/2,
// columns (w%2)*Hh .. +Hh-1 of it, for all U units of the CTA, reading
// those rows of wh from shared memory and streaming its slice of dg
// through a private ring of chunks (chunk c of tile q, one cp.async group
// of 16 bytes a lane, through L2 alone: L1 is not coherent, and the
// buffers are rewritten every other frame; one bulk copy a chunk ran 9-11%
// slower on an H100, and deeper rings did not help: PERF.md).
// The slices' partial sums meet in shared memory and each (row, unit)
// cell sums them in slice order: fixed order, one writer per dxw, dh and
// dc element, so two runs give the same bits. RT: the type the product's
// dg operand is rounded to (float, or bf16 for f32 streams with bf16
// weights; bf16 streams are bf16 values already). kP: each direction's
// frames lie d.pitch rows apart with its own d.mask (Frames); else they
// are the layer's, B rows apart with `mask`.
template <typename S, typename RT, int RPL, bool kP>
__global__ void __launch_bounds__(YTHREADS, 1)
lstm_bwd_rows(RowsBwdDir<S> d0, RowsBwdDir<S> d1,
              const float* __restrict__ mask, int T, int B, int H, int tpg) {
  using L = LoopShape<RPL>;
  constexpr int U = L::U, NUG = L::NUG, NRG = L::NRG, TR = L::TR;
  constexpr int CHUNK = L::CHUNK;
  constexpr int STAGES = L::STAGES, RLD = L::RLD, NC = L::NC;
  const RowsBwdDir<S> d = blockIdx.z == 0 ? d0 : d1;
  const int fpitch = kP ? d.pitch : B;
  const float* fmask = kP ? d.mask : mask;
  const unsigned int A = gridDim.x;  // the CTAs of a row group
  const int j0 = blockIdx.x * U, grp = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hh = yhh(H), nch = Hh / YKC;
  const int nt = (B + TR - 1) / TR;
  const int t_lo = grp * tpg, ntg = min(nt, t_lo + tpg) - t_lo;
  const int per_step = ntg * nch;  // chunks a warp brings a frame
  const long long G = 4LL * H;
  const long long XB = (long long)nt * TR * YSL * Hh;  // floats a parity
  extern __shared__ __align__(16) uint8_t yrows_raw[];
  float* ring = reinterpret_cast<float*>(yrows_raw);  // [YSL][STAGES]
  float* red = ring + YSL * STAGES * CHUNK;  // [YSL][TR][RLD]
  float* ws = red + YSL * TR * RLD;          // [YSL][Hh][U]

  // ws[sl][k][u] = wh[j0 + u][g*H + half*Hh + k] (sl = 2g + half), zeros
  // past H
  for (int q = tid; q < YSL * Hh * U; q += YTHREADS) {
    const int k = q % Hh, u = (q / Hh) % U, sl = q / (Hh * U);
    const int col = (sl % 2) * Hh + k;
    const bool ok = j0 + u < H && col < H;
    cp_async4_zfill(ws + (sl * Hh + k) * U + u,
                    d.wh + (ok ? (long long)(j0 + u) * G +
                                     (long long)(sl / 2) * H + col
                               : 0),
                    ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int sl = warp, ug = lane % NUG, rg = lane / NUG;
  float* wring = ring + sl * STAGES * CHUNK;

  // the cells this thread updates (cell tid + 256e: row cell / U, unit
  // cell % U) of the tile at row b0: pre, cs[t], cs[tp], dys, the mask
  // and its carries, loaded at the tile's start, in flight during the
  // product
  float pv[NC][4], tv[NC], cpv[NC], dyv[NC], mv[NC], dcv[NC], kv[NC];
  auto load_cells = [&](int t, int tp, int b0, bool carry) {
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int cell = tid + e * YTHREADS;
      const int b = b0 + cell / U, j = j0 + cell % U;
      if (b < B && j < H) {
        const float* p = d.pre + ((long long)t * B + b) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) pv[e][g] = p[g * H];
        const long long own = (long long)b * H + j;
        const long long row = (long long)t * fpitch + b;
        const long long at_t = kP ? row * H + j : (long long)t * B * H + own;
        const long long at_tp =
            kP ? ((long long)tp * fpitch + b) * H + j
               : (long long)tp * B * H + own;
        tv[e] = to_f32(d.cs[at_t]);
        cpv[e] = tp >= 0 ? to_f32(d.cs[at_tp]) : 0.0f;
        dyv[e] = to_f32(d.dys[at_t]);
        mv[e] = fmask[row];
        dcv[e] = carry ? d.dc[own] : 0.0f;
        kv[e] = carry ? d.keep[own] : 0.0f;
      }
    }
  };

  int used = 0;  // the warp's chunks of earlier frames (ring phases)
  for (int step = 0; step < T; ++step) {  // the scan order, backwards
    const int t = d.reverse == 0 ? T - 1 - step : step;
    const int tp = d.reverse ? (t + 1 < T ? t + 1 : -1) : t - 1;
    // dg of the previous frame, and this frame's
    const float* cur = d.dgx + ((step + 1) & 1) * XB;
    float* nxt = d.dgx + (step & 1) * XB;
    // chunk i of the frame (tile i / nch, chunk i % nch of the warp's
    // slice) into its ring stage, one cp.async group (empty past the
    // frame's chunks)
    auto post = [&](int i) {
      if (i < per_step) {
        const float* src =
            cur + (((long long)(t_lo + i / nch) * YSL + sl) * nch + i % nch) *
                      CHUNK;
        float* dst = wring + (used + i) % STAGES * CHUNK;
        for (int v = lane; v < CHUNK / 4; v += 32) {
          cp_async16(dst + 4 * v, src + 4 * v);
        }
      }
      cp_async_commit();
    };
    if (step > 0 && lane == 0) {
      // dg of the previous frame complete for the group's rows: every CTA
      // of the row group has released it (co-residency makes the wait
      // finite; a fault traps after about 10 s instead of hanging)
      const long long start = clock64();
      while (ld_acquire_gpu(d.count + grp) < A * step) {
        if (clock64() - start > (1LL << 34)) __trap();
      }
    }
    __syncwarp();  // the lanes' copies follow lane 0's acquire
    if (step > 0) {
      for (int i = 0; i < STAGES; ++i) post(i);
    }
    for (int q = 0; q < ntg; ++q) {
      const int b0 = (t_lo + q) * TR;
      const bool last = q == ntg - 1;
      load_cells(t, tp, b0, step > 0);
      float dhp[NC] = {};  // the product's dh of the cells
      if (step > 0) {
        float acc[RPL][4];
#pragma unroll
        for (int i = 0; i < RPL; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][v] = 0.0f;
        for (int c = 0; c < nch; ++c) {
          const int i = q * nch + c;
          cp_async_wait_group<STAGES - 1>();  // this lane's copies of i
          __syncwarp();                       // ... and every lane's
          const float* dg = wring + (used + i) % STAGES * CHUNK;
          const float* wk = ws + (sl * Hh + c * YKC) * U + 4 * ug;
#pragma unroll
          for (int kq = 0; kq < 2; ++kq) {
            float4 a4[RPL];
#pragma unroll
            for (int r4 = 0; r4 < RPL; ++r4) {
              const int r = rg + NRG * r4;
              a4[r4] = *reinterpret_cast<const float4*>(
                  dg + r * YKC + 4 * (kq ^ ((r >> 2) & 1)));
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(wk + (4 * kq + kk) * U);
              const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int r4 = 0; r4 < RPL; ++r4) {
                const float x = kk == 0   ? a4[r4].x
                                : kk == 1 ? a4[r4].y
                                : kk == 2 ? a4[r4].z
                                          : a4[r4].w;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  acc[r4][v] = fmaf(x, wv[v], acc[r4][v]);
                }
              }
            }
          }
          __syncwarp();  // every lane read the chunk: refill its stage
          post(i + STAGES);
        }
        // the slice's partial sums: rows rg + NRG*r4, units 4ug .. 4ug+3
#pragma unroll
        for (int r4 = 0; r4 < RPL; ++r4) {
          *reinterpret_cast<float4*>(
              red + (sl * TR + rg + NRG * r4) * RLD + 4 * ug) =
              make_float4(acc[r4][0], acc[r4][1], acc[r4][2], acc[r4][3]);
        }
        __syncthreads();  // the partials are in
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int cell = tid + e * YTHREADS;
          const int rr = cell / U, u = cell % U;
          float tot = red[rr * RLD + u];
#pragma unroll
          for (int s = 1; s < YSL; ++s) tot += red[(s * TR + rr) * RLD + u];
          dhp[e] = tot;
        }
      }
      // the cell backward (precise expf / tanhf, as bptt_cell); dg(t) goes
      // to the exchange at once, dxw[t] and the carries of the frame's
      // last tile only after its release (they are not on the next
      // frame's path)
      S v[NC][4];
      float dc_n[NC], keep_n[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int cell = tid + e * YTHREADS;
        const int rr = cell / U, u = cell % U;
        const int b = b0 + rr, j = j0 + u;
        const float gi = sigmoid_f32(pv[e][0]);
        const float gf = sigmoid_f32(pv[e][1]);
        const float gg = tanhf(pv[e][2]);
        const float go = sigmoid_f32(pv[e][3]);
        const float tc = tanhf(tv[e]);
        const float m = mv[e];
        const float dh_t = (dhp[e] + kv[e]) + dyv[e];
        const float dc_t = dcv[e] + dh_t * go * (1.0f - tc * tc);
        v[e][0] = from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * m);
        v[e][1] = from_f32<S>((dc_t * cpv[e]) * gf * (1.0f - gf) * m);
        v[e][2] = from_f32<S>((dc_t * gi) * (1.0f - gg * gg) * m);
        v[e][3] = from_f32<S>((dh_t * tc) * go * (1.0f - go) * m);
        dc_n[e] = m * (dc_t * gf) + (1.0f - m) * dcv[e];
        keep_n[e] = (1.0f - m) * dh_t;
        if (b >= B || j >= H || step + 1 == T) continue;
        // the dg operand of the next frame's product: column g*H + j is
        // column j % Hh of slice 2g + j / Hh
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          nxt[loop_dg_at<TR>(b, 2 * g + j / Hh, j % Hh, nch)] =
              round_to<RT>(to_f32(v[e][g]));
        }
      }
      auto store = [&]() {  // dxw[t] and the carries of the tile's cells
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int cell = tid + e * YTHREADS;
          const int b = b0 + cell / U, j = j0 + cell % U;
          if (b >= B || j >= H) continue;
          S* dx = d.dxw + ((long long)t * fpitch + b) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) dx[g * H] = v[e][g];
          if (step + 1 == T) continue;  // nobody reads the last carries
          const long long own = (long long)b * H + j;
          d.dc[own] = dc_n[e];
          d.keep[own] = keep_n[e];
        }
      };
      if (!last) store();
      if (last && step + 1 < T) fence_proxy_async_global();
      __syncthreads();  // the partials are read (the next tile rewrites
                        // them) and every dg of the frame is stored
      if (last && tid == 0 && step + 1 < T) {  // release dg(t): one count
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                     :: "l"(d.count + grp) : "memory");
      }
      if (last) store();  // behind the release
    }
    if (step > 0) used += per_step;
  }
}

// How lstm_bwd_rows runs ndir directions at B, H on `sms` SMs: whether it
// fits (its rows of wh in shared memory, H <= 688, and ceil(H/16) CTAs a
// direction on the card), RPL rows a lane (8 where every row group the
// card holds gets a whole 64-row tile, else 4), TR rows a tile, the row
// groups and the tiles of each (as many groups as fill the card, each
// holding a tile)
struct LoopRowsPlan {
  bool fits;
  int RPL, TR, groups, tpg;
};

inline LoopRowsPlan loop_rows_plan(int B, int H, int ndir, int sms) {
  constexpr int U = LoopShape<4>::U;
  LoopRowsPlan p = {false, 4, 0, 0, 0};
  const int A = (H + U - 1) / U;
  if (loop_rows_smem<4>(H) > 232448 || (long long)ndir * A > sms) return p;
  p.fits = true;
  const int gmax = std::max(1, std::min(sms / (ndir * A), YMAX_GROUPS));
  if (loop_rows_smem<8>(H) <= 232448 && B >= 64 * gmax) p.RPL = 8;
  p.TR = p.RPL == 8 ? LoopShape<8>::TR : LoopShape<4>::TR;
  const int nt = (B + p.TR - 1) / p.TR;
  const int g = std::min(nt, gmax);
  p.tpg = (nt + g - 1) / g;
  p.groups = (nt + p.tpg - 1) / p.tpg;
  return p;
}

// lstm_bwd_rows' scratch behind pre: the row groups' frame counters, two
// parities of the exchange (both zeroed before the launch; sized for the
// larger tile), the f32 dc and (1-m)*dh_t carries [B, H]
inline long long loop_rows_scratch(int B, int H) {
  return YCOUNT + 2 * loop_rows_exchange(64, B, H) + 2LL * B * H * 4;
}

template <typename S, typename RT, int RPL, bool kP>
cudaError_t launch_loop_rows(const RowsBwdDir<S>* d, const float* mask,
                             int T, int B, int H, int ndir,
                             const LoopRowsPlan& p, cudaStream_t stream) {
  constexpr int U = LoopShape<RPL>::U;
  auto kernel = lstm_bwd_rows<S, RT, RPL, kP>;
  const int smem = loop_rows_smem<RPL>(H);
  static int configured = 0;  // per instantiation: the largest opt-in yet
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  int T_ = T, B_ = B, H_ = H, tpg = p.tpg;
  RowsBwdDir<S> d0 = d[0], d1 = d[1];
  void* args[] = {&d0, &d1, &mask, &T_, &B_, &H_, &tpg};
  // cooperative: every CTA resident at once (each waits on the others'
  // frames), or the launch fails with cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3((H + U - 1) / U, p.groups, ndir), dim3(YTHREADS), args, smem,
      stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename S, typename RT>
cudaError_t run_loop_rows(int T, int B, int H, int ndir, const Frames& fr,
                          const void* const* wh, const void* const* cs,
                          const void* const* dys, void* const* dxw,
                          float* const* scratch, const int* reverse,
                          cudaStream_t stream) {
  const LoopRowsPlan p = loop_rows_plan(B, H, ndir, device_sms());
  if (!p.fits) return cudaErrorInvalidValue;
  const long long n_pre = (long long)T * B * 4 * H;
  const long long xb = loop_rows_exchange(p.TR, B, H);
  RowsBwdDir<S> d[2];
  for (int i = 0; i < ndir; ++i) {
    uint8_t* tail = reinterpret_cast<uint8_t*>(scratch[i] + n_pre);
    // the counters and the exchange start at zero: columns and rows no
    // CTA owns (past H, past B) are read by the product as zeros
    const cudaError_t err = cudaMemsetAsync(tail, 0, YCOUNT + 2 * xb, stream);
    if (err != cudaSuccess) return err;
    d[i].pre = scratch[i];
    d[i].wh = static_cast<const float*>(wh[i]);
    d[i].cs = static_cast<const S*>(cs[i]);
    d[i].dys = static_cast<const S*>(dys[i]);
    d[i].dxw = static_cast<S*>(dxw[i]);
    d[i].count = reinterpret_cast<unsigned int*>(tail);
    d[i].dgx = reinterpret_cast<float*>(tail + YCOUNT);
    d[i].dc = reinterpret_cast<float*>(tail + YCOUNT + 2 * xb);
    d[i].keep = d[i].dc + (long long)B * H;
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
  }
  if (ndir == 1) d[1] = d[0];
  // the layer's frames (one mask, pitch B) on the instantiations without
  // frames
  const bool layer = fr.pitch == B && fr.mask[0] == fr.mask[ndir - 1];
  auto launch = [&](auto kp) {
    constexpr bool kP = decltype(kp)::value;
    return p.RPL == 8 ? launch_loop_rows<S, RT, 8, kP>(d, fr.mask[0], T, B, H,
                                                        ndir, p, stream)
                      : launch_loop_rows<S, RT, 4, kP>(d, fr.mask[0], T, B, H,
                                                        ndir, p, stream);
  };
  return layer ? launch(std::false_type()) : launch(std::true_type());
}

// The gate GEMM's designs: GEMM_FMA, bptt_gates_gemm's f32 form on the
// FMA units (wh in f32: f32 weights, or bf16 ones widened); GEMM_WIDE,
// bptt_gates_gemm_wide (bf16 wh: type codes 1 and 2 only).
// The frame loop's: LOOP_SPLIT, LOOP_FOLD and LOOP_ROWS (wh in f32; any
// type code, LOOP_ROWS where loop_rows_plan fits), LOOP_PERSISTENT (bf16
// wh; codes 1 and 2, H <= 512), LOOP_TC (bf16 wh; codes 1 and 2, where
// bwd_tc_fits).
constexpr int GEMM_FMA = 0;
constexpr int GEMM_WIDE = 1;
constexpr int LOOP_SPLIT = 0;
constexpr int LOOP_FOLD = 1;
constexpr int LOOP_PERSISTENT = 2;
constexpr int LOOP_TC = 3;
constexpr int LOOP_ROWS = 4;

inline bool bf16_weights(int type_code) {
  return type_code == 1 || type_code == 2;
}

// the library's designs (chosen on an H100, PERF.md): bf16 weights take
// the wide gate GEMM at every H (at the flagship's H=512 too, where it
// beats the 128 x 128 tiles: their epilogue does not overlap the products)
inline int gates_design(int type_code, int H) {
  return bf16_weights(type_code) ? GEMM_WIDE : GEMM_FMA;
}

// The frame loop: bf16 weights up to BMAX_H on lstm_bwd_persistent, above
// it on lstm_bwd_tc where it fits (H <= 1056 for two directions) at every
// B (timed in turns against the f32-weight loops on an H100 at H=1000,
// PERF.md); else the f32-weight loop, bf16 weights widened: the fold up
// to B=32, beyond it lstm_bwd_rows for two directions while the card
// holds two row groups (H <= 528 on 132 SMs), else the split. Timed on an
// H100 (PERF.md) at B 64-512: lstm_bwd_rows 1.3-2.6x faster than the
// split at H 64-256, 1.1-1.5x at H 384-512 (at H=384, B=512 within 4%);
// 2-53% slower at H 576-688, where one row group walks every tile.
inline int loop_design(int type_code, int B, int H, int ndir) {
  if (bf16_weights(type_code)) {
    if (H <= BMAX_H) return LOOP_PERSISTENT;
    if (bwd_tc_fits(H, ndir)) return LOOP_TC;
  }
  if (f32_folds(B)) return LOOP_FOLD;
  const int sms = device_sms();
  const int A = (H + LoopShape<4>::U - 1) / LoopShape<4>::U;
  return ndir == 2 && loop_rows_plan(B, H, ndir, sms).fits &&
                 sms / (ndir * A) >= 2
             ? LOOP_ROWS
             : LOOP_SPLIT;
}

// bytes of a direction's scratch for the frame loop's design: the
// recomputed gates [T, B, 4H] f32 at the front, then the loop's own
inline long long bwd_scratch(int loop, int T, int B, int H) {
  const long long pre = (long long)T * B * 4 * H * 4;
  switch (loop) {
    case LOOP_SPLIT:
    case LOOP_FOLD:  // the carries [2][FR_PARTS + 1][B, H] (split: 2 of them)
      return pre + 20LL * B * H * 4;
    case LOOP_PERSISTENT:
      return pre;
    case LOOP_TC:
      return pre + bwd_tc_scratch(B, H);
    case LOOP_ROWS:
      return pre + loop_rows_scratch(B, H);
  }
  return -1;
}

// pre{0,1} [T*B, 4H] f32 by the named design (wh: bf16 for the wgmma
// designs, f32 for GEMM_FMA)
cudaError_t run_gates(int design, int type_code, int T, int B, int H,
                      int ndir, int pitch, const void* const* xw,
                      const void* const* wh, const void* const* ys,
                      float* const* pre, const int* reverse, cudaStream_t s) {
  if (design != GEMM_FMA && !bf16_weights(type_code)) {
    return cudaErrorInvalidValue;
  }
  switch (design) {
    case GEMM_FMA:
      switch (type_code) {
        case 0:
          return run_gates_gemm_f32<float, float>(T, B, H, ndir, pitch, xw, wh,
                                                  ys, pre, reverse, s);
        case 2:
          return run_gates_gemm_f32<float, bf16>(T, B, H, ndir, pitch, xw, wh,
                                                 ys, pre, reverse, s);
        case 1:  // bf16 streams: every operand is a bf16 value, as in code 3
        case 3:
          return run_gates_gemm_f32<bf16, float>(T, B, H, ndir, pitch, xw, wh,
                                                 ys, pre, reverse, s);
      }
      break;
    case GEMM_WIDE:
      return type_code == 1
                 ? run_gates_wide<bf16>(T, B, H, ndir, pitch, xw, wh, ys,
                                        pre, reverse, s)
                 : run_gates_wide<float>(T, B, H, ndir, pitch, xw, wh, ys,
                                         pre, reverse, s);
  }
  return cudaErrorInvalidValue;
}

// vo_lstm_bwd_named's work (-1: the library's design): the gate GEMM
// into the front of scratch, then the frame loop, on frames `pitch` rows
// apart with a mask each direction (Frames)
int bwd(int type_code, int gemm, int loop, int T, int B, int H, int ndir,
        int pitch, const void* mask0, const void* mask1, const void* xw0,
        const void* wh0, const void* whf0,
        const void* ys0, const void* cs0, const void* dys0, void* dxw0,
        void* scratch0, int reverse0, const void* xw1, const void* wh1,
        const void* whf1, const void* ys1, const void* cs1, const void* dys1,
        void* dxw1, void* scratch1, int reverse1, void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2 || type_code < 0 ||
      type_code > 3 || pitch < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gemm == -1) gemm = gates_design(type_code, H);
  if (loop == -1) loop = loop_design(type_code, B, H, ndir);
  if (gemm < GEMM_FMA || gemm > GEMM_WIDE || loop < LOOP_SPLIT ||
      loop > LOOP_ROWS ||
      ((loop == LOOP_PERSISTENT || loop == LOOP_TC) &&
       !bf16_weights(type_code))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* xw[2] = {xw0, xw1};
  const void* wh[2] = {wh0, wh1};
  const void* whf[2] = {whf0, whf1};
  const void* ys[2] = {ys0, ys1};
  const void* cs[2] = {cs0, cs1};
  const void* dys[2] = {dys0, dys1};
  void* dxw[2] = {dxw0, dxw1};
  float* scratch[2] = {static_cast<float*>(scratch0),
                       static_cast<float*>(scratch1)};
  const int reverse[2] = {reverse0, reverse1};
  const Frames m = {{static_cast<const float*>(mask0),
                     static_cast<const float*>(mask1)},
                    pitch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = run_gates(gemm, type_code, T, B, H, ndir, pitch, xw,
                              gemm == GEMM_FMA ? whf : wh, ys, scratch,
                              reverse, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (loop == LOOP_PERSISTENT) {
    return static_cast<int>(
        type_code == 1
            ? run_loop_persistent<bf16>(T, B, H, ndir, m, wh, cs, dys, dxw,
                                        scratch, reverse, s)
            : run_loop_persistent<float>(T, B, H, ndir, m, wh, cs, dys, dxw,
                                         scratch, reverse, s));
  }
  if (loop == LOOP_TC) {
    return static_cast<int>(
        type_code == 1
            ? run_loop_tc<bf16>(T, B, H, ndir, m, wh, cs, dys, dxw, scratch,
                                reverse, s)
            : run_loop_tc<float>(T, B, H, ndir, m, wh, cs, dys, dxw, scratch,
                                 reverse, s));
  }
  if (loop == LOOP_ROWS) {
    switch (type_code) {
      case 0:
        return static_cast<int>(run_loop_rows<float, float>(
            T, B, H, ndir, m, whf, cs, dys, dxw, scratch, reverse, s));
      case 2:
        return static_cast<int>(run_loop_rows<float, bf16>(
            T, B, H, ndir, m, whf, cs, dys, dxw, scratch, reverse, s));
      default:  // 1, 3: bf16 streams, every operand a bf16 value
        return static_cast<int>(run_loop_rows<bf16, float>(
            T, B, H, ndir, m, whf, cs, dys, dxw, scratch, reverse, s));
    }
  }
  const int fold = loop == LOOP_FOLD;
  switch (type_code) {
    case 0:
      return run_loop_f32<float, float>(T, B, H, ndir, m, whf, cs, dys, dxw,
                                        scratch, reverse, fold, s);
    case 2:
      return run_loop_f32<float, bf16>(T, B, H, ndir, m, whf, cs, dys, dxw,
                                       scratch, reverse, fold, s);
    default:  // 1, 3: bf16 streams, every operand a bf16 value
      return run_loop_f32<bf16, float>(T, B, H, ndir, m, whf, cs, dys, dxw,
                                       scratch, reverse, fold, s);
  }
}

}  // namespace

// The BPTT frames of one or two directions that share T, B, H, the types
// and the mask, type_code as vo_lstm_fwd's, in two stages by the designs
// named (-1: the library's): the gate GEMM, gemm 0 (bptt_gates_gemm's FMA
// form) or 1 (bptt_gates_gemm_wide; the library's for bf16 weights, codes
// 1 and 2), then the frame loop, loop 0 (T bptt_cell and T bptt_dh
// launches), 1 (T bptt_frame launches), 2 (one lstm_bwd_persistent
// launch; codes 1 and 2), 3 (one lstm_bwd_tc launch; codes 1 and 2) or 4
// (one lstm_bwd_rows launch, where it fits; vo_lstm_bwd_loop_design says
// which the library runs). wh{0,1}: [H, 4H]
// in the weight type; whf{0,1}: the same in f32 (bf16 weights widened),
// which the FMA gate GEMM and the f32-weight loops read (for f32 weights,
// wh again). scratch{0,1}: vo_lstm_bwd_scratch bytes for the loop, 16-byte
// aligned, any contents. Writes dxw{0,1} [T, B, 4H] in S. Returns the
// first non-zero CUDA error of a launch, or 0. bf16 weights with gemm 0
// and an f32 loop are the route they took above H=512 before the wide
// GEMM and lstm_bwd_tc.
extern "C" int vo_lstm_bwd_named(
    int gemm, int loop, int type_code, int T, int B, int H, int ndir,
    const void* mask, const void* xw0, const void* wh0, const void* whf0,
    const void* ys0, const void* cs0, const void* dys0, void* dxw0,
    void* scratch0, int reverse0, const void* xw1, const void* wh1,
    const void* whf1, const void* ys1, const void* cs1, const void* dys1,
    void* dxw1, void* scratch1, int reverse1, void* stream) {
  return bwd(type_code, gemm, loop, T, B, H, ndir, B, mask, mask, xw0, wh0,
             whf0, ys0, cs0, dys0, dxw0, scratch0, reverse0, xw1, wh1, whf1,
             ys1, cs1, dys1, dxw1, scratch1, reverse1, stream);
}

// vo_lstm_bwd_named on frames `pitch` rows apart (pitch >= B: frame t's
// row b of xw, ys, cs, dys and dxw is row t*pitch + b, its mask value
// mask{0,1}[t*pitch + b]), with a mask of each direction's own; the
// scratch keeps its dense layout. The layer calls pitch = B and one mask;
// vo_bi_lstm_bwd (lstm_bi_stacked.cu) calls it on the two planes of the
// direction-stacked layout.
extern "C" int vo_lstm_bwd_frames(
    int gemm, int loop, int type_code, int T, int B, int H, int ndir,
    int pitch, const void* mask0, const void* mask1, const void* xw0,
    const void* wh0, const void* whf0, const void* ys0, const void* cs0,
    const void* dys0, void* dxw0, void* scratch0, int reverse0,
    const void* xw1, const void* wh1, const void* whf1, const void* ys1,
    const void* cs1, const void* dys1, void* dxw1, void* scratch1,
    int reverse1, void* stream) {
  return bwd(type_code, gemm, loop, T, B, H, ndir, pitch, mask0, mask1, xw0,
             wh0, whf0, ys0, cs0, dys0, dxw0, scratch0, reverse0, xw1, wh1,
             whf1, ys1, cs1, dys1, dxw1, scratch1, reverse1, stream);
}

// The frame loop design vo_lstm_bwd_named runs for loop -1 at type_code,
// B, H and ndir.
extern "C" int vo_lstm_bwd_loop_design(int type_code, int B, int H,
                                       int ndir) {
  return loop_design(type_code, B, H, ndir);
}

// The plan lstm_bwd_persistent (loop 2) runs at type_code (1 or 2), B, H
// (up to 512) and ndir: out[0] batch rows a cluster (the wgmma N), out[1]
// the clusters it launches, out[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Returns the CUDA error of the query,
// or 0.
extern "C" int vo_lstm_bwd_persistent_plan(int type_code, int B, int H,
                                           int ndir, int* out) {
  if (B < 1 || H < 1 || H > BMAX_H || ndir < 1 || ndir > 2 ||
      !bf16_weights(type_code)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows = 0, resident = 0;
  const cudaError_t err =
      type_code == 1
          ? bwd_persistent_rows<bf16>(B, H, ndir, &rows, &resident)
          : bwd_persistent_rows<float>(B, H, ndir, &rows, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = BWD_ROWS[rows].bn;
  out[1] = ndir * ((B + out[0] - 1) / out[0]);
  out[2] = resident;
  return 0;
}

// The scratch (bytes) a direction needs for the frame loop design `loop`
// (0-4) at T, B, H: the recomputed gates, then the loop's carries (and
// the cooperative loops' dg exchange and frame counters); -1 for another
// loop.
extern "C" long long vo_lstm_bwd_scratch(int loop, int T, int B, int H) {
  return bwd_scratch(loop, T, B, H);
}

// The gate GEMM design vo_lstm_bwd_named runs for gemm -1 at type_code
// and H.
extern "C" int vo_lstm_bwd_gates_design(int type_code, int H) {
  return gates_design(type_code, H);
}

// vo_lstm_dwh (below) on frames `pitch` rows apart (pitch >= B: frame t's
// row b of ys and dxw is row t*pitch + b), as vo_bi_lstm_bwd calls it on
// the planes of the direction-stacked layout; the workspace is the same.
extern "C" int vo_lstm_dwh_frames(int design, int type_code, int T, int B,
                                  int H, int ndir, int pitch, const void* ys0,
                                  const void* dxw0, void* dwh0, int reverse0,
                                  const void* ys1, const void* dxw1,
                                  void* dwh1, int reverse1, void* workspace,
                                  void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2 || pitch < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ys[2] = {ys0, ys1};
  const void* dxw[2] = {dxw0, dxw1};
  void* dwh[2] = {dwh0, dwh1};
  const int reverse[2] = {reverse0, reverse1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_dwh<float, float>(design, T, B, H, ndir, pitch, ys, dxw, dwh,
                                   reverse, workspace, s);
    case 1:
      return run_dwh<bf16, bf16>(design, T, B, H, ndir, pitch, ys, dxw, dwh,
                                 reverse, workspace, s);
    case 2:
      return run_dwh<float, bf16>(design, T, B, H, ndir, pitch, ys, dxw, dwh,
                                  reverse, workspace, s);
    case 3:
      return run_dwh<bf16, float>(design, T, B, H, ndir, pitch, ys, dxw, dwh,
                                  reverse, workspace, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dwh{0,1} [H, 4H] f32 from the saved ys and the BPTT's dxw, for
// one or two directions; every element is written (zeros when T = 1).
// design: for bf16 operands (type codes 1-3) 0 (lstm_dwh_tc's 128 x 128
// tiles) or 1 (its 128 x 256 tiles), -1 the library's (vo_lstm_dwh_design);
// code 0 takes lstm_dwh_fma and only -1. workspace: vo_lstm_dwh_workspace
// bytes, 16-byte aligned, any contents (null when that is 0).
extern "C" int vo_lstm_dwh(int design, int type_code, int T, int B, int H,
                           int ndir, const void* ys0, const void* dxw0,
                           void* dwh0, int reverse0, const void* ys1,
                           const void* dxw1, void* dwh1, int reverse1,
                           void* workspace, void* stream) {
  return vo_lstm_dwh_frames(design, type_code, T, B, H, ndir, B, ys0, dxw0,
                            dwh0, reverse0, ys1, dxw1, dwh1, reverse1,
                            workspace, stream);
}

// The workspace (bytes) vo_lstm_dwh needs for the design (-1: the
// library's) at type_code, T, B, H and ndir.
extern "C" long long vo_lstm_dwh_workspace(int design, int type_code, int T,
                                           int B, int H, int ndir) {
  if (T < 1 || B < 1 || H < 1) return 0;
  if (type_code == 0) return dwh_f32_workspace(T, B, H, ndir);
  return dwh_workspace(design == -1 ? dwh_design(H) : design, T, B, H, ndir);
}

// The dwh design vo_lstm_dwh runs for type_code at H (-1: lstm_dwh_fma).
extern "C" int vo_lstm_dwh_design(int type_code, int H) {
  return type_code == 0 ? -1 : dwh_design(H);
}
