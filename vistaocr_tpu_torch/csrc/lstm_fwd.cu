// Masked LSTM recurrence over precomputed gate inputs, both forms.
//
// Replaces vistaocr_tpu/ops/lstm_pallas.py::_fwd_kernel, in both
// directions: the inference form (save_cell=False, what
// lstm_recurrence_pallas runs) and the training form (save_cell=True, what
// _fwd_rule runs to feed the BPTT kernels of lstm_bwd.cu), which also
// stores the cell state.
//
// What it computes, per direction, with h0 = c0 = 0 and t walking
// 0..T-1 (T-1..0 when reverse):
//   gates = f32(xw[t]) + round_to_W(h) @ wh        (f32 accumulation)
//   i, f, o = sigmoid(.), g = tanh(.)              (i, f, g, o columns)
//   c' = f*c + i*g,  h' = o*tanh(c')
//   h = m*h' + (1-m)*h,  c = m*c' + (1-m)*c        (m = mask[t, b])
//   ys[t] = h in the stream type;  cs[t] = c in the stream type (training)
// xw [T,B,4H], ys and cs [T,B,H] are in the stream type S (float or bf16),
// wh [H,4H] in the weight type W (float or bf16), mask [T,B] float. The
// carry (h, c) and all gate math stay float32. Every design reads a
// direction's frames `pitch` rows apart with a mask of its own (Frames,
// lstm_common.cuh): the layer passes pitch = B and one mask; the planes of
// the direction-stacked layout pass 2B and a mask each (vo_lstm_fwd_frames,
// lstm_bi_stacked.cu). The kernels' own buffers stay dense.
// lstm_fwd_persistent and lstm_fwd_grid take the pitch and the masks as a
// template flag (kP), so the layer's instantiations are the code they
// were; the other designs read them at run time (PERF.md: their times).
//
// What bounds it on an H100: T strictly sequential frames, each one
// [B,H] x [H,4H] product (B=32, H=512: 67 MFLOP for both directions, 0.07
// us of the tensor cores, 1.0 us of the f32 FMA units) plus [B,4H] of xw
// read and [B,H] of ys (and cs) written. No frame has enough work to fill
// the card, so a frame costs its dependency chain: getting h of the
// previous frame to every block that needs it, one K=H product, the gate
// math. A kernel launched per frame (lstm_step, below) also pays a launch
// and a pass over all of wh from L2 every frame: 33 us a frame in f32.
//
// bf16 weights (type codes 1 and 2): one persistent launch walks all T
// frames (lstm_fwd_persistent).
// - A direction and 32 batch rows are one thread-block cluster of
//   ceil(H/32) CTAs (16 at H=512: a non-portable cluster size, checked with
//   cudaOccupancyMaxActiveClusters before the launch). CTA r owns hidden
//   units 32r..32r+31 and all four gate columns of each, so the cell
//   update is the product's epilogue.
// - The product gates^T = wh_slice^T * round_W(h)^T runs on the tensor
//   cores: M = the CTA's 128 gate columns in two m64 tiles (gates i, f and
//   g, o), N = the 32 batch rows, K = H. Each of the CTA's two warpgroups
//   owns one tile and holds its A operand, a 64 x H slice of wh, in
//   registers for all T frames (128 registers a thread at H=512: loaded
//   once through shared memory), so a frame's wgmma.m64n32k16 read only h
//   from shared memory. With both operands in shared memory the product
//   was bound by shared-memory bandwidth (3 KB read per instruction).
// - h (bf16, rounded as the reference rounds it before the product) lives
//   in two buffers per CTA, 64B-swizzled, one 2 KB block of 32 rows x 32
//   units per CTA: frame t reads buffer t%2 and writes its own block of
//   buffer (t+1)%2, then sends that block to every peer with one bulk
//   copy each (cp.async.bulk shared::cta -> shared::cluster), completing
//   on the peer's mbarrier for that buffer. No cluster-wide barrier per
//   frame: the double buffer makes the data's arrival enough, since a
//   peer can send frame t's h only after it has received all of frame
//   t-1's, which every CTA sends only after its product of frame t-1 has
//   read the buffer frame t+1 overwrites. (A cluster barrier after 16-byte
//   DSMEM stores was slower: its release waited on every outstanding
//   global load and store of each thread.)
// - The two warpgroups hand each other the two gates of the rows the
//   other one updates through shared memory; each thread then updates 4
//   (unit, row) elements, keeping their f32 h and c in registers. The
//   gate nonlinearities use the hardware exp2 and reciprocal (absolute
//   error about 1e-6; expf, tanhf and IEEE division made the epilogue the
//   longest part of the frame).
// - Global memory is touched only in bulk and off the frame's critical
//   path: the next frame's xw and mask arrive by cp.async into shared
//   memory (coalesced 16-byte chunks) and ys/cs leave from a staging tile
//   as 16-byte stores, both after the frame's copies are issued (issued
//   during the product instead, they slow its shared-memory reads).
// - Each ys/cs element has one writer, no atomics: two runs give the same
//   bits.
// - Limits: H <= 512 (16 CTAs x 32 units: a cluster cannot hold more of
//   wh), any B (ceil(B/32) clusters per direction; those beyond what the
//   card holds at once run in later waves), any T. Its times on an H100
//   are in PERF.md.
// - Above H=512 (F2) no cluster holds wh: lstm_fwd_tc, below.
//
// bf16 weights above H=512 (type codes 1 and 2; F2), up to H=1056 for two
// directions on 132 SMs: one persistent cooperative launch over the whole
// card on the tensor cores (lstm_fwd_tc), lstm_fwd_grid's skeleton with
// bf16 operands. (Before it F2 ran lstm_fwd_grid with wh widened to f32:
// at H=1000 a CTA's f32 slice, 256 KB, did not fit in shared memory, so
// every warp streamed it from L2 every frame, on the FMA units: 43.9 us a
// frame, 85x the bound; times on an H100 in PERF.md.)
// - A direction is N = ceil(H/16) co-resident CTAs over all batch rows
//   (63 at H=1000: 126 CTAs); CTA r owns units 16r .. 16r+15 and their
//   four gate columns, so the cell update is the product's epilogue.
// - Its bf16 slice of wh (H x 64: 125 KB at H=1000) stays on chip for all
//   T frames as mma.sync B fragments in registers: 8 warps, each a quarter
//   of the contraction (16 k16 steps at H=1000) and half of the 64
//   columns, 128 registers a thread. mma.sync.m16n8k16, not wgmma: wgmma
//   reads B from shared memory only, so keeping the slice in registers
//   means taking it as wgmma's A (as lstm_fwd_persistent does), 256
//   registers a thread for one warpgroup's 64 rows; and the product is
//   under a microsecond a frame either way (4 MFLOP a CTA at B=32).
// - The product gates[rows][64] = round_bf16(h) @ wh_slice: A = h rows
//   by ldmatrix from shared memory, f32 accumulation, as the reference's
//   bf16 product with f32 accumulation. The four contraction slices'
//   partial sums meet in shared memory and each (row, unit) cell sums
//   them in slice order: fixed order, one writer per h, c, ys and cs
//   element, so two runs give the same bits.
// - h crosses CTAs through L2 once a frame, in bf16 (only the product
//   reads another CTA's h; each CTA keeps its cells' f32 h and c for the
//   freeze and the carry in global memory it alone touches): each CTA
//   writes its units' h(t) into one of two buffers (by step parity), laid
//   out as one block a (32-row tile, contraction slice), each row padded
//   to an odd number of 16-byte words so that ldmatrix reads it without
//   bank conflicts; then it releases a per-direction frame counter
//   (red.release.gpu after a CTA barrier). Thread 0 acquires the counter
//   (ld.acquire.gpu in a spin) and brings a tile's four blocks by bulk
//   copies (through L2, completing on one mbarrier a slice), two tiles in
//   flight; each warp waits only for its slice.
// - The epilogue uses the hardware exp2 and reciprocal (as
//   lstm_fwd_persistent; the reference's bf16 h is within 3e-2).
// - Co-residency: one CTA an SM (168 KB of shared memory at
//   H=1000); cudaLaunchCooperativeKernel refuses a grid the card cannot
//   hold; a wait that outlives about 10 s traps.
// - Limits (tc_fits): 17 k16 steps a slice (H <= 1088) and ceil(H/16)
//   CTAs a direction on the card. Beyond them bf16 weights take the
//   f32-weight route below with wh widened to f32 (exact) and h rounded
//   to bf16 where the product reads it. The library runs lstm_fwd_tc at
//   every B where it fits (fwd_design; lstm_step timed beside it in
//   PERF.md).
//
// f32 weights (type codes 0 and 3, the parity path): wgmma has no exact
// f32 x f32 product and TF32 would change the numbers, so the product runs
// on the FMA units, in one persistent cooperative launch spread over the
// whole card (lstm_fwd_grid):
// - A direction is N = ceil(H/U) co-resident CTAs over all batch rows
//   (U = 8 units a CTA at H=512: 64 a direction, 128 CTAs on 132 SMs). CTA
//   r owns units U*r .. U*r+U-1 and all four gate columns of each, so the
//   cell update is the product's epilogue and no partial sum crosses CTAs.
// - Its [H, 4U] slice of wh (64 KB at H=512) is loaded into shared memory
//   once and stays there for all T frames; where it does not fit (U=16,
//   H above 576) each warp streams its rows from L2 with h (cp.async).
// - h crosses CTAs through L2 once a frame: each CTA writes its units'
//   f32 h(t) into one of two global buffers (by step parity), then releases
//   a per-direction frame counter (red.release.gpu after a CTA barrier); a
//   CTA acquires the counter (ld.acquire.gpu in a spin) before it reads
//   h(t). The buffers are tiled so that what a warp reads a stage is one
//   contiguous block, fetched by one bulk copy (the TMA engine, through
//   L2: never a plain load, L1 is not coherent and the buffers are reused
//   every other frame) completing on the warp's mbarrier for that stage.
// - The product of a 32-row tile: the contraction is split KS ways (16 at
//   H=512); each split is a few lanes of a warp, each lane accumulating 8
//   rows x 8 gate columns, one byte of shared memory read per FMA, which
//   is what the SM's shared memory can feed (4 x 8 a lane read 1.5 and was
//   bound by it). Each warp streams its splits' columns of h through a
//   private 4-stage ring, so the product has no block-wide barrier. The
//   splits' partial sums meet in shared memory and each (row, unit) cell
//   sums them in split order: fixed order, one writer per h, c, ys and cs
//   element, so two runs give the same bits.
// - The epilogue keeps the precise expf / tanhf of the reference (the
//   parity route), the thread's own c and h(t-1) come from global memory
//   (loaded at the start of the tile, in flight during the product).
// - Co-residency: cudaLaunchCooperativeKernel refuses a grid the card
//   cannot hold at once (the call returns the error, never deadlocks); a
//   wait that outlives about 10 s traps.
// - Limits: U <= 16 (H <= 1056 for two directions on 132 SMs).
// f32 weights at large B (lstm_fwd_rows): the grid kernel walks a
// direction's row tiles in series on every CTA, each tile's 16-way
// contraction split meeting in shared memory behind a barrier, and every
// CTA reads all of h(t) (1 MB at B=512); there a frame is a real GEMM.
// So CTAs own a unit slice x a row group instead:
// - A direction is A = ceil(H/16) unit groups x G row groups (32 x 2 at
//   H=512, B=512: 128 CTAs); CTA (a, g) owns units 16a .. 16a+15 and
//   their four gate columns over its group's row tiles. Its [Hp, 64] slice
//   of wh (128 KB at H=512) stays in shared memory for all T frames.
// - Warp w owns whole tiles of the group (32 rows): each lane
//   accumulates 8 rows x 8 columns (two units, four gates) over the whole
//   contraction, so there is no split, no partial sum and no barrier in
//   the product, and the cell update is the product's epilogue in the
//   lane's own registers. The warp streams only its rows of h(t-1) through
//   a private 4-stage ring (16 bytes a lane and cp.async; per-warp bulk
//   copies on mbarriers ran 4% slower, deeper rings no faster).
// - Rows never meet, so each row group has its own frame counter: a CTA
//   waits only on the A CTAs that share its rows. h(t) crosses CTAs
//   through L2 in f32, tiled so that a ring stage is one contiguous 2 KB
//   block; a direction reads A x B x H x 4 bytes of it a frame (32 MB at
//   B=512), whatever the row split.
// - The product is bound by shared memory into registers: a 16-byte load
//   moves 512 bytes a warp (128 a cycle), and 8 x 8 a lane reads one byte
//   an FMA, as much as the FMA units take. Times on an H100 in PERF.md.
// - Numerics as lstm_fwd_grid: the reference's expf / tanhf, one writer
//   for each h, c, ys and cs element, sums in a fixed order: two runs give
//   the same bits.
// - Limits (rows_fits): the slice in shared memory (H <= 640) and
//   ceil(H/16) CTAs a direction on the card; a call it cannot take is
//   refused.
// The library's rule (f32_design, times on an H100 in PERF.md):
// lstm_fwd_grid where its units fit and B is at most 320 at H=512 (128
// with fewer units, 32 with wh streamed); lstm_fwd_rows beyond B=384 for
// two directions at H 512-528, where the card holds two row groups (a
// warp's 32-row tile sets its frame's time, so it wins only where
// lstm_step's grid needs a second wave and each warp walks one tile);
// else lstm_step. vo_lstm_fwd_named names any of the five kernels.
// lstm_step, one launch a frame, stays beyond the grid's B where
// lstm_fwd_rows does not win or was not timed (B 321-384 at H=512, H
// below 512 or above 528, one direction):
// - both directions of a BLSTM layer in the same launch (blockIdx.z), 32
//   unit tiles x 2 batch tiles x 2 directions = 128 blocks of 128 threads
//   at the flagship shape;
// - each block owns TJ hidden units and TB batch rows and computes all
//   four gate columns {j, H+j, 2H+j, 3H+j} of its units, so the gate
//   math, the mask freeze and the ys/cs stores are the product's
//   epilogue: the [B,4H] gate pre-activations never leave registers;
// - the product (lstm_common.cuh) runs over shared-memory tiles of h
//   (rounded to W) and wh, with f32 FMA into a 4 rows x 2 units x 4 gates
//   register tile per thread; the next K chunk is loaded into registers
//   while the current one is multiplied, and converted only when stored
//   to shared memory;
// - h ping-pongs between two f32 buffers in global memory (every block
//   reads all of h of step t-1 while writing its slice of step t); each
//   c[b, j] is owned by one thread and updated in place.
// Ragged B and H edges are masked in all four kernels.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "lstm_common.cuh"

namespace {

using namespace vo_lstm;
using namespace vo_sm90;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// --- f32 weights: one launch per frame ----------------------------------------

template <typename S, typename W>
struct Dir {
  const S* xw;        // [T, B, 4H]
  const W* wh;        // [H, 4H]
  S* ys;              // [T, B, H]
  S* cs;              // [T, B, H] cell states (training form) or nullptr
  const float* h_in;  // [B, H] state after the previous step
  float* h_out;       // [B, H] state after this step
  float* c;           // [B, H] cell state, updated in place
  const float* mask;  // [T, pitch] rows
  int pitch;          // rows between frames of xw, ys, cs and the mask
  int t;              // frame index this step processes
};

// R: the type h is rounded to before the product (W, or bf16 for bf16
// weights widened to f32)
template <typename S, typename W, typename R>
__global__ void __launch_bounds__(THREADS)
lstm_step(Dir<S, W> d0, Dir<S, W> d1, int B, int H) {
  const Dir<S, W> d = blockIdx.z == 0 ? d0 : d1;
  __shared__ __align__(16) Tiles sm;

  const int tid = threadIdx.x;
  const int tu = tid % 8;   // unit group: units 2*tu, 2*tu+1 of the tile
  const int tr = tid / 8;   // row group: rows 4*tr .. 4*tr+3 of the tile
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * TB;
  const long long G = 4LL * H;

  float acc[4][2][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][s][g] = 0.0f;
  gate_product<float, W, R>(acc, d.h_in, d.wh, B, H, b0, j0, sm);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * tr + r;
    if (b >= B) continue;
    const long long row = (long long)d.t * d.pitch + b;
    const float m = d.mask[row];
    const S* x = d.xw + row * G;
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
      const long long out = row * H + j;
      d.ys[out] = from_f32<S>(h);
      if (d.cs != nullptr) d.cs[out] = from_f32<S>(c);
    }
  }
}

template <typename S, typename W, typename R>
int run_per_frame(int T, int B, int H, int ndir, const Frames& fr,
                  const void* const* xw, const void* const* wh,
                  void* const* ys, void* const* cs, float* const* scratch,
                  const int* reverse, cudaStream_t stream) {
  Dir<S, W> d[2];
  const long long BH = (long long)B * H;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const W*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].cs = static_cast<S*>(cs[i]);
    d[i].c = scratch[i] + 2 * BH;
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
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
    lstm_step<S, W, R><<<grid, THREADS, 0, stream>>>(d[0], d[1], B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// --- f32 weights: one persistent launch over the whole card ------------------

constexpr int GTHREADS = 256;
constexpr int GROWS = 32;          // batch rows of a tile
constexpr int GKD = 8;             // contraction columns of a ring stage
constexpr int GSTAGES = 4;         // ring depth (per warp)
constexpr int GKALIGN = 128;       // h(t) rows padded to a multiple of this
constexpr int GMAX_U = 16;         // the most hidden units a CTA takes
constexpr int GSMEM_MAX = 232448;  // shared memory a block can have (227 KB)

__host__ __device__ constexpr int grid_hp(int H) {  // padded row of h(t)
  return (H + GKALIGN - 1) / GKALIGN * GKALIGN;
}

template <typename S>
struct GridDir {
  const S* xw;            // [T, B, 4H]
  const float* wh;        // [H, 4H]
  S* ys;                  // [T, B, H]
  S* cs;                  // [T, B, H] cell states (training form) or nullptr
  float* h;               // 2 x h(t) tiled (grid_h_at) by step parity, zeroed
  float* c;               // [B, H] cell states, zeroed
  unsigned int* count;    // frames done x CTAs, zeroed
  const float* mask;      // [T, pitch] rows
  int pitch;              // rows between frames of xw, ys, cs and the mask
  int reverse;
};

// How lstm_fwd_grid<U> splits a tile's product, gates[32 rows][4U columns]
// over K = Hp, among its threads: a thread accumulates 8 rows x 8 columns
// (rows rg + 4r, columns 8cg .. 8cg+7; one byte of shared memory read per
// FMA, which the SM's 128 bytes a cycle can feed); TPS threads cover the
// tile (lanes of one warp), KS such splits divide K into contiguous
// ranges, and each split's partial sums meet in shared memory.
template <int U>  // 4, 8 or 16
struct GridShape {
  static constexpr int C = 4 * U;                 // gate columns g*U + u
  static constexpr int TPS = 2 * U;               // 4 row x U/2 column groups
  static constexpr int KS = U <= 8 ? 16 : 8;
  static constexpr int WARPS = KS * TPS / 32;     // warps in the product
  static constexpr int SPW = 32 / TPS;            // splits a warp holds
  static constexpr int HST = SPW * GROWS * GKD;   // h floats of a warp stage
  static constexpr int WST = SPW * GKD * C;       // streamed wh floats
  static constexpr int CLD = C + 4;               // padded partial-sum row
  static constexpr int NC = (GROWS * U + GTHREADS - 1) / GTHREADS;
};

// shared memory (bytes) of lstm_fwd_grid<U>: the splits' partial sums,
// each warp's ring (h, and wh when it is streamed) and the resident wh
template <int U>
__host__ __device__ constexpr int grid_smem(int H, bool resident) {
  using G = GridShape<U>;
  return 8 * G::WARPS * GSTAGES +
         4 * (G::KS * GROWS * G::CLD +
              G::WARPS * GSTAGES * (G::HST + (resident ? 0 : G::WST)) +
              (resident ? grid_hp(H) * G::C : 0));
}

// where h(t)[b][k] lies in a tiled h buffer (nbt * GROWS * Hp floats):
// [tile b / 32][stage][split][row b % 32][GKD columns], so that a warp's
// ring stage (its splits' GKD columns of one stage, all 32 rows of one
// tile) is one contiguous block, loaded by one bulk copy
__device__ __forceinline__ long long grid_h_at(int b, int k, int kper, int nsc,
                                               int KS) {
  const int r = k % kper;
  return ((((long long)(b / GROWS) * nsc + r / GKD) * KS + k / kper) * GROWS +
          b % GROWS) * GKD + r % GKD;
}

// Grid (N = ceil(H/U), ndir): CTA (r, dir) owns hidden units U*r ..
// U*r + U-1 of its direction and all four gate columns of each, over every
// batch row, for all T frames. `resident`: the CTA's [Hp, 4U] slice of wh
// stays in shared memory; else each warp streams its rows with h. `vec`:
// wh rows hold whole, aligned 16-byte runs of U units of a gate. R: the
// type h is rounded to as the product reads it (float: none; bf16 for
// bf16 weights widened to f32); the f32 h that the freeze and the next
// frame's exchange carry stays unrounded. kP: each direction's frames lie
// d.pitch rows apart with its own d.mask (Frames); else they are the
// layer's, B rows apart with `mask`.
template <typename S, int U, typename R, bool kP>
__global__ void __launch_bounds__(GTHREADS, 1)
lstm_fwd_grid(GridDir<S> d0, GridDir<S> d1, const float* __restrict__ mask,
              int T, int B, int H, int resident, int vec) {
  using Gs = GridShape<U>;
  constexpr int C = Gs::C, KS = Gs::KS, CLD = Gs::CLD, NC = Gs::NC;
  constexpr int SPW = Gs::SPW;
  const GridDir<S> d = blockIdx.y == 0 ? d0 : d1;
  const int fpitch = kP ? d.pitch : B;
  const float* fmask = kP ? d.mask : mask;
  const unsigned int N = gridDim.x;
  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hp = grid_hp(H);
  const int kper = Hp / KS;          // contraction columns of a split
  const int nsc = kper / GKD;        // ring stages a tile
  const int nq = (B + GROWS - 1) / GROWS * nsc;
  const long long G = 4LL * H;
  const long long BHp = (long long)(B + GROWS - 1) / GROWS * GROWS * Hp;
  const int wstage = Gs::HST + (resident ? 0 : Gs::WST);
  extern __shared__ float4 grid_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(grid_raw);  // [WARPS][GSTAGES]
  float* red = reinterpret_cast<float*>(full + Gs::WARPS * GSTAGES);
  float* ring = red + KS * GROWS * CLD;             // [WARPS][GSTAGES] stages
  float* w_res = ring + Gs::WARPS * GSTAGES * wstage;  // [Hp][C] if resident

  // row k of the CTA's slice of wh into dst by the warp's lanes: column
  // col = g*U + u is wh[k][g*H + j0 + u]; 16-byte copies where vec, zeros
  // past H
  auto load_w_row = [&](float* dst, int k) {
    if (vec) {
      for (int q = lane; q < C / 4; q += 32) {
        const int g = 4 * q / U, u = 4 * q % U;
        const bool ok = k < H && j0 + u < H;
        cp_async16_zfill(dst + 4 * q,
                         d.wh + (ok ? k * G + g * H + j0 + u : 0), ok);
      }
    } else {
      for (int q = lane; q < C; q += 32) {
        const int g = q / U, u = q % U;
        const bool ok = k < H && j0 + u < H;
        cp_async4_zfill(dst + q, d.wh + (ok ? k * G + g * H + j0 + u : 0),
                        ok);
      }
    }
  };
  if (resident) {  // the slice, once, by every warp
    for (int k = warp; k < Hp; k += GTHREADS / 32) {
      load_w_row(w_res + k * C, k);
    }
    cp_async_commit();
    cp_async_wait_all();
  }
  if (tid < Gs::WARPS * GSTAGES) mbar_init(&full[tid], 1);
  mbar_fence_init();
  __syncthreads();

  // this thread's place in the product: split ks (contraction columns
  // ks*kper ..), rows rg + 4r of the tile, columns 8cg .. 8cg+7
  const bool active = warp < Gs::WARPS;  // U=4: half the warps
  const int s = lane / Gs::TPS, q_ = lane % Gs::TPS;
  const int rg = q_ / (U / 2), cg = q_ % (U / 2);
  const int ks0 = warp * SPW;  // the warp's first split
  const int ks = ks0 + s;
  float* wring = ring + (active ? warp : 0) * GSTAGES * wstage;
  uint64_t* wfull = full + (active ? warp : 0) * GSTAGES;
  int done = 0;  // the warp's stages of earlier frames (mbarrier phases)

  // the cells of the tile at row b0 of frame t: xw, mask and the thread's
  // own c and h(t-1) (in `h`), loaded at the tile's start, in flight
  // during its product (loaded before the frame's release or wait
  // instead, they delayed the release and the frame read 0.4 us slower)
  float xv[NC][4], mv[NC], cv[NC], hv[NC];
  auto load_cells = [&](int t, const float* h, int b0) {
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int cell = tid + e * GTHREADS;
      const int b = b0 + cell / U, j = j0 + cell % U;
      if (cell < GROWS * U && b < B && j < H) {
        const long long row = (long long)t * fpitch + b;
        const S* x = d.xw + row * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[e][g] = to_f32(x[g * H]);
        mv[e] = fmask[row];
        cv[e] = __ldcg(d.c + (long long)b * H + j);
        hv[e] = __ldcg(h + grid_h_at(b, j, kper, nsc, KS));
      }
    }
  };

  for (int step = 0; step < T; ++step, done += nq) {
    const int t = d.reverse ? T - 1 - step : step;
    const float* cur = d.h + (step & 1) * BHp;
    float* nxt = d.h + ((step + 1) & 1) * BHp;
    // h(t-1) complete: every CTA of the direction has released it
    if (step > 0) {
      if (tid == 0) {
        // co-residency makes the wait finite; a fault that breaks it traps
        // (an error at the next synchronise) after about 10 s, not a hang
        const long long start = clock64();
        while (ld_acquire_gpu(d.count) < N * step) {
          if (clock64() - start > (1LL << 34)) __trap();
        }
      }
      __syncthreads();
    }
    // the warp's stage q: columns sc*GKD .. of each of its splits' ranges
    // for the rows of tile q / nsc, one bulk copy of the tiled h(t-1)
    // (through L2, completing on the stage's mbarrier; L1 is not coherent
    // and the buffers are rewritten every other frame); streamed wh rows
    // by cp.async
    auto issue = [&](int q) {
      if (q < nq) {
        const int slot = (done + q) % GSTAGES;
        float* st = wring + slot * wstage;
        const int kc = q % nsc * GKD;
        if (lane == 0) {
          mbar_arrive_expect_tx(&wfull[slot], Gs::HST * 4);
          bulk_load(st, cur + ((long long)q * KS + ks0) * GROWS * GKD,
                    Gs::HST * 4, &wfull[slot]);
        }
        if (!resident) {
          for (int i = 0; i < SPW * GKD; ++i) {
            load_w_row(st + Gs::HST + i * C,
                       (ks0 + i / GKD) * kper + kc + i % GKD);
          }
        }
      }
      cp_async_commit();
    };
    if (active) {
      // the bulk copies read what other CTAs' generic stores wrote: the
      // issuing lane orders them after the acquire
      if (lane == 0) fence_proxy_async_global();
      for (int q = 0; q < GSTAGES - 1; ++q) issue(q);
    }

    float acc[8][8];
    for (int q = 0; q < nq; ++q) {
      const int sc = q % nsc, b0 = q / nsc * GROWS;
      if (sc == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
        load_cells(t, cur, b0);
      }
      if (active) {
        const int slot = (done + q) % GSTAGES;
        grid_wait(&wfull[slot], (done + q) / GSTAGES & 1);
        if (!resident) cp_async_wait_group<GSTAGES - 2>();
        __syncwarp();  // the whole warp is past stage q - 1: reuse its slot
        issue(q + GSTAGES - 1);
        const float* hs = wring + slot * wstage + s * GROWS * GKD;
        const int k0 = ks * kper + sc * GKD;
#pragma unroll
        for (int kq = 0; kq < GKD / 4; ++kq) {
          float4 h4[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            h4[r] = round4<R>(*reinterpret_cast<const float4*>(
                hs + (rg + 4 * r) * GKD + 4 * kq));
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wr =
                resident ? w_res + (k0 + 4 * kq + kk) * C + 8 * cg
                         : wring + slot * wstage + Gs::HST +
                               (s * GKD + 4 * kq + kk) * C + 8 * cg;
            const float4 wa = *reinterpret_cast<const float4*>(wr);
            const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
            const float w8[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float hk = kk == 0   ? h4[r].x
                               : kk == 1 ? h4[r].y
                               : kk == 2 ? h4[r].z
                                         : h4[r].w;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                acc[r][i] = fmaf(hk, w8[i], acc[r][i]);
              }
            }
          }
        }
      }
      if (sc != nsc - 1) continue;
      // the tile's product is done: the splits' partial sums, then the
      // cell update of each (row, unit), summing the splits in order
      if (active) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float* p = red + (ks * GROWS + rg + 4 * r) * CLD + 8 * cg;
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(p + 4) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int cell = tid + e * GTHREADS;
        const int rr = cell / U, u = cell % U;
        const int b = b0 + rr, j = j0 + u;
        if (cell >= GROWS * U || b >= B || j >= H) continue;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            sum += red[(k * GROWS + rr) * CLD + g * U + u];
          }
          pre[g] = xv[e][g] + sum;
        }
        const float i = sigmoid_f32(pre[0]);
        const float f = sigmoid_f32(pre[1]);
        const float g = tanhf(pre[2]);
        const float o = sigmoid_f32(pre[3]);
        const float m = mv[e];
        const float c_new = f * cv[e] + i * g;
        const float h_new = o * tanhf(c_new);
        const float h = m * h_new + (1.0f - m) * hv[e];
        const float c = m * c_new + (1.0f - m) * cv[e];
        d.c[(long long)b * H + j] = c;
        nxt[grid_h_at(b, j, kper, nsc, KS)] = h;
        const long long out = ((long long)t * fpitch + b) * H + j;
        d.ys[out] = from_f32<S>(h);
        if (d.cs != nullptr) d.cs[out] = from_f32<S>(c);
      }
      if (q == nq - 1) fence_proxy_async_global();  // h(t): bulk copies
      // every cell has read the partial sums (the next tile rewrites them)
      // and stored its h (the frame's release follows the last tile)
      __syncthreads();
    }
    // release h(t): one count a CTA, after every thread's stores
    if (tid == 0 && step + 1 < T) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(d.count) : "memory");
    }
  }
}

// the hidden units a CTA of lstm_fwd_grid takes: the least power of two
// (at least 4) that spreads H over at most sms / ndir CTAs a direction;
// 0 where that needs more than GMAX_U
inline int grid_units(int H, int ndir, int sms) {
  const int per_dir = sms / ndir;
  if (per_dir < 1) return 0;
  const int need = (H + per_dir - 1) / per_dir;
  int u = 4;
  while (u < need) u *= 2;
  return u <= GMAX_U ? u : 0;
}

// whether lstm_fwd_grid<U> holds the CTA's slice of wh in shared memory at
// H (else it streams the slice from L2 every tile)
inline bool grid_resident(int U, int H) {
  switch (U) {
    case 4: return grid_smem<4>(H, true) <= GSMEM_MAX;
    case 8: return grid_smem<8>(H, true) <= GSMEM_MAX;
    case 16: return grid_smem<16>(H, true) <= GSMEM_MAX;
    default: return false;
  }
}

template <typename S, int U, typename R, bool kP>
cudaError_t launch_grid(const GridDir<S>* d, const float* mask, int T, int B,
                        int H, int ndir, cudaStream_t stream) {
  auto kernel = lstm_fwd_grid<S, U, R, kP>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_MAX);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int resident = grid_resident(U, H);
  const int smem = grid_smem<U>(H, resident);
  if (smem > GSMEM_MAX) return cudaErrorInvalidValue;
  int vec = H % 4 == 0;
  for (int i = 0; i < ndir; ++i) vec = vec && aligned16(d[i].wh);
  int T_ = T, B_ = B, H_ = H;
  GridDir<S> d0 = d[0], d1 = d[1];
  void* args[] = {&d0, &d1, &mask, &T_, &B_, &H_, &resident, &vec};
  // cooperative: every CTA resident at once (each waits on the others'
  // frames), or the launch fails with cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3((H + U - 1) / U, ndir),
      dim3(GTHREADS), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename S, typename R>
int run_grid(int T, int B, int H, int ndir, const Frames& fr,
             const void* const* xw, const void* const* wh, void* const* ys,
             void* const* cs, float* const* scratch, const int* reverse,
             cudaStream_t stream) {
  const int U = grid_units(H, ndir, device_sms());
  GridDir<S> d[2];
  const long long BHp = (long long)(B + GROWS - 1) / GROWS * GROWS * grid_hp(H);
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const float*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].cs = static_cast<S*>(cs[i]);
    d[i].h = scratch[i];
    d[i].c = scratch[i] + 2 * BHp;
    d[i].count = reinterpret_cast<unsigned int*>(scratch[i] + 2 * BHp +
                                                 (long long)B * H);
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
    switch (U) {
      case 4: return launch_grid<S, 4, R, kP>(d, fr.mask[0], T, B, H, ndir,
                                              stream);
      case 8: return launch_grid<S, 8, R, kP>(d, fr.mask[0], T, B, H, ndir,
                                              stream);
      case 16: return launch_grid<S, 16, R, kP>(d, fr.mask[0], T, B, H, ndir,
                                                stream);
    }
    return cudaErrorInvalidValue;
  };
  return static_cast<int>(layer ? launch(std::false_type())
                                 : launch(std::true_type()));
}

// --- f32 weights at large B: one persistent launch, CTAs over units x rows --

constexpr int RTHREADS = 256;   // 8 warps, each owning whole row tiles
constexpr int RKC = 8;          // contraction columns of a chunk
constexpr int RSTAGE = 2048;    // bytes of a ring stage
constexpr int RSTAGES = 4;      // a warp's ring depth
constexpr int RK_ALIGN = 16;    // h(t) rows padded to a multiple of this

__host__ __device__ constexpr int rows_hp(int H) {
  return (H + RK_ALIGN - 1) / RK_ALIGN * RK_ALIGN;
}

// How lstm_fwd_rows lays out its work: a CTA owns U units; a thread
// multiplies 8 rows by 8 of their gate columns (two units, four gates
// each) over the whole contraction; a warp's lanes are NRG row groups x
// NCG column groups, so a warp owns tiles of WROWS rows and all 4U
// columns of the CTA.
struct RowsShape {
  static constexpr int U = 16;
  static constexpr int C = 4 * U;           // columns (u%2)*2U + (u/2)*4 + g
  static constexpr int NCG = U / 2;         // column groups (two units each)
  static constexpr int NRG = 32 / NCG;      // row groups of a warp
  static constexpr int WROWS = 8 * NRG;     // rows of a warp's tile
  static constexpr int CHUNK = WROWS * RKC;        // floats of a chunk
  static constexpr int SKC = RSTAGE / 4 / CHUNK;   // chunks a ring stage
};

// shared memory (bytes) of lstm_fwd_rows: the warps' rings, then the
// CTA's [Hp, 4U] slice of wh
__host__ __device__ constexpr int rows_smem(int H) {
  return 8 * RSTAGES * RSTAGE + 4 * rows_hp(H) * RowsShape::C;
}

// floats of one parity of lstm_fwd_rows' h(t) exchange: whole tiles of
// WROWS rows, each row Hp columns
inline long long rows_exchange(int B, int H) {
  constexpr int W = RowsShape::WROWS;
  return (long long)(B + W - 1) / W * W * rows_hp(H);
}

// where h(t)[b][k] lies in a tiled h buffer: [tile b / WROWS][chunk k / 8]
// [row b % WROWS][8 columns], so that a warp's ring stage (SKC chunks of
// one tile) is one contiguous block, 16 bytes a lane and copy; rows with
// bit 2 set hold their two 4-column halves swapped, as the readers do
// (the 4 rows a warp reads at once fall in distinct banks either way)
template <int WROWS>
__device__ __forceinline__ long long rows_h_at(int b, int k, int nck) {
  const int r = b % WROWS;
  return (((long long)(b / WROWS) * nck + k / RKC) * WROWS + r) * RKC +
         ((k % RKC) ^ (((r >> 2) & 1) << 2));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

template <typename S>
struct RowsDir {
  const S* xw;          // [T, B, 4H]
  const float* wh;      // [H, 4H]
  S* ys;                // [T, B, H]
  S* cs;                // [T, B, H] cell states (training form) or nullptr
  float* hx;            // 2 parities of rows_exchange: h(t) tiled, zeroed
  float* h;             // [B, H] the f32 h carry, zeroed
  float* c;             // [B, H] the f32 c carry, zeroed
  unsigned int* count;  // [row groups] frames done x CTAs, zeroed
  const float* mask;    // [T, pitch] rows
  int pitch;            // rows between frames of xw, ys, cs and the mask
  int reverse;
};

// Grid (A = ceil(H/U), row groups, ndir), cooperative: CTA (a, g, dir)
// owns hidden units U*a .. U*a + U-1 of its direction, all four gate
// columns of each, over the rows of its row group's tiles (tiles tpg*g ..
// of WROWS rows), for all T frames. Warp w takes the group's tiles w,
// w + 8, ...; a tile's rows meet no other warp and no other row group, so
// each warp streams only its rows of h(t-1) through its own ring, and
// each row group waits only on the A CTAs that share its rows. R: the
// type h is rounded to as the product reads it (float: none; bf16 for
// bf16 weights widened to f32).
template <typename S, typename R>
__global__ void __launch_bounds__(RTHREADS, 1)
lstm_fwd_rows(RowsDir<S> d0, RowsDir<S> d1, int T, int B, int H, int tpg) {
  using Rs = RowsShape;
  constexpr int U = Rs::U, C = Rs::C, NCG = Rs::NCG, NRG = Rs::NRG;
  constexpr int WROWS = Rs::WROWS;
  constexpr int CHUNK = Rs::CHUNK, SKC = Rs::SKC;
  const RowsDir<S> d = blockIdx.z == 0 ? d0 : d1;
  const unsigned int A = gridDim.x;  // the CTAs of a row group
  const int j0 = blockIdx.x * U, grp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int Hp = rows_hp(H), nck = Hp / RKC, nst = nck / SKC;
  const int nt = (B + WROWS - 1) / WROWS;
  const int t_lo = grp * tpg, ntg = min(nt, t_lo + tpg) - t_lo;
  const int nq = (warp < ntg ? (ntg - warp + 7) / 8 : 0) * nst;
  const long long G = 4LL * H;
  const long long HX = (long long)nt * WROWS * Hp;
  extern __shared__ float4 rows_raw[];
  float* ring = reinterpret_cast<float*>(rows_raw);  // [8][RSTAGES] stages
  float* w_res = ring + 8 * RSTAGES * (RSTAGE / 4);  // [Hp][C]

  // the CTA's slice of wh, once: column (u%2)*2U + (u/2)*4 + g of row k
  // is wh[k][g*H + j0 + u] (zeros past H), so that a thread's two units
  // are two aligned runs of four gates
  for (int q = tid; q < Hp * C; q += RTHREADS) {
    const int k = q / C, c = q % C;
    const int u = (c / (2 * U)) + 2 * ((c % (2 * U)) / 4), g = c % 4;
    const bool ok = k < H && j0 + u < H;
    cp_async4_zfill(w_res + q, d.wh + (ok ? k * G + g * H + j0 + u : 0), ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's rows rg + NRG*i of a tile and units 2cg, 2cg + 1
  const int cg = lane % NCG, rg = lane / NCG;
  float* wring = ring + warp * RSTAGES * (RSTAGE / 4);
  int done = 0;  // the warp's stages of earlier frames (ring slots)

  for (int step = 0; step < T; ++step, done += nq) {
    const int t = d.reverse == 0 ? step : T - 1 - step;
    const float* cur = d.hx + (step & 1) * HX;
    float* nxt = d.hx + ((step + 1) & 1) * HX;
    // the warp's stage q: chunks (q % nst)*SKC .. of its tile q / nst of
    // the tiled h(t-1), 16 bytes a lane and copy, one cp.async group a
    // stage (through L2 alone: L1 is not coherent and the buffers are
    // rewritten every other frame); an empty group past the frame's end.
    // (One bulk copy a stage, completing on an mbarrier, ran 4% slower on
    // an H100, and deeper rings did not help: the product, not the copies,
    // bounds the frame; PERF.md.)
    auto issue = [&](int q) {
      if (q < nq) {
        const int slot = (done + q) % RSTAGES;
        const int tile = t_lo + warp + 8 * (q / nst);
        const float* src =
            cur + ((long long)tile * nck + (q % nst) * SKC) * CHUNK;
        float* dst = wring + slot * (RSTAGE / 4);
        for (int v = lane; v < RSTAGE / 16; v += 32) {
          cp_async16(dst + 4 * v, src + 4 * v);
        }
      }
      cp_async_commit();
    };
    if (lane == 0 && nq > 0 && step > 0) {
      // h(t-1) of the group's rows complete: every CTA of the row group
      // has released it (co-residency makes the wait finite; a fault traps
      // after about 10 s instead of hanging)
      const long long start = clock64();
      while (ld_acquire_gpu(d.count + grp) < A * step) {
        if (clock64() - start > (1LL << 34)) __trap();
      }
    }
    __syncwarp();  // the lanes' copies follow lane 0's acquire
    if (nq > 0) {
      for (int q = 0; q < RSTAGES - 1; ++q) issue(q);
    }

    float acc[8][8];
    for (int q = 0; q < nq; ++q) {
      const int s = q % nst;
      const int b0 = (t_lo + warp + 8 * (q / nst)) * WROWS;
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
        // the tile's xw rows into L2 for its epilogue, during the product
        if (cg == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int b = b0 + rg + NRG * i;
            if (b >= B) continue;
            const S* x = d.xw + ((long long)t * d.pitch + b) * G + j0;
#pragma unroll
            for (int g = 0; g < 4; ++g) prefetch_l2(x + g * H);
          }
        }
      }
      const int slot = (done + q) % RSTAGES;
      cp_async_wait_group<RSTAGES - 2>();  // this lane's copies of stage q
      __syncwarp();  // ... and every lane's; the warp is past stage q - 1
      issue(q + RSTAGES - 1);  // into stage q - 1's slot
      const float* hs = wring + slot * (RSTAGE / 4);
#pragma unroll
      for (int cc = 0; cc < SKC; ++cc) {
        const int k0 = (s * SKC + cc) * RKC;
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          float4 h4[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rg + NRG * i;
            h4[i] = round4<R>(*reinterpret_cast<const float4*>(
                hs + cc * CHUNK + r * RKC + 4 * (kq ^ ((r >> 2) & 1))));
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wr = w_res + (k0 + 4 * kq + kk) * C + 4 * cg;
            const float4 wa = *reinterpret_cast<const float4*>(wr);
            const float4 wb = *reinterpret_cast<const float4*>(wr + 2 * U);
            const float w8[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float hk = kk == 0   ? h4[i].x
                               : kk == 1 ? h4[i].y
                               : kk == 2 ? h4[i].z
                                         : h4[i].w;
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(hk, w8[c], acc[i][c]);
            }
          }
        }
      }
      if (s != nst - 1) continue;
      // the tile's product is done: the thread's cells (8 rows x its two
      // units) hold all four gates, so the cell update needs no exchange
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + rg + NRG * i;
        if (b >= B) continue;
        const long long row = (long long)t * d.pitch + b;
        const float m = d.mask[row];
        const S* x = d.xw + row * G;
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) {
          const int j = j0 + 2 * cg + uu;
          if (j >= H) continue;
          const float i_ = sigmoid_f32(to_f32(x[j]) + acc[i][4 * uu]);
          const float f_ = sigmoid_f32(to_f32(x[H + j]) + acc[i][4 * uu + 1]);
          const float g_ = tanhf(to_f32(x[2 * H + j]) + acc[i][4 * uu + 2]);
          const float o_ = sigmoid_f32(to_f32(x[3 * H + j]) + acc[i][4 * uu + 3]);
          const long long own = (long long)b * H + j;
          const float c_old = d.c[own];
          const float h_old = d.h[own];
          const float c_new = f_ * c_old + i_ * g_;
          const float h_new = o_ * tanhf(c_new);
          const float h = m * h_new + (1.0f - m) * h_old;
          const float c = m * c_new + (1.0f - m) * c_old;
          d.c[own] = c;
          d.h[own] = h;
          nxt[rows_h_at<WROWS>(b, j, nck)] = h;
          const long long out = row * H + j;
          d.ys[out] = from_f32<S>(h);
          if (d.cs != nullptr) d.cs[out] = from_f32<S>(c);
        }
      }
    }
    fence_proxy_async_global();  // h(t) before the release, as the other
    __syncthreads();             // cooperative kernels order it
    if (tid == 0 && step + 1 < T) {  // release h(t): one count a CTA
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(d.count + grp) : "memory");
    }
  }
}

// whether lstm_fwd_rows takes ndir directions at H on `sms` SMs: the
// CTA's [Hp, 64] slice of wh in shared memory (H <= 640) and ceil(H/16)
// CTAs a direction on the card
inline bool rows_fits(int H, int ndir, int sms) {
  return rows_smem(H) <= GSMEM_MAX &&
         (long long)ndir * ((H + RowsShape::U - 1) / RowsShape::U) <= sms;
}

// the row groups lstm_fwd_rows spreads B over (each of A CTAs a direction)
// and the tiles of each: as many groups as fill the card's SMs, each
// holding a tile (a warp's tile, not the SM's FMA rate, sets a frame's
// time: B=384 and 512 take about as long a frame on an H100, PERF.md)
inline void rows_plan(int B, int H, int ndir, int sms, int* groups,
                      int* tpg) {
  const int W = RowsShape::WROWS, U = RowsShape::U;
  const int nt = (B + W - 1) / W;
  const int A = (H + U - 1) / U;
  const int g = std::max(1, std::min(nt, sms / (ndir * A)));
  *tpg = (nt + g - 1) / g;
  *groups = (nt + *tpg - 1) / *tpg;  // every group holds a tile
}

template <typename S, typename R>
cudaError_t launch_rows(const RowsDir<S>* d, int T, int B, int H, int ndir,
                        cudaStream_t stream) {
  auto kernel = lstm_fwd_rows<S, R>;
  const int smem = rows_smem(H);
  static int configured = 0;  // per instantiation: the largest opt-in yet
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  int groups = 0, tpg = 0;
  rows_plan(B, H, ndir, device_sms(), &groups, &tpg);
  int T_ = T, B_ = B, H_ = H;
  RowsDir<S> d0 = d[0], d1 = d[1];
  void* args[] = {&d0, &d1, &T_, &B_, &H_, &tpg};
  // cooperative: every CTA resident at once (each waits on the others'
  // frames), or the launch fails with cudaErrorCooperativeLaunchTooLarge
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel),
      dim3((H + RowsShape::U - 1) / RowsShape::U, groups, ndir),
      dim3(RTHREADS), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename S, typename R>
int run_rows(int T, int B, int H, int ndir, const Frames& fr,
             const void* const* xw, const void* const* wh, void* const* ys,
             void* const* cs, float* const* scratch, const int* reverse,
             cudaStream_t stream) {
  if (!rows_fits(H, ndir, device_sms())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long HX = rows_exchange(B, H);
  const long long BH = (long long)B * H;
  RowsDir<S> d[2];
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const float*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].cs = static_cast<S*>(cs[i]);
    d[i].hx = scratch[i];
    d[i].h = scratch[i] + 2 * HX;
    d[i].c = d[i].h + BH;
    d[i].count = reinterpret_cast<unsigned int*>(d[i].c + BH);
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
  }
  if (ndir == 1) d[1] = d[0];
  return static_cast<int>(launch_rows<S, R>(d, T, B, H, ndir, stream));
}

// --- bf16 weights above H=512 (F2): one persistent launch on the tensor cores

constexpr int TU = 16;            // hidden units a CTA
constexpr int TC = 4 * TU;        // its gate columns, c = g*TU + u
constexpr int TROWS = 32;         // batch rows of a tile
constexpr int TTHREADS = 256;     // 8 warps: 2 column halves x TSL slices
constexpr int TSL = 4;            // contraction slices
constexpr int TMAX_KSTEPS = 17;   // k16 steps a slice holds: H <= 1088
constexpr int TCLD = TC + 8;      // padded row of the partial sums (floats)

// k16 steps of one contraction slice (H padded to a multiple of 64)
__host__ __device__ constexpr int tc_ksteps(int H) {
  return (H + 16 * TSL - 1) / (16 * TSL);
}
// bytes of a row of an h block: the slice's bf16 columns and 16 bytes of
// padding, an odd number of 16-byte words, so that the 8 rows of an
// ldmatrix 8 x 8 matrix fall in 8 distinct bank groups
__host__ __device__ constexpr int tc_pitch(int H) {
  return (2 * tc_ksteps(H) + 1) * 16;
}
// bytes of an h block: one tile's rows of one slice, one bulk copy
__host__ __device__ constexpr int tc_block(int H) {
  return TROWS * tc_pitch(H);
}
// shared memory of lstm_fwd_tc: two tile slots of TSL blocks (the wh
// slice is staged there first: 64 * tc_ksteps(H) rows of TC bf16 fit),
// the slices' partial sums, and an mbarrier a block of each slot
__host__ __device__ constexpr int tc_smem(int H) {
  return 2 * TSL * tc_block(H) + TSL * TROWS * TCLD * 4 + 2 * TSL * 8;
}
// bytes of one parity of the h(t) exchange buffer: a block a tile and slice
inline long long tc_exchange_bytes(int B, int H) {
  return (long long)(B + TROWS - 1) / TROWS * TSL * tc_block(H);
}

template <typename S>
struct TcDir {
  const S* xw;          // [T, B, 4H]
  const bf16* wh;       // [H, 4H]
  S* ys;                // [T, B, H]
  S* cs;                // [T, B, H] cell states (training form) or nullptr
  uint8_t* hx;          // 2 parities of tc_exchange_bytes: h(t) in bf16
  float* h;             // [B, H] the f32 h carry, zeroed
  float* c;             // [B, H] the f32 c carry, zeroed
  unsigned int* count;  // frames done x CTAs, zeroed
  const float* mask;    // [T, pitch] rows
  int pitch;            // rows between frames of xw, ys, cs and the mask
  int reverse;
};

// Grid (N = ceil(H/TU), ndir), cooperative: CTA (r, dir) owns hidden
// units TU*r .. TU*r + TU-1 of its direction and their four gate columns,
// over every batch row, for all T frames. Warp w multiplies gate columns
// 32*(w / TSL) .. +31 over contraction slice s = w % TSL (columns
// s*KSL .. +KSL-1 of h), holding those columns' rows of wh as mma B
// fragments in registers for the whole launch. `vec`: wh rows hold whole,
// aligned 16-byte runs of 8 units (H % 8 == 0).
template <typename S>
__global__ void __launch_bounds__(TTHREADS, 1)
lstm_fwd_tc(TcDir<S> d0, TcDir<S> d1, int T, int B, int H, int vec) {
  const TcDir<S> d = blockIdx.y == 0 ? d0 : d1;
  const unsigned int N = gridDim.x;
  const int j0 = blockIdx.x * TU;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ks = tc_ksteps(H), KSL = 16 * ks, Hp = TSL * KSL;
  const int pitch = tc_pitch(H), block = tc_block(H);
  const int nq = (B + TROWS - 1) / TROWS;
  const long long G = 4LL * H;
  const long long hx_bytes = (long long)nq * TSL * block;
  extern __shared__ __align__(16) uint8_t tc_raw[];
  uint8_t* slots = tc_raw;  // [2][TSL] blocks
  float* red = reinterpret_cast<float*>(slots + 2 * TSL * block);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + TSL * TROWS * TCLD);

  // the CTA's slice of wh, ws[k][c] = wh[k][g*H + j0 + u] (c = g*TU + u),
  // staged in the slots (zeros past H), then each warp's B fragments
  const uint4 zero = make_uint4(0, 0, 0, 0);
  unsigned short* ws = reinterpret_cast<unsigned short*>(slots);
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(d.wh);
  if (vec) {  // 8 units of one gate and row a 16-byte load
    for (int q = tid; q < Hp * TC / 8; q += TTHREADS) {
      const int k = q / (TC / 8), c = (q % (TC / 8)) * 8;
      const int g = c / TU, u = c % TU;
      *reinterpret_cast<uint4*>(ws + k * TC + c) =
          (k < H && j0 + u < H)
              ? *reinterpret_cast<const uint4*>(w16 + (long long)k * G +
                                                (long long)g * H + j0 + u)
              : zero;
    }
  } else {
    for (int q = tid; q < Hp * TC; q += TTHREADS) {
      const int k = q / TC, c = q % TC, g = c / TU, u = c % TU;
      ws[q] = (k < H && j0 + u < H)
                  ? w16[(long long)k * G + (long long)g * H + j0 + u]
                  : static_cast<unsigned short>(0);
    }
  }
  __syncthreads();
  const int sl = warp % TSL, half = warp / TSL;
  // bw[kk][n][j]: rows s*KSL + 16kk + 2(l%4) + 8j (and the next one, high
  // half) of column 32*half + 8n + l/4
  uint32_t bw[TMAX_KSTEPS][4][2];
#pragma unroll
  for (int kk = 0; kk < TMAX_KSTEPS; ++kk)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = sl * KSL + 16 * kk + 2 * (lane % 4) + 8 * j;
        const int c = 32 * half + 8 * n + lane / 4;
        bw[kk][n][j] =
            kk < ks ? static_cast<uint32_t>(ws[k * TC + c]) |
                          (static_cast<uint32_t>(ws[(k + 1) * TC + c]) << 16)
                    : 0u;
      }
  if (tid < 2 * TSL) mbar_init(&full[tid], 1);
  mbar_fence_init();
  __syncthreads();  // the slots are free for h

  // the cells of the tile at row b0 of frame t that this thread updates
  // (cell tid + 256e: row cell / TU, unit cell % TU): xw, mask and its own
  // f32 h and c, loaded at the tile's start, in flight during the product
  constexpr int NC = TROWS * TU / TTHREADS;
  float xv[NC][4], mv[NC], hv[NC], cv[NC];
  auto load_cells = [&](int t, int b0) {
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int cell = tid + e * TTHREADS;
      const int b = b0 + cell / TU, j = j0 + cell % TU;
      if (b < B && j < H) {
        const long long row = (long long)t * d.pitch + b;
        const S* x = d.xw + row * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[e][g] = to_f32(x[g * H]);
        mv[e] = d.mask[row];
        hv[e] = d.h[(long long)b * H + j];
        cv[e] = d.c[(long long)b * H + j];
      }
    }
  };

  long long seq = 0;  // tiles loaded before this frame (mbarrier phases)
  for (int step = 0; step < T; ++step, seq += nq) {
    const int t = d.reverse ? T - 1 - step : step;
    const uint8_t* cur = d.hx + (step & 1) * hx_bytes;
    uint8_t* nxt = d.hx + ((step + 1) & 1) * hx_bytes;
    // tile q of h(t-1) into its slot, a bulk copy a slice (through L2: L1
    // is not coherent, and the buffers are rewritten every other frame)
    auto issue = [&](int q) {
      const int slot = (seq + q) & 1;
      for (int s = 0; s < TSL; ++s) {
        uint64_t* bar = &full[slot * TSL + s];
        mbar_arrive_expect_tx(bar, block);
        bulk_load(slots + (slot * TSL + s) * block,
                  cur + ((long long)q * TSL + s) * block, block, bar);
      }
    };
    if (tid == 0) {
      if (step > 0) {
        // h(t-1) complete: every CTA of the direction has released it
        // (co-residency makes the wait finite; a fault traps after ~10 s)
        const long long start = clock64();
        while (ld_acquire_gpu(d.count) < N * step) {
          if (clock64() - start > (1LL << 34)) __trap();
        }
      }
      fence_proxy_async_global();  // the copies read other CTAs' stores
      issue(0);
      if (nq > 1) issue(1);
    }
    for (int q = 0; q < nq; ++q) {
      const int b0 = q * TROWS;
      const int slot = (seq + q) & 1;
      load_cells(t, b0);
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
      grid_wait(&full[slot * TSL + sl], ((seq + q) >> 1) & 1);
      // A fragments by ldmatrix: lanes 8i..8i+7 address the rows of 8 x 8
      // matrix i (rows 0-7 / 8-15 of the m16 tile, k words 0 / 1)
      const uint32_t a0 = smem_u32(slots + (slot * TSL + sl) * block) +
                          ((lane % 8) + 8 * ((lane / 8) % 2)) * pitch +
                          (lane / 16) * 16;
#pragma unroll
      for (int kk = 0; kk < TMAX_KSTEPS; ++kk) {
        if (kk >= ks) break;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, a0 + 16 * m * pitch + 32 * kk);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            mma_16816(acc[m][n], a, bw[kk][n][0], bw[kk][n][1]);
          }
        }
      }
      // the slice's partial sums: c0,c1 at (row l/4, columns 2(l%4)+0,1),
      // c2,c3 eight rows below
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * m + lane / 4 + 8 * h;
            const int col = 32 * half + 8 * n + 2 * (lane % 4);
            *reinterpret_cast<float2*>(red + (sl * TROWS + row) * TCLD + col) =
                make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
          }
      __syncthreads();  // every product read its slot; the partials are in
      if (tid == 0 && q + 2 < nq) issue(q + 2);  // into the freed slot
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int cell = tid + e * TTHREADS;
        const int rr = cell / TU, u = cell % TU;
        const int b = b0 + rr, j = j0 + u;
        if (b >= B || j >= H) continue;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = red[rr * TCLD + g * TU + u];
#pragma unroll
          for (int s = 1; s < TSL; ++s) {
            sum += red[(s * TROWS + rr) * TCLD + g * TU + u];
          }
          pre[g] = xv[e][g] + sum;
        }
        const float i = sigmoid_fast(pre[0]);
        const float f = sigmoid_fast(pre[1]);
        const float g = tanh_fast(pre[2]);
        const float o = sigmoid_fast(pre[3]);
        const float m = mv[e];
        const float c_new = f * cv[e] + i * g;
        const float h_new = o * tanh_fast(c_new);
        const float h = m * h_new + (1.0f - m) * hv[e];
        const float c = m * c_new + (1.0f - m) * cv[e];
        const long long own = (long long)b * H + j;
        d.h[own] = h;
        d.c[own] = c;
        // h(t) rounded to bf16 where the next frame's product reads it
        const int sx = j / KSL, kx = j % KSL;
        *reinterpret_cast<bf16*>(
            nxt + ((long long)q * TSL + sx) * block + rr * pitch + 2 * kx) =
            __float2bfloat16(h);
        const long long out = ((long long)t * d.pitch + b) * H + j;
        d.ys[out] = from_f32<S>(h);
        if (d.cs != nullptr) d.cs[out] = from_f32<S>(c);
      }
      if (q == nq - 1) fence_proxy_async_global();  // h(t): bulk copies
      __syncthreads();  // the partials are read (the next tile rewrites
                        // them) and every h(t) is stored
    }
    if (tid == 0 && step + 1 < T) {  // release h(t): one count a CTA
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(d.count) : "memory");
    }
  }
}

// whether lstm_fwd_tc takes ndir directions at H: a slice's wh rows in
// registers (TMAX_KSTEPS) and ceil(H/TU) CTAs a direction co-resident, one
// an SM (H <= 1056 for two directions on 132 SMs)
inline bool tc_fits(int H, int ndir) {
  return tc_ksteps(H) <= TMAX_KSTEPS && tc_smem(H) <= GSMEM_MAX &&
         (long long)ndir * ((H + TU - 1) / TU) <= device_sms();
}

template <typename S>
int run_tc(int T, int B, int H, int ndir, const Frames& fr,
           const void* const* xw, const void* const* wh, void* const* ys,
           void* const* cs, float* const* scratch, const int* reverse,
           cudaStream_t stream) {
  if (!tc_fits(H, ndir)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lstm_fwd_tc<S>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long hx = 2 * tc_exchange_bytes(B, H) / 4;  // floats
  TcDir<S> d[2];
  int vec = H % 8 == 0;
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const bf16*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].cs = static_cast<S*>(cs[i]);
    d[i].hx = reinterpret_cast<uint8_t*>(scratch[i]);
    d[i].h = scratch[i] + hx;
    d[i].c = scratch[i] + hx + (long long)B * H;
    d[i].count = reinterpret_cast<unsigned int*>(scratch[i] + hx +
                                                 2LL * B * H);
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
    vec = vec && aligned16(wh[i]);
  }
  if (ndir == 1) d[1] = d[0];
  TcDir<S> d0 = d[0], d1 = d[1];
  int T_ = T, B_ = B, H_ = H;
  void* args[] = {&d0, &d1, &T_, &B_, &H_, &vec};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3((H + TU - 1) / TU, ndir),
      dim3(TTHREADS), args, tc_smem(H), stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// --- bf16 weights: one persistent launch for all frames -----------------------

constexpr int PU = 32;          // hidden units per CTA
constexpr int PM = 4 * PU;      // its gate rows: two m64 tiles of M
constexpr int PN = 32;          // batch rows per cluster (the wgmma N)
constexpr int PTHREADS = 256;   // two warpgroups, one per m64 tile
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_H = PU * MAX_CLUSTER;
constexpr int SLICE = PN * PU * 2;  // one CTA's block of h: 2 KB of bf16

// a row of the staged xw, ys and cs tiles: 32 units and 16 bytes of
// padding, so that a warp's epilogue accesses (rows 2 apart, 8 units
// each) hit distinct banks
template <typename S>
__host__ __device__ constexpr int srow() {
  return PU * static_cast<int>(sizeof(S)) + 16;
}

// shared memory for K = 64*KB: A (PM rows of 64-column blocks, 128 bytes a
// row; once A is in registers, the two warpgroups' gate exchange), two h
// buffers (PN rows of 32-column blocks, 64 bytes a row), the frame's xw
// [4][PN] rows and mask [PN], the ys/cs staging [2][PN] rows and two
// mbarriers
template <typename S, int KB>
constexpr int persistent_smem() {
  return 1024 + KB * PM * 128 + 2 * KB * PN * 128 + 4 * PN * srow<S>() +
         PN * 4 + 2 * PN * srow<S>() + 16;
}

template <typename S>
struct SeqDir {
  const S* xw;     // [T, B, 4H]
  const bf16* wh;  // [H, 4H]
  S* ys;           // [T, B, H]
  S* cs;           // [T, B, H] cell states (training form) or nullptr
  const float* mask;  // [T, pitch] rows
  int pitch;          // rows between frames of xw, ys, cs and the mask
  int reverse;
};

// Grid (cluster size C = ceil(H/32), ceil(B/32), ndir), cluster (C, 1, 1).
// Warpgroup v (warps 4v..4v+3) multiplies tile v of A (gates 2v, 2v+1);
// its thread (warp w, lane l) owns unit 32*rank + 8w + l/4 and batch rows
// 32*blockIdx.y + 8n + 2(l%4) + v (n < 4) for all T frames. `vec`: rows of
// wh, xw, ys and cs are whole, aligned 16-byte chunks (H % 8 == 0). kP:
// each direction's frames lie d.pitch rows apart with its own d.mask
// (Frames); else they are the layer's, B rows apart with `mask` (the
// kernel as it ran before frames had a pitch).
template <typename S, int KB, bool kP>
__global__ void __launch_bounds__(PTHREADS, 1)
lstm_fwd_persistent(SeqDir<S> d0, SeqDir<S> d1, const float* __restrict__ mask,
                    int T, int B, int H, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  const SeqDir<S> d = blockIdx.z == 0 ? d0 : d1;
  const int fpitch = kP ? d.pitch : B;
  const float* fmask = kP ? d.mask : mask;
  const int b0 = blockIdx.y * PN;
  const int j0 = rank * PU;
  const long long G = 4LL * H;
  const int tid = threadIdx.x;
  constexpr int HBUF = 2 * KB * SLICE;
  constexpr int SROW = srow<S>();
  constexpr int ES = static_cast<int>(sizeof(S));
  extern __shared__ uint8_t seq_raw[];
  uint8_t* a_s = align1024(seq_raw);          // [KB][PM][64] bf16, 128B swz
  uint8_t* h_s = a_s + KB * PM * 128;         // 2 x [2KB][PN][32] bf16, 64B
  uint8_t* x_s = h_s + 2 * HBUF;              // [4][PN] rows of SROW bytes
  float* m_s = reinterpret_cast<float*>(x_s + 4 * PN * SROW);  // [PN]
  uint8_t* o_s = reinterpret_cast<uint8_t*>(m_s + PN);  // ys, cs: [2][PN]
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * PN * SROW);
  auto o_at = [&](int which, int r, int uu) {  // staged ys (0) or cs (1)
    return reinterpret_cast<S*>(o_s + (which * PN + r) * SROW) + uu;
  };

  // A and both h buffers (h(-1) = 0) zeroed: rows and columns past H stay
  // zero
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int q = tid; q < (KB * PM * 128 + 2 * HBUF) / 16; q += PTHREADS) {
    reinterpret_cast<uint4*>(a_s)[q] = zero;
  }
  __syncthreads();
  // wh[k][g*H + j0 + uu] goes to A row 64*(g/2) + 16*(uu/8) + 8*(g%2) +
  // uu%8, column k: the rows of one thread's accumulator fragment (16w +
  // l/4 and 16w + l/4 + 8 of its warpgroup's m64 tile) are two gates of one
  // unit, and the same thread of the other warpgroup holds the other two
  auto a_put = [&](int k, int g, int uu, unsigned short v) {
    const int m = 64 * (g / 2) + 16 * (uu / 8) + 8 * (g % 2) + uu % 8;
    *reinterpret_cast<unsigned short*>(a_s + (k / 64) * PM * 128 +
                                       swz128(m, (k % 64) / 8) +
                                       (k % 8) * 2) = v;
  };
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(d.wh);
  if (vec) {  // 8 units of one gate and row of wh per 16-byte load
    constexpr int BATCH = 8;
    const int total = 16 * H;  // (row k, gate, 8-unit chunk)
    for (int base = tid; base < total; base += BATCH * PTHREADS) {
      uint4 v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {  // the batch's loads in flight
        const int q = base + i * PTHREADS;
        const int k = q / 16, g = (q / 4) % 4, uu = 8 * (q % 4);
        v[i] = (q < total && j0 + uu < H)
                   ? *reinterpret_cast<const uint4*>(
                         w16 + (long long)k * G + (long long)g * H + j0 + uu)
                   : zero;
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int q = base + i * PTHREADS;
        if (q >= total) break;
        const int k = q / 16, g = (q / 4) % 4, uu = 8 * (q % 4);
        const unsigned short* e = reinterpret_cast<const unsigned short*>(&v[i]);
#pragma unroll
        for (int r = 0; r < 8; ++r) a_put(k, g, uu + r, e[r]);
      }
    }
  } else {
    for (int q = tid; q < H * PM; q += PTHREADS) {
      const int k = q / PM, g = (q / PU) % 4, uu = q % PU;
      if (j0 + uu < H) {
        a_put(k, g, uu, w16[(long long)k * G + (long long)g * H + j0 + uu]);
      }
    }
  }

  __syncthreads();
  // this thread's fragments of its warpgroup's tile of A, for all of K:
  // register j of k-step kk holds row 16w + l/4 + 8(j%2), columns
  // 16kk + 2(l%4) + 8(j/2) and the next one
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  uint32_t af[4 * KB][4];
#pragma unroll
  for (int kk = 0; kk < 4 * KB; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 64 * wg + 16 * warp + lane / 4 + 8 * (j % 2);
      const int k = 16 * kk + 2 * (lane % 4) + 8 * (j / 2);
      af[kk][j] = *reinterpret_cast<const uint32_t*>(
          a_s + (k / 64) * PM * 128 + swz128(m, (k % 64) / 8) + (k % 8) * 2);
    }
  __syncthreads();  // A's shared memory now holds the gate exchange
  // xch[v][n][0..1][t]: the gates 2v, 2v+1 that warpgroup v computed for
  // the other warpgroup's rows (rows 8n + 2(l%4) + 1 - v)
  float* xch = reinterpret_cast<float*>(a_s);

  // frame t's xw [rows b0.., gate g, units j0..] and mask into x_s, m_s:
  // asynchronous copies, zeros past B and H
  auto load_inputs = [&](int t) {
    if (vec) {
      constexpr int CH = 16 / ES;  // elements per 16-byte chunk
      constexpr int NCH = PU / CH;
      for (int q = tid; q < 4 * PN * NCH; q += PTHREADS) {
        const int g = q / (PN * NCH), r = (q / NCH) % PN, c = q % NCH;
        const bool ok = b0 + r < B && j0 + c * CH < H;
        const S* src = d.xw + (ok ? ((long long)t * fpitch + b0 + r) * G +
                                        (long long)g * H + j0 + c * CH
                                  : 0);
        cp_async16_zfill(x_s + (g * PN + r) * SROW + c * 16, src, ok);
      }
    } else {  // synchronous: shapes outside the main path
      for (int q = tid; q < 4 * PN * PU; q += PTHREADS) {
        const int g = q / (PN * PU), r = (q / PU) % PN, uu = q % PU;
        const bool ok = b0 + r < B && j0 + uu < H;
        *reinterpret_cast<S*>(x_s + (g * PN + r) * SROW + uu * ES) =
            ok ? d.xw[((long long)t * fpitch + b0 + r) * G +
                      (long long)g * H + j0 + uu]
               : from_f32<S>(0.0f);
      }
    }
    if (tid < PN) {
      const bool ok = b0 + tid < B;
      cp_async4_zfill(m_s + tid,
                      fmask + (ok ? (long long)t * fpitch + b0 + tid : 0),
                      ok);
    }
  };

  // the staged ys (and cs) of frame t to global memory
  auto store_outputs = [&](int t) {
    const int nout = d.cs != nullptr ? 2 : 1;
    if (vec) {
      constexpr int CH = 16 / ES;
      constexpr int NCH = PU / CH;
      for (int q = tid; q < nout * PN * NCH; q += PTHREADS) {
        const int which = q / (PN * NCH), r = (q / NCH) % PN, c = q % NCH;
        if (b0 + r >= B || j0 + c * CH >= H) continue;
        S* dst = (which == 0 ? d.ys : d.cs) +
                 ((long long)t * fpitch + b0 + r) * H + j0 + c * CH;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(o_at(which, r, c * CH));
      }
    } else {
      for (int q = tid; q < nout * PN * PU; q += PTHREADS) {
        const int which = q / (PN * PU), r = (q / PU) % PN, uu = q % PU;
        if (b0 + r >= B || j0 + uu >= H) continue;
        (which == 0 ? d.ys : d.cs)[((long long)t * fpitch + b0 + r) * H +
                                   j0 + uu] = *o_at(which, r, uu);
      }
    }
  };

  if (tid == 0) {  // full[b]: the peers' slices of the h in buffer b arrived
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  // every CTA's A, zeroed h buffers and barriers are in place before any
  // peer copies into them or the tensor cores read them
  fence_proxy_async();
  cluster_arrive_release();
  cluster_wait_acquire();

  const int uu = 8 * warp + lane / 4;  // this thread's unit in the CTA
  const bool u_ok = j0 + uu < H;
  const int wt = tid % 128;
  constexpr int NJ = PN / 8;
  float hc[NJ], cc[NJ];  // the f32 carries of this thread's elements
#pragma unroll
  for (int n = 0; n < NJ; ++n) hc[n] = cc[n] = 0.0f;
  load_inputs(d.reverse ? T - 1 : 0);
  for (int step = 0; step < T; ++step) {
    const int t = d.reverse ? T - 1 - step : step;
    const int nbuf = (step + 1) & 1;
    uint8_t* nxt = h_s + nbuf * HBUF;
    const uint32_t cur = smem_u32(h_s + (step & 1) * HBUF);
    // frame s reads what frame s - 1 sent: phase (s - 1) / 2 of its buffer
    if (step > 0) mbar_wait(&full[step & 1], ((step - 1) >> 1) & 1);

    float acc[PN / 2];  // gates 2wg, 2wg+1 of this thread's unit
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * KB; ++kk) {  // 16 columns of K each
      // h: 32-column blocks (one per CTA) of 64B-swizzled rows
      wgmma_m64n32_rs<0>(
          acc, af[kk],
          wgmma_desc(cur + (kk / 2) * SLICE + (kk % 2) * 32, 16, 512, 2));
    }
    wgmma_commit();
    // the frame's inputs, loaded during the previous frame
    cp_async_wait_all();
    __syncthreads();
    float xf[NJ][4], mf[NJ];
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int nb = 8 * n + 2 * (lane % 4) + wg;
      mf[n] = m_s[nb];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        xf[n][g] = to_f32(
            *reinterpret_cast<const S*>(x_s + (g * PN + nb) * SROW + uu * ES));
      }
    }
    wgmma_wait<0>();
    // accumulator 4n + q: gate 2wg + q/2 of row 8n + 2(l%4) + q%2; the rows
    // of the other warpgroup go to it
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      float* x = xch + ((wg * NJ + n) * 2) * 128 + wt;
      x[0] = wg ? acc[4 * n] : acc[4 * n + 1];
      x[128] = wg ? acc[4 * n + 2] : acc[4 * n + 3];
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int nb = 8 * n + 2 * (lane % 4) + wg;  // row of the h tile
      const float* x = xch + (((1 - wg) * NJ + n) * 2) * 128 + wt;
      const float own0 = wg ? acc[4 * n + 1] : acc[4 * n];
      const float own1 = wg ? acc[4 * n + 3] : acc[4 * n + 2];
      const float i = sigmoid_fast(xf[n][0] + (wg ? x[0] : own0));
      const float f = sigmoid_fast(xf[n][1] + (wg ? x[128] : own1));
      const float g = tanh_fast(xf[n][2] + (wg ? own0 : x[0]));
      const float o = sigmoid_fast(xf[n][3] + (wg ? own1 : x[128]));
      const float m = mf[n];
      const float c_new = f * cc[n] + i * g;
      const float h_new = o * tanh_fast(c_new);
      float h = m * h_new + (1.0f - m) * hc[n];
      float c = m * c_new + (1.0f - m) * cc[n];
      if (!u_ok) h = c = 0.0f;  // padding units stay zero
      hc[n] = h;
      cc[n] = c;
      // h rounded to bf16 in this CTA's block of the next h tile
      *reinterpret_cast<bf16*>(nxt + rank * SLICE + swz64(nb, warp) +
                               (lane / 4) * 2) = __float2bfloat16(h);
      *o_at(0, nb, uu) = from_f32<S>(h);
      if (d.cs != nullptr) *o_at(1, nb, uu) = from_f32<S>(c);
    }
    fence_proxy_async();  // the h slice is read by the bulk copies
    __syncthreads();

    if (step + 1 < T) {  // nobody reads the last frame's h
      // the CTA's 2 KB block of h to each peer, one bulk copy per peer
      // (issued by thread p), completing on the peer's full[nbuf]
      if (tid == 0) mbar_arrive_expect_tx(&full[nbuf], (nrank - 1) * SLICE);
      if (tid < nrank && tid != rank) {
        const uint32_t off = rank * SLICE;
        bulk_copy_to_peer(cluster_addr(smem_u32(nxt) + off, tid), nxt + off,
                          SLICE, cluster_addr(smem_u32(&full[nbuf]), tid));
        bulk_commit();
      }
    }
    // global memory traffic that nothing in the recurrence waits on, after
    // the product (issued during it, it slows the product's shared-memory
    // reads): the frame's outputs, the next frame's inputs
    store_outputs(t);
    if (step + 1 < T) load_inputs(d.reverse ? t - 1 : t + 1);
  }
  // no CTA leaves while a copy from or to its shared memory is in flight
  bulk_wait_read();
  cluster_arrive_release();
  cluster_wait_acquire();
}

template <typename S, int KB, bool kP>
cudaError_t launch_persistent(const SeqDir<S>* d, const float* mask, int T,
                              int B, int H, int ndir, int vec,
                              cudaStream_t stream) {
  constexpr int smem = persistent_smem<S, KB>();
  auto kernel = lstm_fwd_persistent<S, KB, kP>;
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
  const int csize = (H + PU - 1) / PU;
  const int nbt = (B + PN - 1) / PN;
  if (nbt > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, nbt, ndir);
  cfg.blockDim = dim3(PTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, d[0], d[1], mask, T, B, H, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename S>
int run_persistent(int T, int B, int H, int ndir, const Frames& fr,
                   const void* const* xw, const void* const* wh,
                   void* const* ys, void* const* cs, const int* reverse,
                   cudaStream_t stream) {
  if (H > MAX_H) return static_cast<int>(cudaErrorInvalidValue);
  SeqDir<S> d[2];
  for (int i = 0; i < ndir; ++i) {
    d[i].xw = static_cast<const S*>(xw[i]);
    d[i].wh = static_cast<const bf16*>(wh[i]);
    d[i].ys = static_cast<S*>(ys[i]);
    d[i].cs = static_cast<S*>(cs[i]);
    d[i].mask = fr.mask[i];
    d[i].pitch = fr.pitch;
    d[i].reverse = reverse[i];
  }
  if (ndir == 1) d[1] = d[0];
  // rows of wh, xw, ys and cs in whole, aligned 16-byte chunks
  int vec = H % 8 == 0;
  for (int i = 0; i < ndir; ++i) {
    vec = vec && aligned16(d[i].wh) && aligned16(d[i].xw) &&
          aligned16(d[i].ys) && aligned16(d[i].cs);
  }
  // K padded to 64, 128, 256 or 512 columns; the layer's frames (one
  // mask, pitch B) on the instantiations without frames
  const int kb = (H + 63) / 64;
  const bool layer = fr.pitch == B && fr.mask[0] == fr.mask[ndir - 1];
  auto launch = [&](auto kp) {
    constexpr bool kP = decltype(kp)::value;
    if (kb <= 1) {
      return launch_persistent<S, 1, kP>(d, fr.mask[0], T, B, H, ndir, vec,
                                         stream);
    } else if (kb <= 2) {
      return launch_persistent<S, 2, kP>(d, fr.mask[0], T, B, H, ndir, vec,
                                         stream);
    } else if (kb <= 4) {
      return launch_persistent<S, 4, kP>(d, fr.mask[0], T, B, H, ndir, vec,
                                         stream);
    }
    return launch_persistent<S, 8, kP>(d, fr.mask[0], T, B, H, ndir, vec,
                                       stream);
  };
  return static_cast<int>(layer ? launch(std::false_type())
                                 : launch(std::true_type()));
}

// The forward's designs (vo_lstm_fwd_named): FWD_STEP (lstm_step a
// frame), FWD_GRID (lstm_fwd_grid) and FWD_ROWS (lstm_fwd_rows), the
// f32-weight route, wh in f32; FWD_TC (lstm_fwd_tc: bf16 weights above
// MAX_H) and FWD_PERSISTENT (lstm_fwd_persistent: bf16 weights up to
// MAX_H), wh in bf16.
constexpr int FWD_STEP = 0;
constexpr int FWD_GRID = 1;
constexpr int FWD_TC = 2;
constexpr int FWD_PERSISTENT = 3;
constexpr int FWD_ROWS = 4;

// f32 weights, by shape (the designs' times on an H100 in PERF.md, two
// directions): lstm_fwd_grid where its units fit a CTA (grid_units) and B
// is at most 320 with wh resident and 8 or more units a CTA (H=512), 128
// with fewer units (H=256), 32 with wh streamed (H=1000); lstm_fwd_rows
// from B=385 for two directions at H from 512 while the card holds two
// row groups (H <= 528 on 132 SMs: it wins from B=448, 18% at B=512 and
// H=512, 17-26% at H=528; it loses at B=384, where lstm_step's grid is
// one wave, by 11-21% at H 256-384 and by 36-62% at H 576-640, where one
// row group walks every tile); lstm_step a frame elsewhere
inline int f32_design(int B, int H, int ndir) {
  const int sms = device_sms();
  const int U = grid_units(H, ndir, sms);
  if (U != 0 && B <= (!grid_resident(U, H) ? 32 : U >= 8 ? 320 : 128)) {
    return FWD_GRID;
  }
  const int A = (H + RowsShape::U - 1) / RowsShape::U;
  return ndir == 2 && B > 384 && H >= 512 && rows_fits(H, ndir, sms) &&
                 sms / (ndir * A) >= 2
             ? FWD_ROWS
             : FWD_STEP;
}

template <typename S, typename R>
int run_f32_as(int design, int T, int B, int H, int ndir, const Frames& fr,
               const void* const* xw, const void* const* wh, void* const* ys,
               void* const* cs, float* const* scratch, const int* reverse,
               cudaStream_t s) {
  switch (design) {
    case FWD_GRID:
      return run_grid<S, R>(T, B, H, ndir, fr, xw, wh, ys, cs, scratch,
                            reverse, s);
    case FWD_ROWS:
      return run_rows<S, R>(T, B, H, ndir, fr, xw, wh, ys, cs, scratch,
                            reverse, s);
    default:
      return run_per_frame<S, float, R>(T, B, H, ndir, fr, xw, wh, ys, cs,
                                        scratch, reverse, s);
  }
}

// The f32-weight route of every type code: wh in f32 (for codes 1 and 2
// the bf16 weights widened, which is exact), h rounded to bf16 before the
// product for codes 1 and 2, as the reference rounds it.
int run_f32(int design, int type_code, int T, int B, int H, int ndir,
            const Frames& fr, const void* const* xw, const void* const* wh,
            void* const* ys, void* const* cs, float* const* scratch,
            const int* reverse, cudaStream_t s) {
  switch (type_code) {
    case 0:
      return run_f32_as<float, float>(design, T, B, H, ndir, fr, xw, wh, ys,
                                      cs, scratch, reverse, s);
    case 1:
      return run_f32_as<bf16, bf16>(design, T, B, H, ndir, fr, xw, wh, ys, cs,
                                    scratch, reverse, s);
    case 2:
      return run_f32_as<float, bf16>(design, T, B, H, ndir, fr, xw, wh, ys,
                                     cs, scratch, reverse, s);
    case 3:
      return run_f32_as<bf16, float>(design, T, B, H, ndir, fr, xw, wh, ys, cs,
                                     scratch, reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline bool bf16_weights(int type_code) {
  return type_code == 1 || type_code == 2;
}

// The library's design (chosen on an H100: PERF.md): bf16 weights take
// the persistent kernel up to MAX_H and lstm_fwd_tc above it where it
// fits (tc_fits: H <= 1056 for two directions), at every B; every other
// call the f32-weight route, by shape (f32_design).
inline int fwd_design(int type_code, int B, int H, int ndir) {
  if (bf16_weights(type_code)) {
    if (H <= MAX_H) return FWD_PERSISTENT;
    if (tc_fits(H, ndir)) return FWD_TC;
  }
  return f32_design(B, H, ndir);
}

int fwd(int design, int type_code, int T, int B, int H, int ndir, int pitch,
        const void* mask0, const void* mask1, const void* xw0,
        const void* wh0, void* ys0, void* cs0, void* scratch0, int reverse0,
        const void* xw1, const void* wh1, void* ys1, void* cs1,
        void* scratch1, int reverse1, void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2 || type_code < 0 ||
      type_code > 3 || pitch < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (design == -1) design = fwd_design(type_code, B, H, ndir);
  const void* xw[2] = {xw0, xw1};
  const void* wh[2] = {wh0, wh1};
  void* ys[2] = {ys0, ys1};
  void* cs[2] = {cs0, cs1};
  float* scratch[2] = {static_cast<float*>(scratch0),
                       static_cast<float*>(scratch1)};
  const int reverse[2] = {reverse0, reverse1};
  const Frames m = {{static_cast<const float*>(mask0),
                     static_cast<const float*>(mask1)},
                    pitch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case FWD_PERSISTENT:
      if (!bf16_weights(type_code)) break;
      return type_code == 1 ? run_persistent<bf16>(T, B, H, ndir, m, xw, wh,
                                                   ys, cs, reverse, s)
                            : run_persistent<float>(T, B, H, ndir, m, xw, wh,
                                                    ys, cs, reverse, s);
    case FWD_TC:
      if (!bf16_weights(type_code)) break;
      return type_code == 1 ? run_tc<bf16>(T, B, H, ndir, m, xw, wh, ys, cs,
                                           scratch, reverse, s)
                            : run_tc<float>(T, B, H, ndir, m, xw, wh, ys, cs,
                                            scratch, reverse, s);
    case FWD_GRID:
      if (grid_units(H, ndir, device_sms()) == 0) break;
      return run_f32(design, type_code, T, B, H, ndir, m, xw, wh, ys, cs,
                     scratch, reverse, s);
    case FWD_ROWS:
      if (!rows_fits(H, ndir, device_sms())) break;
      return run_f32(design, type_code, T, B, H, ndir, m, xw, wh, ys, cs,
                     scratch, reverse, s);
    case FWD_STEP:
      return run_f32(design, type_code, T, B, H, ndir, m, xw, wh, ys, cs,
                     scratch, reverse, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One call runs the whole recurrence of one or two directions that share
// T, B, H, the types and the mask (the two directions of a BLSTM layer),
// by the library's design (vo_lstm_fwd_design).
// type_code: 0 = S f32 / W f32, 1 = S bf16 / W bf16, 2 = S f32 / W bf16,
// 3 = S bf16 / W f32. wh{0,1}: [H, 4H] in bf16 for the bf16-weight
// kernels (lstm_fwd_persistent, lstm_fwd_tc), else in f32 (codes 1 and 2
// on the f32-weight route: the bf16 weights widened, h rounded to bf16
// before each product). scratch{0,1}: vo_lstm_fwd_scratch floats each,
// zeroed by the caller (lstm_fwd_persistent ignores it). cs{0,1}: [T, B,
// H] in S for the training form, or null for the inference form. Returns
// the first non-zero CUDA error of a launch, or 0.
extern "C" int vo_lstm_fwd(int type_code, int T, int B, int H, int ndir,
                           const void* mask,
                           const void* xw0, const void* wh0, void* ys0,
                           void* cs0, void* scratch0, int reverse0,
                           const void* xw1, const void* wh1, void* ys1,
                           void* cs1, void* scratch1, int reverse1,
                           void* stream) {
  return fwd(-1, type_code, T, B, H, ndir, B, mask, mask, xw0, wh0, ys0, cs0,
             scratch0, reverse0, xw1, wh1, ys1, cs1, scratch1, reverse1,
             stream);
}

// vo_lstm_fwd with the design named, so that each can be held to the
// plain version and timed at any shape it takes: 0 lstm_step a frame, 1
// lstm_fwd_grid (both any type code at any H, wh in f32), 2 lstm_fwd_tc
// (codes 1 and 2 where tc_fits), 3 lstm_fwd_persistent (codes 1 and 2, H
// <= 512), 4 lstm_fwd_rows (any type code where rows_fits, wh in f32),
// -1 the library's.
extern "C" int vo_lstm_fwd_named(int design, int type_code, int T, int B,
                                 int H, int ndir, const void* mask,
                                 const void* xw0, const void* wh0, void* ys0,
                                 void* cs0, void* scratch0, int reverse0,
                                 const void* xw1, const void* wh1, void* ys1,
                                 void* cs1, void* scratch1, int reverse1,
                                 void* stream) {
  return fwd(design, type_code, T, B, H, ndir, B, mask, mask, xw0, wh0, ys0,
             cs0, scratch0, reverse0, xw1, wh1, ys1, cs1, scratch1, reverse1,
             stream);
}

// vo_lstm_fwd_named on frames `pitch` rows apart (pitch >= B: frame t's
// row b of xw, ys and cs is row t*pitch + b, its mask value mask{0,1}[t *
// pitch + b]), with a mask of each direction's own. The layer calls pitch
// = B and one mask; vo_bi_lstm_fwd (lstm_bi_stacked.cu) calls it on the
// two planes of the direction-stacked layout.
extern "C" int vo_lstm_fwd_frames(int design, int type_code, int T, int B,
                                  int H, int ndir, int pitch,
                                  const void* mask0, const void* mask1,
                                  const void* xw0, const void* wh0, void* ys0,
                                  void* cs0, void* scratch0, int reverse0,
                                  const void* xw1, const void* wh1, void* ys1,
                                  void* cs1, void* scratch1, int reverse1,
                                  void* stream) {
  return fwd(design, type_code, T, B, H, ndir, pitch, mask0, mask1, xw0, wh0,
             ys0, cs0, scratch0, reverse0, xw1, wh1, ys1, cs1, scratch1,
             reverse1, stream);
}

// The design vo_lstm_fwd runs (vo_lstm_fwd_named's codes) for ndir
// directions of type_code at batch size B and hidden size H.
extern "C" int vo_lstm_fwd_design(int type_code, int B, int H, int ndir) {
  return fwd_design(type_code, B, H, ndir);
}

// The f32 scratch of one direction, in floats: lstm_fwd_grid's h(t) by
// step parity [2][B][Hp], c [B][H] and its frame counter; lstm_step's h
// ping, h pong and c [3][B][H]; lstm_fwd_tc's bf16 h(t) exchange by step
// parity, h and c [2][B][H] and its frame counter; or lstm_fwd_rows' h(t)
// by step parity in whole tiles, h and c [2][B][H] and its row groups'
// frame counters: the largest.
extern "C" long long vo_lstm_fwd_scratch(int B, int H) {
  const long long grid =
      2LL * (B + GROWS - 1) / GROWS * GROWS * grid_hp(H) + (long long)B * H + 4;
  const long long step = 3LL * B * H;
  const long long tc = 2 * tc_exchange_bytes(B, H) / 4 + 2LL * B * H + 4;
  const long long rows =
      2 * rows_exchange(B, H) +
      2LL * B * H + 256;
  return std::max({grid, step, tc, rows});
}
