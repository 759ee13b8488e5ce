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
// carry (h, c) and all gate math stay float32.
//
// What bounds it on an H100: T strictly sequential frames, each one
// [B,H] x [H,4H] product (B=32, H=512: 67 MFLOP for both directions, 0.07
// us of the tensor cores) plus [B,4H] of xw read and [B,H] of ys (and cs)
// written. No frame has enough work to fill the card, so a frame costs
// its dependency chain: getting h of the previous frame to every block
// that needs it, one K=H product, the gate math. A kernel launched per
// frame (below, kept for f32 weights) also pays a launch and a pass over
// all of wh from L2 (2 MiB per direction in bf16) every frame: 33 us a
// frame.
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
// - Limits: H <= 512 (16 CTAs x 32 units; larger H is refused: a cluster
//   cannot hold more of wh), any B (ceil(B/32) clusters per direction;
//   those beyond what the card holds at once run in later waves), any T.
//   Its times on an H100 are in PERF.md.
//
// f32 weights (type codes 0 and 3, the parity path): wgmma has no exact
// f32 x f32 product and TF32 would change the numbers, so these stay on
// the per-frame kernel lstm_step, one launch per frame:
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
// Ragged B and H edges are masked in both kernels.

#include <cooperative_groups.h>

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
  int t;              // frame index this step processes
};

template <typename S, typename W>
__global__ void __launch_bounds__(THREADS)
lstm_step(Dir<S, W> d0, Dir<S, W> d1, const float* __restrict__ mask,
          int B, int H) {
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
  gate_product<float, W>(acc, d.h_in, d.wh, B, H, b0, j0, sm);

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
      const long long out = ((long long)d.t * B + b) * H + j;
      d.ys[out] = from_f32<S>(h);
      if (d.cs != nullptr) d.cs[out] = from_f32<S>(c);
    }
  }
}

template <typename S, typename W>
int run_per_frame(int T, int B, int H, int ndir, const float* mask,
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
  int reverse;
};

// Grid (cluster size C = ceil(H/32), ceil(B/32), ndir), cluster (C, 1, 1).
// Warpgroup v (warps 4v..4v+3) multiplies tile v of A (gates 2v, 2v+1);
// its thread (warp w, lane l) owns unit 32*rank + 8w + l/4 and batch rows
// 32*blockIdx.y + 8n + 2(l%4) + v (n < 4) for all T frames. `vec`: rows of
// wh, xw, ys and cs are whole, aligned 16-byte chunks (H % 8 == 0).
template <typename S, int KB>
__global__ void __launch_bounds__(PTHREADS, 1)
lstm_fwd_persistent(SeqDir<S> d0, SeqDir<S> d1, const float* __restrict__ mask,
                    int T, int B, int H, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  const SeqDir<S> d = blockIdx.z == 0 ? d0 : d1;
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
        const S* src = d.xw + (ok ? ((long long)t * B + b0 + r) * G +
                                        (long long)g * H + j0 + c * CH
                                  : 0);
        cp_async16_zfill(x_s + (g * PN + r) * SROW + c * 16, src, ok);
      }
    } else {  // synchronous: shapes outside the main path
      for (int q = tid; q < 4 * PN * PU; q += PTHREADS) {
        const int g = q / (PN * PU), r = (q / PU) % PN, uu = q % PU;
        const bool ok = b0 + r < B && j0 + uu < H;
        *reinterpret_cast<S*>(x_s + (g * PN + r) * SROW + uu * ES) =
            ok ? d.xw[((long long)t * B + b0 + r) * G + (long long)g * H +
                      j0 + uu]
               : from_f32<S>(0.0f);
      }
    }
    if (tid < PN) {
      const bool ok = b0 + tid < B;
      cp_async4_zfill(m_s + tid, mask + (ok ? (long long)t * B + b0 + tid : 0),
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
                 ((long long)t * B + b0 + r) * H + j0 + c * CH;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(o_at(which, r, c * CH));
      }
    } else {
      for (int q = tid; q < nout * PN * PU; q += PTHREADS) {
        const int which = q / (PN * PU), r = (q / PU) % PN, uu = q % PU;
        if (b0 + r >= B || j0 + uu >= H) continue;
        (which == 0 ? d.ys : d.cs)[((long long)t * B + b0 + r) * H + j0 + uu] =
            *o_at(which, r, uu);
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

template <typename S, int KB>
cudaError_t launch_persistent(const SeqDir<S>* d, const float* mask, int T,
                              int B, int H, int ndir, int vec,
                              cudaStream_t stream) {
  constexpr int smem = persistent_smem<S, KB>();
  auto kernel = lstm_fwd_persistent<S, KB>;
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
int run_persistent(int T, int B, int H, int ndir, const float* mask,
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
    d[i].reverse = reverse[i];
  }
  if (ndir == 1) d[1] = d[0];
  // rows of wh, xw, ys and cs in whole, aligned 16-byte chunks
  int vec = H % 8 == 0;
  for (int i = 0; i < ndir; ++i) {
    vec = vec && aligned16(d[i].wh) && aligned16(d[i].xw) &&
          aligned16(d[i].ys) && aligned16(d[i].cs);
  }
  // K padded to 64, 128, 256 or 512 columns
  const int kb = (H + 63) / 64;
  cudaError_t err;
  if (kb <= 1) {
    err = launch_persistent<S, 1>(d, mask, T, B, H, ndir, vec, stream);
  } else if (kb <= 2) {
    err = launch_persistent<S, 2>(d, mask, T, B, H, ndir, vec, stream);
  } else if (kb <= 4) {
    err = launch_persistent<S, 4>(d, mask, T, B, H, ndir, vec, stream);
  } else {
    err = launch_persistent<S, 8>(d, mask, T, B, H, ndir, vec, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// One call runs the whole recurrence of one or two directions that share
// T, B, H, the types and the mask (the two directions of a BLSTM layer).
// type_code: 0 = S f32 / W f32, 1 = S bf16 / W bf16, 2 = S f32 / W bf16,
// 3 = S bf16 / W f32. Codes 1 and 2 make one persistent launch (H <= 512);
// codes 0 and 3 one launch per frame and need scratch{0,1}: [3, B, H] f32,
// zeroed by the caller (h ping, h pong, c); codes 1 and 2 ignore scratch.
// cs{0,1}: [T, B, H] in S for the training form, or null for the inference
// form. Returns the first non-zero CUDA error of a launch, or 0.
extern "C" int vo_lstm_fwd(int type_code, int T, int B, int H, int ndir,
                           const void* mask,
                           const void* xw0, const void* wh0, void* ys0,
                           void* cs0, void* scratch0, int reverse0,
                           const void* xw1, const void* wh1, void* ys1,
                           void* cs1, void* scratch1, int reverse1,
                           void* stream) {
  if (T < 1 || B < 1 || H < 1 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* xw[2] = {xw0, xw1};
  const void* wh[2] = {wh0, wh1};
  void* ys[2] = {ys0, ys1};
  void* cs[2] = {cs0, cs1};
  float* scratch[2] = {static_cast<float*>(scratch0),
                       static_cast<float*>(scratch1)};
  const int reverse[2] = {reverse0, reverse1};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return run_per_frame<float, float>(T, B, H, ndir, m, xw, wh, ys, cs,
                                         scratch, reverse, s);
    case 1:
      return run_persistent<bf16>(T, B, H, ndir, m, xw, wh, ys, cs, reverse,
                                  s);
    case 2:
      return run_persistent<float>(T, B, H, ndir, m, xw, wh, ys, cs, reverse,
                                   s);
    case 3:
      return run_per_frame<bf16, float>(T, B, H, ndir, m, xw, wh, ys, cs,
                                        scratch, reverse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
