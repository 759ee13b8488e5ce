// Log-space CTC alpha and beta recursions.
//
// Replaces vistaocr_tpu/ops/ctc_pallas.py::_alpha_kernel (ctc_alpha) and
// ::_beta_kernel (ctc_beta). The label gather (lp_ext), the state masks,
// the terminal reduction to log P and the fold of d lp_ext onto classes
// stay torch ops in ops/ctc_cuda.py, as they sit outside the kernels in
// the JAX package.
//
// What they compute, per sample b, over the S = 2L+1 extended-label
// states (NEG = -1e30 stands for -inf everywhere, so no inf - inf arises):
//   alpha_{-1}[s] = 0 if s == 0 else NEG;  for t = 0..T-1:
//     new = lse3(a[s], a[s-1], skip[s] ? a[s-2] : NEG) + lp[t,s]
//     new = svalid[s] ? max(new, NEG) : NEG
//     a[s] = active[t] ? new : a[s];  alphas[t,s] = a[s]
//   beta_T[s] = NEG;  for t = T-1..0:
//     cont = lse3(c[s], c[s+1], skip2[s] ? c[s+2] : NEG)
//     new  = lp[t,s] + (islast[t] ? terminal[s] : cont)
//     new  = svalid[s] ? max(new, NEG) : NEG
//     c[s] = active[t] ? new : c[s]
//     dlp[t,s] = -exp(min(alpha[t,s] + c[s] - lp[t,s] - logP, 0)), zeroed
//                where alpha or c is unreachable (<= NEG/2) or t inactive
// with lse3(a,b,c) = m + log(e^(a-m) + e^(b-m) + e^(c-m)), m = max, and
// NEG when m <= NEG/2; out-of-range neighbours are NEG. lp, alphas, dlp
// are [T,B,S] float32; active, islast [T,B]; skip, skip2, svalid,
// terminal [B,S]; logP [B].
//
// What bounds it on an H100: T strictly sequential frames per sample,
// each a few operations per state. At B=32, T=512, S=513 one recursion
// reads 33 MB (lp, and alphas in the beta) and writes 33 MB, about
// 0.02-0.03 ms of HBM time, so the cost is T dependent steps of latency
// on one SM per sample: a frame's precise lse3 per state (two expf, one
// logf), the neighbour exchange and one block barrier, times T.
//
// What this design does about it: samples are independent, so one block
// per sample runs the whole T loop in ONE launch (the TPU kernel instead
// steps a sequential grid over T with the row in VMEM).
// - Registers and shuffles, not a shared row: thread j owns the R =
//   ceil(S / 1024) consecutive states jR..jR+R-1 (S is not padded) and
//   keeps their values in registers; the two states below (alpha) or
//   above (beta) its range come from the neighbour lane by a shuffle,
//   and across a warp boundary from the neighbour warp's edge pair in
//   shared memory, written before the frame's one barrier
//   (double-buffered by frame parity).
// - Nothing a frame consumes is loaded from global memory in that frame:
//   each thread streams the lp (and, in the beta, alphas) values of its
//   states D frames ahead into a ring of D stages in shared memory by
//   4-byte cp.async (rows of [T,B,S] with S odd are not 16-byte
//   aligned, so neither TMA nor the 16-byte form takes them), one
//   cp.async group per frame; a thread reads only what it copied, so
//   cp.async.wait_group<D-1> alone orders its ring. The frame flags
//   (active, islast) travel in the same groups, copied by lane 0 of each
//   warp into a per-warp ring and broadcast by a shuffle. Per-state
//   constants (skip, svalid, terminal) sit in registers.
// - lse3 skips the exp of the maximum (exactly 1) and sums the other two
//   in the plain version's order, so the kernels round as ops/ctc_cuda.py's
//   plain versions do. expf/logf stay precise: at T=512 a value near 1e3
//   rounded one ulp apart moves d lp by ~1e-4, past its 2e-5 bound, and
//   the approximate forms do move it that far.
// No atomics: two runs are bit-equal. Tried on the card and left out,
// each slower than every thread streaming its own states (PERF.md, CTC
// findings): one copy warp feeding the ring (4-byte or 16-byte copies,
// a frame barrier or mbarriers), loads into a register ring, copy groups
// of several frames, and more states a thread for fewer warps.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using vo_sm90::cp_async4_zfill;
using vo_sm90::cp_async_commit;
using vo_sm90::cp_async_wait_group;

constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_R = 4;  // states a thread: ceil(S / 1024)
constexpr int MAX_S = MAX_THREADS * MAX_R;
constexpr unsigned FULL_MASK = 0xffffffffu;
// ring depth, in frames streamed ahead: 16 where a thread owns one state
// (S <= 1024); 4 above, where a frame takes longer and 16 stages of the
// beta's two rows would not fit in shared memory
constexpr int DEEP = 16;
constexpr int SHALLOW = 4;
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // a launch's limit without opt-in

// lse3 without branches: the exp of the maximum is 1, the other two are
// summed as the plain version sums (e^a + e^b) + e^c; NEG where every
// input is unreachable (then m - m = 0 keeps the discarded value finite)
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool am = a == m;
  const bool bm = !am && b == m;
  const float ex = expf((am ? b : a) - m);
  const float ey = expf((am || bm ? c : b) - m);
  const float sum = am ? (1.0f + ex) + ey : bm ? (ex + 1.0f) + ey
                                               : (ex + ey) + 1.0f;
  const float v = m + logf(sum);
  return m > NEG_INF / 2 ? v : NEG_INF;
}

// the flag lane 0 of this warp copied into its ring slot, to every lane
__device__ __forceinline__ bool warp_flag(const float* slot, int lane) {
  const float v = lane == 0 ? *slot : 0.0f;
  return __shfl_sync(FULL_MASK, v, 0) > 0.0f;
}

// Thread j owns the R consecutive states jR..jR+R-1 and keeps their
// values in registers; the ring holds stage k's input of state jR+r at
// [k][r][j] (conflict-free, and each thread reads only what it copied).
// The two states beyond a thread's range come from its neighbour thread
// by a shuffle, and across a warp boundary from the neighbour warp's
// edge pair, published in shared memory before the frame's barrier
// (double-buffered by frame parity).
template <int D, int R>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_alpha_kernel(const float* __restrict__ lp,
                     const float* __restrict__ active,
                     const float* __restrict__ skip,
                     const float* __restrict__ svalid,
                     float* __restrict__ alphas, int T, int B, int S) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  float* ring = smem;                          // [D][R][nt]: lp
  float* edge = ring + D * R * nt;             // [2][nw][2]: last two states
  float* flags = edge + 4 * nw + warp * D;     // this warp's [D] active
  const int b = blockIdx.x;
  const int s0 = tid * R;
  const long long frame = (long long)B * S;
  const float* lpb = lp + (long long)b * S + s0;
  float* outb = alphas + (long long)b * S + s0;

  // frame f's inputs into stage f % D; one group per frame, empty past T
  auto stream = [&](int f) {
    if (f < T) {
      float* stage = ring + (f % D) * R * nt + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s0 + r < S) cp_async4_zfill(stage + r * nt, lpb + f * frame + r,
                                        true);
      }
      if (lane == 0) {
        cp_async4_zfill(flags + f % D, active + (long long)f * B + b, true);
      }
    }
    cp_async_commit();
  };
  for (int f = 0; f < D - 1; ++f) stream(f);

  bool sk[R], sv[R];
  float a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = s0 + r;
    sk[r] = s < S && s >= 2 && skip[(long long)b * S + s] > 0.0f;
    sv[r] = s < S && svalid[(long long)b * S + s] > 0.0f;
    a[r] = s == 0 ? 0.0f : NEG_INF;
  }
  // the two states below this thread's range (h1 = jR-1, h2 = jR-2) from
  // the lower lanes; returns the thread's second-to-last state, so that
  // lane 31 holds the warp's edge pair
  float h1, h2;
  auto shift_in = [&]() {
    const float second = R >= 2 ? a[R >= 2 ? R - 2 : 0]
                                : __shfl_up_sync(FULL_MASK, a[0], 1);
    h1 = __shfl_up_sync(FULL_MASK, a[R - 1], 1);
    h2 = R >= 2 ? __shfl_up_sync(FULL_MASK, second, 1)
                : __shfl_up_sync(FULL_MASK, a[0], 2);
    return second;
  };
  shift_in();  // frame -1; across warps its edge states are all NEG
  if (tid < 2 * nw) edge[2 * nw + tid] = NEG_INF;  // parity 1: frame -1
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    stream(t + D - 1);
    cp_async_wait_group<D - 1>();  // frame t's group has landed
    const float* lpt = ring + (t % D) * R * nt + tid;
    const float* prev = edge + ((t + 1) & 1) * 2 * nw + 2 * (warp - 1);
    if (lane == 0) {
      h1 = warp > 0 ? prev[0] : NEG_INF;
      h2 = warp > 0 ? prev[1] : NEG_INF;
    }
    if (R == 1 && lane == 1) h2 = warp > 0 ? prev[0] : NEG_INF;
    const bool act = warp_flag(flags + t % D, lane);
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float adv = r >= 1 ? a[r - 1] : h1;
      const float two = r >= 2 ? a[r - 2] : r == 1 ? h1 : h2;
      const float skp = sk[r] ? two : NEG_INF;
      float x = lse3(a[r], adv, skp) + lpt[r * nt];
      x = sv[r] ? fmaxf(x, NEG_INF) : NEG_INF;
      v[r] = act ? x : a[r];
    }
    float* out = outb + t * frame;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s0 + r < S) out[r] = v[r];
      a[r] = v[r];
    }
    // next frame's neighbours within the warp, and this warp's edge pair
    const float second = shift_in();
    if (lane == 31) {
      float* mine = edge + (t & 1) * 2 * nw + 2 * warp;
      mine[0] = a[R - 1];
      mine[1] = second;
    }
    __syncthreads();
  }
}

template <int D, int R>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_beta_kernel(const float* __restrict__ lp,
                    const float* __restrict__ active,
                    const float* __restrict__ islast,
                    const float* __restrict__ skip2,
                    const float* __restrict__ svalid,
                    const float* __restrict__ terminal,
                    const float* __restrict__ alphas,
                    const float* __restrict__ logp,
                    float* __restrict__ dlp, int T, int B, int S) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  float* ring_lp = smem;                       // [D][R][nt], step k = T-1-t
  float* ring_al = ring_lp + D * R * nt;       // [D][R][nt]: alphas
  float* edge = ring_al + D * R * nt;          // [2][nw][2]: first two states
  float* flags = edge + 4 * nw + warp * 2 * D;  // [D][active, islast]
  const int b = blockIdx.x;
  const int s0 = tid * R;
  const long long frame = (long long)B * S;
  const long long off = (long long)b * S + s0;

  // step k (frame T-1-k) into stage k % D; one group per step, empty past 0
  auto stream = [&](int k) {
    const int f = T - 1 - k;
    if (f >= 0) {
      const int st = (k % D) * R * nt + tid;
      const long long base = f * frame + off;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s0 + r < S) {
          cp_async4_zfill(ring_lp + st + r * nt, lp + base + r, true);
          cp_async4_zfill(ring_al + st + r * nt, alphas + base + r, true);
        }
      }
      if (lane == 0) {
        const long long i = (long long)f * B + b;
        cp_async4_zfill(flags + 2 * (k % D), active + i, true);
        cp_async4_zfill(flags + 2 * (k % D) + 1, islast + i, true);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < D - 1; ++k) stream(k);

  bool sk[R], sv[R];
  float term[R], c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = s0 + r;
    sk[r] = s + 2 < S && skip2[(long long)b * S + s] > 0.0f;
    sv[r] = s < S && svalid[(long long)b * S + s] > 0.0f;
    term[r] = s < S ? terminal[(long long)b * S + s] : NEG_INF;
    c[r] = NEG_INF;
  }
  const float lg = logp[b];
  if (tid < 2 * nw) edge[2 * nw + tid] = NEG_INF;  // parity 1: frame T
  // the two states above this thread's range, in frame t+1
  float g1 = NEG_INF, g2 = NEG_INF;
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    stream(k + D - 1);
    cp_async_wait_group<D - 1>();
    const int st = (k % D) * R * nt + tid;
    const float* next = edge + ((k + 1) & 1) * 2 * nw + 2 * (warp + 1);
    if (lane == 31) {
      g1 = warp + 1 < nw ? next[0] : NEG_INF;
      g2 = warp + 1 < nw ? next[1] : NEG_INF;
    }
    if (R == 1 && lane == 30) g2 = warp + 1 < nw ? next[0] : NEG_INF;
    const bool act = warp_flag(flags + 2 * (k % D), lane);
    const bool last = warp_flag(flags + 2 * (k % D) + 1, lane);
    float* out = dlp + t * frame + off;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float n1 = r + 1 < R ? c[r + 1 < R ? r + 1 : 0] : g1;
      const float two = r + 2 < R ? c[r + 2 < R ? r + 2 : 0]
                                  : r + 1 < R ? g1 : g2;
      const float n2 = sk[r] ? two : NEG_INF;
      const float l = ring_lp[st + r * nt];
      const float tail = last ? term[r] : lse3(c[r], n1, n2);
      float x = l + tail;
      x = sv[r] ? fmaxf(x, NEG_INF) : NEG_INF;
      const float bt = act ? x : c[r];
      // d lp, off the recursion's chain: nothing below waits on it
      const float al = ring_al[st + r * nt];
      const float expo = al + bt - l - lg;
      const bool reach = al > NEG_INF / 2 && bt > NEG_INF / 2 && act;
      if (s0 + r < S) out[r] = reach ? -expf(fminf(expo, 0.0f)) : 0.0f;
      c[r] = bt;
    }
    // next step's neighbours within the warp, and this warp's edge pair
    const float second = R >= 2 ? c[R >= 2 ? 1 : 0]
                                : __shfl_down_sync(FULL_MASK, c[0], 1);
    g1 = __shfl_down_sync(FULL_MASK, c[0], 1);
    g2 = R >= 2 ? __shfl_down_sync(FULL_MASK, second, 1)
                : __shfl_down_sync(FULL_MASK, c[0], 2);
    if (lane == 0) {
      float* mine = edge + (k & 1) * 2 * nw + 2 * warp;
      mine[0] = c[0];
      mine[1] = second;
    }
    __syncthreads();
  }
}

int states_per_thread(int S) { return (S + MAX_THREADS - 1) / MAX_THREADS; }

int threads_for(int S) {
  const int R = states_per_thread(S);
  const int n = (S + R - 1) / R;
  return ((n + 31) / 32) * 32;
}

// dynamic shared memory: `rows` rings of D stages of R x threads values,
// the edge pairs, and `nflags` flags of D stages per warp
size_t smem_bytes(int S, int D, int rows, int nflags) {
  const int nt = threads_for(S);
  const int warps = nt / 32;
  return sizeof(float) *
         ((size_t)rows * D * states_per_thread(S) * nt + 4 * warps +
          (size_t)warps * nflags * D);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int S, size_t smem, void* stream,
           Args... args) {
  if (smem > DEFAULT_SMEM) {  // the opt-in costs a host call: only if needed
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for S: ring depth D and states a thread R
template <template <int, int> class Pick, typename... Args>
int dispatch(int S, Args... args) {
  switch (states_per_thread(S)) {
    case 1: return Pick<DEEP, 1>::run(args...);
    case 2: return Pick<SHALLOW, 2>::run(args...);
    case 3: return Pick<SHALLOW, 3>::run(args...);
    default: return Pick<SHALLOW, MAX_R>::run(args...);
  }
}

template <int D, int R>
struct Alpha {
  static int run(int T, int B, int S, const float* lp, const float* active,
                 const float* skip, const float* svalid, float* alphas,
                 void* stream) {
    return launch(ctc_alpha_kernel<D, R>, B, S, smem_bytes(S, D, 1, 1),
                  stream, lp, active, skip, svalid, alphas, T, B, S);
  }
};

template <int D, int R>
struct Beta {
  static int run(int T, int B, int S, const float* lp, const float* active,
                 const float* islast, const float* skip2,
                 const float* svalid, const float* terminal,
                 const float* alphas, const float* logp, float* dlp,
                 void* stream) {
    return launch(ctc_beta_kernel<D, R>, B, S, smem_bytes(S, D, 2, 2),
                  stream, lp, active, islast, skip2, svalid, terminal,
                  alphas, logp, dlp, T, B, S);
  }
};

}  // namespace

// alphas [T,B,S] from lp [T,B,S], active [T,B], skip/svalid [B,S]; one
// block per sample. Returns the first CUDA error of the launch, or 0.
extern "C" int vo_ctc_alpha(int T, int B, int S, const void* lp,
                            const void* active, const void* skip,
                            const void* svalid, void* alphas, void* stream) {
  if (T < 1 || B < 1 || S < 1 || S > MAX_S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<Alpha>(S, T, B, S, static_cast<const float*>(lp),
                         static_cast<const float*>(active),
                         static_cast<const float*>(skip),
                         static_cast<const float*>(svalid),
                         static_cast<float*>(alphas), stream);
}

// dlp [T,B,S] (d(-log P)/d lp) from the beta recursion; inputs as the JAX
// _beta_kernel takes them. Returns the first CUDA error of the launch, or 0.
extern "C" int vo_ctc_beta(int T, int B, int S, const void* lp,
                           const void* active, const void* islast,
                           const void* skip2, const void* svalid,
                           const void* terminal, const void* alphas,
                           const void* logp, void* dlp, void* stream) {
  if (T < 1 || B < 1 || S < 1 || S > MAX_S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<Beta>(S, T, B, S, static_cast<const float*>(lp),
                        static_cast<const float*>(active),
                        static_cast<const float*>(islast),
                        static_cast<const float*>(skip2),
                        static_cast<const float*>(svalid),
                        static_cast<const float*>(terminal),
                        static_cast<const float*>(alphas),
                        static_cast<const float*>(logp),
                        static_cast<float*>(dlp), stream);
}
