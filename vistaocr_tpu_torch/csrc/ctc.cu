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
// each a few flops per state: at B=32, T=512, S=511 one recursion reads
// 33 MB (lp, and alphas in the beta) and writes 33 MB, far below a
// millisecond of HBM time, so the cost is T dependent steps of latency
// (a shared-memory round and a barrier each).
//
// What this design does about it: samples are independent, so one block
// per sample runs the whole T loop in ONE launch (the TPU kernel instead
// steps a sequential grid over T with the row in VMEM). The row lives in
// shared memory, double-buffered, so one barrier per frame separates the
// reads of row t-1 from the writes of row t; threads run across s, and S
// is padded to nothing (each thread takes states s = tid, tid + blockDim,
// ...). The per-state constants (skip, svalid, terminal) are loaded once
// into registers when a thread owns at most MAX_PER_THREAD states.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_PER_THREAD = 4;  // S <= 4096

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (!(m > NEG_INF / 2)) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const float* __restrict__ active,
                                 const float* __restrict__ skip,
                                 const float* __restrict__ svalid,
                                 float* __restrict__ alphas,
                                 int T, int B, int S) {
  extern __shared__ float row[];  // [2, S]
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  float* cur = row;
  float* nxt = row + S;
  bool sk[MAX_PER_THREAD], sv[MAX_PER_THREAD];
#pragma unroll
  for (int q = 0; q < MAX_PER_THREAD; ++q) {
    const int s = threadIdx.x + q * nt;
    sk[q] = s < S && s >= 2 && skip[(long long)b * S + s] > 0.0f;
    sv[q] = s < S && svalid[(long long)b * S + s] > 0.0f;
    if (s < S) cur[s] = s == 0 ? 0.0f : NEG_INF;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const bool act = active[(long long)t * B + b] > 0.0f;
    const float* lpt = lp + ((long long)t * B + b) * S;
    float* out = alphas + ((long long)t * B + b) * S;
#pragma unroll
    for (int q = 0; q < MAX_PER_THREAD; ++q) {
      const int s = threadIdx.x + q * nt;
      if (s >= S) break;
      const float stay = cur[s];
      const float adv = s >= 1 ? cur[s - 1] : NEG_INF;
      const float skp = sk[q] ? cur[s - 2] : NEG_INF;
      float v = lse3(stay, adv, skp) + lpt[s];
      v = sv[q] ? fmaxf(v, NEG_INF) : NEG_INF;
      v = act ? v : stay;
      nxt[s] = v;
      out[s] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp,
                                const float* __restrict__ active,
                                const float* __restrict__ islast,
                                const float* __restrict__ skip2,
                                const float* __restrict__ svalid,
                                const float* __restrict__ terminal,
                                const float* __restrict__ alphas,
                                const float* __restrict__ logp,
                                float* __restrict__ dlp,
                                int T, int B, int S) {
  extern __shared__ float row[];  // [2, S]
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  float* cur = row;
  float* nxt = row + S;
  bool sk[MAX_PER_THREAD], sv[MAX_PER_THREAD];
  float term[MAX_PER_THREAD];
#pragma unroll
  for (int q = 0; q < MAX_PER_THREAD; ++q) {
    const int s = threadIdx.x + q * nt;
    const long long i = (long long)b * S + s;
    sk[q] = s + 2 < S && skip2[i] > 0.0f;
    sv[q] = s < S && svalid[i] > 0.0f;
    term[q] = s < S ? terminal[i] : NEG_INF;
    if (s < S) cur[s] = NEG_INF;
  }
  const float lg = logp[b];
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const bool act = active[(long long)t * B + b] > 0.0f;
    const bool last = islast[(long long)t * B + b] > 0.0f;
    const long long base = ((long long)t * B + b) * S;
#pragma unroll
    for (int q = 0; q < MAX_PER_THREAD; ++q) {
      const int s = threadIdx.x + q * nt;
      if (s >= S) break;
      const float carry = cur[s];
      const float n1 = s + 1 < S ? cur[s + 1] : NEG_INF;
      const float n2 = sk[q] ? cur[s + 2] : NEG_INF;
      const float tail = last ? term[q] : lse3(carry, n1, n2);
      const float l = lp[base + s];
      float v = l + tail;
      v = sv[q] ? fmaxf(v, NEG_INF) : NEG_INF;
      const float bt = act ? v : carry;
      nxt[s] = bt;
      const float al = alphas[base + s];
      const float expo = al + bt - l - lg;
      const bool reach = al > NEG_INF / 2 && bt > NEG_INF / 2 && act;
      dlp[base + s] = reach ? -expf(fminf(expo, 0.0f)) : 0.0f;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

int threads_for(int S) {
  const int per = (S + MAX_THREADS - 1) / MAX_THREADS;
  const int n = (S + per - 1) / per;
  return ((n + 31) / 32) * 32;
}

}  // namespace

// alphas [T,B,S] from lp [T,B,S], active [T,B], skip/svalid [B,S]; one
// block per sample. Returns cudaGetLastError() after the launch.
extern "C" int vo_ctc_alpha(int T, int B, int S, const void* lp,
                            const void* active, const void* skip,
                            const void* svalid, void* alphas, void* stream) {
  if (T < 1 || B < 1 || S < 1 || S > MAX_THREADS * MAX_PER_THREAD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * (size_t)S * sizeof(float);
  ctc_alpha_kernel<<<B, threads_for(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(active),
      static_cast<const float*>(skip), static_cast<const float*>(svalid),
      static_cast<float*>(alphas), T, B, S);
  return static_cast<int>(cudaGetLastError());
}

// dlp [T,B,S] (d(-log P)/d lp) from the beta recursion; inputs as the JAX
// _beta_kernel takes them. Returns cudaGetLastError() after the launch.
extern "C" int vo_ctc_beta(int T, int B, int S, const void* lp,
                           const void* active, const void* islast,
                           const void* skip2, const void* svalid,
                           const void* terminal, const void* alphas,
                           const void* logp, void* dlp, void* stream) {
  if (T < 1 || B < 1 || S < 1 || S > MAX_THREADS * MAX_PER_THREAD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * (size_t)S * sizeof(float);
  ctc_beta_kernel<<<B, threads_for(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(active),
      static_cast<const float*>(islast), static_cast<const float*>(skip2),
      static_cast<const float*>(svalid), static_cast<const float*>(terminal),
      static_cast<const float*>(alphas), static_cast<const float*>(logp),
      static_cast<float*>(dlp), T, B, S);
  return static_cast<int>(cudaGetLastError());
}
