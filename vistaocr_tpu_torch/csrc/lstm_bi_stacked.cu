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
// That is exactly what the layer kernels of lstm_fwd.cu and lstm_bwd.cu
// compute for two directions that share T, B and H, with f32 streams and
// f32 or bf16 weights (their type codes 0 and 2). The stacked layout
// differs from theirs in three ways only: a frame's rows of plane p start
// at row (2t+p)*B, not t*B; each plane has a mask of its own; and plane 1
// walks forward (its flip is the caller's). So both entries run the
// layer's designs on the planes in place, as its two directions (Frames,
// lstm_common.cuh): pointers xw + p*B*4H, ys + p*B*H and so on, a frame
// pitch of 2B rows, mask + p*B with the same pitch, reverse = 0. No plane
// is copied to a dense tensor (the stacked xw alone is 268 MB at B=32,
// T=512, H=512). The designs are the library's for the shape (the forward
// by vo_lstm_fwd_design; the BPTT's gate GEMM, frame loop and dwh by
// vo_lstm_bwd_gates_design, vo_lstm_bwd_loop_design and
// vo_lstm_dwh_design; vo_bi_lstm_design names them), with their numerics:
// f32 carries, h and dgates rounded to W where the products read them,
// dxw and dwh in f32, and their sums in the same order as the layer's, so
// a plane's outputs are bit-equal to the layer's on a dense copy of it.
// What bounds each design on an H100, and its limits, is in the source
// notes of lstm_fwd.cu and lstm_bwd.cu. The frame loops and the forwards
// take the pitch at no measured cost; the two GEMMs over rows (the gate
// recompute and dwh) map each dense row to its frame's row in their
// producer warpgroup, which f32 rows keep busy: they read 7% and 22%
// slower than on dense copies of the planes (PERF.md). TMA tensor maps
// are not used for the planes (f32 streams never took them).
//
// The route's workspace (the forward's zeroed scratch, the BPTT's
// recomputed gates and loop scratch, dwh's split workspace, wh widened to
// f32 where an f32-weight design reads bf16 weights) comes from a
// stream-ordered memory pool of this library's own, which keeps what it
// has taken (release threshold: all): the entries keep their C ABI, and a
// call after the first maps no new device memory.

#include <cstdint>
#include <mutex>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" {
int vo_lstm_fwd_design(int type_code, int B, int H, int ndir);
long long vo_lstm_fwd_scratch(int B, int H);
int vo_lstm_fwd_frames(int design, int type_code, int T, int B, int H,
                       int ndir, int pitch, const void* mask0,
                       const void* mask1, const void* xw0, const void* wh0,
                       void* ys0, void* cs0, void* scratch0, int reverse0,
                       const void* xw1, const void* wh1, void* ys1, void* cs1,
                       void* scratch1, int reverse1, void* stream);
int vo_lstm_bwd_gates_design(int type_code, int H);
int vo_lstm_bwd_loop_design(int type_code, int B, int H, int ndir);
long long vo_lstm_bwd_scratch(int loop, int T, int B, int H);
int vo_lstm_bwd_frames(int gemm, int loop, int type_code, int T, int B, int H,
                       int ndir, int pitch, const void* mask0,
                       const void* mask1, const void* xw0, const void* wh0,
                       const void* whf0, const void* ys0, const void* cs0,
                       const void* dys0, void* dxw0, void* scratch0,
                       int reverse0, const void* xw1, const void* wh1,
                       const void* whf1, const void* ys1, const void* cs1,
                       const void* dys1, void* dxw1, void* scratch1,
                       int reverse1, void* stream);
int vo_lstm_dwh_design(int type_code, int H);
long long vo_lstm_dwh_workspace(int design, int type_code, int T, int B,
                                int H, int ndir);
int vo_lstm_dwh_frames(int design, int type_code, int T, int B, int H,
                       int ndir, int pitch, const void* ys0, const void* dxw0,
                       void* dwh0, int reverse0, const void* ys1,
                       const void* dxw1, void* dwh1, int reverse1,
                       void* workspace, void* stream);
}

namespace {

// the layer's design codes (lstm_fwd.cu's FWD_*, lstm_bwd.cu's GEMM_* and
// LOOP_*) that read wh in bf16; every other design reads it in f32
constexpr int FWD_TC = 2;
constexpr int FWD_PERSISTENT = 3;
constexpr int GEMM_FMA = 0;
constexpr int LOOP_PERSISTENT = 2;
constexpr int LOOP_TC = 3;

// w_type 0 (wh f32) and 1 (wh bf16) as the layer's type codes for f32
// streams: 0 and 2
inline int type_code(int w_type) { return w_type == 0 ? 0 : 2; }

inline long long round_up(long long bytes) { return (bytes + 255) / 256 * 256; }

// `bytes` from the library's pool on the current device, ordered on s
cudaError_t pool_alloc(void** p, long long bytes, cudaStream_t s) {
  static std::mutex mu;
  static cudaMemPool_t pools[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (pools[dev] == nullptr) {
      cudaMemPoolProps props = {};
      props.allocType = cudaMemAllocationTypePinned;
      props.location.type = cudaMemLocationTypeDevice;
      props.location.id = dev;
      err = cudaMemPoolCreate(&pools[dev], &props);
      if (err != cudaSuccess) return err;
      uint64_t keep = UINT64_MAX;
      err = cudaMemPoolSetAttribute(pools[dev],
                                    cudaMemPoolAttrReleaseThreshold, &keep);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaMallocFromPoolAsync(p, static_cast<size_t>(bytes), pools[dev],
                                 s);
}

// dst[i] = f32(src[i]), exact: bf16 weights for an f32-weight design
__global__ void widen_bf16(const __nv_bfloat16* __restrict__ src,
                           float* __restrict__ dst, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = __bfloat162float(src[i]);
  }
}

cudaError_t widen(const void* src, float* dst, long long n, cudaStream_t s) {
  widen_bf16<<<264, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(src), dst,
                                 n);
  return cudaGetLastError();
}

// the first error of a call and of freeing its workspace
int finish(int err, void* work, cudaStream_t s) {
  const cudaError_t freed =
      work == nullptr ? cudaSuccess : cudaFreeAsync(work, s);
  return err != 0 ? err : static_cast<int>(freed);
}

}  // namespace

// The designs vo_bi_lstm_fwd and vo_bi_lstm_bwd run at w_type, B and H:
// out[0] the forward's (vo_lstm_fwd_named's codes), out[1] the gate
// GEMM's and out[2] the frame loop's (vo_lstm_bwd_named's), out[3] dwh's
// (vo_lstm_dwh's; -1: lstm_dwh_fma). Returns 0, or cudaErrorInvalidValue.
extern "C" int vo_bi_lstm_design(int w_type, int B, int H, int* out) {
  if (B < 1 || H < 1 || (w_type != 0 && w_type != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int code = type_code(w_type);
  out[0] = vo_lstm_fwd_design(code, B, H, 2);
  out[1] = vo_lstm_bwd_gates_design(code, H);
  out[2] = vo_lstm_bwd_loop_design(code, B, H, 2);
  out[3] = vo_lstm_dwh_design(code, H);
  return 0;
}

// K6a: the recurrence of both planes, one call of the layer's forward
// (one launch, or T for lstm_step). w_type: 0 = wh float32, 1 = wh bf16
// (the compute type h is rounded to). Writes ys, cs [T,2,B,H] float32.
// Returns the first CUDA error, or 0.
extern "C" int vo_bi_lstm_fwd(int w_type, int T, int B, int H, const void* xw,
                              const void* mask, const void* wh, void* ys,
                              void* cs, void* stream) {
  int design[4];
  if (T < 1 || vo_bi_lstm_design(w_type, B, H, design) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = type_code(w_type);
  const long long G = 4LL * H, HW = H * G;
  const bool bf16_wh = design[0] == FWD_TC || design[0] == FWD_PERSISTENT;
  // each plane's zeroed scratch (lstm_fwd_persistent takes none), then wh
  // widened to f32 for bf16 weights on an f32-weight design
  const long long sc =
      design[0] == FWD_PERSISTENT ? 0 : round_up(vo_lstm_fwd_scratch(B, H) * 4);
  const long long wf = w_type == 1 && !bf16_wh ? 2 * HW * 4 : 0;
  void* work = nullptr;
  if (2 * sc + wf > 0) {
    const cudaError_t err = pool_alloc(&work, 2 * sc + wf, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  char* base = static_cast<char*>(work);
  const long long esz = w_type == 1 ? 2 : 4;
  const char* w0 = static_cast<const char*>(wh);
  const char* w1 = w0 + HW * esz;
  int err = 0;
  if (sc > 0) err = static_cast<int>(cudaMemsetAsync(base, 0, 2 * sc, s));
  if (err == 0 && wf > 0) {
    float* whf = reinterpret_cast<float*>(base + 2 * sc);
    err = static_cast<int>(widen(wh, whf, 2 * HW, s));
    w0 = reinterpret_cast<const char*>(whf);
    w1 = reinterpret_cast<const char*>(whf + HW);
  }
  if (err == 0) {
    const float* m = static_cast<const float*>(mask);
    const float* x = static_cast<const float*>(xw);
    float* y = static_cast<float*>(ys);
    float* c = static_cast<float*>(cs);
    const long long BH = (long long)B * H;
    err = vo_lstm_fwd_frames(design[0], code, T, B, H, 2, 2 * B, m, m + B, x,
                             w0, y, c, sc > 0 ? base : nullptr, 0, x + B * G,
                             w1, y + BH, c + BH,
                             sc > 0 ? base + sc : nullptr, 0, stream);
  }
  return finish(err, work, s);
}

// K6b: the BPTT of both planes from the forward's ys and cs: the layer's
// gate GEMM and frame loop (one call), then its dwh (one call). w_type as
// vo_bi_lstm_fwd. scratch: unused (the workspace is the pool's); callers
// pass null. Writes dxw [T,2,B,4H] and dwh [2,H,4H] float32 (every
// element; dwh is zero when T = 1).
extern "C" int vo_bi_lstm_bwd(int w_type, int T, int B, int H, const void* xw,
                              const void* mask, const void* wh,
                              const void* ys, const void* cs, const void* dys,
                              void* dxw, void* dwh, void* scratch,
                              void* stream) {
  (void)scratch;
  int design[4];
  if (T < 1 || vo_bi_lstm_design(w_type, B, H, design) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = type_code(w_type);
  const int gemm = design[1], loop = design[2];
  const long long G = 4LL * H, HW = H * G, BH = (long long)B * H;
  // each plane's scratch (the recomputed gates, then the loop's own),
  // dwh's workspace, and wh widened to f32 where the FMA gate GEMM or an
  // f32-weight loop reads bf16 weights
  const long long sb = vo_lstm_bwd_scratch(loop, T, B, H);
  if (sb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long sc = round_up(sb);
  const long long dw =
      round_up(vo_lstm_dwh_workspace(-1, code, T, B, H, 2));
  const bool widened = w_type == 1 && (gemm == GEMM_FMA ||
                                       (loop != LOOP_PERSISTENT &&
                                        loop != LOOP_TC));
  const long long wf = widened ? 2 * HW * 4 : 0;
  void* work = nullptr;
  cudaError_t e = pool_alloc(&work, 2 * sc + dw + wf, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  char* base = static_cast<char*>(work);
  const long long esz = w_type == 1 ? 2 : 4;
  const char* w0 = static_cast<const char*>(wh);
  const char* w1 = w0 + HW * esz;
  const char* f0 = w0;  // wh in f32 (f32 weights: wh itself)
  const char* f1 = w1;
  int err = 0;
  if (widened) {
    float* whf = reinterpret_cast<float*>(base + 2 * sc + dw);
    err = static_cast<int>(widen(wh, whf, 2 * HW, s));
    f0 = reinterpret_cast<const char*>(whf);
    f1 = reinterpret_cast<const char*>(whf + HW);
  }
  const float* m = static_cast<const float*>(mask);
  const float* x = static_cast<const float*>(xw);
  const float* y = static_cast<const float*>(ys);
  const float* c = static_cast<const float*>(cs);
  const float* dy = static_cast<const float*>(dys);
  float* dx = static_cast<float*>(dxw);
  float* dw_out = static_cast<float*>(dwh);
  if (err == 0) {
    err = vo_lstm_bwd_frames(gemm, loop, code, T, B, H, 2, 2 * B, m, m + B, x,
                             w0, f0, y, c, dy, dx, base, 0, x + B * G, w1, f1,
                             y + BH, c + BH, dy + BH, dx + B * G, base + sc, 0,
                             stream);
  }
  if (err == 0) {
    err = vo_lstm_dwh_frames(-1, code, T, B, H, 2, 2 * B, y, dx, dw_out, 0,
                             y + BH, dx + B * G, dw_out + HW, 0,
                             dw > 0 ? base + 2 * sc : nullptr, stream);
  }
  return finish(err, work, s);
}
