// NSCC congestion-window kernels for sm_90a: the batched entry point and
// the fabric tick's two per-flow forms.
//
// nscc_update_kernel replaces the reference package's Pallas TPU kernel
//   kernels/nscc_update.py  nscc_update -> _nscc_kernel
// nscc_ack_kernel and nscc_epoch_kernel are its forms on the port's tick:
// the reference's tick runs the same window arithmetic as plain jnp
// (core/cms/nscc.py on_ack_per_flow and quick_adapt, under jax.jit), and
// the port ran it as 19-26 eager operations a hook. Each is one launch.
//
// Per window i (Sec. 3.3.1, the four cases x the coalesced ACK count),
// window_next below, shared by the entry point and the ACK form:
//   high    = rtt > target
//   dec     = -md * clip((rtt - target) / max(rtt, eps), 0, 1)
//   quick   = quick_gain * clip(gap, 0, 1)
//   gentle  = ai / max(cwnd, 1)
//   delta   = ecn ? (high ? dec : 0) : (high ? gentle : quick)
//   out     = clip(count > 0 ? cwnd + delta * f32(count) : cwnd, min, max)
// with gap = (target - rtt) / target at the entry point (an exact division)
// and (target - rtt) * f32(1 / target) on the tick: the reference's jitted
// tick has XLA fold the division by the constant into a multiply by its
// f32 reciprocal, which the host computes once (nscc.py _f32_reciprocal).
// The ACK form is the entry point's body with count = has_ack (0 or 1):
// delta * 1.0f is exact, so the window lane is the plain tick's bit for
// bit; it also returns epoch_acked + has_ack.
// The epoch form is Quick Adapt: where now - epoch_tick >= epoch_len, a
// lossy epoch rescales cwnd to clip(cwnd * acked / max(acked + lost, 1),
// qa_min_frac * max_cwnd, max_cwnd), then every window is floored at
// min_cwnd and a due epoch's counters reset to (0, 0, now).
//
// Bound on this card: memory. The entry point reads cwnd, rtt, count
// (4 B each) and ecn (1 B) and writes out (4 B): 17 B a lane, ~0.085 ms at
// N = 2**24 and 3.35 TB/s. The ACK form reads cwnd, rtt, epoch_acked
// (4 B each), has_ack and ecn (1 B each) and writes cwnd and epoch_acked:
// 22 B a lane, ~0.054 us at the tick's B x F = 4 x 2048 lanes. The epoch
// form reads and writes four 4-byte lanes: 32 B a lane. ~20 f32 operations
// a lane are far below the card's rate. At the tick's shapes a launch is
// bound by launch latency (~1.2-1.8 us): what the tick forms buy is one
// launch where the eager composition took 19-26 device operations.
//
// Design: the TPU kernel padded the pool to [R, 128] lanes and walked
// BLOCK_R-row tiles; here one thread owns one window and neighbouring
// threads read neighbouring words, so every load and store is coalesced
// and the ragged end is one bounds check. The tick forms take the [B, F]
// lanes as one flat [B*F] view and write fresh outputs (the tick's
// previous state is read again after the step). Every result is bitwise
// equal to the plain PyTorch version (kernels/ref.py) on the card:
//   * every product, sum and quotient is an explicitly rounded intrinsic
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot
//     contract `cwnd + delta * count` into one FMA and every division is
//     IEEE whatever the build flags;
//   * the constants (target = base_rtt * target_factor, -md, quick_gain,
//     ai, eps = 1e-6, min and max, qa_min_frac * max_cwnd) arrive as
//     floats rounded once on the host from the Python doubles, as JAX and
//     PyTorch round a Python scalar against an f32 tensor;
//   * max and clip return a NaN operand unchanged, as torch.clamp and
//     jnp.clip do (fmaxf/fminf would drop it);
//   * now - epoch_tick wraps as int32 arithmetic does (computed unsigned).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct WindowConsts {
  float target, inv_target, neg_md, quick_gain, ai, eps, min_cwnd, max_cwnd;
};

// max(x, lo) that keeps a NaN x: torch.clamp(min=)'s own CUDA form
// (a NaN check, then fmaxf), so signed zeros come out as they do there
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x != x) ? x : fmaxf(x, lo);
}

// clip(x, lo, hi) that keeps a NaN x: torch.clamp's CUDA form
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

// the window after `count` coalesced ACKs of one (ecn, rtt) sample
template <bool kFolded>
__device__ __forceinline__ float window_next(float c, float r, bool ecn,
                                             int32_t count,
                                             const WindowConsts& p) {
  const bool high = r > p.target;
  const float overload = clip_nan(
      __fdiv_rn(__fsub_rn(r, p.target), max_nan(r, p.eps)), 0.0f, 1.0f);
  const float dec = __fmul_rn(p.neg_md, overload);
  const float diff = __fsub_rn(p.target, r);
  const float gap = clip_nan(kFolded ? __fmul_rn(diff, p.inv_target)
                                     : __fdiv_rn(diff, p.target),
                             0.0f, 1.0f);
  const float quick = __fmul_rn(p.quick_gain, gap);
  const float gentle = __fdiv_rn(p.ai, max_nan(c, 1.0f));
  const float delta = ecn ? (high ? dec : 0.0f) : (high ? gentle : quick);
  const float step = __fmul_rn(delta, __int2float_rn(count));
  const float next = count > 0 ? __fadd_rn(c, step) : c;
  return clip_nan(next, p.min_cwnd, p.max_cwnd);
}

__global__ void __launch_bounds__(kThreads)
nscc_update_kernel(const float* __restrict__ cwnd,
                   const uint8_t* __restrict__ ecn,
                   const float* __restrict__ rtt,
                   const int32_t* __restrict__ count,
                   float* __restrict__ out, long long n, WindowConsts p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = window_next<false>(cwnd[i], rtt[i], ecn[i] != 0, count[i], p);
}

__global__ void __launch_bounds__(kThreads)
nscc_ack_kernel(const float* __restrict__ cwnd,
                const int32_t* __restrict__ acked,
                const uint8_t* __restrict__ has_ack,
                const uint8_t* __restrict__ ecn,
                const float* __restrict__ rtt, float* __restrict__ cwnd_out,
                int32_t* __restrict__ acked_out, long long n,
                WindowConsts p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t k = has_ack[i] != 0;
  cwnd_out[i] = window_next<true>(cwnd[i], rtt[i], ecn[i] != 0, k, p);
  acked_out[i] = static_cast<int32_t>(static_cast<uint32_t>(acked[i]) +
                                      static_cast<uint32_t>(k));
}

__global__ void __launch_bounds__(kThreads)
nscc_epoch_kernel(const float* __restrict__ cwnd,
                  const int32_t* __restrict__ acked,
                  const int32_t* __restrict__ lost,
                  const int32_t* __restrict__ epoch_tick,
                  float* __restrict__ cwnd_out, int32_t* __restrict__ acked_out,
                  int32_t* __restrict__ lost_out,
                  int32_t* __restrict__ tick_out, long long n, int32_t now,
                  int32_t epoch_len, float qa_floor, float min_cwnd,
                  float max_cwnd) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t a = acked[i], l = lost[i], t = epoch_tick[i];
  const int32_t age = static_cast<int32_t>(static_cast<uint32_t>(now) -
                                           static_cast<uint32_t>(t));
  const bool due = age >= epoch_len;
  const float delivered = __int2float_rn(a);
  const float frac = __fdiv_rn(
      delivered, max_nan(__fadd_rn(delivered, __int2float_rn(l)), 1.0f));
  const float c = cwnd[i];
  const float next = (due && l > 0)
                         ? clip_nan(__fmul_rn(c, frac), qa_floor, max_cwnd)
                         : c;
  cwnd_out[i] = max_nan(next, min_cwnd);
  acked_out[i] = due ? 0 : a;
  lost_out[i] = due ? 0 : l;
  tick_out[i] = due ? now : t;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int nscc_update_launch(const void* cwnd, const void* ecn,
                                  const void* rtt, const void* count, void* out,
                                  long long n, float target, float neg_md,
                                  float quick_gain, float ai, float eps,
                                  float min_cwnd, float max_cwnd,
                                  void* stream) {
  const WindowConsts p{target, 0.0f, neg_md, quick_gain, ai, eps, min_cwnd,
                       max_cwnd};
  nscc_update_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cwnd), static_cast<const uint8_t*>(ecn),
      static_cast<const float*>(rtt), static_cast<const int32_t*>(count),
      static_cast<float*>(out), n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nscc_ack_launch(const void* cwnd, const void* acked,
                               const void* has_ack, const void* ecn,
                               const void* rtt, void* cwnd_out,
                               void* acked_out, long long n, float target,
                               float inv_target, float neg_md,
                               float quick_gain, float ai, float eps,
                               float min_cwnd, float max_cwnd, void* stream) {
  const WindowConsts p{target, inv_target, neg_md, quick_gain, ai, eps,
                       min_cwnd, max_cwnd};
  nscc_ack_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cwnd), static_cast<const int32_t*>(acked),
      static_cast<const uint8_t*>(has_ack), static_cast<const uint8_t*>(ecn),
      static_cast<const float*>(rtt), static_cast<float*>(cwnd_out),
      static_cast<int32_t*>(acked_out), n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nscc_epoch_launch(const void* cwnd, const void* acked,
                                 const void* lost, const void* epoch_tick,
                                 void* cwnd_out, void* acked_out,
                                 void* lost_out, void* tick_out, long long n,
                                 int now, int epoch_len, float qa_floor,
                                 float min_cwnd, float max_cwnd,
                                 void* stream) {
  nscc_epoch_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cwnd), static_cast<const int32_t*>(acked),
      static_cast<const int32_t*>(lost),
      static_cast<const int32_t*>(epoch_tick), static_cast<float*>(cwnd_out),
      static_cast<int32_t*>(acked_out), static_cast<int32_t*>(lost_out),
      static_cast<int32_t*>(tick_out), n, now, epoch_len, qa_floor, min_cwnd,
      max_cwnd);
  return static_cast<int>(cudaGetLastError());
}
