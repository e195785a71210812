// Batched NSCC congestion-window update for sm_90a.
//
// Replaces the reference package's Pallas TPU kernel
//   kernels/nscc_update.py  nscc_update -> _nscc_kernel
//
// Per window i (Sec. 3.3.1, the four cases x the coalesced ACK count):
//   high    = rtt > target
//   dec     = -md * clip((rtt - target) / max(rtt, eps), 0, 1)
//   quick   = quick_gain * clip((target - rtt) / target, 0, 1)
//   gentle  = ai / max(cwnd, 1)
//   delta   = ecn ? (high ? dec : 0) : (high ? gentle : quick)
//   out     = clip(count > 0 ? cwnd + delta * f32(count) : cwnd, min, max)
//
// Bound on this card: memory. Each lane reads cwnd, rtt, count (4 B each)
// and ecn (1 B) and writes out (4 B): 17 B a lane, about 0.085 ms at
// N = 2**24 and 3.35 TB/s; ~20 f32 operations a lane are far below the
// card's rate. At the main path's N = 2048 a launch is bound by launch
// latency.
//
// Design: the TPU kernel padded the pool to [R, 128] lanes and walked
// BLOCK_R-row tiles; here one thread owns one window and neighbouring
// threads read neighbouring words, so every load and store is coalesced
// and the ragged end is one bounds check. The result is bitwise equal to
// the plain PyTorch version (kernels/ref.py), which is bitwise equal to
// the reference's jnp oracle:
//   * every product, sum and quotient is an explicitly rounded intrinsic
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot
//     contract `cwnd + delta * count` into one FMA and every division is
//     IEEE whatever the build flags;
//   * the constants (target = base_rtt * target_factor, -md, quick_gain,
//     ai, eps = 1e-6, min and max) arrive as floats rounded once on the
//     host from the Python doubles, as JAX and PyTorch round a Python
//     scalar against an f32 tensor;
//   * max and clip return a NaN operand unchanged, as torch.clamp and
//     jnp.clip do (fmaxf/fminf would drop it).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// max(x, lo) that keeps a NaN x: torch.clamp(min=)'s own CUDA form
// (a NaN check, then fmaxf), so signed zeros come out as they do there
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x != x) ? x : fmaxf(x, lo);
}

// clip(x, lo, hi) that keeps a NaN x: torch.clamp's CUDA form
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
nscc_update_kernel(const float* __restrict__ cwnd,
                   const uint8_t* __restrict__ ecn,
                   const float* __restrict__ rtt,
                   const int32_t* __restrict__ count,
                   float* __restrict__ out, long long n, float target,
                   float neg_md, float quick_gain, float ai, float eps,
                   float min_cwnd, float max_cwnd) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float c = cwnd[i];
  const float r = rtt[i];
  const int32_t k = count[i];
  const bool high = r > target;
  const float overload =
      clip_nan(__fdiv_rn(__fsub_rn(r, target), max_nan(r, eps)), 0.0f, 1.0f);
  const float dec = __fmul_rn(neg_md, overload);
  const float gap = clip_nan(__fdiv_rn(__fsub_rn(target, r), target), 0.0f, 1.0f);
  const float quick = __fmul_rn(quick_gain, gap);
  const float gentle = __fdiv_rn(ai, max_nan(c, 1.0f));
  const float delta = ecn[i] ? (high ? dec : 0.0f) : (high ? gentle : quick);
  const float step = __fmul_rn(delta, __int2float_rn(k));
  const float next = k > 0 ? __fadd_rn(c, step) : c;
  out[i] = clip_nan(next, min_cwnd, max_cwnd);
}

}  // namespace

extern "C" int nscc_update_launch(const void* cwnd, const void* ecn,
                                  const void* rtt, const void* count, void* out,
                                  long long n, float target, float neg_md,
                                  float quick_gain, float ai, float eps,
                                  float min_cwnd, float max_cwnd,
                                  void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  nscc_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cwnd), static_cast<const uint8_t*>(ecn),
      static_cast<const float*>(rtt), static_cast<const int32_t*>(count),
      static_cast<float*>(out), n, target, neg_md, quick_gain, ai, eps,
      min_cwnd, max_cwnd);
  return static_cast<int>(cudaGetLastError());
}
