// Duplicate-safe NACK retransmit-bit marking for sm_90a.
//
// Replaces the reference package's Pallas TPU kernel
//   kernels/nack_mark.py  nack_mark -> _nack_kernel
//
// For every lane l with valid[l] and 0 <= flow[l] < F, set bit off[l]
// (clipped to [0, W*32)) of row flow[l] of the [F, W] uint32 ring `out`,
// which the wrapper has already filled with a copy of rtx. Lanes hitting
// the same bit combine as OR; a lane with an out-of-range row marks
// nothing (the TPU kernel's contract).
//
// Bound on this card: memory. The function reads rtx and the L lanes once
// and writes the ring once — at the main path's F = 2048, W = 16,
// L = Q + 2F = 9216 about 0.35 MB, 0.1 us at 3.35 TB/s, so a launch is
// bound by launch latency.
//
// Design: the TPU kernel could not scatter across lanes, so it built an
// [F, L] x [L, W*32] f32 matmul of one-hots and packed the product back
// into words. Here the scatter is what it is: one thread per lane and one
// atomicOr into the target word. OR is commutative and idempotent, so the
// result does not depend on the order the atomics land in — it is
// deterministic and bitwise equal to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nack_mark_kernel(uint32_t* __restrict__ out, const int32_t* __restrict__ flow,
                 const int32_t* __restrict__ off,
                 const uint8_t* __restrict__ valid, int lanes, int f, int w) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const int row = flow[l];
  if (!valid[l] || row < 0 || row >= f) return;
  const int o = min(max(off[l], 0), w * 32 - 1);
  atomicOr(out + static_cast<size_t>(row) * w + (o >> 5), 1u << (o & 31));
}

}  // namespace

extern "C" int nack_mark_launch(void* out, const void* flow, const void* off,
                                const void* valid, int lanes, int f, int w,
                                void* stream) {
  nack_mark_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int32_t*>(flow),
      static_cast<const int32_t*>(off), static_cast<const uint8_t*>(valid),
      lanes, f, w);
  return static_cast<int>(cudaGetLastError());
}
