// In-place bit marks on the [B*F, W] retransmit ring of B scenarios, for
// sm_90a.
//
// Replaces the reference package's Pallas TPU kernel
//   kernels/nack_mark.py  nack_mark -> _nack_kernel
// and, on the port's tick, the dense [F, W] bit planes that the
// reference tick builds around it to set or clear one bit per row.
//
// Two kernels, each a template, and four C entry points:
//
// * nack_mark_kernel<LANES, ROD> — one thread per lane, over B
//   scenarios of L lanes each: lane l is lane j = l % L of scenario
//   b = l / L, read at b*ld + j of the lane arrays (ld: the scenario
//   stride of the lanes, so a [B, L] slice of wider rows is read in
//   place), and it may mark only scenario b's rows b*F .. b*F + F-1. A
//   lane marks nothing unless nack and 0 <= flow < F (an out-of-range
//   flow marks nothing: the TPU kernel's contract, and what keeps a
//   flow of -1 or F off the neighbour scenario's rows), and, with ROD,
//   the flow's ROD mask rod[flow] (one [F] mask for every scenario) is
//   clear. With row = b*F + flow, its offset is
//     LANES:  off = psn - base[row] (uint32 wrap, read as int32), and
//             the lane marks only where 0 <= off < W*32;
//     !LANES: off = psn clipped to [0, W*32) (the TPU kernel's form,
//             where the caller passes the offset itself).
//   It sets bit off & 31 of word off >> 5 of that row with atomicOr:
//   lanes that hit one word or one bit combine as OR, which is
//   commutative and idempotent, so the result does not depend on the
//   order the atomics land in.
//   nack_mark_launch      : !LANES, no ROD, B = 1 — ops.nack_mark, on
//                           a copy;
//   nack_mark_lanes_launch: LANES, ROD if rod != nullptr — the tick's
//                           NACK site, on the ring itself.
//
// * own_bit_kernel<SET, UNLESS> — one thread per row, which owns its
//   row: no atomics. Row i acts only where valid[i] and
//   0 <= off[i] < W*32, and sets (SET) or clears bit off[i] with one
//   read-modify-write of word off[i] >> 5. With UNLESS it sets the bit
//   only where the same bit of the [F, W] ring `unless` is clear.
//   set_own_bit_launch   : SET, UNLESS if unless != nullptr;
//   clear_own_bit_launch : CLEAR.
//
// Bound on this card: memory, and far below a launch. At the main
// path's F = 2048, W = 16, L = Q + 2F = 9216 the lane form reads about
// 83 KB of lanes a scenario plus the rows and words it marks; a row
// form reads
// 5 B a row plus the words it touches. Each is well under 0.1 us at
// 3.35 TB/s, so a launch is bound by launch latency: what the design
// saves is the device operations around it (no copy of the ring, no
// [F, W] plane, no lane arithmetic in PyTorch).
//
// Design: the TPU kernel could not scatter across lanes, so it built an
// [F, L] x [L, W*32] f32 matmul of one-hots and packed the product back
// into words. Here the scatter is what it is. Every independent load of
// a thread is issued before the first test, so it waits on memory once
// for its lane and once for the dependent row (base, rod, unless).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool LANES, bool ROD>
__global__ void __launch_bounds__(kThreads)
nack_mark_kernel(uint32_t* __restrict__ rtx, const uint32_t* __restrict__ base,
                 const int32_t* __restrict__ flow,
                 const int32_t* __restrict__ psn,
                 const uint8_t* __restrict__ nack,
                 const uint8_t* __restrict__ rod, int lanes, int per, int ld,
                 int f, int w) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const int b = l / per;                  // the lane's scenario
  const size_t at = static_cast<size_t>(b) * ld + (l - b * per);
  const int fl = flow[at];
  const int p = psn[at];
  const bool on = nack[at] != 0;
  if (!on || fl < 0 || fl >= f) return;
  if (ROD && rod[fl]) return;
  const size_t row = static_cast<size_t>(b) * f + fl;
  int o;
  if (LANES) {
    o = static_cast<int>(static_cast<uint32_t>(p) - base[row]);
    if (o < 0 || o >= w * 32) return;
  } else {
    o = min(max(p, 0), w * 32 - 1);
  }
  atomicOr(rtx + row * w + (o >> 5), 1u << (o & 31));
}

template <bool SET, bool UNLESS>
__global__ void __launch_bounds__(kThreads)
own_bit_kernel(uint32_t* __restrict__ rtx, const int32_t* __restrict__ off,
               const uint8_t* __restrict__ valid,
               const uint32_t* __restrict__ unless, int n, int w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int o = off[i];
  const bool on = valid[i] != 0;
  if (!on || o < 0 || o >= w * 32) return;
  const size_t at = static_cast<size_t>(i) * w + (o >> 5);
  const uint32_t b = 1u << (o & 31);
  if (UNLESS && (unless[at] & b)) return;
  if (SET) {
    rtx[at] |= b;
  } else {
    rtx[at] &= ~b;
  }
}

inline unsigned blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int nack_mark_launch(void* rtx, const void* flow, const void* off,
                                const void* valid, int lanes, int f, int w,
                                void* stream) {
  nack_mark_kernel<false, false>
      <<<blocks(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint32_t*>(rtx), nullptr,
          static_cast<const int32_t*>(flow), static_cast<const int32_t*>(off),
          static_cast<const uint8_t*>(valid), nullptr, lanes, lanes, lanes, f,
          w);
  return static_cast<int>(cudaGetLastError());
}

// lanes = B * per lanes in all; ld = the lane arrays' scenario stride
// (elements); the ring and base hold B * f rows.
extern "C" int nack_mark_lanes_launch(void* rtx, const void* base,
                                      const void* flow, const void* psn,
                                      const void* nack, const void* rod,
                                      int lanes, int per, int ld, int f,
                                      int w, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<uint32_t*>(rtx);
  auto b = static_cast<const uint32_t*>(base);
  auto fl = static_cast<const int32_t*>(flow);
  auto p = static_cast<const int32_t*>(psn);
  auto nk = static_cast<const uint8_t*>(nack);
  auto rd = static_cast<const uint8_t*>(rod);
  if (rd != nullptr) {
    nack_mark_kernel<true, true><<<blocks(lanes), kThreads, 0, s>>>(
        r, b, fl, p, nk, rd, lanes, per, ld, f, w);
  } else {
    nack_mark_kernel<true, false><<<blocks(lanes), kThreads, 0, s>>>(
        r, b, fl, p, nk, nullptr, lanes, per, ld, f, w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int set_own_bit_launch(void* rtx, const void* off,
                                  const void* valid, const void* unless,
                                  int n, int w, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<uint32_t*>(rtx);
  auto o = static_cast<const int32_t*>(off);
  auto v = static_cast<const uint8_t*>(valid);
  auto u = static_cast<const uint32_t*>(unless);
  if (u != nullptr) {
    own_bit_kernel<true, true><<<blocks(n), kThreads, 0, s>>>(r, o, v, u, n, w);
  } else {
    own_bit_kernel<true, false><<<blocks(n), kThreads, 0, s>>>(r, o, v, nullptr,
                                                              n, w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int clear_own_bit_launch(void* rtx, const void* off,
                                    const void* valid, int n, int w,
                                    void* stream) {
  own_bit_kernel<false, false>
      <<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<uint32_t*>(rtx), static_cast<const int32_t*>(off),
          static_cast<const uint8_t*>(valid), nullptr, n, w);
  return static_cast<int>(cudaGetLastError());
}
