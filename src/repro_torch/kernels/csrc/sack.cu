// SACK-ring cumulative-ACK advance for sm_90a, in a dense-mask form and
// an own-bit form, from one templated kernel.
//
// Replaces two Pallas TPU kernels of the reference package:
//   kernels/sack_bitmap.py  sack_advance -> _sack_kernel   (FUSED = false)
//   kernels/sack_fused.py   sack_fused   -> _fused_kernel  (FUSED = true)
//
// Per row (one flow's PDC): record a received bit into the ring; adv =
// contiguous set bits from bit 0 of word 0; funnel-shift ring (and rtx,
// fused) right by adv bits; base += adv. Rows are [N, W] uint32 words,
// W <= 32. The mask form (OWN = false) is the TPU contract: ring |= an
// [N, W] bit plane. The TPU cannot set one bit per row, so its tick
// builds that plane, tests the row's old bit and clears the acked bit in
// rtx with dense [N, W] passes around the call. The own-bit form (OWN =
// true) takes the row's offset instead — off (int32, PSN - base), ok and
// clear (bool) — and does that work itself:
//   set     = ok && 0 <= off < 32 W   (signed)
//   already = set && bit off of the OLD ring
//   ring   |= set ? bit off : 0, then advance and shift as above
//   off2    = off - adv (uint32 wrap); fused only: if clear &&
//             0 <= off2 < 32 W, clear bit off2 of the shifted rtx.
//
// Bound on this card: memory. Each input word is read once and each
// output word written once — at the main path's N = 2048, W = 16 an
// own-bit fused launch moves 563,200 B, 0.17 us at 3.35 TB/s — far under
// a launch's own ~1 us, so what a call costs is the launch and the dense
// passes around it. The own-bit form removes those passes (about 60
// device operations per tick, each a launch of its own); the mask form
// stays for the ports of repro.kernels.ops.
//
// Design: the TPU kernel expressed the per-row variable shift as a W x W
// one-hot contraction and padded every row to 128 lanes. Here a row lives
// in one segment of a warp, Wp = the next power of two >= W lanes wide,
// lane j of the segment holding word j (zero past W), so the row never
// leaves registers and a warp holds 32 / Wp rows: at W = 16 two rows,
// every lane busy (one row per warp left half of each warp idle) and a
// warp's load one contiguous 128-B line. The launch floor is what a
// launch costs at all; against it the kernel keeps its own critical path
// to one round trip to memory:
//   * log2 Wp is a template parameter (the host picks the instantiation
//     from W), so a lane's row, word and address need no loop;
//   * every load is issued first: the words, the row's base and its
//     off/ok/clear (one broadcast per segment);
//   * the lane holding word off >> 5 reads `already` and sets the bit;
//   * the full words are one __ballot_sync, shifted to the segment and
//     masked to its W real words; the first partial word is
//     __ffs(~bits)-1 and its trailing ones __ffs(~word)-1 (a full row
//     advances W*32); every shuffle is taken by all 32 lanes, never under
//     a branch on one segment's data;
//   * lane j fetches words j+ws and j+ws+1 with __shfl_sync(width = Wp)
//     (0 past W) and builds its output with __funnelshift_r; both rings
//     share the shift amount;
//   * padded lanes and rows past N take part in the warp's shuffles and
//     ballot with zero words and store nothing; a warp wholly past N
//     exits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

struct Args {
  const uint32_t* ring;
  const uint32_t* base;
  const uint32_t* rtx;
  const uint32_t* mask;
  const int32_t* off;
  const uint8_t* ok;
  const uint8_t* clear;
  uint32_t* ring_out;
  uint32_t* base_out;
  uint32_t* rtx_out;
  int32_t* adv_out;
  uint8_t* already_out;
  int n, w;
};

// LW = log2 of the segment width Wp, the next power of two >= w: fixed at
// compile time, so a lane's row and word follow from its index at once
template <bool FUSED, bool OWN, int LW>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) sack_kernel(Args a) {
  constexpr int wp = 1 << LW;
  constexpr unsigned seg_mask = (wp == 32) ? kFull : ((1u << wp) - 1u);
  const int w = a.w, n = a.n, mp = w * 32;
  const int lane = threadIdx.x & 31;
  const int seg = lane >> LW;
  const int j = lane & (wp - 1);
  const int warp_row0 =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) << (5 - LW);
  if (warp_row0 >= n) return;  // uniform across the warp
  const int row = warp_row0 + seg;
  const bool live = row < n;
  const bool in = live && j < w;
  const size_t at = static_cast<size_t>(row) * w + j;

  // --- every load first ---
  uint32_t r = 0, x = 0, m = 0, b0 = 0;
  int32_t o = 0;
  bool set = false, clr = false;
  if (in) {
    r = __ldg(a.ring + at);
    if (FUSED) x = __ldg(a.rtx + at);
    if (!OWN && FUSED) m = __ldg(a.mask + at);
  }
  if (live && j == 0) b0 = __ldg(a.base + row);
  if (OWN && live) {
    o = __ldg(a.off + row);
    set = __ldg(a.ok + row) != 0;
    if (FUSED) clr = __ldg(a.clear + row) != 0;
  }
  // --- record the row's bit ---
  if (OWN) {
    set = set && o >= 0 && o < mp;
    const int owner = set ? (o >> 5) : 0;
    const uint32_t b = 1u << (o & 31);
    if (in && j == owner) {
      a.already_out[row] = (set && (r & b)) ? 1 : 0;
      if (set) r |= b;
    }
  } else if (FUSED) {
    r |= m;
  }
  // --- CACK advance: whole words first, then the first partial word ---
  const unsigned wmask = (w == 32) ? kFull : ((1u << w) - 1u);
  const unsigned full =
      (__ballot_sync(kFull, in && r == kFull) >> (seg << LW)) & seg_mask;
  // the two segments of a warp may differ on full == wmask, so every
  // lane takes the shuffle: a __shfl_sync under a divergent branch would
  // name lanes that do not reach it
  const bool all_full = full == wmask;
  const int ws = all_full ? 0 : __ffs(~full) - 1;  // else < w
  const uint32_t first = __shfl_sync(kFull, r, ws, wp);
  const int adv = all_full ? mp : ws * 32 + __ffs(~first) - 1;
  // --- funnel shift right by adv bits, both rings ---
  const int src_lo = j + (adv >> 5);
  const int src_hi = src_lo + 1;
  const unsigned bits = static_cast<unsigned>(adv) & 31u;
  uint32_t lo = __shfl_sync(kFull, r, src_lo & (wp - 1), wp);
  uint32_t hi = __shfl_sync(kFull, r, src_hi & (wp - 1), wp);
  lo = src_lo < w ? lo : 0u;
  hi = src_hi < w ? hi : 0u;
  uint32_t xo = 0;
  if (FUSED) {
    uint32_t xlo = __shfl_sync(kFull, x, src_lo & (wp - 1), wp);
    uint32_t xhi = __shfl_sync(kFull, x, src_hi & (wp - 1), wp);
    xlo = src_lo < w ? xlo : 0u;
    xhi = src_hi < w ? xhi : 0u;
    xo = __funnelshift_r(xlo, xhi, bits);
    if (OWN) {
      // the acked PSN's offset from the new base, as the tick computes it
      const int32_t o2 = static_cast<int32_t>(static_cast<uint32_t>(o) -
                                              static_cast<uint32_t>(adv));
      if (clr && o2 >= 0 && o2 < mp && j == (o2 >> 5)) xo &= ~(1u << (o2 & 31));
    }
  }
  if (in) {
    a.ring_out[at] = __funnelshift_r(lo, hi, bits);
    if (FUSED) a.rtx_out[at] = xo;
  }
  if (live && j == 0) {
    a.base_out[row] = b0 + static_cast<uint32_t>(adv);
    a.adv_out[row] = adv;
  }
}

template <bool FUSED, bool OWN, int LW>
int launch_seg(const Args& a, cudaStream_t stream) {
  constexpr int rows_per_block = kWarpsPerBlock << (5 - LW);
  const dim3 grid((a.n + rows_per_block - 1) / rows_per_block);
  sack_kernel<FUSED, OWN, LW><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, bool OWN>
int launch(const Args& a, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.w <= 1) return launch_seg<FUSED, OWN, 0>(a, s);
  if (a.w <= 2) return launch_seg<FUSED, OWN, 1>(a, s);
  if (a.w <= 4) return launch_seg<FUSED, OWN, 2>(a, s);
  if (a.w <= 8) return launch_seg<FUSED, OWN, 3>(a, s);
  if (a.w <= 16) return launch_seg<FUSED, OWN, 4>(a, s);
  return launch_seg<FUSED, OWN, 5>(a, s);
}

template <typename T>
const T* in_ptr(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out_ptr(void* p) { return static_cast<T*>(p); }

}  // namespace

extern "C" int sack_advance_launch(const void* ring, const void* base,
                                   void* ring_out, void* base_out,
                                   void* adv_out, int n, int w, void* stream) {
  return launch<false, false>(
      {in_ptr<uint32_t>(ring), in_ptr<uint32_t>(base), nullptr, nullptr,
       nullptr, nullptr, nullptr, out_ptr<uint32_t>(ring_out),
       out_ptr<uint32_t>(base_out), nullptr, out_ptr<int32_t>(adv_out),
       nullptr, n, w},
      stream);
}

extern "C" int sack_fused_launch(const void* ring, const void* base,
                                 const void* rtx, const void* mask,
                                 void* ring_out, void* base_out, void* rtx_out,
                                 void* adv_out, int n, int w, void* stream) {
  return launch<true, false>(
      {in_ptr<uint32_t>(ring), in_ptr<uint32_t>(base), in_ptr<uint32_t>(rtx),
       in_ptr<uint32_t>(mask), nullptr, nullptr, nullptr,
       out_ptr<uint32_t>(ring_out), out_ptr<uint32_t>(base_out),
       out_ptr<uint32_t>(rtx_out), out_ptr<int32_t>(adv_out), nullptr, n, w},
      stream);
}

extern "C" int sack_advance_own_launch(const void* ring, const void* base,
                                       const void* off, const void* ok,
                                       void* ring_out, void* base_out,
                                       void* adv_out, void* already_out,
                                       int n, int w, void* stream) {
  return launch<false, true>(
      {in_ptr<uint32_t>(ring), in_ptr<uint32_t>(base), nullptr, nullptr,
       in_ptr<int32_t>(off), in_ptr<uint8_t>(ok), nullptr,
       out_ptr<uint32_t>(ring_out), out_ptr<uint32_t>(base_out), nullptr,
       out_ptr<int32_t>(adv_out), out_ptr<uint8_t>(already_out), n, w},
      stream);
}

extern "C" int sack_fused_own_launch(const void* ring, const void* base,
                                     const void* rtx, const void* off,
                                     const void* ok, const void* clear,
                                     void* ring_out, void* base_out,
                                     void* rtx_out, void* adv_out,
                                     void* already_out, int n, int w,
                                     void* stream) {
  return launch<true, true>(
      {in_ptr<uint32_t>(ring), in_ptr<uint32_t>(base), in_ptr<uint32_t>(rtx),
       nullptr, in_ptr<int32_t>(off), in_ptr<uint8_t>(ok),
       in_ptr<uint8_t>(clear), out_ptr<uint32_t>(ring_out),
       out_ptr<uint32_t>(base_out), out_ptr<uint32_t>(rtx_out),
       out_ptr<int32_t>(adv_out), out_ptr<uint8_t>(already_out), n, w},
      stream);
}
