// SACK-ring cumulative-ACK advance, plain and fused, for sm_90a.
//
// Replaces two Pallas TPU kernels of the reference package:
//   kernels/sack_bitmap.py  sack_advance -> _sack_kernel   (FUSED = false)
//   kernels/sack_fused.py   sack_fused   -> _fused_kernel  (FUSED = true)
//
// Per row (one flow's PDC): ring |= mask (fused only); adv = contiguous
// set bits from bit 0 of word 0; funnel-shift ring (and rtx, fused) right
// by adv bits; base += adv. Rows are [N, W] uint32 words, W <= 32.
//
// Bound on this card: memory. Each input word is read once and each
// output word written once — at the main path's N = 2048, W = 16 a fused
// launch moves about 0.68 MB, 0.2 us at 3.35 TB/s, so a launch is bound
// by launch latency, not by bytes or arithmetic.
//
// Design: the TPU kernel expressed the per-row variable shift as a W x W
// one-hot contraction and padded every row to 128 lanes, because the TPU
// vector unit cannot gather across lanes. Here one warp owns one row and
// lane j holds word j, so the row never leaves registers:
//   * the full words are one __ballot_sync; the first partial word is
//     __ffs(~ballot)-1 and its trailing ones __ffs(~word)-1 (a full row
//     advances W*32);
//   * lane j fetches words j+ws and j+ws+1 with __shfl_sync (0 past W)
//     and builds its output with __funnelshift_r; both rings share the
//     shift amount;
//   * loads are coalesced (a warp reads one row's W consecutive words,
//     consecutive warps consecutive rows); ROWS_PER_BLOCK rows share a
//     block and the ragged last block exits warp by warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;

template <bool FUSED>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
sack_kernel(const uint32_t* __restrict__ ring, const uint32_t* __restrict__ base,
            const uint32_t* __restrict__ rtx, const uint32_t* __restrict__ mask,
            uint32_t* __restrict__ ring_out, uint32_t* __restrict__ base_out,
            uint32_t* __restrict__ rtx_out, int32_t* __restrict__ adv_out,
            int n, int w) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp: the shuffles stay full
  const bool in = lane < w;
  const size_t at = static_cast<size_t>(row) * w + lane;
  uint32_t r = 0, x = 0;
  if (in) {
    r = ring[at];
    if (FUSED) {
      r |= mask[at];
      x = rtx[at];
    }
  }
  // --- CACK advance: whole words first, then the first partial word ---
  const unsigned wmask = (w == 32) ? kFull : ((1u << w) - 1u);
  const unsigned full = __ballot_sync(kFull, in && r == kFull);
  int adv;
  if (full == wmask) {
    adv = w * 32;
  } else {
    const int ws = __ffs(~full) - 1;
    const uint32_t first = __shfl_sync(kFull, r, ws);
    adv = ws * 32 + __ffs(~first) - 1;
  }
  // --- funnel shift right by adv bits, both rings ---
  const int src_lo = lane + (adv >> 5);
  const int src_hi = src_lo + 1;
  const unsigned bits = static_cast<unsigned>(adv) & 31u;
  uint32_t lo = __shfl_sync(kFull, r, src_lo & 31);
  uint32_t hi = __shfl_sync(kFull, r, src_hi & 31);
  lo = src_lo < w ? lo : 0u;
  hi = src_hi < w ? hi : 0u;
  uint32_t xo = 0;
  if (FUSED) {
    uint32_t xlo = __shfl_sync(kFull, x, src_lo & 31);
    uint32_t xhi = __shfl_sync(kFull, x, src_hi & 31);
    xlo = src_lo < w ? xlo : 0u;
    xhi = src_hi < w ? xhi : 0u;
    xo = __funnelshift_r(xlo, xhi, bits);
  }
  if (in) {
    ring_out[at] = __funnelshift_r(lo, hi, bits);
    if (FUSED) rtx_out[at] = xo;
  }
  if (lane == 0) {
    base_out[row] = base[row] + static_cast<uint32_t>(adv);
    adv_out[row] = adv;
  }
}

inline dim3 grid_for(int n) { return dim3((n + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace

extern "C" int sack_advance_launch(const void* ring, const void* base,
                                   void* ring_out, void* base_out,
                                   void* adv_out, int n, int w, void* stream) {
  sack_kernel<false><<<grid_for(n), 32 * kRowsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ring), static_cast<const uint32_t*>(base),
      nullptr, nullptr, static_cast<uint32_t*>(ring_out),
      static_cast<uint32_t*>(base_out), nullptr,
      static_cast<int32_t*>(adv_out), n, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sack_fused_launch(const void* ring, const void* base,
                                 const void* rtx, const void* mask,
                                 void* ring_out, void* base_out, void* rtx_out,
                                 void* adv_out, int n, int w, void* stream) {
  sack_kernel<true><<<grid_for(n), 32 * kRowsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ring), static_cast<const uint32_t*>(base),
      static_cast<const uint32_t*>(rtx), static_cast<const uint32_t*>(mask),
      static_cast<uint32_t*>(ring_out), static_cast<uint32_t*>(base_out),
      static_cast<uint32_t*>(rtx_out), static_cast<int32_t*>(adv_out), n, w);
  return static_cast<int>(cudaGetLastError());
}
