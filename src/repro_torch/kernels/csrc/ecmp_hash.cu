// Batched ECMP port selection for sm_90a.
//
// Replaces the reference package's Pallas TPU kernel
//   kernels/ecmp_hash.py  ecmp_select -> _hash_kernel
//
// Per packet lane i: x = H(src, dst, ev, salt), the uint32
// multiply-xor-shift avalanche of network/ecmp.py ecmp_hash; the port is
// x mod fanout, as an int32 in [0, fanout).
//
// Bound on this card: memory. Four 4-byte lanes in and one 4-byte lane
// out, 20 B a lane: about 0.100 ms at N = 2**24 and 3.35 TB/s; the ~15
// integer operations a lane (one modulus) stay far below the card's
// rate. At the main path's N = Q + F = 7168 a launch is bound by launch
// latency.
//
// Design: the TPU vector unit has no integer divide, so the Pallas kernel
// took a compile-time fanout and did a 16-bit long division; here fanout
// is a runtime argument (>= 1, checked by the wrapper), a power of two
// takes a mask and any other fanout the hardware's 32-bit unsigned `%`.
// The branch is uniform across the launch. One thread owns one lane;
// loads and stores are coalesced. The int32 inputs are read as their
// uint32 bit patterns, so a negative lane hashes as JAX's astype(uint32)
// does, and every shift is a logical shift on uint32_t.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ecmp_select_kernel(const uint32_t* __restrict__ src,
                   const uint32_t* __restrict__ dst,
                   const uint32_t* __restrict__ ev,
                   const uint32_t* __restrict__ salt,
                   int32_t* __restrict__ out, long long n, uint32_t fanout) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x = src[i] * 0x9E3779B1u ^ dst[i] * 0x85EBCA77u ^
               ev[i] * 0xC2B2AE3Du ^ salt[i] * 0x27D4EB2Fu;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  const uint32_t port = (fanout & (fanout - 1u)) == 0u ? (x & (fanout - 1u))
                                                        : (x % fanout);
  out[i] = static_cast<int32_t>(port);
}

}  // namespace

extern "C" int ecmp_select_launch(const void* src, const void* dst,
                                  const void* ev, const void* salt, void* out,
                                  long long n, int fanout, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  ecmp_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(dst),
      static_cast<const uint32_t*>(ev), static_cast<const uint32_t*>(salt),
      static_cast<int32_t*>(out), n, static_cast<uint32_t>(fanout));
  return static_cast<int>(cudaGetLastError());
}
