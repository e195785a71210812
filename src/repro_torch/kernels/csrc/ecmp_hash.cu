// ECMP kernels for sm_90a: the batched port selection entry point and the
// fabric tick's two routing walks.
//
// ecmp_select_kernel replaces the reference package's Pallas TPU kernel
//   kernels/ecmp_hash.py  ecmp_select -> _hash_kernel
// ecmp_inject_kernel and ecmp_route_kernel are its forms on the port's
// tick: the reference's tick hashes and walks its routing tables in plain
// jnp (network/ecmp.py RoutingTables.injection_queue and route_step), and
// the port ran them as 28 and 48 eager operations. Each is one launch.
//
// The hash, ecmp_hash below and shared by all three: x = H(src, dst, ev,
// salt), the uint32 multiply-xor-shift avalanche of network/ecmp.py
// ecmp_hash; a port is x mod fanout (pick).
//   select: port = pick(H(src, dst, ev, salt), fanout)
//   inject (one lane per flow): sleaf, dleaf = host_leaf[src], [dst];
//     dleaf == sleaf ? host_queue[dst]
//                    : up1[sleaf, pick(H(src, dst, ev, sleaf), fanout1)]
//   route (one lane per queue head): st, sw = stage[q], next_switch[q];
//     two levels (leaf_spine): UP1 -> down1[clamp(sw - L), dleaf],
//       DOWN1 -> host_queue[dst], else DELIVERED;
//     three levels (fat_tree3): UP1 -> (agg / Ap == dpod ? go_down
//       : up2[agg, pick(H(src, dst, ev, sw), half)]), UP2 ->
//       down2[clamp(sw - L - A), dpod], DOWN2 -> go_down, DOWN1 ->
//       host_queue[dst], else DELIVERED; agg = clamp(sw - L), go_down =
//       down1[agg, dleaf mod Lp], dpod = host_pod[dst].
// The stage/next_switch lookups and the clamps are the plain version's;
// every other table index is clamped to its table too, so no lane can
// read outside one (for every lane the tick makes, that changes nothing).
//
// Bound on this card: memory, and at the tick's shapes launch latency.
// select: four 4-byte lanes in, one out, 20 B a lane, ~0.100 ms at
// N = 2**24 and 3.35 TB/s. inject: src, dst, ev in and the queue out
// (16 B a lane) plus the tables it reads once. route at B x Q lanes:
// src, dst, ev in and the queue out (16 B a lane), the [Q] queue ids and
// the tables once: ~0.35 MB, ~0.1 us, at B = 4, Q = 5120. The ~20 integer
// operations a lane (one modulus) stay far below the card's rate. A
// launch costs ~1.2-1.8 us, so what the tick forms buy is one launch
// where the eager composition took 28 and 48 device operations.
//
// Design: one thread owns one lane; lane loads and stores are coalesced.
// The TPU vector unit has no integer divide, so the Pallas kernel took a
// compile-time fanout and did a 16-bit long division; here the fanout is
// a runtime argument (>= 1), a power of two takes a mask and any other the
// hardware's 32-bit unsigned `%` (the branch is uniform across a launch;
// the fat tree's up2 fanout is 8). The routing tables are int32 and small:
// 69,632 B at fat_tree3(k=16, pods=16) (stage and next_switch [5120], three
// [1024] host arrays, up1 / down1 / up2 [128, 8], down2 [64, 16]). They
// are read through the read-only path (__ldg) and stay resident in the
// 50 MB L2 from tick to tick; a launch of ~80 blocks would spend more
// staging them in shared memory (each block a full copy, ~70 KB) than its
// few cached reads cost. route's [Q] queue ids are shared by the B
// scenarios: blockIdx.y walks the scenarios, and each reads the same ids
// (a zero scenario stride), never an expanded copy. A lane reads only the
// tables its stage needs. The int32 lanes are read as their uint32 bit
// patterns for the hash, so a negative lane hashes as JAX's
// astype(uint32) does, and every shift is a logical shift on uint32_t.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int32_t kDelivered = -2;  // network/ecmp.py DELIVERED
// network/topology.py Stage
constexpr int32_t kUp1 = 0, kUp2 = 1, kDown2 = 2, kDown1 = 3;

__device__ __forceinline__ uint32_t ecmp_hash(uint32_t src, uint32_t dst,
                                              uint32_t ev, uint32_t salt) {
  uint32_t x = src * 0x9E3779B1u ^ dst * 0x85EBCA77u ^ ev * 0xC2B2AE3Du ^
               salt * 0x27D4EB2Fu;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t pick(uint32_t x, uint32_t fanout) {
  return (fanout & (fanout - 1u)) == 0u ? (x & (fanout - 1u)) : (x % fanout);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// table[clamp(i, 0, n - 1)] through the read-only path
__device__ __forceinline__ int32_t at(const int32_t* __restrict__ table,
                                      int i, int n) {
  return __ldg(table + clampi(i, 0, n - 1));
}

// table[clamp(r, 0, rows - 1), clamp(c, 0, cols - 1)] of a [rows, cols]
// row-major table
__device__ __forceinline__ int32_t at2(const int32_t* __restrict__ table,
                                       int r, int c, int rows, int cols) {
  return __ldg(table + clampi(r, 0, rows - 1) * cols + clampi(c, 0, cols - 1));
}

__global__ void __launch_bounds__(kThreads)
ecmp_select_kernel(const uint32_t* __restrict__ src,
                   const uint32_t* __restrict__ dst,
                   const uint32_t* __restrict__ ev,
                   const uint32_t* __restrict__ salt,
                   int32_t* __restrict__ out, long long n, uint32_t fanout) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int32_t>(
      pick(ecmp_hash(src[i], dst[i], ev[i], salt[i]), fanout));
}

// the routing tables of one QueueGraph, as the kernels read them
struct Tables {
  const int32_t* stage;        // [nq]
  const int32_t* next_switch;  // [nq]
  const int32_t* host_leaf;    // [hosts]
  const int32_t* host_queue;   // [hosts]
  const int32_t* host_pod;     // [hosts]
  const int32_t* up1;          // [leaves, fanout1]
  const int32_t* down1;        // [d1_rows, d1_cols]
  const int32_t* up2;          // [d1_rows, half] (three levels)
  const int32_t* down2;        // [d2_rows, d2_cols] (three levels)
  int nq, hosts, leaves, fanout1, d1_rows, d1_cols, half, d2_rows, d2_cols;
};

// lanes with element strides: the tick's EV lane may be a strided view
// (STATIC's ev_set[..., 0]), read in place
__global__ void __launch_bounds__(kThreads)
ecmp_inject_kernel(const int32_t* __restrict__ src, long long src_stride,
                   const int32_t* __restrict__ dst, long long dst_stride,
                   const int32_t* __restrict__ ev, long long ev_stride,
                   int32_t* __restrict__ out, long long n, Tables t) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t s = src[i * src_stride], d = dst[i * dst_stride];
  const int32_t sleaf = at(t.host_leaf, s, t.hosts);
  const int32_t dleaf = at(t.host_leaf, d, t.hosts);
  if (sleaf == dleaf) {
    out[i] = at(t.host_queue, d, t.hosts);
    return;
  }
  const uint32_t h = pick(ecmp_hash(s, d, ev[i * ev_stride], sleaf),
                          t.fanout1);
  out[i] = at2(t.up1, sleaf, static_cast<int>(h), t.leaves, t.fanout1);
}

// lanes [B, per]; queue ids [per] with scenario stride q_stride (0: the
// same ids for every scenario)
template <bool kThree>
__global__ void __launch_bounds__(kThreads)
ecmp_route_kernel(const int32_t* __restrict__ queue, long long q_stride,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ ev, int32_t* __restrict__ out,
                  int batch, long long per, Tables t) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= per) return;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long i = b * per + j;
    const int q = __ldg(queue + b * q_stride + j);
    const int32_t st = at(t.stage, q, t.nq);
    const int32_t sw = at(t.next_switch, q, t.nq);
    const int32_t d = dst[i];
    int32_t nxt = kDelivered;
    if (st == kDown1) {
      nxt = at(t.host_queue, d, t.hosts);
    } else if (!kThree) {
      if (st == kUp1) {
        nxt = at2(t.down1, sw - t.leaves, at(t.host_leaf, d, t.hosts),
                  t.d1_rows, t.d1_cols);
      }
    } else if (st == kUp2) {
      const int core = clampi(sw - t.leaves - t.d1_rows, 0, t.d2_rows - 1);
      nxt = at2(t.down2, core, at(t.host_pod, d, t.hosts), t.d2_rows,
                t.d2_cols);
    } else if (st == kUp1 || st == kDown2) {
      const int agg = clampi(sw - t.leaves, 0, t.d1_rows - 1);
      if (st == kUp1 && agg / t.fanout1 != at(t.host_pod, d, t.hosts)) {
        const uint32_t h = pick(ecmp_hash(src[i], d, ev[i], sw), t.half);
        nxt = at2(t.up2, agg, static_cast<int>(h), t.d1_rows, t.half);
      } else {
        // dleaf mod Lp with the sign of Lp, as torch's % on int32
        int local = at(t.host_leaf, d, t.hosts) % t.d1_cols;
        if (local < 0) local += t.d1_cols;
        nxt = at2(t.down1, agg, local, t.d1_rows, t.d1_cols);
      }
    }
    out[i] = nxt;
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

Tables tables(const void* stage, const void* next_switch,
              const void* host_leaf, const void* host_queue,
              const void* host_pod, const void* up1, const void* down1,
              const void* up2, const void* down2, int nq, int hosts,
              int leaves, int fanout1, int d1_rows, int d1_cols, int half,
              int d2_rows, int d2_cols) {
  return Tables{static_cast<const int32_t*>(stage),
                static_cast<const int32_t*>(next_switch),
                static_cast<const int32_t*>(host_leaf),
                static_cast<const int32_t*>(host_queue),
                static_cast<const int32_t*>(host_pod),
                static_cast<const int32_t*>(up1),
                static_cast<const int32_t*>(down1),
                static_cast<const int32_t*>(up2),
                static_cast<const int32_t*>(down2),
                nq, hosts, leaves, fanout1, d1_rows, d1_cols, half, d2_rows,
                d2_cols};
}

}  // namespace

extern "C" int ecmp_select_launch(const void* src, const void* dst,
                                  const void* ev, const void* salt, void* out,
                                  long long n, int fanout, void* stream) {
  ecmp_select_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(dst),
      static_cast<const uint32_t*>(ev), static_cast<const uint32_t*>(salt),
      static_cast<int32_t*>(out), n, static_cast<uint32_t>(fanout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ecmp_inject_launch(const void* src, long long src_stride,
                                  const void* dst, long long dst_stride,
                                  const void* ev, long long ev_stride,
                                  void* out, long long n,
                                  const void* host_leaf,
                                  const void* host_queue, const void* up1,
                                  int hosts, int leaves, int fanout1,
                                  void* stream) {
  const Tables t = tables(nullptr, nullptr, host_leaf, host_queue, nullptr,
                          up1, nullptr, nullptr, nullptr, 0, hosts, leaves,
                          fanout1, 0, 0, 0, 0, 0);
  ecmp_inject_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), src_stride,
      static_cast<const int32_t*>(dst), dst_stride,
      static_cast<const int32_t*>(ev), ev_stride, static_cast<int32_t*>(out),
      n, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ecmp_route_launch(
    const void* queue, long long q_stride, const void* src, const void* dst,
    const void* ev, void* out, int batch, long long per, const void* stage,
    const void* next_switch, const void* host_leaf, const void* host_queue,
    const void* host_pod, const void* down1, const void* up2,
    const void* down2, int nq, int hosts, int leaves, int fanout1,
    int d1_rows, int d1_cols, int half, int d2_rows, int d2_cols,
    int three_level, void* stream) {
  const Tables t = tables(stage, next_switch, host_leaf, host_queue,
                          host_pod, nullptr, down1, up2, down2, nq, hosts,
                          leaves, fanout1, d1_rows, d1_cols, half, d2_rows,
                          d2_cols);
  const dim3 grid(blocks_for(per), batch < kMaxGridY ? batch : kMaxGridY);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* q = static_cast<const int32_t*>(queue);
  const int32_t* a = static_cast<const int32_t*>(src);
  const int32_t* d = static_cast<const int32_t*>(dst);
  const int32_t* e = static_cast<const int32_t*>(ev);
  int32_t* o = static_cast<int32_t*>(out);
  if (three_level) {
    ecmp_route_kernel<true><<<grid, kThreads, 0, s>>>(q, q_stride, a, d, e, o,
                                                      batch, per, t);
  } else {
    ecmp_route_kernel<false><<<grid, kThreads, 0, s>>>(q, q_stride, a, d, e,
                                                       o, batch, per, t);
  }
  return static_cast<int>(cudaGetLastError());
}
