// Arrival ranks and per-queue enqueue counts of the fabric tick's enqueue
// phase (make_step, section 7), for sm_90a.
//
// Replaces no Pallas kernel. The reference package computes this step
// with jnp one-hots: _rank_within's masked pairwise count
// (src/repro/network/fabric.py:371) and the [Q, n] enqueue one-hot summed
// into each queue's count (:1023). The port's tick ran the same
// composition as three [B, n, n] boolean planes and two [B, Q, n] planes
// with int sums over them: about half of a tick's device time at the
// benchmark's widths (B = 8, n = Q + F = 7168, Q = 5120: 411 MB a plane).
// It was added because that composition was the largest cost on the tick.
//
// For B scenarios of n candidate lanes and Q queues (row b of each
// array), lane i is live where valid[i] and 0 <= target[i] < Q (the plain
// version's gather raises on a valid lane outside [0, Q)):
//   rank[i]  = #{j < i : lane j live, target[j] == target[i]}
//   pos[i]   = base[target[i]] + rank[i] (int32 wrap); base[0] where i is
//              not live
//   fits[i]  = lane i live and pos[i] < capacity
//   added[q] = #{i : fits[i], target[i] == q}
//            = #{r in [0, count_q) : int32(base[q] + r) < capacity},
//              computed from count_q, each queue's live lanes
// bit for bit as kernels/ref.py's enqueue_rank_ref, the composition moved
// unchanged.
//
// Bound on this card: latency, not bytes. A scenario reads target (4 B)
// and valid (1 B) a lane and base (4 B) a queue, and writes pos (4 B)
// and fits (1 B) a lane and added (4 B) a queue: 10 n + 8 Q bytes, about
// 0.90 MB at B = 8 (0.27 us at 3.35 TB/s); the composition's planes
// moved over 10^4 times that. What is left is the launch and the walk's
// dependent steps below (31-34 us a launch on an H100 at B = 8 and 16,
// where the composition took 7.6 and 15 ms).
//
// Design: one block per scenario walks its lanes in index order, so the
// result is the sequential count and depends on no atomic's order.
//   1. The block zeroes Q counters: in dynamic shared memory where Q x 4 B
//      fits a block's opt-in limit (160 KB at Q = 40960), else in a
//      [B, Q] global scratch that the wrapper allocates. Only the shape
//      decides.
//   2. Warp 0 takes 32 lanes a step. __match_any_sync on the live target
//      gives each lane its peers in the step; its rank is its queue's
//      counter plus the peers below it, and the lowest peer adds the
//      group's size to the counter. The warp loads the targets of the
//      next kAhead steps and matches a batch's peers before its serial
//      chain, so a step waits only on its counter's read and write
//      (224 steps at n = 7168). Ranks go to pos.
//   3. The whole block adds base to the ranks (pos, fits) and turns each
//      queue's counter into added.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kAhead = 8;  // warp steps whose lanes are loaded ahead
constexpr size_t kStaticSmem = 48 * 1024;  // above it: an opt-in

// lane i's target where the lane is live, else -1
__device__ __forceinline__ int live_target(const int32_t* __restrict__ target,
                                           const uint8_t* __restrict__ valid,
                                           int i, int n, int q) {
  if (i >= n) return -1;
  const int t = target[i];
  return (valid[i] != 0 && t >= 0 && t < q) ? t : -1;
}

// #{r in [0, c) : int32(base + r) < cap}, with int32's wrap past 2^31 - 1
__device__ __forceinline__ int fitting(int base, int c, int cap) {
  const long long b = base;
  const long long wrap = 2147483648LL - b;  // the first r whose sum wraps
  const long long straight = c < wrap ? c : wrap;
  long long room = static_cast<long long>(cap) - b;
  long long n = room < straight ? room : straight;
  n = n > 0 ? n : 0;
  if (c > wrap) {
    room += 4294967296LL;
    const long long hi = room < c ? room : c;
    n += hi > wrap ? hi - wrap : 0;
  }
  return static_cast<int>(n);
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
enqueue_rank_kernel(const int32_t* __restrict__ target,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ base, int32_t* __restrict__ pos,
                    int32_t* __restrict__ added, uint8_t* __restrict__ fits,
                    int32_t* scratch, int n, int q, int capacity) {
  extern __shared__ int32_t shared_counts[];
  const size_t row = blockIdx.x;
  target += row * n;
  valid += row * n;
  pos += row * n;
  fits += row * n;
  base += row * q;
  added += row * q;
  int32_t* count = SHARED ? shared_counts : scratch + row * q;
  for (int j = threadIdx.x; j < q; j += kThreads) count[j] = 0;
  __syncthreads();

  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    int cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cur[k] = live_target(target, valid, k * kWarp + lane, n, q);
    }
    for (int i0 = 0; i0 < n; i0 += kAhead * kWarp) {
      int next[kAhead];
      unsigned peers[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        next[k] = live_target(target, valid, i0 + (kAhead + k) * kWarp + lane,
                              n, q);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        peers[k] = __match_any_sync(0xffffffffu, cur[k]);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int t = cur[k];
        const int c = t >= 0 ? count[t] : 0;
        __syncwarp();  // every peer has read the counter
        if (t >= 0 && (peers[k] & below) == 0) count[t] = c + __popc(peers[k]);
        __syncwarp();  // the next step reads the new counter
        const int i = i0 + k * kWarp + lane;
        if (i < n) pos[i] = c + __popc(peers[k] & below);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) cur[k] = next[k];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = live_target(target, valid, i, n, q);
    const unsigned rank = t >= 0 ? static_cast<unsigned>(pos[i]) : 0u;
    const int p = static_cast<int>(
        static_cast<unsigned>(base[t >= 0 ? t : 0]) + rank);
    pos[i] = p;
    fits[i] = (t >= 0 && p < capacity) ? 1 : 0;
  }
  for (int j = threadIdx.x; j < q; j += kThreads) {
    added[j] = fitting(base[j], count[j], capacity);
  }
}

}  // namespace

// The largest dynamic shared memory a block of the current device may opt
// into, in bytes (negative: a CUDA error).
extern "C" int enqueue_rank_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  }
  return e == cudaSuccess ? bytes : -static_cast<int>(e);
}

// batch rows of n lanes (target, valid, pos, fits) and q queues (base,
// added); the counters in shared memory where scratch is null, else in
// scratch's batch x q int32.
extern "C" int enqueue_rank_launch(const void* target, const void* valid,
                                   const void* base, void* pos, void* added,
                                   void* fits, void* scratch, int batch, int n,
                                   int q, int capacity, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(target);
  auto v = static_cast<const uint8_t*>(valid);
  auto b = static_cast<const int32_t*>(base);
  auto p = static_cast<int32_t*>(pos);
  auto a = static_cast<int32_t*>(added);
  auto f = static_cast<uint8_t*>(fits);
  if (scratch == nullptr) {
    const size_t bytes = static_cast<size_t>(q) * sizeof(int32_t);
    if (bytes > kStaticSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(&enqueue_rank_kernel<true>),
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    enqueue_rank_kernel<true><<<batch, kThreads, bytes, s>>>(
        t, v, b, p, a, f, nullptr, n, q, capacity);
  } else {
    enqueue_rank_kernel<false><<<batch, kThreads, 0, s>>>(
        t, v, b, p, a, f, static_cast<int32_t*>(scratch), n, q, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
