// Per-flow folds of the fabric tick's event lanes (make_step, sections 1
// and 5), for sm_90a.
//
// Replaces no Pallas kernel. The reference package densifies the tick's
// ACK / NACK lanes and its deliveries with jnp one-hots: the [F, E]
// ACK/NACK one-hot of section 1 (src/repro/network/fabric.py, `hot_ack` /
// `hot_nack` and their `_pick`s) and the [F, Q] delivery one-hot of
// section 5 (`hot_d`). The port's tick ran the same composition as [B, F,
// E] and [B, F, Q] boolean planes with int32 `where` + `sum` passes over
// them: about 80 % of a tick's device time at the benchmark's widths
// (B = 8, F = 2048, E = 2Q + 2F = 14336: 235 M lanes a plane, three
// int32 `where`s of that size a tick) and the largest live tensors of the
// tick. It was added because that composition was the largest cost on the
// tick, and what it computes is a scatter of the lanes onto their flows.
//
// For B scenarios of L lanes, F flows, 1-3 lane masks (M) and 1-4 sums (S)
// (row b of each [B, L] array; sum s reads value lane s under mask
// sum_mask[s]): for each scenario b and flow f in [0, F)
//   out[k, b, f]     = #{i : mask_k[b, i] and flow[b, i] == f}      k < M
//   out[M + s, b, f] = sum of value_s[b, i] over the lanes of mask
//                      sum_mask[s] with flow[b, i] == f, in int32 with
//                      wrap (as torch.sum(dtype=int32))             s < S
// A lane whose flow lies outside [0, F) folds nowhere. Integer atomics are
// exact and their order does not change the result, so the kernel is bit
// for bit kernels/ref.py's flow_fold_ref (the composition moved unchanged),
// also where several lanes hit one flow.
//
// Bound on this card: latency, not bytes. A scenario reads its flow (4 B),
// M mask bytes and S values (4 B) a lane and writes (M + S) F int32: at
// B = 8, L = 14336, M = 2, S = 3 (section 1 under AI Full) 2.39 MB, 0.71 us
// at 3.35 TB/s; section 5 (L = Q = 5120, M = S = 1) 0.50 MB. What is left
// is the launch and a few dependent rounds of loads.
//
// Design: one block per scenario, its (M + S) F counters in dynamic shared
// memory (40 KB at F = 2048 under AI Full, 56 KB with REPS's clean-ACK
// fold): the block zeroes them, each thread loads kUnroll lanes at a time
// (flows, masks and values before any atomic, so the loads overlap) and
// adds into shared memory, then the block writes the counters out, so no
// memset precedes the launch. Where the counters do not fit the block's
// opt-in limit (F past ~8000 with seven folds) the wrapper zeroes the
// output and the same walk adds into it in device memory. Only the shape
// decides which.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxMasks = 3;
constexpr int kMaxSums = 4;
constexpr size_t kStaticSmem = 48 * 1024;  // above it: an opt-in

struct FoldArgs {
  const int32_t* flow;
  const uint8_t* mask[kMaxMasks];
  const int32_t* value[kMaxSums];
  int32_t* out;
  int batch, lanes, flows, masks, sums;
  int sum_mask;  // 2 bits a sum: the mask it reads
};

template <bool SHARED>
__global__ void __launch_bounds__(kThreads) flow_fold_kernel(const FoldArgs a) {
  extern __shared__ int32_t shared_acc[];
  const size_t row = blockIdx.x;
  const size_t lane0 = row * a.lanes;
  const size_t plane = static_cast<size_t>(a.batch) * a.flows;
  const int slots = a.masks + a.sums;
  int32_t* out = a.out + row * a.flows;  // fold k at out[k * plane + f]
  if (SHARED) {
    for (int j = threadIdx.x; j < slots * a.flows; j += kThreads) {
      shared_acc[j] = 0;
    }
    __syncthreads();
  }
  // fold k's counter of flow f
  auto acc = [&](int k, int f) -> int32_t* {
    return SHARED ? shared_acc + k * a.flows + f : out + k * plane + f;
  };

  for (int i0 = 0; i0 < a.lanes; i0 += kThreads * kUnroll) {
    int f[kUnroll];
    unsigned on[kUnroll];
    int32_t v[kUnroll][kMaxSums] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      f[u] = -1;
      on[u] = 0;
      if (i < a.lanes) {
        f[u] = a.flow[lane0 + i];
#pragma unroll
        for (int k = 0; k < kMaxMasks; ++k) {
          if (k < a.masks && a.mask[k][lane0 + i] != 0) on[u] |= 1u << k;
        }
#pragma unroll
        for (int s = 0; s < kMaxSums; ++s) {
          v[u][s] = s < a.sums ? a.value[s][lane0 + i] : 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a flow outside [0, F) (negative too, as unsigned) folds nowhere
      if (on[u] == 0 || static_cast<unsigned>(f[u]) >=
                            static_cast<unsigned>(a.flows)) {
        continue;
      }
#pragma unroll
      for (int k = 0; k < kMaxMasks; ++k) {
        if (on[u] >> k & 1u) atomicAdd(acc(k, f[u]), 1);
      }
#pragma unroll
      for (int s = 0; s < kMaxSums; ++s) {
        if (s < a.sums && (on[u] >> (a.sum_mask >> 2 * s & 3) & 1u)) {
          atomicAdd(acc(a.masks + s, f[u]), v[u][s]);
        }
      }
    }
  }

  if (SHARED) {
    __syncthreads();
    for (int j = threadIdx.x; j < slots * a.flows; j += kThreads) {
      const int k = j / a.flows;
      out[k * plane + (j - k * a.flows)] = shared_acc[j];
    }
  }
}

}  // namespace

// batch rows of `lanes` lanes: flow (int32), masks of 1-3 bool lanes, sums
// of 1-4 int32 value lanes (sum s reads mask (sum_mask >> 2 s) & 3); out
// [masks + sums, batch, flows] int32. shared != 0: the counters in dynamic
// shared memory (out written whole); shared == 0: out is zeroed by the
// caller and added into.
extern "C" int flow_fold_launch(const void* flow, const void* mask0,
                                const void* mask1, const void* mask2,
                                const void* value0, const void* value1,
                                const void* value2, const void* value3,
                                void* out, int batch, int lanes, int flows,
                                int masks, int sums, int sum_mask, int shared,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  FoldArgs a;
  a.flow = static_cast<const int32_t*>(flow);
  a.mask[0] = static_cast<const uint8_t*>(mask0);
  a.mask[1] = static_cast<const uint8_t*>(mask1);
  a.mask[2] = static_cast<const uint8_t*>(mask2);
  a.value[0] = static_cast<const int32_t*>(value0);
  a.value[1] = static_cast<const int32_t*>(value1);
  a.value[2] = static_cast<const int32_t*>(value2);
  a.value[3] = static_cast<const int32_t*>(value3);
  a.out = static_cast<int32_t*>(out);
  a.batch = batch;
  a.lanes = lanes;
  a.flows = flows;
  a.masks = masks;
  a.sums = sums;
  a.sum_mask = sum_mask;
  if (shared != 0) {
    const size_t bytes =
        static_cast<size_t>(masks + sums) * flows * sizeof(int32_t);
    if (bytes > kStaticSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(&flow_fold_kernel<true>),
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    flow_fold_kernel<true><<<batch, kThreads, bytes, s>>>(a);
  } else {
    flow_fold_kernel<false><<<batch, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
