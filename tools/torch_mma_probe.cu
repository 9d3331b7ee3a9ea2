// Tensor-core instruction-rate probe for Hopper (sm_90a).
//
// One kernel, compiled once per variant (-DPROBE_VARIANT=k) by
// tools/torch_mma_probe.py, that issues a long loop of ONE mma.sync
// instruction: each warp keeps kChains independent accumulators, so the
// loop is bound by the instruction's issue rate and not by its latency.
// The operands are fixed registers; the sums are written out so that
// nothing is optimized away.
//   0  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   1  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc
//   2  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   3  mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32

#include <cuda_runtime.h>

#ifndef PROBE_VARIANT
#define PROBE_VARIANT 0
#endif

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma(int (&c)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
#if PROBE_VARIANT == 0
#define PROBE_OP "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
#elif PROBE_VARIANT == 1
#define PROBE_OP "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
#elif PROBE_VARIANT == 2
#define PROBE_OP "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
#else
#define PROBE_OP "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
#endif
  asm volatile(PROBE_OP
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void probe_kernel(int* out, int iters) {
  const unsigned a0 = (threadIdx.x + 1) * 0x9E3779B9u;
  const unsigned a1 = a0 ^ 0x55555555u, a2 = a0 + 12345u, a3 = ~a0;
  const unsigned b0 = a0 * 3u, b1 = a1 * 5u;
  int acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) mma(acc[j], a0, a1, a2, a3, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Launch blocks x threads, each warp issuing iters * kChains mma; returns
// the cudaGetLastError() that follows the launch.
extern "C" int probe_launch(int* out, int blocks, int threads, int iters,
                            void* stream) {
  probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_chains() { return kChains; }
