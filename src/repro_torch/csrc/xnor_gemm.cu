// XNOR-popcount GEMM for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel _xnor_kernel / xnor_gemm_pallas of
// src/repro/kernels/xnor_gemm/kernel.py, the paper's XNOR baseline (§8.3):
// the +-1 product of K-bitpacked operands,
//   out[m, n] = k_bits - 2 * sum_w popc(a[m, w] ^ b[n, w]),
// with a (M, Kw) and b (N, Kw) int32 words, K packed LSB-first, and out
// (M, N) int32.  It computes what the Pallas kernel computes, not how
// Mosaic tiled it: the TPU's pad of M, N and Kw to its block sizes is not
// carried over.  The ragged M, N and Kw edges are masked here; a masked
// K-word reads 0 on both sides, and 0 ^ 0 has no set bit, so the sum stays
// exact (k_bits counts only the real bits).
//
// Design.  A block of 256 threads owns a 64 x 64 output tile; each thread
// owns a 4 x 4 register micro-tile, rows ty + 16 i and columns tx + 16 j,
// so a warp's shared-memory reads are broadcasts (rows) and 16 distinct
// consecutive words (columns).  A loop over K-words stages a 64 x 16-word
// slab of A and of B in shared memory, transposed to [word][row] with one
// word of padding per row, then every thread runs 16 XOR + __popc + add
// per staged word.  The epilogue writes k_bits - 2 * acc.
//
// What bounds it on the card: operations, not bytes.  The card's floor for
// this function is its int8 tensor-core rate (a +-1 operand is an int8),
// 2*M*N*k operations at 1,979 TOP/s: 0.0098 ms at VGG16 conv6 (M 16384,
// N 256, k 2304), where the bytes (A and B read once, the int32 result
// written once, 21.6 MB) take 0.0064 ms.  This kernel does not reach the
// tensor cores.  Its own limit is the popc pipe: M*N*Kw popcounts, and the
// int32 population count issues at 16 per SM per clock on compute
// capability 9.0 (the CUDA C++ guide's arithmetic-throughput table), a
// quarter of the XOR and add rate; that is 0.072 ms at VGG16 conv6, over
// 7x the card's floor.  What the design does about the popc limit: each
// staged word is reused across 64 rows or columns from shared memory, so
// the loads do not compete with the popcounts, and each thread holds 16
// independent accumulators to keep the popc pipe fed.  What it leaves for
// later: the popcounts of a slab's padding words past Kw, and the tensor
// cores (b1 mma, or popc(a^b) = popc(a) + popc(b) - 2 popc(a&b) as an
// AND-popc product), which the card's floor assumes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                     // output rows and columns a block owns
constexpr int kMicro = 4;                     // rows and columns a thread owns
constexpr int kSide = kTile / kMicro;         // 16 threads along each side
constexpr int kThreads = kSide * kSide;       // 256
constexpr int kSlab = 16;                     // K-words staged per pass

__global__ void __launch_bounds__(kThreads)
xnor_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
            int* __restrict__ out, int M, int N, int Kw, int k_bits) {
  __shared__ unsigned as[kSlab][kTile + 1];
  __shared__ unsigned bs[kSlab][kTile + 1];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  int acc[kMicro][kMicro] = {};

  for (int k0 = 0; k0 < Kw; k0 += kSlab) {
    for (int i = threadIdx.x; i < kTile * kSlab; i += kThreads) {
      const int r = i / kSlab;
      const int w = i % kSlab;
      const int k = k0 + w;
      const int ma = m0 + r;
      const int nb = n0 + r;
      as[w][r] = (ma < M && k < Kw) ? a[static_cast<size_t>(ma) * Kw + k] : 0u;
      bs[w][r] = (nb < N && k < Kw) ? b[static_cast<size_t>(nb) * Kw + k] : 0u;
    }
    __syncthreads();  // the slab is staged before any thread reads it
#pragma unroll
    for (int w = 0; w < kSlab; ++w) {
      unsigned av[kMicro], bv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = as[w][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) bv[j] = bs[w][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();  // every read of this slab before the next is staged
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int m = m0 + ty + kSide * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = k_bits - 2 * acc[i][j];
    }
  }
}

}  // namespace

// Launcher with a plain C interface, bound from Python with ctypes.  The
// wrapper checks the shapes and skips empty outputs; M tiles go on the grid's
// x axis (up to 2^31 - 1 blocks), N tiles on y (up to 65,535 blocks).  It
// returns the cudaGetLastError() that follows the launch (0 = success).
extern "C" int xnor_gemm_launch(const unsigned* a, const unsigned* b,
                                int* out, int M, int N, int Kw, int k_bits,
                                void* stream) {
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  xnor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, M, N, Kw, k_bits);
  return static_cast<int>(cudaGetLastError());
}
