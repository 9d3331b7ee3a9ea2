// XNOR-popcount GEMM for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel _xnor_kernel / xnor_gemm_pallas of
// src/repro/kernels/xnor_gemm/kernel.py, the paper's XNOR baseline (§8.3):
// the +-1 product of K-bitpacked operands,
//   out[m, n] = k_bits - 2 * sum_w popc(a[m, w] ^ b[n, w]),
// with a (M, Kw) and b (N, Kw) int32 words, K packed LSB-first, and out
// (M, N) int32.  It computes what the Pallas kernel computes, not how
// Mosaic tiled it: the TPU's pad of M, N and Kw to its block sizes is not
// carried over.  The ragged M, N and Kw edges are masked here: a masked
// word is staged as 0 on both sides and counts nothing.
//
// Route: the binary tensor cores.  Each 256-bit k-step is one
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// straight on the packed words (a b1 fragment register holds one word, so
// no bit is moved), through the identity
//   popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b),
// so out = k_bits - 2 (pa[m] + pb[n]) + 4 and[m, n], where pa and pb are
// the rows' popcounts, summed from the fragments the mma reads anyway.
// The bit order inside a word does not matter: A and B hold each k in the
// same place.  tools/torch_mma_probe.py timed it alone on an H100 80GB
// HBM3 at 700 W (PERF.md): native BMMA, issued at the int8 m16n8k32's
// rate (0.58 per SM per clock) with 8x its k, on operands of 1/8 its
// bytes; .xor.popc compiles for sm_90a but is emulated, 6.4x slower.
//
// Design.  A block of 8 warps owns a 64 x 128 output tile, each warp 32 x
// 32 (2 x 4 mma tiles of 16 x 8).  A loop over K stages 16-word chunks of
// A and B in shared memory, three in flight through cp.async (4 bytes a
// word, zero-filled past M, N or Kw, since Kw need not be a multiple of
// 4), rows padded to 20 words so that every fragment load is free of bank
// conflicts.  The epilogue adds the popcount terms into an int32 tile in
// the same shared memory and writes it out a row per warp, 16 bytes a
// thread.
//
// What bounds it on the card.  The card's floor for this function is
// max(bytes, 2*M*N*k operations at the card's fastest rate for a +-1
// product).  That rate is the b1 mma's, 1.0e16 operations/s as the probe
// measured it, 5x the int8 tensor-core peak of 1,979 TOP/s.  At VGG16
// conv6 (M 16384, N 256, k 2304) the operations then take 0.0019 ms and
// the bytes bind: 21.6 MB (A, B, and the 16.8 MB int32 result) at 3.35
// TB/s, 0.0064 ms.  On an H100 80GB HBM3 at 700 W (PERF.md) the kernel
// takes about 0.0214 ms of device time there, against torch._int_mm's
// 0.0316 on the +-1 int8 operands: 3.3x the card's floor, bound by moving
// the tiles (512 blocks, three resident an SM, so 1.3 waves).  A call from
// Python costs more host time than that (the wrapper's checks, the output
// allocation, the ctypes launch), so back to back it is host-bound.  What
// the design leaves for later: wgmma, TMA loads, and a persistent grid.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                 // output rows (of A) a block owns
constexpr int kBN = 128;                // output columns (rows of B)
constexpr int kWarpsN = 4;              // warps along N; 2 along M
constexpr int kThreads = 256;
constexpr int kTM = 2;                  // 16-row mma tiles a warp owns
constexpr int kTN = 4;                  // 8-column mma tiles a warp owns
constexpr int kKC = 16;                 // K-words a chunk stages
constexpr int kLd = kKC + 4;            // padded row stride (words)
constexpr int kStages = 3;              // chunks in flight
constexpr int kStage = (kBM + kBN) * kLd;   // words of one stage
constexpr int kOutLd = kBN + 8;         // the output tile's row stride
static_assert(kBM * kOutLd <= kStages * kStage, "tile fits the stages");

__device__ __forceinline__ void cp_async4(unsigned* smem, const unsigned* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void mma_and_popc(int (&c)[4], unsigned a0,
                                             unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
xnor_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
            int* __restrict__ out, int M, int N, int Kw, int k_bits) {
  // kStages chunks of A (kBM rows) then B (kBN rows), kLd words a row;
  // after the K loop the same memory holds the output tile
  __shared__ __align__(16) unsigned buf[kStages * kStage];
  __shared__ int pa_s[kBM];
  __shared__ int pb_s[kBN];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;               // fragment row group
  const int t = lane % 4;               // thread in group
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  auto as = [&](int st, int r, int w) -> unsigned& {
    return buf[st * kStage + r * kLd + w];
  };
  auto bs = [&](int st, int r, int w) -> unsigned& {
    return buf[st * kStage + (kBM + r) * kLd + w];
  };

  // chunk c of A and B into stage c % kStages, as one commit group (empty
  // past the last chunk); words past Kw, rows past M or N are zero-filled
  const int chunks = (Kw + kKC - 1) / kKC;
  auto stage = [&](int c) {
    if (c < chunks) {
      const int k0 = c * kKC;
      const int st = c % kStages;
      for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
        const int r = i / kKC, w = i % kKC;
        const bool ok = m0 + r < M && k0 + w < Kw;
        cp_async4(&as(st, r, w),
                  ok ? a + static_cast<size_t>(m0 + r) * Kw + k0 + w : a, ok);
      }
      for (int i = threadIdx.x; i < kBN * kKC; i += kThreads) {
        const int r = i / kKC, w = i % kKC;
        const bool ok = n0 + r < N && k0 + w < Kw;
        cp_async4(&bs(st, r, w),
                  ok ? b + static_cast<size_t>(n0 + r) * Kw + k0 + w : b, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int acc[kTM][kTN][4] = {};
  int pa[kTM][2] = {};                  // rows g and g + 8 of each m-tile
  int pb[kTN] = {};                     // column g of each n-tile
  for (int c = 0; c < kStages - 1; ++c) stage(c);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // chunk c is staged, and chunk c-1's stage is free
    stage(c + kStages - 1);
    const int st = c % kStages;
    const int steps = min(kKC, Kw - c * kKC + 7) / 8;  // 8-word k-steps
    for (int ks = 0; ks < steps; ++ks) {
      const int kk = ks * 8 + t;
      unsigned af[kTM][4], bf[kTN][2];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = wm * 32 + i * 16 + g;
        af[i][0] = as(st, r, kk);
        af[i][1] = as(st, r + 8, kk);
        af[i][2] = as(st, r, kk + 4);
        af[i][3] = as(st, r + 8, kk + 4);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int r = wn * 32 + j * 8 + g;
        bf[j][0] = bs(st, r, kk);
        bf[j][1] = bs(st, r, kk + 4);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          mma_and_popc(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                       bf[j][0], bf[j][1]);
      if (wn == 0) {                    // one warp column counts A's rows
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          pa[i][0] += __popc(af[i][0]) + __popc(af[i][2]);
          pa[i][1] += __popc(af[i][1]) + __popc(af[i][3]);
        }
      }
      if (wm == 0) {                    // one warp row counts B's rows
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          pb[j] += __popc(bf[j][0]) + __popc(bf[j][1]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // row popcounts: the 4 threads of a group hold a row's words t, t + 4
  // of every k-step
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[i][h] += __shfl_xor_sync(0xffffffffu, pa[i][h], 1);
      pa[i][h] += __shfl_xor_sync(0xffffffffu, pa[i][h], 2);
    }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], 1);
    pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], 2);
  }
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      pa_s[wm * 32 + i * 16 + g] = pa[i][0];
      pa_s[wm * 32 + i * 16 + g + 8] = pa[i][1];
    }
  }
  if (wm == 0 && t == 0) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) pb_s[wn * 32 + j * 8 + g] = pb[j];
  }
  __syncthreads();  // row counts written, every stage read

  // out = k_bits - 2 (pa + pb) + 4 and into the tile (c0, c1 in row g,
  // c2, c3 in g + 8; 8-byte stores, free of bank conflicts at this stride)
  int* tile = reinterpret_cast<int*>(buf);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + g + 8 * h;
      const int base = k_bits - 2 * pa_s[r];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = wn * 32 + j * 8 + 2 * t;
        int2 v;
        v.x = base - 2 * pb_s[col] + 4 * acc[i][j][2 * h];
        v.y = base - 2 * pb_s[col + 1] + 4 * acc[i][j][2 * h + 1];
        *reinterpret_cast<int2*>(&tile[r * kOutLd + col]) = v;
      }
    }
  __syncthreads();

  // the tile out, a warp a row: 16-byte stores when rows are 16-byte
  // aligned (N % 4 == 0), else 4-byte ones; rows past M and columns past
  // N are left out
  const bool vec = (N & 3) == 0;
  for (int i = threadIdx.x; i < kBM * (kBN / 4); i += kThreads) {
    const int r = i / (kBN / 4), q = i % (kBN / 4);
    const int m = m0 + r, n = n0 + 4 * q;
    if (m >= M || n >= N) continue;
    const int4 v = *reinterpret_cast<const int4*>(&tile[r * kOutLd + 4 * q]);
    int* dst = out + static_cast<size_t>(m) * N + n;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (n + 1 < N) dst[1] = v.y;
      if (n + 2 < N) dst[2] = v.z;
      if (n + 3 < N) dst[3] = v.w;
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
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  xnor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, M, N, Kw, k_bits);
  return static_cast<int>(cudaGetLastError());
}
