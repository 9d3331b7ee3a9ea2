// Bit pack and unpack of a wave's samples for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference packs and unpacks with plain
// jnp (src/repro/kernels/logic_dsp/ops.py pack_bits_jnp, unpack_bits_jnp),
// and the port ran the same arithmetic as eager PyTorch (kernels/logic_dsp/
// ref.py pack_bits_ref, unpack_bits_ref): an int32 copy of the whole slab,
// a multiply by 32 weights and a reduce to pack; an (n, W, 32) int32
// temporary and a transpose to unpack.  Those chains move about 450 MB at
// VGG16 conv8's wave and cost a Python dispatch an op on the wave's
// critical path, so the two functions became one kernel each.
//
// The layout (LSB-first, the words of core/packing.py): a (batch, n) bool
// slab, a sample a row, packs to (n, W) int32 words, W = ceil(batch / 32),
// sample 32 j + k at bit k of word j; bit 31 is the int32 sign bit.  The
// pad samples of a ragged last word are zero bits, and the unpack writes
// only the first `batch` sample rows.
//
// What bounds them on the card: bytes, read and written once.  At conv8's
// wave (8,192 x 2,304) the pack reads the 18.9 MB slab and writes 2.4 MB of
// words, 6.4 us at 3.35 TB/s; at fc1's (8,192 x 400) 3.3 MB and 0.4 MB.
// The unpack of 512 output rows reads 0.5 MB of words and writes 4.2 MB of
// bool rows.  No int32 temporary, no weight upload: only the wrapper
// allocates (the output, with torch.empty).
//
// Design.  Both kernels take a tile of 32 word groups' worth of samples by
// 32 columns per warp: a block of 8 warps owns 8 consecutive words (256
// samples) of 32 columns.
//  - pack: a lane owns one sample row of its warp's 32-row group and reads
//    its 32 columns, one 32-byte sector (two 16-byte loads where the row's
//    address allows, 4-byte loads where it is 4-byte aligned, bytes at a
//    ragged edge).  One __ballot_sync a column gives that column's word:
//    bit k is lane k's byte.  Lane t keeps column t's word, and the block
//    stages its 8 x 32 words in shared memory so that each column's 8
//    words go out as one 32-byte sector.
//  - unpack: the mirror.  The block reads each column's 8 words as one
//    sector into shared memory; lane t of a warp holds column t's word.
//    One __ballot_sync a sample k gives lane k its own sample's 32 column
//    bits (a shuffle a column would give the same bits one at a time).
//    The lane spreads them to 32 bytes of 0 or 1 and writes them as
//    contiguous bytes of its sample row, 16 bytes a store where aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;     // columns a warp owns: a 32-byte row sector
constexpr int kWarps = 8;     // word groups a block owns: 8 words = a sector
constexpr int kThreads = kCols * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Columns c0..c0+31 of one bool row into v (byte t of v[t / 4] is column
// c0 + t), `valid` of them real (the rest read as 0).
__device__ __forceinline__ void load_row(const unsigned char* p, int valid,
                                         unsigned v[8]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* q = p + 16 * h;
    const int k = valid - 16 * h;            // bytes of this half
    if (k >= 16 && (a & 15) == 0) {
      const uint4 x = *reinterpret_cast<const uint4*>(q);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    } else if (k >= 16 && (a & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[4 * h + i] = reinterpret_cast<const unsigned*>(q)[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * h + i] = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < k) v[4 * h + t / 4] |= unsigned(q[t]) << (8 * (t % 4));
      }
    }
  }
}

// Bits 0..31 of m as 32 bytes of 0 or 1 into columns c0..c0+31 of one bool
// row, `valid` of them real.
__device__ __forceinline__ void store_row(unsigned char* p, int valid,
                                          unsigned m) {
  unsigned v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // nibble bits 0..3 to bytes 0..3: the shifted copies do not overlap
    v[q] = (((m >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* q = p + 16 * h;
    const int k = valid - 16 * h;
    if (k >= 16 && (a & 15) == 0) {
      *reinterpret_cast<uint4*>(q) =
          make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else if (k >= 16 && (a & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reinterpret_cast<unsigned*>(q)[i] = v[4 * h + i];
      }
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < k) q[t] = static_cast<unsigned char>((m >> (16 * h + t)) & 1u);
      }
    }
  }
}

// grid (ceil(W / 8), ceil(n / 32)), kThreads threads.
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const unsigned char* __restrict__ bits, int batch, int n,
                int* __restrict__ words, int W) {
  __shared__ int tile[kCols][kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kCols;
  const long long row = (static_cast<long long>(blockIdx.x) * kWarps + warp)
                        * 32 + lane;
  unsigned v[8];
  if (row < batch) {
    load_row(bits + row * n + c0, min(kCols, n - c0), v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0;    // the pad samples: zero bits
  }
  int mine = 0;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const unsigned w =
        __ballot_sync(kFull, (v[t / 4] >> (8 * (t % 4))) & 0xFFu);
    if (lane == t) mine = static_cast<int>(w);
  }
  tile[lane][warp] = mine;
  __syncthreads();
  const int col = threadIdx.x / kWarps, jj = threadIdx.x % kWarps;
  const int c = c0 + col;
  const long long j = static_cast<long long>(blockIdx.x) * kWarps + jj;
  if (c < n && j < W) words[static_cast<long long>(c) * W + j] = tile[col][jj];
}

// grid (ceil(W / 8), ceil(n / 32)), kThreads threads.
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const int* __restrict__ words, int n, int W,
                  unsigned char* __restrict__ bits, int batch) {
  __shared__ int tile[kCols][kWarps + 1];
  const int c0 = blockIdx.y * kCols;
  {
    const int col = threadIdx.x / kWarps, jj = threadIdx.x % kWarps;
    const int c = c0 + col;
    const long long j = static_cast<long long>(blockIdx.x) * kWarps + jj;
    tile[col][jj] =
        (c < n && j < W) ? words[static_cast<long long>(c) * W + j] : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned word = static_cast<unsigned>(tile[lane][warp]);
  unsigned m = 0;                  // bit t: column c0 + t of this sample
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const unsigned b = __ballot_sync(kFull, (word >> k) & 1u);
    if (lane == k) m = b;
  }
  const long long row = (static_cast<long long>(blockIdx.x) * kWarps + warp)
                        * 32 + lane;
  if (row < batch) store_row(bits + row * n + c0, min(kCols, n - c0), m);
}

dim3 grid_of(int W, int n) {
  return dim3((W + kWarps - 1) / kWarps, (n + kCols - 1) / kCols);
}

}  // namespace

// Launchers with a plain C interface, bound from Python with ctypes.  The
// wrappers (kernels/logic_dsp/kernel.py) check dtypes and shapes, make the
// input contiguous and skip empty launches.  Words tiles go on the grid's
// x axis (up to 2^31 - 1 blocks), column tiles on y (up to 65,535, so n up
// to 2,097,120).  Each returns the cudaGetLastError() after its launch.
extern "C" {

int bitpack_pack(const unsigned char* bits, int batch, int n, int* words,
                 int W, void* stream) {
  const dim3 grid = grid_of(W, n);
  if (batch < 0 || n <= 0 || W <= 0 || grid.y > 65535u ||
      static_cast<long long>(W) * 32 < batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bits, batch, n, words, W);
  return static_cast<int>(cudaGetLastError());
}

int bitpack_unpack(const int* words, int n, int W, unsigned char* bits,
                   int batch, void* stream) {
  const dim3 grid = grid_of(W, n);
  if (batch < 0 || n <= 0 || W <= 0 || grid.y > 65535u ||
      static_cast<long long>(W) * 32 < batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n, W, bits, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
