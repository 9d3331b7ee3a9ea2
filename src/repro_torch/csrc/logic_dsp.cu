// Levelized gate-program executor for Hopper (sm_90a): K1 and K2.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/logic_dsp/kernel.py
// with one kernel, mega_kernel:
//   K2 <- _mega_kernel  / mega_pallas_call   (a whole stage pipeline, chain
//                                             or parallel mode, one launch)
//   K1 <- _logic_kernel / logic_pallas_call  (one program): the one-stage
//         case of K2, launched with the stage table (0, n_steps, n_in,
//         n_out, 0) in chain mode, which reads the inputs and gathers
//         straight to the output.
// It computes what the Pallas kernels compute, not how Mosaic tiled it.
// A scratch of n_addr int32 rows per word column holds row 0 = 0, row 1 = -1
// and the packed inputs at rows 2..1+n_in.  Step s has n_unit lanes: lane u
// reads rows src_a[s,u] and src_b[s,u], applies its bitwise op and writes
// row dst[s,u].  The outputs are gathered from the output_addrs rows at the
// end.
//
// Design.  Word columns are independent, so a thread block owns a
// contiguous slice of `bw` columns (the wrapper picks 2, or 1 where 2 do
// not fit; 2 won an H100 sweep over 1, 2 and 4, PERF.md) and runs every
// lane of every step for them.  The wrapper hands the kernel one index record per lane and step
// instead of the four streams: the step's bank (step_branch) already
// folded into the lane's op, and the op given as its 4-bit truth table, so
// a step is one branch-free select whatever its opcodes.  Two variants of
// one template, picked by the wrapper from the program's size:
//  - kShared: the scratch lives in dynamic shared memory, n_addr x bw
//    ints, a row's bw columns side by side.  It is taken whenever it fits
//    a block's 227 KB (at bw = 2 up to about 28k rows, 57k at bw = 1),
//    which covers every program the LeNet-5 fc1 layer and the flow give.
//    A thread runs whole lanes, all bw columns as one 4- or 8-byte
//    access; the record is 8 bytes (src_a | src_b << 16, dst | tt << 16),
//    and the wrapper orders each step's lanes so that the lanes of one
//    shared-memory wavefront spread their rows over the banks.
//  - device memory: the scratch is a row-major (n_addr, W) int32 buffer
//    that the wrapper allocates and that stays L2-resident; a thread keeps
//    one column and the record is 16 bytes (src_a, src_b, dst, tt).
//    Programs of any size run here.
// The records are the same for every block and stay L2-resident; a ring of
// `ring` step slots in shared memory is filled with cp.async ring - 1
// steps ahead, so a step's index loads never wait on L2 (the device
// variant's ring 0 reads them straight from device memory, for lanes too
// wide for the ring).
// Within a step every read that matters happens before any write: results
// go to a per-thread slot of shared memory, then a barrier, then the
// scatter, then a second barrier before the next step.  When the wrapper
// has proved, once per program, that no row written in a step is read in
// it (a read matters unless the lane writes its stage's trash row, or its
// op ignores that operand), each thread writes its result at once and the
// step ends on its one barrier.  NOP padding lanes all write their stage's
// trash row; nothing reads it.
//
// What bounds it on the card: a step is a chain of shared-memory accesses
// (record, two operand rows, the result row) and one block barrier; the
// rows are random, so the accesses stay bank-conflicted (about 2.2x the
// conflict-free wavefronts at fc1 after the lane order).  On an H100 80GB
// HBM3 at 700 W (PERF.md) fc1's 145 steps take about 0.26 us each in the
// shared variant, some 66x the launch's bound of 0.56 us, which the word
// operations set; the bytes a launch must move (inputs, outputs, records)
// are smaller still.  The device variant pays L2 round trips, about 0.63
// us a step.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;

// Packed record of the shared-memory variant (rows < 2^16).
struct __align__(8) NarrowRec {
  unsigned ab;  // src_a | src_b << 16
  unsigned dt;  // dst | truth table << 16
};
// Record of the device-memory variant.
struct __align__(16) WideRec {
  int a, b, d, tt;
};

struct Lane {
  int a, b, d, tt;
};

__device__ __forceinline__ Lane decode(NarrowRec r) {
  return {static_cast<int>(r.ab & 0xFFFFu), static_cast<int>(r.ab >> 16),
          static_cast<int>(r.dt & 0xFFFFu), static_cast<int>(r.dt >> 16)};
}
__device__ __forceinline__ Lane decode(WideRec r) {
  return {r.a, r.b, r.d, r.tt};
}

// Bit k of the truth table tt as a mask of 0 or all ones.
__device__ __forceinline__ int tt_mask(int tt, int k) {
  return (tt << (31 - k)) >> 31;
}

// The op of truth table tt on every bit: bit 2x + y of tt is op(x, y).
__device__ __forceinline__ int apply_tt(int tt, int a, int b) {
  const int m0 = tt_mask(tt, 0), m1 = tt_mask(tt, 1);
  const int m2 = tt_mask(tt, 2), m3 = tt_mask(tt, 3);
  const int if_a0 = (b & m1) | (~b & m0);
  const int if_a1 = (b & m3) | (~b & m2);
  return (a & if_a1) | (~a & if_a0);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0..2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The block's view of the scratch: row r, column c (0 <= c < bw) is
// base[r * ld + c]; columns at or past `ncols` (the ragged last block) are
// skipped wherever device memory is touched.
struct View {
  int* base;
  int ld;
  int lg;     // log2(bw)
  int ncols;  // real columns of this block
  int c0;     // first word column of the block
  int W;
};

// Rows 0..1+n_in of the block's columns: const0, const1, then the stage's
// inputs from `feed`.  The other rows are left as they are: a valid
// program reads them only after a write in the same stage.
__device__ void init_scratch(const View& v, const int* feed, int n_in) {
  const int n = (2 + n_in) << v.lg;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i >> v.lg;
    const int col = i & ((1 << v.lg) - 1);
    if (col >= v.ncols) continue;
    const int x = row == 0   ? 0
                  : row == 1 ? -1
                             : feed[static_cast<size_t>(row - 2) * v.W +
                                    v.c0 + col];
    v.base[row * static_cast<size_t>(v.ld) + col] = x;
  }
}

// dest[rows ? rows[j] : j] = scratch[addrs[j]] for j < n_out.
__device__ void gather(const View& v, const int* addrs, const int* rows,
                       int n_out, int* dest) {
  const int n = n_out << v.lg;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i >> v.lg;
    const int col = i & ((1 << v.lg) - 1);
    if (col >= v.ncols) continue;
    const int row = rows ? rows[j] : j;
    dest[static_cast<size_t>(row) * v.W + v.c0 + col] =
        v.base[addrs[j] * static_cast<size_t>(v.ld) + col];
  }
}

// K2: the stage table is (n_stages, 5) int32 rows (step_lo, step_hi, n_in,
// n_out, out_lo) over the concatenated steps, in order, so the ring walks
// the global steps 0..total_steps-1 across stage boundaries.  Every stage
// re-initializes rows 0..1+n_in, because the liveness allocator may have
// reused const or input rows as gate rows in the stage before.  Chain mode
// hands stage k's outputs to stage k+1 through `handoff`, a (max n_out, W)
// device buffer of which each block uses only its own columns; the last
// stage writes `out`.  Parallel mode reads the primary inputs in every
// stage and writes each stage output j straight to its permuted row
// out_rows[out_lo + j].
// A row of kCols word columns of the shared scratch, loaded and stored
// as one vector.
template <int kCols>
struct Row;
template <>
struct Row<1> {
  int x;
};
template <>
struct __align__(8) Row<2> {
  int x, y;
};

template <int kCols>
__device__ __forceinline__ Row<kCols> apply_row(int tt, Row<kCols> a,
                                                Row<kCols> b) {
  const int m0 = tt_mask(tt, 0), m1 = tt_mask(tt, 1);
  const int m2 = tt_mask(tt, 2), m3 = tt_mask(tt, 3);
  auto f = [&](int x, int y) {
    return (x & ((y & m3) | (~y & m2))) | (~x & ((y & m1) | (~y & m0)));
  };
  Row<kCols> r;
  r.x = f(a.x, b.x);
  if constexpr (kCols > 1) r.y = f(a.y, b.y);
  return r;
}

// kShared: a thread runs whole lanes (all kCols columns of a lane at once,
// vector loads and stores of shared memory; the records hold rows).  The
// device variant (kShared false, kCols 1): a thread keeps one column for
// the launch and takes the lanes lane0, lane0 + stride, ... of every step.
template <bool kShared, int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    mega_kernel(const typename std::conditional<kShared, NarrowRec,
                                                WideRec>::type* recs,
                int total_steps, const int* stage_table, int n_stages,
                int chain, int n_unit, const int* inputs,
                const int* out_addrs, const int* out_rows, int* scratch,
                int* handoff, int* out, int W, int lg, int n_addr, int ring,
                int one_barrier) {
  using Rec = typename std::conditional<kShared, NarrowRec, WideRec>::type;
  extern __shared__ int4 smem[];
  Rec* slots = reinterpret_cast<Rec*>(smem);
  int* after = reinterpret_cast<int*>(slots + ring * n_unit);
  const int bw = 1 << lg;
  const int c0 = static_cast<int>(blockIdx.x) * bw;
  View v;
  v.lg = lg;
  v.c0 = c0;
  v.W = W;
  v.ncols = min(bw, W - c0);
  v.base = kShared ? after : scratch + c0;
  v.ld = kShared ? bw : W;
  int* res = kShared ? after + n_addr * bw : after;
  // the device variant's thread: one column, lanes lane0 + j * stride
  const int col = kShared ? 0 : threadIdx.x & (bw - 1);
  const int lane0 = kShared ? threadIdx.x : threadIdx.x >> lg;
  const int stride = kShared ? blockDim.x : blockDim.x >> lg;
  const bool col_ok = kShared || col < v.ncols;
  Row<kCols>* const rows = reinterpret_cast<Row<kCols>*>(after);
  int* const col_base = v.base + col;
  auto at = [&](int r) -> int* {
    return col_base + static_cast<size_t>(r) * W;
  };

  // the ring (ring is 0, 2 or 4): step t's records sit in slot t & (ring-1)
  auto fetch = [&](int t) {
    if (t < total_steps) {
      Rec* dst = slots + (t & (ring - 1)) * n_unit;
      const Rec* src = recs + static_cast<size_t>(t) * n_unit;
      for (int u = threadIdx.x; u < n_unit; u += blockDim.x)
        cp_async(dst + u, src + u, static_cast<int>(sizeof(Rec)));
    }
    cp_commit();
  };
  if (ring) {
    for (int t = 0; t < ring - 1; ++t) fetch(t);
    cp_wait(ring - 2);  // step 0's records, published by the next barrier
  }

  for (int k = 0; k < n_stages; ++k) {
    const int* m = stage_table + 5 * k;
    const int step_lo = m[0], step_hi = m[1], n_in = m[2], n_out = m[3],
              out_lo = m[4];
    init_scratch(v, (chain && k > 0) ? handoff : inputs, n_in);
    __syncthreads();
    for (int s = step_lo; s < step_hi; ++s) {
      if (ring) fetch(s + ring - 1);  // into step s-1's slot, read by now
      // the shared variant always has a ring, so its records are read
      // from shared memory
      const Rec* rec = (kShared || ring)
                           ? slots + (s & (ring - 1)) * n_unit
                           : recs + static_cast<size_t>(s) * n_unit;
      if (one_barrier) {
        if (col_ok) {
          for (int u = lane0; u < n_unit; u += stride) {
            const Lane l = decode(rec[u]);
            if constexpr (kShared) {
              rows[l.d] = apply_row<kCols>(l.tt, rows[l.a], rows[l.b]);
            } else {
              *at(l.d) = apply_tt(l.tt, *at(l.a), *at(l.b));
            }
          }
        }
      } else {
        if (col_ok) {
          for (int u = lane0; u < n_unit; u += stride) {
            const Lane l = decode(rec[u]);
            if constexpr (kShared) {
              reinterpret_cast<Row<kCols>*>(res)[u] =
                  apply_row<kCols>(l.tt, rows[l.a], rows[l.b]);
            } else {
              res[(u << lg) + col] = apply_tt(l.tt, *at(l.a), *at(l.b));
            }
          }
        }
        __syncthreads();  // every read of step s before any write of it
        if (col_ok) {
          for (int u = lane0; u < n_unit; u += stride) {
            const int d = decode(rec[u]).d;
            if constexpr (kShared) {
              rows[d] = reinterpret_cast<Row<kCols>*>(res)[u];
            } else {
              *at(d) = res[(u << lg) + col];
            }
          }
        }
      }
      if (ring) cp_wait(ring - 2);  // step s+1's records have landed
      __syncthreads();  // step s's writes (and s+1's records) before s+1
    }
    if (!chain) {
      gather(v, out_addrs + out_lo, out_rows + out_lo, n_out, out);
    } else {
      gather(v, out_addrs + out_lo, nullptr, n_out,
             k + 1 == n_stages ? out : handoff);
    }
    __syncthreads();  // the gather's reads before the next stage's re-init
  }
}

// Launch one instantiation, first raising its dynamic shared-memory limit
// when this launch needs more than it was given on this device so far
// (cudaFuncSetAttribute is not free, so it runs once per new maximum).
template <bool kShared, int kCols>
cudaError_t launch(const void* recs, int total_steps, const int* stage_table,
                   int n_stages, int chain, int n_unit, const int* inputs,
                   const int* out_addrs, const int* out_rows, int* scratch,
                   int* handoff, int* out, int W, int lg, int n_addr,
                   int ring, int one_barrier, int threads, int smem,
                   cudaStream_t stream) {
  using Rec = typename std::conditional<kShared, NarrowRec, WideRec>::type;
  constexpr int kDevices = 64;
  static int granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && smem > granted[dev % kDevices]) {
    err = cudaFuncSetAttribute(mega_kernel<kShared, kCols>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    granted[dev % kDevices] = smem;
  }
  const int bw = 1 << lg;
  mega_kernel<kShared, kCols>
      <<<(W + bw - 1) / bw, threads, smem, stream>>>(
          static_cast<const Rec*>(recs), total_steps, stage_table, n_stages,
          chain, n_unit, inputs, out_addrs, out_rows, scratch, handoff, out,
          W, lg, n_addr, ring, one_barrier);
  return cudaGetLastError();
}

}  // namespace

// Launcher with a plain C interface, bound from Python with ctypes.  `recs`
// are (total_steps, n_unit) records, 8 bytes each for the shared-memory
// variant and 16 for the device-memory one; `scratch` is used (and may be
// null) only by the latter; bw = 1 << lg (1 or 2 for the shared variant).
// The block's `threads` and dynamic shared memory `smem` (bytes) are the
// wrapper's launch plan (kernel.py), the one place that sizes a launch.
// It returns the CUDA error of the launch (0 = success).
extern "C" {

int logic_dsp_mega(const void* recs, int total_steps, const int* stage_table,
                   int n_stages, int chain, int n_unit, const int* inputs,
                   const int* out_addrs, const int* out_rows, int* scratch,
                   int* handoff, int* out, int W, int lg, int n_addr,
                   int shared, int ring, int one_barrier, int threads,
                   int smem, void* stream) {
  if (threads < 1 || threads > kMaxThreads || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(S, C)                                                 \
  launch<S, C>(recs, total_steps, stage_table, n_stages, chain, n_unit,    \
               inputs, out_addrs, out_rows, scratch, handoff, out, W, lg,  \
               n_addr, ring, one_barrier, threads, smem, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (!shared) {
    err = REPRO_LAUNCH(false, 1);
  } else if (lg == 0) {
    err = REPRO_LAUNCH(true, 1);
  } else if (lg == 1) {
    err = REPRO_LAUNCH(true, 2);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(err);
}

// The CUDA error text behind a return code of this library's launchers
// (this one, xnor_gemm_launch, bitpack_pack and bitpack_unpack), for the
// Python wrappers' exceptions.
const char* repro_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
