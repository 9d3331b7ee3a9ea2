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
// end.  Dispatch is banked as in the reference: step_branch[s] < 9 applies
// that one opcode to every lane, 9 (MIXED_DISPATCH) selects per lane.
//
// Design.  Word columns are independent, so a thread block owns a
// contiguous slice of `bw` columns (the wrapper picks 2, narrower only when
// the step results would not fit shared memory) and runs every lane of
// every step for them.  The scratch is a row-major (n_addr, W) int32 device buffer that the
// wrapper allocates (neighbouring threads touch neighbouring words of a
// row); at the LeNet-5 fc1 width it is some 14,500 rows, 58 KB a column, far
// past a block's shared memory, so it lives in device memory and stays
// L2-resident.  Within a step every operand read happens before any result
// is written: results go to shared memory, then __syncthreads, scatter,
// __syncthreads.  The kernel does not rely on the scheduler's guarantee that
// a row freed by a read is reused only at the next step.  NOP padding lanes
// of a step all write that program's trash row, all with the same value
// (the step's op on rows 0 and 0); nothing reads the trash row, so the
// duplicate writes are benign.
//
// What bounds it on the card: the work is two L2 reads and one L2 write per
// lane and column, with a dependent index load in front of each read, so a
// step is latency-bound on L2 round trips and on the two block barriers;
// the bytes a wave must move (inputs in, outputs out) are a small part.
// What the simple design leaves on the table: scratch in device memory
// instead of shared memory, one barrier pair per step, and no overlap of
// one step's index loads with the previous step's scatter.

#include <cuda_runtime.h>

namespace {

constexpr int kMixedDispatch = 9;  // gate_ir.MIXED_DISPATCH
constexpr int kMaxThreads = 256;

__device__ __forceinline__ int apply_op(int op, int a, int b) {
  switch (op) {
    case 1: return a & b;     // AND
    case 2: return a | b;     // OR
    case 3: return a ^ b;     // XOR
    case 4: return ~(a & b);  // NAND
    case 5: return ~(a | b);  // NOR
    case 6: return ~(a ^ b);  // XNOR
    case 7: return ~a;        // NOT (a ^ -1)
    case 8: return a;         // COPY
    default: return 0;        // NOP
  }
}

// The block's slice of word columns [c0, c0 + bw) of row-major (rows, W)
// arrays; columns at or past W (the ragged last block) are skipped.
struct Cols {
  int c0;
  int bw;
  int W;
};

__device__ __forceinline__ size_t at(int row, int col, int W) {
  return static_cast<size_t>(row) * W + col;
}

// Rows 0..1+n_in of the block's columns: const0, const1, then the stage's
// inputs from `feed`.  The other rows are left as they are: a valid
// program reads them only after a write in the same stage.
__device__ void init_scratch(int* scratch, const int* feed, int n_in,
                             Cols c) {
  const int n = (2 + n_in) * c.bw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / c.bw;
    const int col = c.c0 + i % c.bw;
    if (col >= c.W) continue;
    const int v = row == 0 ? 0 : row == 1 ? -1 : feed[at(row - 2, col, c.W)];
    scratch[at(row, col, c.W)] = v;
  }
}

// Steps [lo, hi) over the block's columns; `res` is n_unit * bw ints of
// shared memory.  A zero-step range touches no stream pointer (they may be
// null for an empty stream).  Ends on a barrier when it runs any step.
__device__ void run_steps(int* scratch, const int* src_a, const int* src_b,
                          const int* dst, const int* opcode,
                          const int* step_branch, int lo, int hi, int n_unit,
                          Cols c, int* res) {
  const int n = n_unit * c.bw;
  for (int s = lo; s < hi; ++s) {
    const int branch = step_branch[s];
    const size_t base = static_cast<size_t>(s) * n_unit;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int lane = i / c.bw;
      const int col = c.c0 + i % c.bw;
      if (col >= c.W) continue;
      const int a = scratch[at(src_a[base + lane], col, c.W)];
      const int b = scratch[at(src_b[base + lane], col, c.W)];
      const int op = branch < kMixedDispatch ? branch : opcode[base + lane];
      res[i] = apply_op(op, a, b);
    }
    __syncthreads();  // every read of step s before any write of it
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int lane = i / c.bw;
      const int col = c.c0 + i % c.bw;
      if (col >= c.W) continue;
      scratch[at(dst[base + lane], col, c.W)] = res[i];
    }
    __syncthreads();  // step s's writes before step s+1's reads
  }
}

// dest[rows ? rows[j] : j] = scratch[addrs[j]] for j < n_out.
__device__ void gather(const int* scratch, const int* addrs, const int* rows,
                       int n_out, int* dest, Cols c) {
  const int n = n_out * c.bw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i / c.bw;
    const int col = c.c0 + i % c.bw;
    if (col >= c.W) continue;
    const int row = rows ? rows[j] : j;
    dest[at(row, col, c.W)] = scratch[at(addrs[j], col, c.W)];
  }
}

// K2: the stage table is (n_stages, 5) int32 rows (step_lo, step_hi, n_in,
// n_out, out_lo).  Every stage re-initializes rows 0..1+n_in, because the
// liveness allocator may have reused const or input rows as gate rows in the
// stage before.  Chain mode hands stage k's outputs to stage k+1 through
// `handoff`, a (max n_out, W) device buffer of which each block uses only
// its own columns; the last stage writes `out`.  Parallel mode reads the
// primary inputs in every stage and writes each stage output j straight to
// its permuted row out_rows[out_lo + j].
__global__ void mega_kernel(const int* src_a, const int* src_b,
                            const int* dst, const int* opcode,
                            const int* step_branch, const int* stage_table,
                            int n_stages, int chain, int n_unit,
                            const int* inputs, const int* out_addrs,
                            const int* out_rows, int* scratch, int* handoff,
                            int* out, int W, int bw) {
  extern __shared__ int res[];
  const Cols c{static_cast<int>(blockIdx.x) * bw, bw, W};
  for (int k = 0; k < n_stages; ++k) {
    const int* m = stage_table + 5 * k;
    const int step_lo = m[0], step_hi = m[1], n_in = m[2], n_out = m[3],
              out_lo = m[4];
    const int* feed = (chain && k > 0) ? handoff : inputs;
    init_scratch(scratch, feed, n_in, c);
    __syncthreads();
    run_steps(scratch, src_a, src_b, dst, opcode, step_branch, step_lo,
              step_hi, n_unit, c, res);
    if (!chain) {
      gather(scratch, out_addrs + out_lo, out_rows + out_lo, n_out, out, c);
    } else {
      gather(scratch, out_addrs + out_lo, nullptr, n_out,
             k + 1 == n_stages ? out : handoff, c);
    }
    __syncthreads();  // the gather's reads before the next stage's re-init
  }
}

int threads_for(int n_unit, int bw) {
  const int n = n_unit * bw;
  const int t = (n + 31) / 32 * 32;
  return t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
}

cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mega_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Launcher with a plain C interface, bound from Python with ctypes.  It
// returns the cudaGetLastError() that follows the launch (0 = success).
extern "C" {

int logic_dsp_mega(const int* src_a, const int* src_b, const int* dst,
                   const int* opcode, const int* step_branch,
                   const int* stage_table, int n_stages, int chain,
                   int n_unit, const int* inputs, const int* out_addrs,
                   const int* out_rows, int* scratch, int* handoff, int* out,
                   int W, int bw, void* stream) {
  const size_t smem = static_cast<size_t>(n_unit) * bw * sizeof(int);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (W + bw - 1) / bw;
  mega_kernel<<<blocks, threads_for(n_unit, bw), smem,
                static_cast<cudaStream_t>(stream)>>>(
      src_a, src_b, dst, opcode, step_branch, stage_table, n_stages, chain,
      n_unit, inputs, out_addrs, out_rows, scratch, handoff, out, W, bw);
  return static_cast<int>(cudaGetLastError());
}

const char* logic_dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
