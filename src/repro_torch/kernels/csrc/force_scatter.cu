// Force scatter: the backward of the neighbour gather coords[idx] of the DP
// force path, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes.
//
// Not a TPU kernel: in the JAX reference the gradient of the gather
// (repro/dp/model.py::_atomic_e, coords[safe]) is XLA's scatter-add.  It
// is DeePMD-kit's prod_force op: the per-pair cotangents of the neighbour
// coordinates summed onto the atoms they came from.  PyTorch's own backward
// of the gather (indexing_backward_kernel) sorts all N x K slots, padded
// ones included, and every padded slot points at atom 0, so one segment of
// the sort holds about two thirds of the entries and is added one by one.
//
// Here the wrapper (force_scatter.py::reverse_list) builds a reverse list:
// the valid slots (idx >= 0, mask > 0), ordered by destination atom and,
// within an atom, by ascending flat slot i*K + k (a stable sort), with the
// segment offsets.  Masked and padded slots are not in it.  One warp per
// atom: the lanes load up to 32 of the atom's 12-byte cotangent rows at
// once (memory-level parallelism), then every lane adds them in list order
// from +0.0 with __fadd_rn (no contraction, order fixed), so the sum has
// the bits of the plain version, index_add_ over the valid slots in
// ascending flat order, and a repeated call gives the same bits.
//
// Bound: device-memory bytes.  The valid cotangent rows (12 B each), the
// list (8 B per valid slot) and offsets (8 B per atom) read, 12 B per atom
// written: ~9 MB at N = 15,668, K = 82, a few microseconds at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 8 atoms per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
force_scatter_kernel(const float* __restrict__ g,
                     const long long* __restrict__ perm,
                     const long long* __restrict__ off,
                     float* __restrict__ out, int n) {
  const long long atom = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (atom >= n) return;                 // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long p0 = __ldg(off + atom), p1 = __ldg(off + atom + 1);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (long long base = p0; base < p1; base += 32) {
    float vx = 0.f, vy = 0.f, vz = 0.f;
    if (base + lane < p1) {
      const float* row = g + 3 * __ldg(perm + base + lane);
      vx = __ldg(row);
      vy = __ldg(row + 1);
      vz = __ldg(row + 2);
    }
    const int cnt = (int)min(32LL, p1 - base);
    for (int t = 0; t < cnt; ++t) {
      ax = __fadd_rn(ax, __shfl_sync(kFull, vx, t));
      ay = __fadd_rn(ay, __shfl_sync(kFull, vy, t));
      az = __fadd_rn(az, __shfl_sync(kFull, vz, t));
    }
  }
  if (lane == 0) {
    out[3 * atom] = ax;
    out[3 * atom + 1] = ay;
    out[3 * atom + 2] = az;
  }
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// out (n, 3) = per-atom sums of g (rows of 3 floats) over the reverse list
// perm (valid slots by atom), off (n + 1) its segment offsets
int force_scatter(const float* g, const long long* perm, const long long* off,
                  float* out, int n, void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  if (n > 0) {
    const long long blocks = ((long long)n + kThreads / 32 - 1) / (kThreads / 32);
    force_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, perm, off, out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
