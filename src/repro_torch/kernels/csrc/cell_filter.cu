// Cell-candidate distance filter with the candidate gather fused in, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces repro/kernels/cell_gather.py::_cell_filter_kernel (cell_filter).
// The TPU kernel took (C, M) displacement planes that XLA had gathered into
// device memory; here the kernel takes the buffer coordinates (C, 3), the
// candidate or list indices (C, M) int32 (-1 = none) and the buffer mask
// (C,), gathers the two positions itself and writes the (C, M) flags, so
// the (C, M, 3) displacement tensor never reaches device memory.
//
// Flag (i, j) = idx >= 0 && idx != i && mask[i] > 0 && d2 < thr, with
// d2 = (dx*dx + dy*dy) + dz*dz and dx = x[idx] - x[i].  Every operation is
// an explicitly rounded intrinsic in the plain version's order, so the
// compiler cannot contract a multiply-add into an FMA: a pair at |d| ~ rcut
// gets the same flag as on the CPU, bit for bit.  thr is the fp32 rounding
// of rcut * rcut formed in double (the wrapper passes it).
//
// Bound: device-memory bytes (4 bytes of index in and 1 byte of flag out per
// entry, plus 16 bytes per row); no reuse, so one thread per entry with a
// grid-stride loop.  Neighbouring threads read neighbouring indices; the
// gathered coordinates come from a few cells and hit in L1/L2.
#include <cuda_runtime.h>

namespace {

__global__ void cell_filter_kernel(const float* __restrict__ xyz,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ mask,
                                   unsigned char* __restrict__ out,
                                   long long total, int m, float thr) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / m;
    const int j = __ldg(idx + e);
    unsigned char flag = 0;
    if (j >= 0 && j != i && __ldg(mask + i) > 0.f) {
      const float dx = __fsub_rn(__ldg(xyz + 3 * (long long)j), __ldg(xyz + 3 * i));
      const float dy = __fsub_rn(__ldg(xyz + 3 * (long long)j + 1), __ldg(xyz + 3 * i + 1));
      const float dz = __fsub_rn(__ldg(xyz + 3 * (long long)j + 2), __ldg(xyz + 3 * i + 2));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      flag = d2 < thr;
    }
    out[e] = flag;
  }
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int cell_filter(const float* xyz, const int* idx, const float* mask,
                unsigned char* out, long long rows, int m, float thr,
                void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  const long long total = rows * (long long)m;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  cell_filter_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      xyz, idx, mask, out, total, m, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
