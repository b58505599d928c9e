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
// Bound: device-memory bytes (4 bytes of index in per entry of a row whose
// mask is > 0, 1 byte of flag out per entry, 16 bytes per row); no reuse.
// Design (cell_filter_rows_kernel): one warp per row, so the row index
// comes from the block and warp numbers (no division per entry) and the
// row's centre position and mask are read once into registers.  The row's entries are split into a head of at most
// 3 entries, a body read 16 bytes at a time (int4: four indices) and
// written 4 flags at a time (uchar4), and a tail of at most 3; the head
// makes the body start on a 16-byte boundary whatever M is, so every row,
// M % 4 != 0 included, takes the vector body.  A row whose mask is not > 0
// writes zeros without reading its indices.  The grid is one block of 8
// warps per 8 rows, sized to the work.  The gathered coordinates come from
// a few cells and hit in L1/L2.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ unsigned char flag(const float* __restrict__ xyz,
                                              int j, long long i, float xi,
                                              float yi, float zi, float thr) {
  if (j < 0 || j == i) return 0;
  const float dx = __fsub_rn(__ldg(xyz + 3 * (long long)j), xi);
  const float dy = __fsub_rn(__ldg(xyz + 3 * (long long)j + 1), yi);
  const float dz = __fsub_rn(__ldg(xyz + 3 * (long long)j + 2), zi);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 < thr;
}

// One warp per row.  vec: idx and out are aligned so that the flat entry e
// is 16-byte aligned in idx exactly when it is 4-byte aligned in out (else
// every row is read entry by entry).
__global__ void __launch_bounds__(kThreads)
cell_filter_rows_kernel(const float* __restrict__ xyz,
                        const int* __restrict__ idx,
                        const float* __restrict__ mask,
                        unsigned char* __restrict__ out, long long rows, int m,
                        float thr, int vec) {
  const long long i = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= rows) return;                 // warp-uniform
  const int lane = threadIdx.x & 31;
  const int* irow = idx + i * m;
  unsigned char* orow = out + i * m;
  // head: the entries before the first 16-byte boundary of the index row
  const int head =
      min(m, vec ? (int)(((16 - ((uintptr_t)irow & 15)) & 15) >> 2) : m);
  const int nvec = (m - head) >> 2;
  const int tail = head + 4 * nvec;
  const int4* ivec = reinterpret_cast<const int4*>(irow + head);
  uchar4* ovec = reinterpret_cast<uchar4*>(orow + head);
  if (!(__ldg(mask + i) > 0.f)) {        // all flags 0, indices unread
    for (int c = lane; c < head; c += 32) orow[c] = 0;
    for (int v = lane; v < nvec; v += 32) ovec[v] = make_uchar4(0, 0, 0, 0);
    for (int c = tail + lane; c < m; c += 32) orow[c] = 0;
    return;
  }
  const float xi = __ldg(xyz + 3 * i), yi = __ldg(xyz + 3 * i + 1),
              zi = __ldg(xyz + 3 * i + 2);
  for (int c = lane; c < head; c += 32)
    orow[c] = flag(xyz, __ldg(irow + c), i, xi, yi, zi, thr);
  for (int v = lane; v < nvec; v += 32) {
    const int4 j = __ldg(ivec + v);
    ovec[v] = make_uchar4(flag(xyz, j.x, i, xi, yi, zi, thr),
                          flag(xyz, j.y, i, xi, yi, zi, thr),
                          flag(xyz, j.z, i, xi, yi, zi, thr),
                          flag(xyz, j.w, i, xi, yi, zi, thr));
  }
  for (int c = tail + lane; c < m; c += 32)
    orow[c] = flag(xyz, __ldg(irow + c), i, xi, yi, zi, thr);
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int cell_filter(const float* xyz, const int* idx, const float* mask,
                unsigned char* out, long long rows, int m, float thr,
                void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  if (rows > 0 && m > 0) {
    const int vec = ((uintptr_t)idx & 15) == 0 && ((uintptr_t)out & 3) == 0;
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    cell_filter_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        xyz, idx, mask, out, rows, m, thr, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
