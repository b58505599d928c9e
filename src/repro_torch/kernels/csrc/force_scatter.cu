// Force scatter: the backward of the neighbour gather coords[idx] (the DP
// force path, the classical force field's pair and bonded tables) and the
// DD force reduction, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes.
//
// Not a TPU kernel: in the JAX reference the gradient of the gather
// (repro/dp/model.py::_atomic_e, coords[safe]) is XLA's scatter-add.  It
// is DeePMD-kit's prod_force op: the per-pair cotangents of the neighbour
// coordinates summed onto the atoms they came from.
//
// Contract: out[j] = the sum of the rows g[s] (3 floats) over the valid
// slots s (idx[s] == j, mask[s] > 0) from +0.0, one __fadd_rn per slot in
// ascending flat order s = i*K + k: the bits of index_add_ over the valid
// slots in ascending order (force_scatter.py::force_scatter_plain), on
// every call.
//
// Two parts, one C entry each.
//
// (1) force_scatter_list_i32 / _i64 build the reverse list: the valid flat
// slots ordered by destination atom and, within an atom, ascending, with
// the atoms' segment starts.  A stable LSD radix sort by hand: 32-bit keys
// (the atom) and 32-bit values (the flat slot), 8-bit digits, one pass per
// byte of the largest key (2 passes up to 65,536 atoms, 3 up to 2^24).
// Each pass is three kernels over tiles of 4,096 entries: a histogram of
// each tile's digits, radix_scan (one block per digit: the tiles' first
// places) and radix_scatter, which ranks each tile warp by warp over
// contiguous runs of 512 entries, lane by lane with __match_any_sync,
// stages it in shared memory in digit order and writes each digit's run to
// its place.  A slot's place follows tile, warp, round and lane order,
// never an atomic, so every pass is stable and each atom keeps its slots in
// ascending flat order whatever its segment's length (one atom holding
// every slot included).  idx and mask are read once, 16 bytes a load, by
// first_count, the first pass's histogram: it drops masked, padded and
// out-of-range slots and writes each tile's valid ones, in order, to the
// tile's own stretch of scratch, which the first scatter reads (the
// classical pair table keeps 2.3M of its 47.8M slots); a warp stops at the
// first round past its tile's valid entries.  Later passes sort the V valid
// slots only, V read on the card (no host sync: their grids are sized for
// every slot and the tiles past V return at once).  The last pass writes
// the sorted keys beside the list; list_offsets finds each atom's segment
// start by a binary search over them.  Histograms are digit-major, so each
// digit's counts over the tiles are one stretch for radix_scan.
//
// (2) force_scatter_sum: each block of 96 threads owns 32 atoms (one thread
// per atom and component) and the contiguous stretch of the list they
// hold.  It stages that stretch 1,024 entries at a time: every thread loads
// list entries and their rows' floats (32 loads in flight a thread, the 3
// floats of a row by 3 neighbouring threads) into shared memory, then each
// thread adds its atom's entries of the stage in list order, 8 shared
// loads ahead of 8 adds.  A long segment (the DD force reduction piles each
// rank's padded rows onto one atom) costs its thread a chain of adds from
// shared memory, not a chain of loads from device memory; an atom with no
// slot costs its threads two loads.  No atomics on floats.
//
// Bound: device-memory bytes.  Sums: the valid rows (12 B), the list (4 B
// a slot) and offsets (4 B an atom) read, 12 B an atom written.  List: idx
// and mask read once.  The sort moves more: the first pass writes and
// reads each valid slot's key and value twice, each later pass reads 4 + 8
// B and writes 8 B per valid slot.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // one thread per digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kNone = kRadix;                 // digit of an invalid entry
constexpr int kRounds = 16;                   // entries per lane and tile
constexpr int kPerWarp = 32 * kRounds;        // a warp's contiguous run
constexpr int kTile = kWarps * kPerWarp;      // 4,096 entries
constexpr int kVec = 4;                       // slots per load in first_count
constexpr unsigned kFull = 0xffffffffu;

// The sorting passes' input: entries [first, limit) of (keys, vals).
// Later passes read the previous pass's V entries; the first pass's
// scatter reads each tile's valid slots as first_count compacted them.
struct Sorted {
  const int* keys;
  const int* vals;
  const int* nvalid;
  __device__ __forceinline__ long long limit() const { return *nvalid; }
  __device__ __forceinline__ bool load(long long s, long long lim, int& key,
                                       int& val) const {
    key = val = 0;
    if (s >= lim) return false;
    key = __ldg(keys + s);
    val = __ldg(vals + s);
    return true;
  }
};

struct Compacted : Sorted {
  const int* count;                           // valid slots of each tile
  __device__ __forceinline__ long long limit() const {
    return (long long)blockIdx.x * kTile + __ldg(count + blockIdx.x);
  }
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive scan of one int per thread over the block; *sum gets the total.
// s_warp: kWarps ints of shared memory; ends with a __syncthreads.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* sum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int c = s_warp[u];
    before += u < w ? c : 0;
    all += c;
  }
  __syncthreads();
  *sum = all;
  return before + incl - v;
}

__device__ __forceinline__ int digit_of(bool ok, int key, int shift) {
  return ok ? (key >> shift) & (kRadix - 1) : kNone;
}

// kVec consecutive entries from p (16-byte aligned), or those below lim.
__device__ __forceinline__ void load_vec(const int* p, long long s,
                                         long long lim, int (&o)[kVec]) {
  if (s + kVec <= lim) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + s));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = s + j < lim ? __ldg(p + s + j) : -1;
  }
}

__device__ __forceinline__ void load_vec(const long long* p, long long s,
                                         long long lim, long long (&o)[kVec]) {
  if (s + kVec <= lim) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + s));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + s) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = s + j < lim ? __ldg(p + s + j) : -1;
  }
}

__device__ __forceinline__ void load_vec(const float* p, long long s,
                                         long long lim, float (&o)[kVec]) {
  if (s + kVec <= lim) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + s));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = s + j < lim ? __ldg(p + s + j) : 0.f;
  }
}

// The first pass's histogram: tile b's slots (warp w: slots w*512 ..
// w*512 + 511, kVec a lane and round, in flat order), the valid ones
// counted by low digit into hist[d * nb + b] and written, in order, to
// ckeys/cvals from the tile's first place; their number to count[b].
template <typename I>
__global__ void __launch_bounds__(kThreads)
first_count(const I* __restrict__ idx, const float* __restrict__ mask,
            long long slots, int n, int* __restrict__ hist, int nb,
            int* __restrict__ ckeys, int* __restrict__ cvals,
            int* __restrict__ count) {
  constexpr int kLoads = kPerWarp / (32 * kVec);   // 4 rounds of kVec
  __shared__ int s_cnt[kRadix + 1];
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long base = (long long)blockIdx.x * kTile;
  s_cnt[t] = 0;
  if (t == 0) s_cnt[kNone] = 0;
  I key[kLoads][kVec];
  float m[kLoads][kVec];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const long long s = base + w * kPerWarp + r * 32 * kVec + kVec * lane;
    load_vec(idx, s, slots, key[r]);
    load_vec(mask, s, slots, m[r]);
  }
  __syncthreads();
  int at[kLoads], in_run = 0;                // lane's first place in the run
  unsigned okbits = 0;
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool ok = key[r][j] >= 0 && key[r][j] < (I)n && m[r][j] > 0.f;
      okbits |= (unsigned)ok << (r * kVec + j);
      mine += ok;
      const int d = digit_of(ok, (int)key[r][j], 0);
      const unsigned peers = __match_any_sync(kFull, d);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&s_cnt[d], __popc(peers));
    }
    const int incl = warp_inclusive_scan(mine, lane);
    at[r] = in_run + incl - mine;
    in_run += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  hist[(long long)t * nb + blockIdx.x] = s_cnt[t];
  int tile_valid;
  const int before = block_exclusive_scan(lane == 0 ? in_run : 0, s_warp,
                                          &tile_valid);
  const long long first = base + __shfl_sync(kFull, before, 0);
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    int p = at[r];
    const long long s = base + w * kPerWarp + r * 32 * kVec + kVec * lane;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (okbits >> (r * kVec + j) & 1u) {
        ckeys[first + p] = (int)key[r][j];
        cvals[first + p] = (int)(s + j);
        ++p;
      }
    }
  }
  if (t == 0) count[blockIdx.x] = tile_valid;
}

// A later pass's histogram: hist[d * nb + b] = the entries of tile b with
// digit d.
__global__ void __launch_bounds__(kThreads)
radix_hist(Sorted src, int shift, int* __restrict__ hist, int nb) {
  __shared__ int s_cnt[kRadix + 1];
  const long long lim = src.limit();
  const long long base = (long long)blockIdx.x * kTile;
  if (base >= lim) return;                    // block-uniform
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  s_cnt[t] = 0;
  if (t == 0) s_cnt[kNone] = 0;
  int key[kRounds], val[kRounds];
  bool ok[kRounds];
  const long long run = base + (long long)w * kPerWarp;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    ok[r] = src.load(run + 32 * r + lane, lim, key[r], val[r]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (run + 32 * r >= lim) break;           // warp-uniform
    const int d = digit_of(ok[r], key[r], shift);
    const unsigned peers = __match_any_sync(kFull, d);
    if (ok[r] && lane == __ffs(peers) - 1) atomicAdd(&s_cnt[d], __popc(peers));
  }
  __syncthreads();
  hist[(long long)t * nb + blockIdx.x] = s_cnt[t];
}

// Block d: digit d's row over the tiles in use, exclusive in place;
// total[d] their sum.  In the first pass every tile is in use (nvalid null).
__global__ void __launch_bounds__(kThreads)
radix_scan(int* __restrict__ hist, int* __restrict__ total, int nb,
           const int* __restrict__ nvalid) {
  __shared__ int s_warp[kWarps];
  const int used = nvalid ? (int)(((long long)*nvalid + kTile - 1) / kTile) : nb;
  int* row = hist + (long long)blockIdx.x * nb;
  int carry = 0;
  for (int c0 = 0; c0 < used; c0 += 4 * kThreads) {
    const int i0 = c0 + 4 * threadIdx.x;
    int v[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = i0 + q < used ? row[i0 + q] : 0;
      sum += v[q];
    }
    int all;
    int excl = carry + block_exclusive_scan(sum, s_warp, &all);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < used) row[i0 + q] = excl;
      excl += v[q];
    }
    carry += all;
  }
  if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// Tile b's entries to their places: digit d's first place is the count of
// smaller digits over all tiles plus digit d's count in earlier tiles;
// within the tile, warp, round and lane order.  Block 0 of the first pass
// writes V (every block sees the digits' totals).
template <class Src>
__global__ void __launch_bounds__(kThreads)
radix_scatter(Src src, int shift, const int* __restrict__ hist, int nb,
              const int* __restrict__ total, int* __restrict__ keys_out,
              int* __restrict__ vals_out, int* __restrict__ nvalid_out) {
  __shared__ int s_cnt[kWarps][kRadix + 1];   // per warp and digit
  __shared__ int s_first[kRadix];             // global place of the tile's digit run
  __shared__ int s_local[kRadix];             // tile-local start of the digit run
  __shared__ int s_warp[kWarps];
  __shared__ int s_keys[kTile], s_vals[kTile];
  const long long lim = src.limit();
  const long long base = (long long)blockIdx.x * kTile;
  if (base >= lim && blockIdx.x != 0) return;  // block-uniform; 0 writes V
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;

  int all;
  const int tot = total[t];
  const int below = block_exclusive_scan(tot, s_warp, &all);
  if (nvalid_out && blockIdx.x == 0 && t == 0) *nvalid_out = all;
  s_first[t] = below + hist[(long long)t * nb + blockIdx.x];
  for (int d = lane; d <= kRadix; d += 32) s_cnt[w][d] = 0;

  int key[kRounds], val[kRounds];
  bool ok[kRounds];
  const long long run = base + (long long)w * kPerWarp;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    ok[r] = src.load(run + 32 * r + lane, lim, key[r], val[r]);
  __syncwarp();
  // each warp counts its run's digits, up to the tile's last entry
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (run + 32 * r >= lim) break;           // warp-uniform
    const int d = digit_of(ok[r], key[r], shift);
    peers[r] = __match_any_sync(kFull, d);
    if (lane == __ffs(peers[r]) - 1) s_cnt[w][d] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
  // digit t: the tile's count, its tile-local start, each warp's start
  int mine = 0;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) mine += s_cnt[u][t];
  int valid;
  int start = block_exclusive_scan(mine, s_warp, &valid);
  s_local[t] = start;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int c = s_cnt[u][t];
    s_cnt[u][t] = start;
    start += c;
  }
  __syncthreads();
  // stage the tile in digit order
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (run + 32 * r >= lim) break;           // warp-uniform
    const int d = digit_of(ok[r], key[r], shift);
    if (ok[r]) {
      const int p = s_cnt[w][d] + __popc(peers[r] & lower);
      s_keys[p] = key[r];
      s_vals[p] = val[r];
    }
    __syncwarp();
    if (lane == __ffs(peers[r]) - 1) s_cnt[w][d] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
  // each digit's run to its place: consecutive threads, consecutive places
  for (int i = t; i < valid; i += kThreads) {
    const int k = s_keys[i];
    const int d = (k >> shift) & (kRadix - 1);
    const int p = s_first[d] + (i - s_local[d]);
    keys_out[p] = k;
    vals_out[p] = s_vals[i];
  }
}

// off[j] = the first place whose key is >= j (off[n] = V).
__global__ void __launch_bounds__(kThreads)
list_offsets(const int* __restrict__ keys, const int* __restrict__ nvalid,
             int* __restrict__ off, int n) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j > n) return;
  int lo = 0, hi = *nvalid;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(keys + mid) < j) lo = mid + 1;
    else hi = mid;
  }
  off[j] = lo;
}

constexpr int kSumAtoms = 32;                 // atoms a block
constexpr int kSumThreads = 3 * kSumAtoms;    // one per atom and component
constexpr int kStage = 1024;                  // list entries staged at once
constexpr int kSumLoads = 3 * kStage / kSumThreads;  // 32 floats a thread

__global__ void __launch_bounds__(kSumThreads)
segment_sums(const float* __restrict__ g, const int* __restrict__ perm,
             const int* __restrict__ off, float* __restrict__ out, int n) {
  __shared__ float s_rows[3 * kStage];
  const int t = threadIdx.x;
  const long long a0 = (long long)blockIdx.x * kSumAtoms;
  const long long a1 = min((long long)n, a0 + kSumAtoms);
  const long long atom = a0 + t / 3;
  const int c = t % 3;
  const bool mine = atom < a1;
  int p = mine ? __ldg(off + atom) : 0;
  const int p1 = mine ? __ldg(off + atom + 1) : 0;
  const int q1 = __ldg(off + a1);
  float acc = 0.f;
  for (int q0 = __ldg(off + a0); q0 < q1; q0 += kStage) {
    const int len = min(kStage, q1 - q0);
    float v[kSumLoads];
#pragma unroll
    for (int r = 0; r < kSumLoads; ++r) {
      const int i = t + r * kSumThreads;      // float i of the stage
      const int e = i / 3;
      v[r] = e < len ? __ldg(g + 3LL * __ldg(perm + q0 + e) + (i - 3 * e)) : 0.f;
    }
    __syncthreads();                          // the last stage is added
#pragma unroll
    for (int r = 0; r < kSumLoads; ++r) s_rows[t + r * kSumThreads] = v[r];
    __syncthreads();
    const int end = min(p1, q0 + len);
    for (; p + 8 <= end; p += 8) {
      float u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = s_rows[3 * (p + k - q0) + c];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, u[k]);
    }
    for (; p < end; ++p) acc = __fadd_rn(acc, s_rows[3 * (p - q0) + c]);
  }
  if (mine) out[3 * atom + c] = acc;
}

// The list of the valid slots of (idx, mask) (slots entries each, of which
// the first V are the list): perm and keys its values and keys, tmp_keys
// and tmp_vals the other half of the ping-pong (and the first pass's
// compacted tiles), hist 256 x nb, count nb and total 256 ints of scratch
// (nb = ceil(slots / 4096)), nvalid V, off (n + 1) the segment starts.
// slots < 2^31 and idx, mask 16-byte aligned (the wrapper checks both).
template <typename I>
int build_list(const I* idx, const float* mask, long long slots, int n,
               int* keys, int* perm, int* tmp_keys, int* tmp_vals, int* hist,
               int* count, int* total, int* nvalid, int* off,
               cudaStream_t st) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  if (n <= 0) return (int)cudaGetLastError();
  if (slots <= 0) {
    cudaMemsetAsync(nvalid, 0, sizeof(int), st);
    cudaMemsetAsync(off, 0, sizeof(int) * ((size_t)n + 1), st);
    return (int)cudaGetLastError();
  }
  int bits = 0;                               // bits of the largest key, n - 1
  while (bits < 31 && ((n - 1) >> bits) != 0) ++bits;
  const int passes = bits > 8 ? (bits + 7) / 8 : 1;
  const int nb = (int)((slots + kTile - 1) / kTile);
  // pass p writes (keys, perm) when passes - 1 - p is even, so the last
  // pass lands there; the first pass compacts into the other pair
  int* ko[2] = {keys, tmp_keys};
  int* vo[2] = {perm, tmp_vals};
  const int first = (passes - 1) % 2;
  first_count<I><<<nb, kThreads, 0, st>>>(idx, mask, slots, n, hist, nb,
                                          ko[1 - first], vo[1 - first], count);
  radix_scan<<<kRadix, kThreads, 0, st>>>(hist, total, nb, nullptr);
  Compacted tiles;
  tiles.keys = ko[1 - first];
  tiles.vals = vo[1 - first];
  tiles.nvalid = nvalid;
  tiles.count = count;
  radix_scatter<Compacted><<<nb, kThreads, 0, st>>>(
      tiles, 0, hist, nb, total, ko[first], vo[first], nvalid);
  for (int p = 1; p < passes; ++p) {
    const int in = (passes - p) % 2, to = (passes - 1 - p) % 2;
    const Sorted src{ko[in], vo[in], nvalid};
    radix_hist<<<nb, kThreads, 0, st>>>(src, 8 * p, hist, nb);
    radix_scan<<<kRadix, kThreads, 0, st>>>(hist, total, nb, nvalid);
    radix_scatter<Sorted><<<nb, kThreads, 0, st>>>(src, 8 * p, hist, nb, total,
                                                   ko[to], vo[to], nullptr);
  }
  const long long blocks = ((long long)n + 1 + kThreads - 1) / kThreads;
  list_offsets<<<(unsigned)blocks, kThreads, 0, st>>>(keys, nvalid, off, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

int force_scatter_list_i32(const int* idx, const float* mask, long long slots,
                           int n, int* keys, int* perm, int* tmp_keys,
                           int* tmp_vals, int* hist, int* count, int* total,
                           int* nvalid, int* off, void* stream) {
  return build_list(idx, mask, slots, n, keys, perm, tmp_keys, tmp_vals, hist,
                    count, total, nvalid, off, (cudaStream_t)stream);
}

int force_scatter_list_i64(const long long* idx, const float* mask,
                           long long slots, int n, int* keys, int* perm,
                           int* tmp_keys, int* tmp_vals, int* hist, int* count,
                           int* total, int* nvalid, int* off, void* stream) {
  return build_list(idx, mask, slots, n, keys, perm, tmp_keys, tmp_vals, hist,
                    count, total, nvalid, off, (cudaStream_t)stream);
}

// out (n, 3) = per-atom sums of g (rows of 3 floats) over the reverse list
// perm (valid slots by atom), off (n + 1) its segment starts
int force_scatter_sum(const float* g, const int* perm, const int* off,
                      float* out, int n, void* stream) {
  cudaGetLastError();
  if (n > 0) {
    const long long blocks = ((long long)n + kSumAtoms - 1) / kSumAtoms;
    segment_sums<<<(unsigned)blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
        g, perm, off, out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
