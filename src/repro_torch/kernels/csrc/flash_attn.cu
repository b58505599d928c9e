// Blockwise (flash) attention forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces repro/kernels/flash_attn.py::_flash_kernel (flash_attention):
// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) with Hq % Hkv == 0, fp32 or bf16 in,
// output in q's type; the prefill kernels also take a value width DV other
// than D (MLA: q/k 192, v 128, as the JAX LM's chunked_attention does; the
// output is then (B, Hq, Sq, DV)).  Scores s = (q . k) / sqrt(D) in fp32, optionally
// soft-capped (softcap * tanh(s / softcap)); key j is visible to query i
// (absolute position q_offset + i) when j < Sk, and, as asked, causally
// (q_offset + i >= j) and inside the window ((q_offset + i) - j < window).
// Online softmax with running (m, l, acc) in fp32; a row with no visible
// key gives exactly 0, as in the Pallas kernel.  Unlike the Pallas kernel,
// which pads K and V to its block and masks only the causal and window
// conditions, keys j >= Sk are masked explicitly.
//
// What bounds it on the H100: at prefill (many query rows per KV head) the
// visible-pair FLOPs (4 D per pair and q head) against the tensor cores'
// bf16 peak (989 TFLOP/s); at decode (group * Sq <= 16 rows per KV head)
// the bytes of the visible K and V rows, read once per KV head: ~1 FLOP per
// byte, so neither the tensor cores nor the FMA rate matter there, only
// keeping enough loads in flight on every SM (3.35 TB/s over 132 SMs and
// ~1 us of latency: ~25 KB per SM at all times) and launching no more CTAs
// than one wave.
//
// Three kernels, by rows per KV head (group * Sq) and dtype:
//
// * bf16 prefill (group * Sq > 16): flash_fwd_wgmma_kernel, on Hopper's
//   tensor-core path.  One CTA of three warpgroups per (b, kv head, 128
//   query rows), the row blocks that see the most keys first:
//   - Producer warpgroup (setmaxnreg 40): one thread streams the CTA's
//     visible KV blocks (BK keys) by TMA (cp.async.bulk.tensor.4d over a
//     (D, Sk, Hkv, B) tensor map built on the host from the view's
//     strides, cuTensorMapEncodeTiled taken from the driver through
//     cudaGetDriverEntryPoint, so no -lcuda; a __grid_constant__
//     parameter, so a captured call replays) into a ring of STAGES stages
//     (K and V of a stage on full mbarriers of their own, one empty
//     mbarrier a stage).  TMA zero-fills rows past Sk; they are masked all
//     the same.  Tiles are swizzled 128 B (64 B at D = 32), as the wgmma
//     descriptors read them.
//   - Two consumer warpgroups (setmaxnreg 232), 64 query rows each: Q by
//     16-byte loads into the swizzled layout (rows r = i * group + g, so
//     one K/V tile serves every q head of the group; 128 rows need not
//     split into whole heads); S = Q K^T as wgmma.mma_async m64n{BK}k16
//     (Q and K K-major in shared memory, fp32 sums in registers); the
//     online softmax in registers, in log2 units, masks only on the
//     blocks that need them, and a warpgroup skips (waits for and
//     releases) the blocks none of its rows sees; O += P V as
//     m64n{DV}k16 with A = P from registers (the accumulator fragment
//     rounded to bf16 in place, as the JAX LM's chunked_attention rounds
//     P; the TPU kernel and the plain version keep P in fp32: up to ~2^-9
//     of each probability, inside the 1e-2 x max gate) and B = V MN-major
//     through the transpose bit (no transposed copy).  Block it's S is
//     issued with block it - 1's P V, and the softmax of block it runs
//     while the latter does.  Epilogue: O / l as bf16, lse = m ln 2 + log
//     l.
//   - Instances (BK, STAGES; shared memory = 1 KB of alignment + Q 128 x
//     DK + STAGES x BK x (DK + DV), bf16): (32, 32) 128, 4: 73 KB; (64,
//     64) 128, 3: 113 KB; (128, 128) 128, 2: 161 KB; (192, 128) 128, 2:
//     209 KB; (256, 256) 64, 2: 193 KB.  One CTA a SM.  Registers: 168 a
//     thread at launch (384 threads), the consumers' output accumulator
//     DV / 2 and scores BK / 2 floats a thread; -Xptxas -v (printed by
//     chip_smoke.py): no spills.
//   - A wait on an mbarrier that lasts over 10 s traps (a launch error the
//     wrapper raises) instead of hanging the card.
//   - On the H100 (PERF.md, row 6a): 1.3-2.3x faster than the mma.sync
//     kernel it replaced at every LM path's shape in one call, at 11-40%
//     of the bound; short loops (few KV blocks a CTA) pay each stage's
//     load latency, since a stage is refilled only after its P V.  Every
//     (DK, DV) runs here, (32, 32) too, though no path calls it and it is
//     slower than the mma.sync kernel was (q (4, 16, 2048, 32), causal:
//     0.330-0.334 ms against 0.254-0.255 in one call).
// * fp32 prefill (group * Sq > 16): flash_fwd_kernel, fp32 FMAs from shared
//   memory, 256 threads as 16 x 16, 64 rows per CTA.  fp32 stays off the
//   tensor cores because fp32 inputs there mean TF32, which would break the
//   fp32 gate (atol 1e-4 x max) of the card-vs-CPU LM check and
//   tests/test_torch_card.py.
// * decode, fp32 and bf16 (group * Sq <= 16): flash_decode_kernel, written
//   for a call bound by bytes (gemma2-2b: 101 MB of K/V at a 6,175-key
//   global layer, 30 us at 3.35 TB/s; ~0.2 GFLOP, so fp32 FMAs suffice):
//   - Grid: one CTA of 8 warps per (split, kv head, b).  The split count is
//     fixed by the keys given (the cache's capacity S_max at decode), about
//     two CTAs per SM in all and never more than one wave (gemma2-2b, B = 4,
//     4 KV heads, 132 SMs: 16 splits, 256 CTAs), at most one per 64-key
//     block.  Each CTA reads the position from device memory (flash_decode:
//     queries at *pos.., keys < *pos + Sq), finds the 64-key blocks some
//     query sees (causal, inside the window, j < length) and takes its even
//     share of them in order; a CTA with none writes the empty partial
//     (m = NEG, l = 0).  Nothing the host passes depends on the position,
//     so a decode step replays as a CUDA graph.
//   - Rows: only the group's real rows are held, in fp32 registers (R =
//     group * Sq rounded up to 2, 4, 8 or 16; gemma2-2b: 2); no 16-row tile
//     of padding.  A warp holds min(R, 4) rows; for R > 4, R / 4 row groups
//     of warps share each key.
//   - Stream: K and V rows come through a ring of 4 stages of 16 KB in
//     shared memory (16 keys of K and V at D = 256 in bf16), filled with
//     16-byte cp.async copies three stages ahead of the math: up to 48 KB in
//     flight per CTA, 96 KB per SM.
//   - Math: each warp takes its slice of every stage's keys; a key's row is
//     spread over the lanes in 16-byte pieces (at D = 256 in bf16 and up to
//     2 rows, 16 lanes of 32 bytes: two keys a warp at once), its dot
//     products summed by xor butterflies (every lane gets the same bits);
//     softcap through the prefill's ex2-based tanh; an online softmax in
//     log2 units with one max and one rescale per stage; P V in fp32.
//   - Merges: the warps' (acc, m, l) merge in key-slice order in shared
//     memory, the splits' in split order in flash_decode_combine_kernel (one
//     CTA per output row); no atomics, so a repeated call gives the same
//     bits.  Workspace: splits * B * Hq * Sq * (D + 2) floats.
//   - Shared memory: the 64 KB ring (reused for the warps' partials); two
//     CTAs per SM (__launch_bounds__(256, 2): at most 128 registers a
//     thread; -Xptxas -v, printed by chip_smoke.py, gives counts and spills).
//   - A cache sharded by its sequence (the LM's flash-decoding layout over
//     a device mesh, lm/layers.py): the host int kv_base is the global
//     index of the slice's row 0, the masks compare global positions, the
//     rows at or past pos + Sq - kv_base are never read, and the rows'
//     log-sum-exp (lse = m ln 2 + log l, fp32 (B, Hq, Sq)) comes out through
//     an optional pointer, so the caller merges the slices by it.  A slice
//     no query can see writes O = 0 and lse = -inf (every split empty: m =
//     NEG, l = 0, no division by 0).  kv_base is a launch argument, so a
//     step stays capturable.
//
// Kept in every kernel: the GQA group's q heads are the interleaved rows of
// one CTA (row r = i * group + g), so one K/V tile serves every q head of
// the group and K and V are never copied per q head; KV blocks that no row
// of a CTA can see are never read (causal prefill reads half of K/V, a
// windowed layer at most its window); K and V are read through the cache
// view's strides; no atomics.
//
// Calls with DK != DV go to the prefill kernels at every Sq, also at 16 or
// fewer rows per KV head (MLA has Hq = Hkv, so a prompt of up to 16 tokens):
// the decode kernel keeps one width.  So do calls that ask for the row
// log-sum-exp.
//
// The log-sum-exp (training): both prefill kernels write, through an
// optional pointer, lse = m + log(l) of each query row in natural-log units,
// fp32 (B, Hq, Sq): the bf16 kernel from its log2-unit (m, l) as
// m ln 2 + log(l), the fp32 kernel from its own.  A row with no visible key
// gets -inf (and its output stays 0).  The autograd Function around the
// kernel (kernels/ops.py::FlashAttention) keeps it for the backward, which
// recomputes the probabilities as exp(s - lse).  With a null pointer (every
// serving call) nothing else changes: the same arithmetic and the same
// output bits, one store fewer.
//
// Template instances: flash_fwd_wgmma_kernel<DK, DV>, flash_fwd_kernel<float,
// DK, DV, 64> with (DK, DV) = (D, D) and (192, 128),
// flash_decode_kernel<float | bf16, D, 2 | 4 | 8 | 16>, D in {32, 64,
// 128, 256}.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BK = 64;        // keys per block
constexpr int DECODE_ROWS = 16;  // the decode kernel's rows per KV head
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PAD = 1;  // row stride D + 1 words: conflict-free
  __device__ static float2 pair(const float* p) {
    return make_float2(p[0], p[1]);
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <typename T, int DK, int DV, int BQ>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * (DK + Elem<T>::PAD) * sizeof(T) +
         (size_t)BK * DV * sizeof(T) + (size_t)BQ * (BK + 16) * sizeof(float);
}

// ROWS rows of D elements into shared memory rows of stride `ld`: row r
// comes from row_ptr(r) (nullptr: zeros).  Every 16-byte load of the tile
// is issued before the first store, so a thread keeps all its loads in
// flight at once (a load-store loop would wait out each load's latency);
// the stores go out as 32-bit words, since padded rows are not 16-byte
// aligned.
template <typename T, int D, int ROWS, typename RowPtr>
__device__ __forceinline__ void load_tile(T* dst, int ld, RowPtr row_ptr) {
  constexpr int V = D * (int)sizeof(T) / 16;   // 16-byte pieces per row
  constexpr int N = (ROWS * V + THREADS - 1) / THREADS;
  uint4 buf[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * THREADS;
    buf[n] = make_uint4(0u, 0u, 0u, 0u);
    if (e < ROWS * V) {
      const T* src = row_ptr(e / V);
      if (src != nullptr) buf[n] = __ldg(reinterpret_cast<const uint4*>(src) + e % V);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * THREADS;
    if (e < ROWS * V) {
      uint32_t* w = reinterpret_cast<uint32_t*>(dst + (e / V) * ld) + 4 * (e % V);
      w[0] = buf[n].x;
      w[1] = buf[n].y;
      w[2] = buf[n].z;
      w[3] = buf[n].w;
    }
  }
}

template <typename T, int DK, int DV, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv,
                 int sq, int sk, long long k_bs, long long k_hs,
                 long long v_bs, long long v_hs, int causal, int window,
                 float softcap, int q_offset, float scale) {
  constexpr int RI = BQ / 16;   // query rows per thread
  constexpr int KJ = BK / 16;   // keys per thread in the score tile
  constexpr int DP = DV / 32;   // output column pairs per thread
  constexpr int QS = DK + Elem<T>::PAD;
  constexpr int PS = BK + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QS;
  T* vs = ks + BK * QS;
  float* ps = reinterpret_cast<float*>(vs + BK * DV);

  const int group = hq / hkv;
  const int rows = group * sq;
  const int r0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Q rows of the block: row r is query i = r / group of q head
  // kvh * group + r % group
  load_tile<T, DK, BQ>(qs, QS, [&](int rr) -> const T* {
    const int r = r0 + rr;
    if (r >= rows) return nullptr;
    const long long head = (long long)b * hq + kvh * group + r % group;
    return q + (head * sq + r / group) * DK;
  });

  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) qpos[i] = q_offset + (r0 + ty + 16 * i) / group;

  // KV blocks visible to some row of this block
  const int last_row = min(r0 + BQ, rows) - 1;
  const int qlo = q_offset + r0 / group, qhi = q_offset + last_row / group;
  const int kv_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kv_end = causal ? min(sk, qhi + 1) : sk;
  const int jb0 = kv_begin / BK;
  const int jb1 = kv_end > kv_begin ? (kv_end + BK - 1) / BK : jb0;

  float m[RI], l[RI];
  float2 acc[RI][DP];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DP; ++jd) acc[i][jd] = make_float2(0.f, 0.f);
  }

  const T* kb = k + b * k_bs + kvh * k_hs;
  const T* vb = v + b * v_bs + kvh * v_hs;
  for (int jb = jb0; jb < jb1; ++jb) {
    const int c0 = jb * BK;
    __syncthreads();  // the previous block's tiles are consumed
    const int valid = min(BK, sk - c0);
    load_tile<T, DK, BK>(ks, QS, [&](int r) -> const T* {
      return r < valid ? kb + (long long)(c0 + r) * DK : nullptr;
    });
    load_tile<T, DV, BK>(vs, DV, [&](int r) -> const T* {
      return r < valid ? vb + (long long)(c0 + r) * DV : nullptr;
    });
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 2) {
      float2 qa[RI], kk[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = Elem<T>::pair(qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kk[j] = Elem<T>::pair(ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool vis[KJ];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = c0 + tx + 16 * j;
        vis[j] = kpos < sk && (!causal || qpos[i] >= kpos) &&
                 (window <= 0 || qpos[i] - kpos < window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = vis[j] ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DP; ++jd) {
        acc[i][jd].x *= alpha;
        acc[i][jd].y *= alpha;
      }
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < DP; ++jd) {
        const float2 vv = Elem<T>::pair(vs + c * DV + 2 * tx + 32 * jd);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][jd].x = fmaf(p[i], vv.x, acc[i][jd].x);
          acc[i][jd].y = fmaf(p[i], vv.y, acc[i][jd].y);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const long long head = (long long)b * hq + kvh * group + r % group;
    const long long row = head * sq + r / group;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    if (lse != nullptr && tx == 0)
      lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    T* dst = o + row * DV;
#pragma unroll
    for (int jd = 0; jd < DP; ++jd)
      Elem<T>::store(dst + 2 * tx + 32 * jd, acc[i][jd].x / l_safe,
                     acc[i][jd].y / l_safe);
  }
}
// ---------------------------------------------------------------------------
// Shared by the kernels below
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// tanh from one ex2 and one fast divide: absolute error ~1e-7 (tanh.approx
// would be ~5e-4, i.e. 2.5e-2 in a score soft-capped at 50)
__device__ __forceinline__ float tanh_exp(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// ---------------------------------------------------------------------------
// bf16 prefill: wgmma.mma_async fed by TMA through an mbarrier ring; one
// producer warpgroup, two consumer warpgroups of 64 query rows each.
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;          // query rows of a consumer warpgroup
constexpr int PF_BQ = 2 * WG_ROWS;   // query rows of a CTA
constexpr int PF_THREADS = 384;      // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;    // setmaxnreg: 40 x 128 + 232 x 256
constexpr int CONSUMER_REGS = 232;   // = 168 x 384, the launch's registers

// Tiles of the (DK, DV) instance.  Q, K and V are kept in shared memory as
// column chunks of CK (CV) elements, each chunk's rows one swizzle span of
// 2 CK bytes (128 B, or 64 B at D = 32), swizzled as TMA writes them and
// as the wgmma descriptors read them.  BK keys a stage; STAGES stages.
template <int DK, int DV>
struct Prefill {
  static constexpr int BK = DK == 256 ? 64 : 128;
  static constexpr int STAGES = DK == 32 ? 4 : (DK == 64 ? 3 : 2);
  static constexpr int CK = DK < 64 ? DK : 64;
  static constexpr int CV = DV < 64 ? DV : 64;
  static constexpr int SWK = 2 * CK, SWV = 2 * CV;   // bytes a chunk row
  static constexpr int Q_CHUNK = PF_BQ * SWK;        // bytes a chunk
  static constexpr int K_CHUNK = BK * SWK;
  static constexpr int V_CHUNK = BK * SWV;
  static constexpr int Q_BYTES = PF_BQ * DK * 2;
  static constexpr int K_BYTES = BK * DK * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // 1,024 bytes to align the tiles (the swizzle repeats every 1,024), the
  // tiles, three mbarriers a stage
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                              3 * STAGES * 8;
  static_assert(SMEM <= 232448, "over the 227 KB a block can have");
  static_assert(Q_CHUNK % 1024 == 0 && K_CHUNK % 1024 == 0 &&
                V_CHUNK % 1024 == 0, "tiles must keep the swizzle's phase");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait for the phase of `parity` to complete.  A wait of more than 10 s
// can only be a fault of the ring's bookkeeping: it traps (a launch error
// the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes of an operand of
// an asynchronous wgmma across the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle of `sw` bytes (128 -> 1, 64 -> 2).
// K-major operands (Q, K): 8-row groups SBO = 8 sw apart, LBO unused (1);
// MN-major V: 8-key groups SBO = 8 sw apart, sw-byte column chunks LBO
// apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int sw) {
  const uint64_t layout = sw == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulator fragment d (N / 2
// registers a thread: n8 tile j holds (row g, cols 8j + 2t, +1) in d[4j],
// d[4j + 1] and row g + 8 in d[4j + 2], d[4j + 3] of warp w's 16 rows,
// g = lane / 4, t = lane % 4).  ss: A and B from shared memory, both
// K-major; rs: A from registers (the m16k16 fragment of mma.sync), B from
// shared memory MN-major (the transpose bit set).  scale_d 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b,
                            int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// KV blocks [jb0, jb1) of BK keys that some row in [first, last] sees
template <int BK>
__device__ __forceinline__ void kv_blocks(int first, int last, int group,
                                          int q_offset, int sk, int causal,
                                          int window, int& jb0, int& jb1) {
  const int qlo = q_offset + first / group, qhi = q_offset + last / group;
  const int kv_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kv_end = causal ? min(sk, qhi + 1) : sk;
  jb0 = kv_begin / BK;
  jb1 = kv_end > kv_begin ? (kv_end + BK - 1) / BK : jb0;
}

// A thread's two rows (g and g + 8 of its warp's 16) and the masks
struct RowMask {
  int sk, causal, window, qpos_lo, qpos_hi, t;
  float sl2, cap_in, cap_out;   // cap_out > 0: soft-capped
};

// One block's score fragment: scaled (and soft-capped) into log2 units,
// masked (a key no row may see is NEG) unless the block is `full`, then
// turned into probabilities exp2(x - m) with the running (m, l) of the
// two rows updated; alpha, the factor that rescales the rows' output
// accumulator.  l is this thread's partial (quad-summed at the end).
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               const RowMask& mk, int c0,
                                               bool full, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      x = mk.cap_out > 0.f ? mk.cap_out * tanh_exp(x * mk.cap_in) : x * mk.sl2;
      if (!full) {
        const int kpos = c0 + 8 * j + 2 * mk.t + (e & 1);
        const int qp = e < 2 ? mk.qpos_lo : mk.qpos_hi;
        const bool vis = kpos < mk.sk && (!mk.causal || qp >= kpos) &&
                         (mk.window <= 0 || qp - kpos < mk.window);
        x = vis ? x : NEG;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - mn);
    m[h] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // masked scores are NEG: p = 0 exactly, also in a row with no
      // visible key so far (m = NEG)
      const float x = s[4 * j + e];
      const float p = x > 0.5f * NEG ? exp2f(x - m[e >> 1]) : 0.f;
      s[4 * j + e] = p;
      sum[e >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// S = Q K^T of one block: DK / 16 steps of m64n{BK}k16, Q (this
// warpgroup's 64 rows) and K (BK keys) K-major; a k16 step within a
// swizzle row advances the start address by 32 bytes
template <int DK, int DV>
__device__ __forceinline__ void issue_qk(float (&s)[Prefill<DK, DV>::BK / 2],
                                         uint32_t qa, uint32_t kt) {
  using P = Prefill<DK, DV>;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t ch = kk * 16 / P::CK, at = kk * 16 % P::CK * 2;
    Wgmma<P::BK>::ss(
        s, gmma_desc(qa + ch * P::Q_CHUNK + at, 16, 8 * P::SWK, P::SWK),
        gmma_desc(kt + ch * P::K_CHUNK + at, 16, 8 * P::SWK, P::SWK), kk);
  }
}

// O += P V of one block: BK / 16 steps of m64n{DV}k16, P (bf16) from
// registers, V MN-major (key rows of DV contiguous elements, no transposed
// copy); a 16-key step advances the start address by 16 rows
template <int DK, int DV>
__device__ __forceinline__ void issue_pv(
    float (&o)[DV / 2], const uint32_t (&p)[Prefill<DK, DV>::BK / 4],
    uint32_t vt) {
  using P = Prefill<DK, DV>;
#pragma unroll
  for (int kc = 0; kc < P::BK / 16; ++kc) {
    const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2],
                           p[4 * kc + 3]};
    Wgmma<DV>::rs(o, a, gmma_desc(vt + kc * 16 * P::SWV, P::V_CHUNK,
                                  8 * P::SWV, P::SWV));
  }
}

// The probabilities as bf16 pairs: the fragments of n8 tiles 2kc and
// 2kc + 1 are the A fragment of 16-key step kc
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(PF_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int hq, int hkv, int sq, int sk, int causal,
                       int window, float softcap, int q_offset, float scale) {
  using P = Prefill<DK, DV>;
  constexpr int BK = P::BK, ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // the Q tile
  unsigned char* qtile = smem_raw + (base - raw);
  // stage st: K at base + Q_BYTES + st STAGE_BYTES, V after it; the
  // barriers full_k, full_v and empty of stage st at bars + 8 (st, ST +
  // st, 2 ST + st)
  const uint32_t bars = base + P::Q_BYTES + ST * P::STAGE_BYTES;
  auto k_tile = [&](int st) { return base + P::Q_BYTES + st * P::STAGE_BYTES; };
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (ST + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * ST + st); };

  const int group = hq / hkv, rows = group * sq;
  // the last row blocks see the most keys under a causal mask: they go
  // out first, so the short ones fill the tail
  const int r0 = (gridDim.x - 1 - blockIdx.x) * PF_BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int active = min(2, (rows - r0 + WG_ROWS - 1) / WG_ROWS);
  int jb0, jb1;
  kv_blocks<BK>(r0, min(r0 + PF_BQ, rows) - 1, group, q_offset, sk, causal,
                window, jb0, jb1);
  const int n = jb1 - jb0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 4 * active);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full, K and V of a stage on
    // barriers of their own (S needs only K)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int it = 0; it < n; ++it) {
        const int st = it % ST;
        mbar_wait(empty(st), ((it / ST) & 1) ^ 1);
        const int c0 = (jb0 + it) * BK;
        const uint32_t kt = k_tile(st);
        mbar_expect_tx(full_k(st), P::K_BYTES);
#pragma unroll
        for (int c = 0; c < DK / P::CK; ++c)
          tma_load_4d(kt + c * P::K_CHUNK, &tmk, c * P::CK, c0, kvh, b,
                      full_k(st));
        mbar_expect_tx(full_v(st), P::V_BYTES);
#pragma unroll
        for (int c = 0; c < DV / P::CV; ++c)
          tma_load_4d(kt + P::K_BYTES + c * P::V_CHUNK, &tmv, c * P::CV, c0,
                      kvh, b, full_v(st));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  if (cw >= active) return;     // no rows for this warpgroup
  const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
  const int wr0 = r0 + cw * WG_ROWS;
  const int wlast = min(wr0 + WG_ROWS, rows) - 1;

  // the warpgroup's 64 rows of Q into its half of the swizzled tile: row
  // r is query r / group of q head kvh * group + r % group (rows past
  // the group's are zeros); every 16-byte load before the first store
  {
    constexpr int UPR = DK / 8, CU = P::CK / 8;   // 16-byte units a row, a chunk row
    constexpr int NL = WG_ROWS * UPR / 128;
    uint4 buf[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int e = tid + 128 * i, r = wr0 + e / UPR;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        const long long head = (long long)b * hq + kvh * group + r % group;
        buf[i] = __ldg(reinterpret_cast<const uint4*>(
                           q + (head * sq + r / group) * DK) + e % UPR);
      }
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int e = tid + 128 * i, u = e % UPR;
      const int off = (cw * WG_ROWS + e / UPR) * P::SWK + u % CU * 16;
      const int phys = off ^ (((off >> 7) & (P::SWK / 16 - 1)) << 4);
      *reinterpret_cast<uint4*>(qtile + u / CU * P::Q_CHUNK + phys) = buf[i];
    }
  }
  // the stores (generic proxy) visible to wgmma (async proxy), then the
  // warpgroup's other threads' rows
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

  int wjb0, wjb1;    // this warpgroup's blocks, inside the CTA's
  kv_blocks<BK>(wr0, wlast, group, q_offset, sk, causal, window, wjb0, wjb1);
  int i0 = wjb0 - jb0, i1 = wjb1 - jb0;
  if (i1 <= i0) i0 = i1 = n;
  const int row_lo = wr0 + warp * 16 + (lane >> 2);
  RowMask mk;
  mk.sk = sk;
  mk.causal = causal;
  mk.window = window;
  mk.qpos_lo = q_offset + row_lo / group;
  mk.qpos_hi = q_offset + (row_lo + 8) / group;
  mk.t = lane & 3;
  mk.sl2 = scale * LOG2E;
  mk.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  mk.cap_out = softcap > 0.f ? softcap * LOG2E : 0.f;
  // the warp's rows need no mask in a block wholly inside Sk, the causal
  // bound and the window
  const int wq_min = q_offset + (wr0 + warp * 16) / group;
  const int wq_max = q_offset + (wr0 + warp * 16 + 15) / group;
  auto full = [&](int c0) {
    return c0 + BK <= sk && (!causal || wq_min >= c0 + BK - 1) &&
           (window <= 0 || wq_max - c0 < window);
  };
  auto release = [&](int it) {   // this warp is done with block it's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it % ST));
  };
  // blocks of the CTA that no row of this warpgroup sees: waited for (so
  // the ring's phases stay in step) and released
  auto skip = [&](int it) {
    mbar_wait(full_k(it % ST), (it / ST) & 1);
    mbar_wait(full_v(it % ST), (it / ST) & 1);
    release(it);
  };

  float oacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];   // m in log2 units

  for (int it = 0; it < i0; ++it) skip(it);
  if (i0 < i1) {
    float s[BK / 2];
    uint32_t p[BK / 4];
    {
      const int st = i0 % ST;
      mbar_wait(full_k(st), (i0 / ST) & 1);
      wgmma_fence();
      issue_qk<DK, DV>(s, base + cw * WG_ROWS * P::SWK, k_tile(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const int c0 = (jb0 + i0) * BK;
      online_softmax<BK>(s, mk, c0, full(c0), m, l, alpha);
      pack_p<BK>(p, s);
    }
    // block it's S = Q K^T runs beside block it - 1's O += P V; the
    // softmax of block it overlaps the latter
    for (int it = i0 + 1; it < i1; ++it) {
      const int st = it % ST, pst = (it - 1) % ST;
      mbar_wait(full_k(st), (it / ST) & 1);
      wgmma_fence();
      issue_qk<DK, DV>(s, base + cw * WG_ROWS * P::SWK, k_tile(st));
      wgmma_commit();
      mbar_wait(full_v(pst), ((it - 1) / ST) & 1);
      issue_pv<DK, DV>(oacc, p, k_tile(pst) + P::K_BYTES);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      const int c0 = (jb0 + it) * BK;
      online_softmax<BK>(s, mk, c0, full(c0), m, l, alpha);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(p);
      release(it - 1);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
      pack_p<BK>(p, s);
    }
    const int st = (i1 - 1) % ST;
    mbar_wait(full_v(st), ((i1 - 1) / ST) & 1);
    wgmma_fence();
    issue_pv<DK, DV>(oacc, p, k_tile(st) + P::K_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(p);
    release(i1 - 1);
  }
  for (int it = i1; it < n; ++it) skip(it);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_lo + 8 * h;
    if (r >= rows) continue;
    const long long head = (long long)b * hq + kvh * group + r % group;
    const long long row = head * sq + r / group;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    if (lse != nullptr && (lane & 3) == 0)
      // (m, l) in log2 units of the scaled score: lse = (m + log2 l) ln 2
      lse[row] = l[h] > 0.f ? m[h] * LN2 + logf(l[h]) : -INFINITY;
    __nv_bfloat16* dst = o + row * DV + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * h] * inv, oacc[4 * j + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    return e == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// errors of this file's own (past the runtime's codes): error_string
constexpr int ERR_NO_ENCODE = 100001;   // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 100002;      // it refused the map (+ CUresult)

// The tensor map of k or v: (D, Sk, Hkv, B), rows of D contiguous bf16,
// the view's head and batch strides (elements; any, multiples of 8), a
// box of `cols` x `bk` rows of one head; the swizzle span is the box's
// row (128 B, or 64 B at D = 32).  TMA fills rows past Sk with zeros.  A
// dimension of size 1 is never stepped, so its stride is the packed one.
// With Sk = 0 no block is read: a map of one row over `ptr`.
int kv_tensor_map(CUtensorMap* map, const void* ptr, int d, int sk, int hkv,
                  int b, long long hs, long long bs, int cols, int bk) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  if (sk == 0) hkv = b = sk = 1;
  const cuuint64_t row = (cuuint64_t)d * 2;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)sk, (cuuint64_t)hkv,
                        (cuuint64_t)b};
  cuuint64_t strides[3] = {
      row, hkv > 1 ? (cuuint64_t)hs * 2 : row * sk,
      b > 1 ? (cuuint64_t)bs * 2 : row * sk * hkv};
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)bk, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + 1000 * (int)r;
}

template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int hq, int hkv, int sq, int sk,
                 long long k_bs, long long k_hs, long long v_bs,
                 long long v_hs, int causal, int window, float softcap,
                 int q_offset, cudaStream_t stream) {
  using P = Prefill<DK, DV>;
  CUtensorMap tmk, tmv;
  int err = kv_tensor_map(&tmk, sk ? k : q, DK, sk, hkv, b, k_hs, k_bs,
                          P::CK, P::BK);
  if (err == 0)
    err = kv_tensor_map(&tmv, sk ? v : q, DV, sk, hkv, b, v_hs, v_bs, P::CV,
                        P::BK);
  if (err != 0) return err;
  auto kern = flash_fwd_wgmma_kernel<DK, DV>;
  // once per instance, at its first call: a captured call only launches
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long rows = (long long)(hq / hkv) * sq;
  dim3 grid((unsigned)((rows + PF_BQ - 1) / PF_BQ), (unsigned)hkv,
            (unsigned)b);
  kern<<<grid, PF_THREADS, P::SMEM, stream>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, hq, hkv, sq, sk, causal, window,
      softcap, q_offset, 1.0f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}
// ---------------------------------------------------------------------------
// Decode (group * Sq <= 16 rows per KV head), fp32 and bf16: a ring of
// cp.async stages in shared memory, the group's real rows in registers, the
// length from device memory, a grid fixed by the keys given.
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;                  // 8 warps
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_STAGES = 4;
constexpr int DEC_STAGE_BYTES = 16384;            // K and V rows of one stage
constexpr int DEC_SMEM = DEC_STAGES * DEC_STAGE_BYTES;

// 16 bytes of T as floats
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void to_float(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_float(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // element 2i
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // element 2i + 1
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// E contiguous elements of T (16-byte aligned) as floats
template <typename T, int E>
__device__ __forceinline__ void load_f(const T* p, float (&f)[E]) {
  constexpr int N = Vec16<T>::N;
#pragma unroll
  for (int c = 0; c < E / N; ++c)
    Vec16<T>::to_float(*reinterpret_cast<const uint4*>(p + c * N), f + c * N);
}

// How a key row of D elements of T is spread over a warp for R rows: EPL
// elements a lane (at least one 16-byte piece; 16 bf16 at D = 256 for at
// most 2 rows, so a warp reads two keys at once and a score's butterfly has
// 4 steps, not 5; more rows would spill their registers), LPK lanes a key,
// KPW keys a warp at once; KS keys of K and of V in one stage of
// DEC_STAGE_BYTES.
template <typename T, int D, int R>
struct DecodeShape {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int PER = D / (sizeof(T) == 2 && R <= 2 ? 16 : 32);
  static constexpr int EPL = PER > VEC ? PER : VEC;
  static constexpr int LPK = D / EPL;
  static constexpr int KPW = 32 / LPK;
  static constexpr int KS = DEC_STAGE_BYTES / (2 * D * (int)sizeof(T));
};

// The keys [k0, k1) of split `split` of `splits`: the 64-key blocks that
// hold keys [lo, hi) divided evenly, in order (kernels/ref.py::
// decode_split_ranges is the same arithmetic); k0 >= k1 when it has none.
__device__ __forceinline__ void split_range(int lo, int hi, int split,
                                            int splits, int& k0, int& k1) {
  const int jb0 = lo / BK, jb1 = hi > lo ? (hi + BK - 1) / BK : jb0;
  const int per = (jb1 - jb0 + splits - 1) / splits;
  const int b0 = jb0 + split * per, b1 = min(jb1, b0 + per);
  k0 = max(lo, b0 * BK);
  k1 = min(hi, b1 * BK);
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;               // splits x (B Hq Sq) x (D + 2) partials
  float* lse;              // (B, Hq, Sq) row log-sum-exp, or null
  const long long* pos;    // device position (flash_decode) or null
  int hq, hkv, sq, sk;
  long long k_bs, k_hs, v_bs, v_hs;
  int causal, window, q_offset, splits;
  int kv_base;             // global index of key row 0 (a cache slice)
  float scale, softcap;
};

// One CTA per (split, kv head, b); R = the group's rows rounded up to 2, 4,
// 8 or 16.  Warp w holds RW = min(R, 4) rows (row group w % G) and takes
// key slice w / G of every stage.
template <typename T, int D, int R>
__global__ void __launch_bounds__(DEC_THREADS, 2)
flash_decode_kernel(const DecodeArgs a) {
  using S = DecodeShape<T, D, R>;
  constexpr int EPL = S::EPL, LPK = S::LPK, KPW = S::KPW, KS = S::KS;
  constexpr int RW = R < 4 ? R : 4;
  constexpr int G = R / RW;
  constexpr int KSL = DEC_WARPS / G;          // key slices
  constexpr int KPS = KS / KSL;               // keys of a slice per stage
  constexpr int NIT = KPS / KPW;
  constexpr int CH = D / S::VEC;              // 16-byte pieces per row
  static_assert(KPS % KPW == 0 && NIT >= 1, "stage too small");
  static_assert(DEC_WARPS * RW * (D + 2) * 4 <= DEC_SMEM, "partials");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);       // stage s: K at s*2*KS*D, V after

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % G, slice = warp / G;
  const int sub = lane / LPK;                 // which of the warp's KPW keys
  const int c0 = (lane % LPK) * EPL;          // this lane's first column
  const int group = a.hq / a.hkv, rows = group * a.sq;

  // key row j is key kv_base + j of the sequence; positions are global
  int q_offset = a.q_offset, kv_len = a.sk;
  if (a.pos != nullptr) {
    q_offset = (int)*a.pos;
    kv_len = max(0, min(a.sk, q_offset + a.sq - a.kv_base));
  }
  // rows some query can see, and this split's share of them: rows past
  // pos + Sq - kv_base are never read
  const int lo = a.window > 0 ? max(0, q_offset - a.window + 1 - a.kv_base) : 0;
  const int hi = a.causal ? min(kv_len, q_offset + a.sq - a.kv_base) : kv_len;
  int k0, k1;
  split_range(lo, hi, split, a.splits, k0, k1);
  const int n_st = k1 > k0 ? (k1 - k0 + KS - 1) / KS : 0;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_bs + kvh * a.k_hs;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_bs + kvh * a.v_hs;
  auto load_stage = [&](int st) {
    T* kd = ring + (st % DEC_STAGES) * 2 * KS * D;
    T* vd = kd + KS * D;
    const int base = k0 + st * KS;
    for (int e = tid; e < KS * CH; e += DEC_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool ok = base + r < k1;
      const long long off = ok ? (long long)(base + r) * D + c * S::VEC : 0;
      cp_async16(kd + r * D + c * S::VEC, kb + off, ok ? 16 : 0);
      cp_async16(vd + r * D + c * S::VEC, vb + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < n_st) load_stage(st);
    cp_async_commit();
  }

  // this warp's rows: row r is query r / group of q head kvh * group +
  // r % group; rows past the group's are zeros and see no key
  float qr[RW][EPL];
  int qpos[RW];
  bool real[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = rg * RW + i;
    real[i] = r < rows;
    qpos[i] = q_offset + r / group;
    if (real[i]) {
      const long long head = (long long)b * a.hq + kvh * group + r % group;
      load_f<T, EPL>(static_cast<const T*>(a.q) + (head * a.sq + r / group) * D + c0,
                     qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] = 0.f;
    }
  }

  const float sl2 = a.scale * LOG2E;
  const float cap_in = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  const float cap_out = a.softcap * LOG2E;
  float m[RW], l[RW], acc[RW][EPL];            // m in log2 units
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();   // stage st has landed; stage st - 1 is consumed
    if (st + DEC_STAGES - 1 < n_st) load_stage(st + DEC_STAGES - 1);
    cp_async_commit();
    const T* kt = ring + (st % DEC_STAGES) * 2 * KS * D;
    const T* vt = kt + KS * D;
    const int first = slice * KPS + sub;      // stage row of iteration 0

    float x[NIT][RW], mx[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) mx[i] = NEG;
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int j = first + it * KPW;
      const int key = k0 + st * KS + j;   // row; kv_base + key globally
      float kf[EPL];
      load_f<T, EPL>(kt + j * D + c0, kf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[i][e], kf[e], d);
        // butterfly over the key's lanes: each of them gets the same bits
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const float xv = a.softcap > 0.f ? cap_out * tanh_exp(d * cap_in) : d * sl2;
        const int gk = a.kv_base + key;
        const bool vis = real[i] && key < k1 && (!a.causal || qpos[i] >= gk) &&
                         (a.window <= 0 || qpos[i] - gk < a.window);
        x[it][i] = vis ? xv : NEG;
        mx[i] = fmaxf(mx[i], x[it][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int off = 16; off >= LPK; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      float vf[EPL];
      load_f<T, EPL>(vt + (first + it * KPW) * D + c0, vf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        // a masked key is NEG: p = 0 exactly, also while m is NEG
        const float p = x[it][i] > 0.5f * NEG ? exp2f(x[it][i] - m[i]) : 0.f;
        l[i] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' partials

  // the warp's KPW key lanes summed (butterfly: every lane the same bits),
  // then its (acc, m, l) per row to shared memory
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int off = 16; off >= LPK; off >>= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    }
  }
  float* part = reinterpret_cast<float*>(smem);   // [warp][i][D + 2]
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float* w = part + (warp * RW + i) * (D + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) w[c0 + e] = acc[i][e];
      if (lane == 0) {
        w[D] = m[i];
        w[D + 1] = l[i];
      }
    }
  }
  __syncthreads();

  // the key slices merged in slice order, per row and column
  const long long n_rows = (long long)gridDim.z * a.hq * a.sq;
  for (int e = tid; e < rows * D; e += DEC_THREADS) {
    const int r = e / D, d = e % D;
    const int i = r % RW, g = r / RW;
    float mm = NEG;
#pragma unroll
    for (int s = 0; s < KSL; ++s)
      mm = fmaxf(mm, part[((s * G + g) * RW + i) * (D + 2) + D]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int s = 0; s < KSL; ++s) {
      const float* w = part + ((s * G + g) * RW + i) * (D + 2);
      const float f = exp2f(w[D] - mm);
      ll = fmaf(w[D + 1], f, ll);
      aa = fmaf(w[d], f, aa);
    }
    const long long head = (long long)b * a.hq + kvh * group + r % group;
    const long long row = head * a.sq + r / group;
    if (a.splits == 1) {
      static_cast<T*>(a.o)[row * D + d] = Vec16<T>::store(ll > 0.f ? aa / ll : 0.f);
      if (a.lse != nullptr && d == 0)
        a.lse[row] = ll > 0.f ? mm * LN2 + logf(ll) : -INFINITY;
    } else {
      // this split's unnormalised partial, merged in split order by
      // flash_decode_combine_kernel
      float* w = a.ws + ((long long)split * n_rows + row) * (D + 2);
      w[d] = aa;
      if (d == 0) {
        w[D] = mm;
        w[D + 1] = ll;
      }
    }
  }
}

// One output row per CTA, one column per thread: the splits' partials (m in
// log2 units) merged in split order: m = max m_s, l = sum l_s 2^(m_s - m),
// the same for acc.  Every split's (m, l) is loaded at once and the column
// loads are unrolled, so the merge costs a few round trips to L2, not one
// per split.  A row no split saw (l = 0) gives exactly 0 and, where `lse`
// is given, a log-sum-exp of -inf (every split then holds m = NEG, so the
// weights are finite: 2^(NEG - NEG) = 1 times l = 0).
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                            float* __restrict__ lse, long long n_rows,
                            int splits) {
  extern __shared__ float wl[];                  // [splits] weights, [splits] l
  __shared__ float lsum;
  const long long row = blockIdx.x, stride = n_rows * (D + 2);
  const float* w = ws + row * (D + 2);
  const int d = threadIdx.x;
  for (int s = d; s < splits; s += D) {
    wl[s] = w[s * stride + D];
    wl[splits + s] = w[s * stride + D + 1];
  }
  __syncthreads();
  if (d == 0) {
    float m = NEG;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, wl[s]);
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = exp2f(wl[s] - m);
      wl[s] = f;
      l = fmaf(wl[splits + s], f, l);
    }
    lsum = l;
    if (lse != nullptr) lse[row] = l > 0.f ? m * LN2 + logf(l) : -INFINITY;
  }
  __syncthreads();
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) acc = fmaf(w[s * stride + d], wl[s], acc);
  o[row * D + d] = Vec16<T>::store(lsum > 0.f ? acc / lsum : 0.f);
}

template <typename T, int D, int R>
int launch_decode(const DecodeArgs& a, int b, cudaStream_t stream) {
  auto kern = flash_decode_kernel<T, D, R>;
  // once per instance, at its first (eager) call: a captured call only
  // launches
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)a.splits, (unsigned)a.hkv, (unsigned)b);
  kern<<<grid, DEC_THREADS, DEC_SMEM, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long n_rows = (long long)b * a.hq * a.sq;
  flash_decode_combine_kernel<T, D>
      <<<(unsigned)n_rows, D, 2 * a.splits * sizeof(float), stream>>>(
          a.ws, static_cast<T*>(a.o), a.lse, n_rows, a.splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int decode_by_rows(const DecodeArgs& a, int b, cudaStream_t st) {
  const int rows = a.hq / a.hkv * a.sq;
  if (rows <= 2) return launch_decode<T, D, 2>(a, b, st);
  if (rows <= 4) return launch_decode<T, D, 4>(a, b, st);
  if (rows <= 8) return launch_decode<T, D, 8>(a, b, st);
  return launch_decode<T, D, 16>(a, b, st);
}

template <typename T>
int decode_by_dim(int d, const DecodeArgs& a, int b, cudaStream_t st) {
  switch (d) {
    case 32: return decode_by_rows<T, 32>(a, b, st);
    case 64: return decode_by_rows<T, 64>(a, b, st);
    case 128: return decode_by_rows<T, 128>(a, b, st);
    case 256: return decode_by_rows<T, 256>(a, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int DK, int DV>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int hq, int hkv, int sq, int sk,
                long long k_bs, long long k_hs, long long v_bs, long long v_hs,
                int causal, int window, float softcap, int q_offset,
                cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr size_t smem = smem_bytes<float, DK, DV, BQ>();
  auto kern = flash_fwd_kernel<float, DK, DV, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(hq / hkv) * sq;
  dim3 grid((unsigned)((rows + BQ - 1) / BQ), (unsigned)hkv, (unsigned)b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, hq, hkv, sq,
      sk, k_bs, k_hs, v_bs, v_hs, causal, window, softcap, q_offset,
      1.0f / sqrtf((float)DK));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) {
  static char msg[96];
  if (e == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (e >= ERR_ENCODE) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a K/V map "
             "(CUresult %d)", (e - ERR_ENCODE) / 1000);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)e);
}

// Prefill: Hq / Hkv * Sq > 16 rows per KV head, or any Sq when the value
// width dv differs from the query/key width d (the decode kernel has no such
// instance) or when `lse` (fp32 (B, Hq, Sq), or null) asks for the rows'
// log-sum-exp.  dtype 0 = float32, 1 = bfloat16.  q is contiguous (B, Hq, Sq,
// d), o (B, Hq, Sq, dv); k and v have rows of d and dv contiguous elements
// and the given batch and head strides (elements), so a cache sliced to its
// filled length needs no copy.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   int dtype, int b, int hq, int hkv, int sq, int sk, int d,
                   int dv, long long k_bs, long long k_hs, long long v_bs,
                   long long v_hs, int causal, int window, float softcap,
                   int q_offset, void* lse, void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  cudaStream_t st = (cudaStream_t)stream;
  float* lse_f = static_cast<float*>(lse);
  if ((d == dv && (long long)(hq / hkv) * sq <= DECODE_ROWS &&
       lse == nullptr) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
#define FLASH_CASE(DK, DV)                                                   \
  if (d == DK && dv == DV)                                                   \
    return dtype == 0                                                        \
               ? launch_fp32<DK, DV>(q, k, v, o, lse_f, b, hq, hkv, sq, sk,  \
                                     k_bs, k_hs, v_bs, v_hs, causal, window, \
                                     softcap, q_offset, st)                  \
               : launch_wgmma<DK, DV>(q, k, v, o, lse_f, b, hq, hkv, sq, sk, \
                                      k_bs, k_hs, v_bs, v_hs, causal,        \
                                      window, softcap, q_offset, st);
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)   // MLA (deepseek-v3): qk_nope + qk_rope, v_head_dim
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// Decode: Hq / Hkv * Sq <= 16 rows per KV head, fp32 or bf16, layouts as in
// flash_attn_fwd.  With `pos` (a device int64) the queries sit at *pos ..
// *pos + Sq - 1 and see keys < min(Sk, *pos + Sq), causally (q_offset and
// causal are then ignored); without it, at q_offset and keys < Sk.  Key row
// j is key kv_base + j of the sequence (a slice of a cache sharded by its
// sequence; 0 for a whole cache): the causal and window masks compare
// global positions, and rows at or past *pos + Sq - kv_base are not read.
// `lse`, if not null, receives fp32 (B, Hq, Sq) row log-sum-exps of the
// scaled (soft-capped) scores, -inf where a row sees no key (its output is
// then 0).  The grid is `splits` CTAs per (b, kv head); with splits > 1
// `ws` holds splits * B * Hq * Sq * (D + 2) floats of partials.
int flash_attn_decode(const void* q, const void* k, const void* v, void* o,
                      int dtype, int b, int hq, int hkv, int sq, int sk, int d,
                      long long k_bs, long long k_hs, long long v_bs,
                      long long v_hs, int causal, int window, float softcap,
                      int q_offset, const void* pos, int splits, void* ws,
                      int kv_base, void* lse, void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)(hq / hkv) * sq > DECODE_ROWS || splits < 1 ||
      (splits > 1 && ws == nullptr) || 2 * splits * sizeof(float) > 49152)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.ws = static_cast<float*>(ws);
  a.lse = static_cast<float*>(lse);
  a.kv_base = kv_base;
  a.pos = static_cast<const long long*>(pos);
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.sk = sk;
  a.k_bs = k_bs; a.k_hs = k_hs; a.v_bs = v_bs; a.v_hs = v_hs;
  a.causal = pos != nullptr || causal;
  a.window = window; a.q_offset = q_offset; a.splits = splits;
  a.scale = 1.0f / sqrtf((float)d);
  a.softcap = softcap;
  if (dtype == 0) return decode_by_dim<float>(d, a, b, st);
  if (dtype == 1) return decode_by_dim<__nv_bfloat16>(d, a, b, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
