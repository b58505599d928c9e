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
// * bf16 prefill (group * Sq > 16): flash_fwd_mma_kernel, on the tensor
//   cores.  One CTA of 8 warps per (b, kv head, 128 query rows); each
//   warp owns 16 rows; the row blocks that see the most keys go first.
//   Q K^T and P V are mma.sync.m16n8k16 (bf16 operands, fp32 sums) fed by
//   ldmatrix (.trans for V); wgmma is not used.  The
//   scores, running (m, l) and the output accumulator stay in registers;
//   the score fragments of two 8-key tiles are the A fragment of one
//   16-key step of P V, so P goes to the product as bf16 from registers,
//   never through shared memory.  Rounding P to bf16 is what the JAX LM's
//   chunked_attention does (repro/lm/layers.py); the TPU kernel and the
//   plain version keep P in fp32, so this instance differs from them by up
//   to ~2^-9 of each probability, inside the 1e-2 x max gate.  Softcap is
//   applied to the fp32 accumulator fragment as 1 - 2 / (exp(2x) + 1)
//   (one ex2 and one fast divide, absolute error ~1e-7; tanh.approx.f32
//   would err by ~5e-4, 2.5e-2 in a score capped at 50).  K and V tiles
//   (64 keys) are double-buffered in shared memory with cp.async, the next
//   block's load in flight during the current block's math.  Rows of Q, K
//   and V are padded by 16 bytes in shared memory, which makes the
//   ldmatrix reads conflict-free at every D.  Shared memory: Q 128 x D plus
//   two stages of K and V, (128 + 4 * 64) * (D + 8) * 2 bytes: 198 KB at
//   D = 256, 102 KB at D = 128 (one CTA per SM either way, by shared
//   memory or by registers: 8 warps per SM); at (DK, DV) = (192, 128), Q and
//   K rows of DK + 8 and V rows of DV + 8 elements, 134 KB.  Registers: the
//   output accumulator is DV / 2 floats per thread (128 at D = 256);
//   -Xptxas -v (printed by chip_smoke.py) gives the count and spills.
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
// Template instances: flash_fwd_mma_kernel<DK, DV>, flash_fwd_kernel<float,
// DK, DV, 64> with (DK, DV) = (D, D) and (192, 128),
// flash_decode_kernel<float | bf16, D, 2 | 4 | 8 | 16>, D in {32, 64,
// 128, 256}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bf16 prefill on tensor cores: mma.sync.m16n8k16 (bf16 in, fp32 sums) fed
// by ldmatrix, K/V double-buffered in shared memory with cp.async.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 128;      // query rows per CTA (8 warps x 16 rows)
constexpr int MMA_THREADS = 256;
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// tanh from one ex2 and one fast divide: absolute error ~1e-7 (tanh.approx
// would be ~5e-4, i.e. 2.5e-2 in a score soft-capped at 50)
__device__ __forceinline__ float tanh_exp(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

template <int DK, int DV>
constexpr size_t mma_smem_bytes() {
  // Q plus two stages of K and V, rows padded by 16 bytes (width + 8
  // elements)
  return ((size_t)(MMA_BQ + 2 * BK) * (DK + 8) + (size_t)2 * BK * (DV + 8)) *
         sizeof(__nv_bfloat16);
}

template <int DK, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int hq, int hkv, int sq,
                     int sk, long long k_bs, long long k_hs, long long v_bs,
                     long long v_hs, int causal, int window, float softcap,
                     int q_offset, float scale) {
  constexpr int LDS = DK + 8;     // smem row stride of Q and K (elements)
  constexpr int LDV = DV + 8;     // and of V
  constexpr int CH = DK / 8;      // 16-byte pieces per row of Q and K
  constexpr int CHV = DV / 8;     // and of V
  constexpr int NT = DV / 8;      // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + MMA_BQ * LDS;        // 2 stages
  __nv_bfloat16* vs = ks + 2 * BK * LDS;        // 2 stages

  const int group = hq / hkv;
  const int rows = group * sq;
  // the last row blocks see the most keys under a causal mask: they go
  // out first, so the short ones fill the tail
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int e = tid; e < MMA_BQ * CH; e += MMA_THREADS) {
    const int rr = e / CH, c = e % CH, r = r0 + rr;
    const __nv_bfloat16* src = q;
    if (r < rows) {
      const long long head = (long long)b * hq + kvh * group + r % group;
      src = q + (head * sq + r / group) * DK + c * 8;
    }
    cp_async16(qs + rr * LDS + c * 8, src, r < rows ? 16 : 0);
  }
  cp_async_commit();

  const int last_row = min(r0 + MMA_BQ, rows) - 1;
  const int qlo = q_offset + r0 / group, qhi = q_offset + last_row / group;
  const int kv_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kv_end = causal ? min(sk, qhi + 1) : sk;
  const int jb0 = kv_begin / BK;
  const int jb1 = kv_end > kv_begin ? (kv_end + BK - 1) / BK : jb0;

  const __nv_bfloat16* kb = k + b * k_bs + kvh * k_hs;
  const __nv_bfloat16* vb = v + b * v_bs + kvh * v_hs;
  auto load_kv = [&](int jb, int stage) {
    const int c0 = jb * BK;
    __nv_bfloat16* kd = ks + stage * BK * LDS;
    __nv_bfloat16* vd = vs + stage * BK * LDV;
    for (int e = tid; e < BK * CH; e += MMA_THREADS) {
      const int rr = e / CH, c = e % CH;
      const bool ok = c0 + rr < sk;
      const long long off = ok ? (long long)(c0 + rr) * DK + c * 8 : 0;
      cp_async16(kd + rr * LDS + c * 8, kb + off, ok ? 16 : 0);
    }
    for (int e = tid; e < BK * CHV; e += MMA_THREADS) {
      const int rr = e / CHV, c = e % CHV;
      const bool ok = c0 + rr < sk;
      const long long off = ok ? (long long)(c0 + rr) * DV + c * 8 : 0;
      cp_async16(vd + rr * LDV + c * 8, vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  if (jb0 < jb1) load_kv(jb0, 0);

  // this thread's two rows of the warp's 16: g and g + 8
  const int row_lo = r0 + warp * 16 + g;
  const int qpos_lo = q_offset + row_lo / group;
  const int qpos_hi = q_offset + (row_lo + 8) / group;
  const int wrow0 = r0 + warp * 16;
  const int wq_min = q_offset + wrow0 / group;
  const int wq_max = q_offset + (wrow0 + 15) / group;
  const float sl2 = scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * LOG2E;

  float oacc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;   // m in log2 units

  for (int jb = jb0; jb < jb1; ++jb) {
    const int stage = (jb - jb0) & 1;
    if (jb + 1 < jb1) {
      load_kv(jb + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * BK * LDS;
    const __nv_bfloat16* vt = vs + stage * BK * LDV;
    const int c0 = jb * BK;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bf[4];
        const int mi = lane >> 3;
        ldsm_x4(bf, kt + (n2 * 16 + (mi >> 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                        (mi & 1) * 8);
        mma_bf16(s[2 * n2], a, bf[0], bf[1]);
        mma_bf16(s[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; scores kept in log2 units
    const bool full = c0 + BK <= sk && (!causal || wq_min >= c0 + BK - 1) &&
                      (window <= 0 || wq_max - c0 < window);
    float mx_lo = NEG, mx_hi = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (softcap > 0.f) {
          x = cap_out * tanh_exp(x * cap_in);
        } else {
          x *= sl2;
        }
        if (!full) {
          const int kpos = c0 + 8 * j + 2 * t + (e & 1);
          const int qp = e < 2 ? qpos_lo : qpos_hi;
          const bool vis = kpos < sk && (!causal || qp >= kpos) &&
                           (window <= 0 || qp - kpos < window);
          x = vis ? x : NEG;
        }
        s[j][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        // masked scores are NEG: p = 0 exactly, also in a row with no
        // visible key so far (m = NEG)
        const float p = x > 0.5f * NEG ? exp2f(x - (e < 2 ? mn_lo : mn_hi)) : 0.f;
        s[j][e] = p;
        if (e < 2) sum_lo += p; else sum_hi += p;
      }
    l_lo = l_lo * al_lo + sum_lo;   // per-thread partial; quad-summed at the end
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      oacc[j][0] *= al_lo;
      oacc[j][1] *= al_lo;
      oacc[j][2] *= al_hi;
      oacc[j][3] *= al_hi;
    }

    // O += P V: P from registers as bf16 (the S fragments of two n-tiles
    // are the A fragment of one 16-key step)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int mi = lane >> 3;
#pragma unroll
      for (int dt = 0; dt < DV / 16; ++dt) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vt + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LDV + dt * 16 +
                          (mi >> 1) * 8);
        mma_bf16(oacc[2 * dt], a, bf[0], bf[1]);
        mma_bf16(oacc[2 * dt + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_lo + 8 * half;
    if (r >= rows) continue;
    const long long head = (long long)b * hq + kvh * group + r % group;
    __nv_bfloat16* dst = o + (head * sq + r / group) * DV + 2 * t;
    const float inv = half ? inv_hi : inv_lo;
    if (lse != nullptr && t == 0) {
      // (m, l) in log2 units of the scaled score: lse = (m + log2 l) ln 2
      const float lh = half ? l_hi : l_lo, mh = half ? m_hi : m_lo;
      lse[head * sq + r / group] = lh > 0.f ? mh * LN2 + logf(lh) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          oacc[j][2 * half] * inv, oacc[j][2 * half + 1] * inv);
  }
}

template <int DK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int hq, int hkv, int sq, int sk,
               long long k_bs, long long k_hs, long long v_bs, long long v_hs,
               int causal, int window, float softcap, int q_offset,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DK, DV>();
  auto kern = flash_fwd_mma_kernel<DK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(hq / hkv) * sq;
  dim3 grid((unsigned)((rows + MMA_BQ - 1) / MMA_BQ), (unsigned)hkv,
            (unsigned)b);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      hq, hkv, sq, sk, k_bs, k_hs, v_bs, v_hs, causal, window, softcap, q_offset,
      1.0f / sqrtf((float)DK));
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
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

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
               : launch_mma<DK, DV>(q, k, v, o, lse_f, b, hq, hkv, sq, sk,   \
                                    k_bs, k_hs, v_bs, v_hs, causal, window,  \
                                    softcap, q_offset, st);
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
