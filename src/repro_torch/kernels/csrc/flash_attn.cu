// Blockwise (flash) attention forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces repro/kernels/flash_attn.py::_flash_kernel (flash_attention):
// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) with Hq % Hkv == 0, fp32 or bf16 in,
// output in q's type.  Scores s = (q . k) / sqrt(D) in fp32, optionally
// soft-capped (softcap * tanh(s / softcap)); key j is visible to query i
// (absolute position q_offset + i) when j < Sk, and, as asked, causally
// (q_offset + i >= j) and inside the window ((q_offset + i) - j < window).
// Online softmax with running (m, l, acc) in fp32; a row with no visible
// key gives exactly 0, as in the Pallas kernel.  Unlike the Pallas kernel,
// which pads K and V to its block and masks only the causal and window
// conditions, keys j >= Sk are masked explicitly.
//
// What bounds it on the H100: at the prefill shapes the visible-pair FLOPs
// (4 D per pair and q head) against the tensor cores' bf16 peak (989
// TFLOP/s); at decode (Sq = 1) the bytes of the visible K and V, read once
// per q-head group.
//
// Three instances, by dtype and rows per KV head (group * Sq):
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
//   memory or by registers: 8 warps per SM).  Registers: the output
//   accumulator is D / 2 floats per thread (128 at D = 256); -Xptxas -v
//   (printed by chip_smoke.py) gives the count and spills.
// * bf16 decode (group * Sq <= 16) and every fp32 call: flash_fwd_kernel,
//   fp32 FMAs from shared memory, 256 threads as 16 x 16, BQ = 64 rows
//   (fp32 prefill) or 16 (decode).  Decode is bound by bytes and stays on
//   this path; fp32 stays off the tensor cores because fp32 inputs there
//   mean TF32, which would break the fp32 gate (atol 1e-4 x max) of the
//   card-vs-CPU LM check and tests/test_torch_card.py.  Decode has only
//   B * Hkv row blocks (16 for gemma2-2b), too few for 132 SMs: there the
//   visible KV blocks are split over `splits` CTAs per row block, each
//   writes its unnormalised (acc, m, l), and flash_combine_kernel merges
//   them in split order.
//
// Kept in every instance: the GQA group's q heads are the interleaved rows
// of one CTA (row r = i * group + g), so one K/V tile serves every q head
// of the group and K and V are never copied per q head; KV blocks that no
// row of a query block can see are skipped (causal prefill reads half of
// K/V, a windowed layer at most its window; the skipped blocks contribute
// exact zeros); K and V are read through the cache view's strides; no
// atomics, and the decode splits merge in a fixed order, so a repeated
// call gives the same bits.
//
// Template instances: flash_fwd_mma_kernel<D>, flash_fwd_kernel<float, D,
// 16 | 64> and flash_fwd_kernel<bf16, D, 16>, D in {32, 64, 128, 256}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // keys per block
constexpr int DECODE_ROWS = 16;  // row blocks of the decode instance
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG = -1e30f;

// rows of the output (and of a split's partials): B * Hq * Sq
__host__ __device__ inline long long b_rows(int hq, int sq, int b) {
  return (long long)b * hq * sq;
}

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

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 2;  // row stride D / 2 + 1 words: conflict-free
  __device__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <typename T, int D, int BQ>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * (D + Elem<T>::PAD) * sizeof(T) +
         (size_t)BK * D * sizeof(T) + (size_t)BQ * (BK + 16) * sizeof(float);
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

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int sk, long long k_bs, long long k_hs,
                 long long v_bs, long long v_hs, int causal, int window,
                 float softcap, int q_offset, float scale, int splits,
                 float* __restrict__ ws) {
  constexpr int RI = BQ / 16;   // query rows per thread
  constexpr int KJ = BK / 16;   // keys per thread in the score tile
  constexpr int DP = D / 32;    // output column pairs per thread
  constexpr int QS = D + Elem<T>::PAD;
  constexpr int PS = BK + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QS;
  T* vs = ks + BK * QS;
  float* ps = reinterpret_cast<float*>(vs + BK * D);

  const int group = hq / hkv;
  const int rows = group * sq;
  const int split = blockIdx.x % splits;
  const int r0 = (blockIdx.x / splits) * BQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Q rows of the block: row r is query i = r / group of q head
  // kvh * group + r % group
  load_tile<T, D, BQ>(qs, QS, [&](int rr) -> const T* {
    const int r = r0 + rr;
    if (r >= rows) return nullptr;
    const long long head = (long long)b * hq + kvh * group + r % group;
    return q + (head * sq + r / group) * D;
  });

  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) qpos[i] = q_offset + (r0 + ty + 16 * i) / group;

  // KV blocks visible to some row of this block
  const int last_row = min(r0 + BQ, rows) - 1;
  const int qlo = q_offset + r0 / group, qhi = q_offset + last_row / group;
  const int kv_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kv_end = causal ? min(sk, qhi + 1) : sk;
  int jb0 = kv_begin / BK;
  int jb1 = kv_end > kv_begin ? (kv_end + BK - 1) / BK : jb0;
  // this CTA's share of the blocks when the keys are split (decode)
  const int per = (jb1 - jb0 + splits - 1) / splits;
  jb0 = min(jb1, jb0 + split * per);
  jb1 = min(jb1, jb0 + per);

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
    load_tile<T, D, BK>(ks, QS, [&](int r) -> const T* {
      return r < valid ? kb + (long long)(c0 + r) * D : nullptr;
    });
    load_tile<T, D, BK>(vs, D, [&](int r) -> const T* {
      return r < valid ? vb + (long long)(c0 + r) * D : nullptr;
    });
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
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
        const float2 vv = Elem<T>::pair(vs + c * D + 2 * tx + 32 * jd);
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
    if (splits > 1) {
      // unnormalised partial (acc, m, l) of this split, combined in split
      // order by flash_combine_kernel
      float* w = ws + ((long long)split * b_rows(hq, sq, gridDim.z) + row) * (D + 2);
#pragma unroll
      for (int jd = 0; jd < DP; ++jd)
        *reinterpret_cast<float2*>(w + 2 * tx + 32 * jd) = acc[i][jd];
      if (tx == 0) {
        w[D] = m[i];
        w[D + 1] = l[i];
      }
      continue;
    }
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    T* dst = o + row * D;
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

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q plus two stages of K and V, rows padded by 16 bytes (D + 8 elements)
  return (size_t)(MMA_BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                     int sk, long long k_bs, long long k_hs, long long v_bs,
                     long long v_hs, int causal, int window, float softcap,
                     int q_offset, float scale) {
  constexpr int LDS = D + 8;      // smem row stride (elements)
  constexpr int CH = D / 8;       // 16-byte pieces per row
  constexpr int NT = D / 8;       // n-tiles of the output
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
      src = q + (head * sq + r / group) * D + c * 8;
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
    __nv_bfloat16* vd = vs + stage * BK * LDS;
    for (int e = tid; e < BK * CH; e += MMA_THREADS) {
      const int rr = e / CH, c = e % CH;
      const bool ok = c0 + rr < sk;
      const long long off = ok ? (long long)(c0 + rr) * D + c * 8 : 0;
      cp_async16(kd + rr * LDS + c * 8, kb + off, ok ? 16 : 0);
      cp_async16(vd + rr * LDS + c * 8, vb + off, ok ? 16 : 0);
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
    const __nv_bfloat16* vt = vs + stage * BK * LDS;
    const int c0 = jb * BK;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
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
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vt + (kc * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + dt * 16 +
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
    __nv_bfloat16* dst = o + (head * sq + r / group) * D + 2 * t;
    const float inv = half ? inv_hi : inv_lo;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          oacc[j][2 * half] * inv, oacc[j][2 * half + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int sk, long long k_bs, long long k_hs,
               long long v_bs, long long v_hs, int causal, int window,
               float softcap, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(hq / hkv) * sq;
  dim3 grid((unsigned)((rows + MMA_BQ - 1) / MMA_BQ), (unsigned)hkv,
            (unsigned)b);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq,
      hkv, sq, sk, k_bs, k_hs, v_bs, v_hs, causal, window, softcap, q_offset,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// One output row per CTA, one column per thread: the splits' partials
// merged in split order (m = max m_s, l = sum l_s e^(m_s - m), the same for
// acc), so a repeated call gives the same bits.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                     long long n_rows, int splits) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  float m = NEG;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, ws[((long long)s * n_rows + row) * (D + 2) + D]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* w = ws + ((long long)s * n_rows + row) * (D + 2);
    const float a = expf(w[D] - m);
    l += w[D + 1] * a;
    acc += w[d] * a;
  }
  const float out = acc / (l > 0.f ? l : 1.f);
  if constexpr (sizeof(T) == 4) {
    o[row * D + d] = out;
  } else {
    o[row * D + d] = __float2bfloat16_rn(out);
  }
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, long long k_bs, long long k_hs,
           long long v_bs, long long v_hs, int causal, int window,
           float softcap, int q_offset, int splits, float* ws,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, BQ>();
  auto kern = flash_fwd_kernel<T, D, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(hq / hkv) * sq;
  dim3 grid((unsigned)((rows + BQ - 1) / BQ * splits), (unsigned)hkv,
            (unsigned)b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, k_bs,
      k_hs, v_bs, v_hs, causal, window, softcap, q_offset,
      1.0f / sqrtf((float)D), splits, ws);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n_rows = b_rows(hq, sq, b);
  flash_combine_kernel<T, D><<<(unsigned)n_rows, D, 0, stream>>>(
      ws, static_cast<T*>(o), n_rows, splits);
  return (int)cudaGetLastError();
}

template <typename T, int BQ>
int by_dim(int d, const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, long long k_bs, long long k_hs,
           long long v_bs, long long v_hs, int causal, int window,
           float softcap, int q_offset, int splits, float* ws,
           cudaStream_t st) {
#define FLASH_CASE(DD)                                                        \
  case DD:                                                                    \
    return launch<T, DD, BQ>(q, k, v, o, b, hq, hkv, sq, sk, k_bs, k_hs,      \
                             v_bs, v_hs, causal, window, softcap, q_offset,   \
                             splits, ws, st);
  switch (d) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// dtype 0 = float32, 1 = bfloat16.  q and o are contiguous (B, Hq, Sq, D);
// k and v have rows of D contiguous elements and the given batch and head
// strides (elements), so a cache sliced to its filled length needs no copy.
// `splits` > 1 (decode only, Hq / Hkv * Sq <= 16) divides each row block's
// visible KV blocks over that many CTAs; `ws` then holds
// splits * B * Hq * Sq * (D + 2) floats of partials (else it may be null).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   int dtype, int b, int hq, int hkv, int sq, int sk, int d,
                   long long k_bs, long long k_hs, long long v_bs,
                   long long v_hs, int causal, int window, float softcap,
                   int q_offset, int splits, void* ws, void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  cudaStream_t st = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  const bool decode = (long long)(hq / hkv) * sq <= DECODE_ROWS;
  if (splits < 1 || (splits > 1 && (!decode || w == nullptr)))
    return (int)cudaErrorInvalidValue;
#define FLASH_ARGS d, q, k, v, o, b, hq, hkv, sq, sk, k_bs, k_hs, v_bs, v_hs, \
                   causal, window, softcap, q_offset, splits, w, st
  if (dtype == 0)
    return decode ? by_dim<float, DECODE_ROWS>(FLASH_ARGS)
                  : by_dim<float, 64>(FLASH_ARGS);
#undef FLASH_ARGS
  if (dtype == 1 && decode) {
    return by_dim<__nv_bfloat16, DECODE_ROWS>(
        d, q, k, v, o, b, hq, hkv, sq, sk, k_bs, k_hs, v_bs, v_hs, causal,
        window, softcap, q_offset, splits, w, st);
  }
  if (dtype == 1) {
#define MMA_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch_mma<DD>(q, k, v, o, b, hq, hkv, sq, sk, k_bs, k_hs, v_bs, \
                          v_hs, causal, window, softcap, q_offset, st);
    switch (d) {
      MMA_CASE(32)
      MMA_CASE(64)
      MMA_CASE(128)
      MMA_CASE(256)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
