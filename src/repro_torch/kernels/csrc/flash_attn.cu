// Blockwise (flash) attention forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces repro/kernels/flash_attn.py::_flash_kernel (flash_attention):
// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) with Hq % Hkv == 0, fp32 or bf16 in,
// output in q's type.  Scores s = (q . k) / sqrt(D) in fp32, optionally
// soft-capped (softcap * tanh(s / softcap)); key j is visible to query i
// (absolute position q_offset + i) when j < Sk, and, as asked, causally
// (q_offset + i >= j) and inside the window ((q_offset + i) - j < window).
// Online softmax with running (m, l, acc) in fp32; masked scores are -1e30
// and are masked again after the exp, so a row with no visible key gives 0
// (acc / l_safe, l_safe = 1 where l = 0), as in the Pallas kernel.  Unlike
// the Pallas kernel, which pads K and V to its block and masks only the
// causal and window conditions, keys j >= Sk are masked explicitly.
//
// Design (simple and right; wgmma, TMA and warp specialisation are later
// work):
// * One CTA per (b, kv head, block of BQ query rows).  The rows of a block
//   are the (query, q head) pairs of that kv head's GQA group, interleaved
//   (row r = i * group + g), so a K/V tile in shared memory serves every q
//   head of the group: K and V are never copied per q head.  Decode
//   (group * Sq <= 16 rows) takes a BQ = 16 instance, everything else
//   BQ = 64.
// * 256 threads as 16 x 16: thread (tx, ty) owns rows ty + 16 i; in the
//   score tile it owns keys tx + 16 j of the BK = 64-key block, in the
//   output tile the column pairs 2 tx + 32 jd.  Q and K rows are padded in
//   shared memory so the score loop reads them without bank conflicts; the
//   probability tile is staged through shared memory (fp32, padded rows).
// * Only KV blocks that some row of the query block can see are visited:
//   causal prefill reads half of K/V, a windowed layer at most its window.
//   The result is the same as visiting every block (the skipped ones
//   contribute exact zeros and leave m unchanged).
// * K/V tiles are read with 16-byte loads, all of a thread's loads of a
//   tile issued before its first store to shared memory.
// * Decode has only B * Hkv row blocks (16 for gemma2-2b), too few for 132
//   SMs: there the visible KV blocks are split over `splits` CTAs per row
//   block, each writes its unnormalised (acc, m, l), and a second kernel
//   merges them in split order.
// * Accumulation in fp32 registers, plain FMAs; no atomics, so a repeated
//   call gives the same bits.
//
// Bound on the H100: at the prefill shapes the visible-pair FLOPs (4 D per
// pair and head) against the bf16 tensor-core peak; this kernel runs on
// the fp32 FMA pipes, so it is bound by operations at the fp32 rate.  At
// decode (Sq = 1) it is bound by the bytes of the visible K and V, read
// once per q-head group.
//
// Template instances: T in {float, bf16}, D in {32, 64, 128, 256},
// BQ in {16, 64}.  Shared memory at D = 256, BQ = 64: 118 KB in bf16,
// 217 KB in fp32.
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
  if (dtype == 1)
    return decode ? by_dim<__nv_bfloat16, DECODE_ROWS>(FLASH_ARGS)
                  : by_dim<__nv_bfloat16, 64>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
