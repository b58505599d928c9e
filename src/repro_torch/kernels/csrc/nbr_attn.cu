// DPA-1 gated neighbour-attention stack: forward and analytic backward for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces repro/kernels/nbr_attn.py::_stack_fwd_kernel and
// ::_stack_bwd_kernel (custom VJP nbr_attention_stack).
//
// Work: per centre atom, l_a layers of QKV projections (M -> H), K x K
// scores, softmax x angular gate, value mix, out-projection (H -> M),
// residual and LayerNorm.  At K = 64, M = 128, H = 256 that is ~21 MFLOP per
// layer per atom against ~32 KB of activations, so the stack is bound by
// fp32 operations on the H100, not by bytes.
//
// Design (first version: plain fp32 FMAs on the CUDA cores, no wgmma/TMA):
// one CTA per atom keeps the K x M activations G, the pre-norm sum and the
// K x K score tile in shared memory across all layers, so G is read from
// and written to device memory once per stack.  Full Q/K/V (3 x K x H) do
// not fit beside G, so H is streamed in kChunk-wide column chunks:
// Q_c, K_c -> S += Q_c K_c^T; softmax x gate -> W; V_c -> O_c = W V_c ->
// out += O_c Wo[c, :].  The gate (r_hat.r_hat^T)(sw x sw)(mask x mask) is
// recomputed from five K-vectors wherever it is used and never stored.
// bf16 mode rounds every matmul operand to bf16 where the JAX kernel casts
// it, and accumulates in fp32.  Masked keys score FLT_MAX below zero (not
// -inf), so a fully masked row gives a uniform softmax times a zero gate:
// zeros, never NaN.
//
// Backward: the TPU kernel += its parameter gradients into accumulators
// that persist across a sequential grid; on a GPU that is a race.  Here a
// param-grad launch runs a fixed number of CTAs, each striding over atoms in
// a fixed order and owning its own partial sums in device memory; a second
// kernel adds the partials in block order.  No atomics, so results repeat
// bit for bit.  The force path asks for no parameter gradients and skips
// that work (a separate template instance).  The angular-gate cotangent is
// linear, so it is expanded onto dr_hat / dsw per layer and head instead of
// keeping a K x K accumulator across layers.
//
// Shared memory sets the largest K: see nbr_attn_fwd_smem / _bwd_smem (the
// Python wrapper raises above the 227 KB a block may use).  At M = 128 the
// forward takes K <= 134 and the backward K <= 89 with every tile in shared
// memory.  Above that the backward runs a second instance (GMEM): its three
// K x M tiles (the layer input, read straight from the stash; the incoming
// cotangent; the pre-norm sum) live in device memory, in a per-CTA workspace
// that L2 serves, and only the K x K tiles, the chunk buffers and the
// K-vectors stay in shared memory (K <= 152 at M = 128).  That instance runs
// a persistent grid of one CTA per workspace slot striding over atoms.  The
// wrapper picks the shared-memory instance whenever it fits, so K <= 89 runs
// exactly the code it ran before.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 512;      // 16 warps: one CTA per SM at K = 82
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;          // H columns per streamed chunk
constexpr int kLdc = kChunk + 1;    // padded row stride of chunk buffers
constexpr float kLnEps = 1e-5f;

struct StackArgs {
  const float *g, *rx, *ry, *rz, *sw, *mask;
  const float *wq, *wk, *wv, *wo, *gamma, *beta;
  const float *dout;
  float *out, *stash;
  float *dg, *drx, *dry, *drz, *dsw, *part, *ws;
  int n, k, m, h, layers, heads;
  float scale;
};

size_t fwd_floats(int k, int m) {
  return 2 * (size_t)k * (m + 1) + (size_t)k * (k + 1) + 2 * (size_t)k * kLdc
         + 5 * (size_t)k;
}

size_t bwd_floats(int k, int m) {
  return 3 * (size_t)k * (m + 1) + 2 * (size_t)k * (k + 1)
         + 4 * (size_t)k * kLdc + 10 * (size_t)k;
}

// shared memory of the GMEM backward: the K x M tiles are in device memory
size_t bwd_gmem_floats(int k) {
  return 2 * (size_t)k * (k + 1) + 4 * (size_t)k * kLdc + 10 * (size_t)k;
}

template <bool BF16>
__device__ __forceinline__ float op(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[rows x cols] <- sum_d a(r, d) * b(d, c), delivered through c(r, col, v).
// Each thread owns TR x TC micro-tiles; out-of-range rows/cols are clamped
// on load and skipped on store.  Every output element has one owner, so a
// store functor may read-modify-write without a race.
template <int TR, int TC, class FA, class FB, class FC>
__device__ __forceinline__ void block_mm(int rows, int cols, int depth,
                                         FA a, FB b, FC c) {
  const int tr = (rows + TR - 1) / TR;
  const int tc = (cols + TC - 1) / TC;
  for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
    const int r0 = (t / tc) * TR;
    const int c0 = (t % tc) * TC;
    int ri[TR], ci[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) ri[i] = min(r0 + i, rows - 1);
#pragma unroll
    for (int j = 0; j < TC; ++j) ci[j] = min(c0 + j, cols - 1);
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < depth; ++d) {
      float av[TR], bv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) av[i] = a(ri[i], d);
#pragma unroll
      for (int j = 0; j < TC; ++j) bv[j] = b(d, ci[j]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (r0 + i < rows && c0 + j < cols) c(r0 + i, c0 + j, acc[i][j]);
  }
}

// The per-atom geometry vectors in shared memory and the gate built on them.
struct Gate {
  const float *rx, *ry, *rz, *sw, *mk;
  __device__ __forceinline__ float gate(int i, int j) const {
    return rx[i] * rx[j] + ry[i] * ry[j] + rz[i] * rz[j];
  }
  __device__ __forceinline__ float gmul(int i, int j) const {
    return gate(i, j) * (sw[i] * sw[j]) * (mk[i] * mk[j]);
  }
};

// sS <- P = softmax_j(mask_j ? scale * (Q_h K_h^T)_ij : -FLT_MAX) for the
// head whose columns start at col0.  Uses sA/sB as chunk buffers.  Starts
// and ends with a barrier.
template <bool BF16>
__device__ void scores_softmax(const float* sG, int ldm, const float* wq,
                               const float* wk, int h, int col0, int hd,
                               float* sS, int ldk, float* sA, float* sB,
                               int k, int m, const float* mk, float scale) {
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int cw = min(kChunk, hd - c0);
    const int col = col0 + c0;
    __syncthreads();
    block_mm<2, 2>(k, cw, m,
        [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
        [&](int d, int c) { return op<BF16>(__ldg(wq + (size_t)d * h + col + c)); },
        [&](int r, int c, float v) { sA[r * kLdc + c] = v; });
    block_mm<2, 2>(k, cw, m,
        [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
        [&](int d, int c) { return op<BF16>(__ldg(wk + (size_t)d * h + col + c)); },
        [&](int r, int c, float v) { sB[r * kLdc + c] = v; });
    __syncthreads();
    block_mm<4, 4>(k, k, cw,
        [&](int r, int d) { return op<BF16>(sA[r * kLdc + d]); },
        [&](int d, int c) { return op<BF16>(sB[c * kLdc + d]); },
        [&](int r, int c, float v) {
          if (c0 == 0) sS[r * ldk + c] = v; else sS[r * ldk + c] += v;
        });
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < k; i += kWarps) {
    float* row = sS + i * ldk;
    float mx = -FLT_MAX;
    for (int j = lane; j < k; j += 32) {
      const float x = mk[j] > 0.f ? row[j] * scale : -FLT_MAX;
      row[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < k; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < k; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) stack_fwd_kernel(StackArgs a) {
  extern __shared__ float smem[];
  const int k = a.k, m = a.m, h = a.h, hd = a.h / a.heads;
  const int ldm = m + 1, ldk = k + 1;
  float* sG = smem;                 // layer input / output   k x ldm
  float* sOut = sG + k * ldm;       // out-projection sum     k x ldm
  float* sS = sOut + k * ldm;       // scores -> P -> W       k x ldk
  float* sA = sS + k * ldk;         // chunk buffers          k x kLdc
  float* sB = sA + k * kLdc;
  float* sV = sB + k * kLdc;        // rx ry rz sw mask       5 x k
  const Gate gt{sV, sV + k, sV + 2 * k, sV + 3 * k, sV + 4 * k};
  const float* mk = gt.mk;
  const size_t atom = blockIdx.x;
  const size_t nk = atom * k, nkm = nk * m;

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    sV[j] = a.rx[nk + j];
    sV[k + j] = a.ry[nk + j];
    sV[2 * k + j] = a.rz[nk + j];
    sV[3 * k + j] = a.sw[nk + j];
    sV[4 * k + j] = a.mask[nk + j];
  }
  for (int e = threadIdx.x; e < k * m; e += blockDim.x)
    sG[(e / m) * ldm + e % m] = a.g[nkm + e];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = 0; l < a.layers; ++l) {
    const float* wq = a.wq + (size_t)l * m * h;
    const float* wk = a.wk + (size_t)l * m * h;
    const float* wv = a.wv + (size_t)l * m * h;
    const float* wo = a.wo + (size_t)l * h * m;
    const float* gamma = a.gamma + (size_t)l * m;
    const float* beta = a.beta + (size_t)l * m;
    for (int e = threadIdx.x; e < k * m; e += blockDim.x) {
      const float x = sG[(e / m) * ldm + e % m];
      if (a.stash) a.stash[((size_t)l * a.n + atom) * k * m + e] = x;
      sOut[(e / m) * ldm + e % m] = 0.f;
    }
    for (int hh = 0; hh < a.heads; ++hh) {
      scores_softmax<BF16>(sG, ldm, wq, wk, h, hh * hd, hd, sS, ldk, sA, sB,
                           k, m, mk, a.scale);
      for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
        const int i = e / k, j = e % k;
        sS[i * ldk + j] *= gt.gmul(i, j);
      }
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        const int cw = min(kChunk, hd - c0);
        const int col = hh * hd + c0;
        __syncthreads();
        block_mm<2, 2>(k, cw, m,
            [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
            [&](int d, int c) { return op<BF16>(__ldg(wv + (size_t)d * h + col + c)); },
            [&](int r, int c, float v) { sA[r * kLdc + c] = v; });
        __syncthreads();
        block_mm<2, 2>(k, cw, k,
            [&](int r, int d) { return op<BF16>(sS[r * ldk + d]); },
            [&](int d, int c) { return op<BF16>(sA[d * kLdc + c]); },
            [&](int r, int c, float v) { sB[r * kLdc + c] = v; });
        __syncthreads();
        block_mm<4, 4>(k, m, cw,
            [&](int r, int d) { return op<BF16>(sB[r * kLdc + d]); },
            [&](int d, int c) { return op<BF16>(__ldg(wo + (size_t)(col + d) * m + c)); },
            [&](int r, int c, float v) { sOut[r * ldm + c] += v; });
      }
      __syncthreads();
    }
    // residual + LayerNorm + row mask, one warp per row
    for (int i = warp; i < k; i += kWarps) {
      float* gr = sG + i * ldm;
      const float* orow = sOut + i * ldm;
      float s = 0.f;
      for (int j = lane; j < m; j += 32) s += gr[j] + orow[j];
      const float mu = warp_sum(s) / m;
      float v = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float d = gr[j] + orow[j] - mu;
        v += d * d;
      }
      const float inv = rsqrtf(warp_sum(v) / m + kLnEps);
      for (int j = lane; j < m; j += 32) {
        const float x = (gr[j] + orow[j] - mu) * inv;
        gr[j] = (x * gamma[j] + beta[j]) * mk[i];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < k * m; e += blockDim.x)
    a.out[nkm + e] = sG[(e / m) * ldm + e % m];
}

template <bool BF16, bool PARAMS, bool GMEM = false>
__global__ void __launch_bounds__(kThreads) stack_bwd_kernel(StackArgs a) {
  extern __shared__ float smem[];
  const int k = a.k, m = a.m, h = a.h, L = a.layers, hd = a.h / a.heads;
  // GMEM: the K x M tiles are unpadded rows in device memory
  const int ldm = GMEM ? m : m + 1, ldk = k + 1;
  float* ws = GMEM ? a.ws + blockIdx.x * 2 * (size_t)k * m : nullptr;
  float* sG = smem;                 // layer input (stash)           k x ldm
  float* sD = GMEM ? ws : sG + k * ldm;      // cotangent -> dg1     k x ldm
  float* sX = GMEM ? ws + k * m : sD + k * ldm;  // pre-norm sum -> xhat -> dgin
  float* sP = GMEM ? smem : sX + k * ldm;    // P -> dgmul           k x ldk
  float* sW = sP + k * ldk;         // dW -> ds                      k x ldk
  float* sA = sW + k * ldk;         // chunk buffers                 k x kLdc
  float* sB = sA + k * kLdc;
  float* sC = sB + k * kLdc;
  float* sE = sC + k * kLdc;
  float* sV = sE + k * kLdc;        // rx ry rz sw mask              5 x k
  float* sAcc = sV + 5 * k;         // drx dry drz dsw               4 x k
  float* sInv = sAcc + 4 * k;       // LayerNorm 1/sigma             k
  const Gate gt{sV, sV + k, sV + 2 * k, sV + 3 * k, sV + 4 * k};
  const float* mk = gt.mk;
  const size_t mh = (size_t)m * h;
  float* part = PARAMS ? a.part + blockIdx.x * (L * (4 * mh + 2 * (size_t)m))
                       : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (size_t atom = blockIdx.x; atom < (size_t)a.n; atom += gridDim.x) {
    const size_t nk = atom * k, nkm = nk * m;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      sV[j] = a.rx[nk + j];
      sV[k + j] = a.ry[nk + j];
      sV[2 * k + j] = a.rz[nk + j];
      sV[3 * k + j] = a.sw[nk + j];
      sV[4 * k + j] = a.mask[nk + j];
      sAcc[j] = sAcc[k + j] = sAcc[2 * k + j] = sAcc[3 * k + j] = 0.f;
    }
    for (int e = threadIdx.x; e < k * m; e += blockDim.x)
      sD[(e / m) * ldm + e % m] = a.dout[nkm + e];

    for (int l = L - 1; l >= 0; --l) {
      const float* wq = a.wq + (size_t)l * mh;
      const float* wk = a.wk + (size_t)l * mh;
      const float* wv = a.wv + (size_t)l * mh;
      const float* wo = a.wo + (size_t)l * mh;
      const float* gamma = a.gamma + (size_t)l * m;
      float* pwq = part + (size_t)l * mh;
      float* pwk = part + L * mh + (size_t)l * mh;
      float* pwv = part + 2 * L * mh + (size_t)l * mh;
      float* pwo = part + 3 * L * mh + (size_t)l * mh;
      float* pgamma = part + 4 * L * mh + (size_t)l * m;
      float* pbeta = part + 4 * L * mh + (size_t)L * m + (size_t)l * m;

      __syncthreads();
      if constexpr (GMEM) {
        sG = a.stash + ((size_t)l * a.n + atom) * k * m;
        for (int e = threadIdx.x; e < k * m; e += blockDim.x) sX[e] = 0.f;
      } else {
        for (int e = threadIdx.x; e < k * m; e += blockDim.x) {
          sG[(e / m) * ldm + e % m] = a.stash[((size_t)l * a.n + atom) * k * m + e];
          sX[(e / m) * ldm + e % m] = 0.f;
        }
      }
      // -- recompute the layer's pre-norm sum into sX --------------------
      for (int hh = 0; hh < a.heads; ++hh) {
        scores_softmax<BF16>(sG, ldm, wq, wk, h, hh * hd, hd, sP, ldk, sA, sB,
                             k, m, mk, a.scale);
        for (int c0 = 0; c0 < hd; c0 += kChunk) {
          const int cw = min(kChunk, hd - c0);
          const int col = hh * hd + c0;
          __syncthreads();
          block_mm<2, 2>(k, cw, m,
              [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
              [&](int d, int c) { return op<BF16>(__ldg(wv + (size_t)d * h + col + c)); },
              [&](int r, int c, float v) { sA[r * kLdc + c] = v; });
          __syncthreads();
          block_mm<2, 2>(k, cw, k,
              [&](int r, int d) { return op<BF16>(sP[r * ldk + d] * gt.gmul(r, d)); },
              [&](int d, int c) { return op<BF16>(sA[d * kLdc + c]); },
              [&](int r, int c, float v) { sB[r * kLdc + c] = v; });
          __syncthreads();
          block_mm<4, 4>(k, m, cw,
              [&](int r, int d) { return op<BF16>(sB[r * kLdc + d]); },
              [&](int d, int c) { return op<BF16>(__ldg(wo + (size_t)(col + d) * m + c)); },
              [&](int r, int c, float v) { sX[r * ldm + c] += v; });
        }
        __syncthreads();
      }
      // -- LayerNorm backward --------------------------------------------
      for (int i = warp; i < k; i += kWarps) {
        float* xr = sX + i * ldm;
        const float* gr = sG + i * ldm;
        float s = 0.f;
        for (int j = lane; j < m; j += 32) s += gr[j] + xr[j];
        const float mu = warp_sum(s) / m;
        float v = 0.f;
        for (int j = lane; j < m; j += 32) {
          const float d = gr[j] + xr[j] - mu;
          v += d * d;
        }
        const float inv = rsqrtf(warp_sum(v) / m + kLnEps);
        for (int j = lane; j < m; j += 32) xr[j] = (gr[j] + xr[j] - mu) * inv;
        if (lane == 0) sInv[i] = inv;
      }
      __syncthreads();
      if constexpr (PARAMS) {
        for (int c = threadIdx.x; c < m; c += blockDim.x) {
          float sg = 0.f, sb = 0.f;
          for (int r = 0; r < k; ++r) {
            const float dln = sD[r * ldm + c] * mk[r];
            sg += dln * sX[r * ldm + c];
            sb += dln;
          }
          pgamma[c] += sg;
          pbeta[c] += sb;
        }
        __syncthreads();
      }
      for (int i = warp; i < k; i += kWarps) {
        float* dr = sD + i * ldm;
        float* xr = sX + i * ldm;
        float s1 = 0.f, s2 = 0.f;
        for (int j = lane; j < m; j += 32) {
          const float dxh = dr[j] * mk[i] * gamma[j];
          s1 += dxh;
          s2 += dxh * xr[j];
        }
        const float mean1 = warp_sum(s1) / m, mean2 = warp_sum(s2) / m;
        for (int j = lane; j < m; j += 32) {
          const float dxh = dr[j] * mk[i] * gamma[j];
          dr[j] = sInv[i] * (dxh - mean1 - xr[j] * mean2);   // dg1
          xr[j] = 0.f;                                        // dgin acc
        }
      }
      // -- attention backward, head by head ------------------------------
      for (int hh = 0; hh < a.heads; ++hh) {
        if (a.heads > 1)
          scores_softmax<BF16>(sG, ldm, wq, wk, h, hh * hd, hd, sP, ldk, sA,
                               sB, k, m, mk, a.scale);
        for (int c0 = 0; c0 < hd; c0 += kChunk) {
          const int cw = min(kChunk, hd - c0);
          const int col = hh * hd + c0;
          __syncthreads();
          // V_c (recomputed as the forward did) and do_c = dg1 Wo_c^T
          block_mm<2, 2>(k, cw, m,
              [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
              [&](int d, int c) { return op<BF16>(__ldg(wv + (size_t)d * h + col + c)); },
              [&](int r, int c, float v) { sA[r * kLdc + c] = v; });
          block_mm<2, 2>(k, cw, m,
              [&](int r, int d) { return sD[r * ldm + d]; },
              [&](int d, int c) { return __ldg(wo + (size_t)(col + c) * m + d); },
              [&](int r, int c, float v) { sB[r * kLdc + c] = v; });
          __syncthreads();
          // dW += do_c V_c^T;  dv_c = W^T do_c;  [O_c = W V_c for dWo]
          block_mm<4, 4>(k, k, cw,
              [&](int r, int d) { return sB[r * kLdc + d]; },
              [&](int d, int c) { return sA[c * kLdc + d]; },
              [&](int r, int c, float v) {
                if (c0 == 0) sW[r * ldk + c] = v; else sW[r * ldk + c] += v;
              });
          block_mm<2, 2>(k, cw, k,
              [&](int r, int d) { return sP[d * ldk + r] * gt.gmul(d, r); },
              [&](int d, int c) { return sB[d * kLdc + c]; },
              [&](int r, int c, float v) { sC[r * kLdc + c] = v; });
          if constexpr (PARAMS) {
            block_mm<2, 2>(k, cw, k,
                [&](int r, int d) { return op<BF16>(sP[r * ldk + d] * gt.gmul(r, d)); },
                [&](int d, int c) { return op<BF16>(sA[d * kLdc + c]); },
                [&](int r, int c, float v) { sE[r * kLdc + c] = v; });
          }
          __syncthreads();
          // dgin += dv_c Wv_c^T
          block_mm<4, 4>(k, m, cw,
              [&](int r, int d) { return sC[r * kLdc + d]; },
              [&](int d, int c) { return __ldg(wv + (size_t)c * h + col + d); },
              [&](int r, int c, float v) { sX[r * ldm + c] += v; });
          if constexpr (PARAMS) {
            block_mm<4, 2>(m, cw, k,
                [&](int r, int d) { return sG[d * ldm + r]; },
                [&](int d, int c) { return sC[d * kLdc + c]; },
                [&](int r, int c, float v) { pwv[(size_t)r * h + col + c] += v; });
            block_mm<2, 4>(cw, m, k,
                [&](int r, int d) { return sE[d * kLdc + r]; },
                [&](int d, int c) { return sD[d * ldm + c]; },
                [&](int r, int c, float v) { pwo[(size_t)(col + r) * m + c] += v; });
          }
        }
        __syncthreads();
        // softmax backward: ds -> sW, dgmul = dW * P -> sP (row-local)
        for (int i = warp; i < k; i += kWarps) {
          float* wr = sW + i * ldk;
          float* pr = sP + i * ldk;
          float dot = 0.f;
          for (int j = lane; j < k; j += 32) dot += wr[j] * gt.gmul(i, j) * pr[j];
          dot = warp_sum(dot);
          for (int j = lane; j < k; j += 32) {
            const float dw = wr[j], p = pr[j];
            wr[j] = p * (dw * gt.gmul(i, j) - dot) * a.scale;
            pr[j] = dw * p;
          }
        }
        __syncthreads();
        // gate expansion of this head's dgmul onto dr_hat and dsw
        for (int i = threadIdx.x; i < k; i += blockDim.x) {
          float ax = 0.f, ay = 0.f, az = 0.f, as = 0.f;
          for (int j = 0; j < k; ++j) {
            const float mm = mk[i] * mk[j];
            const float swsw = gt.sw[i] * gt.sw[j];
            const float gij = sP[i * ldk + j], gji = sP[j * ldk + i];
            const float sym = (gij + gji) * swsw * mm;
            ax += sym * gt.rx[j];
            ay += sym * gt.ry[j];
            az += sym * gt.rz[j];
            as += (gij + gji) * gt.gate(i, j) * mm * gt.sw[j];
          }
          sAcc[i] += ax;
          sAcc[k + i] += ay;
          sAcc[2 * k + i] += az;
          sAcc[3 * k + i] += as;
        }
        // dq_c = ds K_c, dk_c = ds^T Q_c; dgin += dq_c Wq_c^T + dk_c Wk_c^T
        for (int c0 = 0; c0 < hd; c0 += kChunk) {
          const int cw = min(kChunk, hd - c0);
          const int col = hh * hd + c0;
          __syncthreads();
          block_mm<2, 2>(k, cw, m,
              [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
              [&](int d, int c) { return op<BF16>(__ldg(wq + (size_t)d * h + col + c)); },
              [&](int r, int c, float v) { sA[r * kLdc + c] = v; });
          block_mm<2, 2>(k, cw, m,
              [&](int r, int d) { return op<BF16>(sG[r * ldm + d]); },
              [&](int d, int c) { return op<BF16>(__ldg(wk + (size_t)d * h + col + c)); },
              [&](int r, int c, float v) { sB[r * kLdc + c] = v; });
          __syncthreads();
          block_mm<2, 2>(k, cw, k,
              [&](int r, int d) { return sW[r * ldk + d]; },
              [&](int d, int c) { return sB[d * kLdc + c]; },
              [&](int r, int c, float v) { sC[r * kLdc + c] = v; });
          block_mm<2, 2>(k, cw, k,
              [&](int r, int d) { return sW[d * ldk + r]; },
              [&](int d, int c) { return sA[d * kLdc + c]; },
              [&](int r, int c, float v) { sE[r * kLdc + c] = v; });
          __syncthreads();
          block_mm<4, 4>(k, m, 2 * cw,
              [&](int r, int d) {
                return d < cw ? sC[r * kLdc + d] : sE[r * kLdc + d - cw];
              },
              [&](int d, int c) {
                return d < cw ? __ldg(wq + (size_t)c * h + col + d)
                              : __ldg(wk + (size_t)c * h + col + d - cw);
              },
              [&](int r, int c, float v) { sX[r * ldm + c] += v; });
          if constexpr (PARAMS) {
            block_mm<4, 2>(m, cw, k,
                [&](int r, int d) { return sG[d * ldm + r]; },
                [&](int d, int c) { return sC[d * kLdc + c]; },
                [&](int r, int c, float v) { pwq[(size_t)r * h + col + c] += v; });
            block_mm<4, 2>(m, cw, k,
                [&](int r, int d) { return sG[d * ldm + r]; },
                [&](int d, int c) { return sE[d * kLdc + c]; },
                [&](int r, int c, float v) { pwk[(size_t)r * h + col + c] += v; });
          }
        }
        __syncthreads();
      }
      // dg for the layer below = dg1 + dgin
      for (int e = threadIdx.x; e < k * m; e += blockDim.x) {
        const int idx = (e / m) * ldm + e % m;
        sD[idx] += sX[idx];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < k * m; e += blockDim.x)
      a.dg[nkm + e] = sD[(e / m) * ldm + e % m];
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      a.drx[nk + j] = sAcc[j];
      a.dry[nk + j] = sAcc[k + j];
      a.drz[nk + j] = sAcc[2 * k + j];
      a.dsw[nk + j] = sAcc[3 * k + j];
    }
    __syncthreads();
  }
}

// out[i] = sum over blocks b (in order) of part[b * size + i]
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int nblk,
                                       long long size) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < size;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(size_t)b * size + i];
    out[i] = s;
  }
}

template <class Kern>
int launch(Kern kern, int grid, size_t smem, cudaStream_t stream,
           const StackArgs& a) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t nbr_attn_fwd_smem(int k, int m) { return sizeof(float) * fwd_floats(k, m); }
size_t nbr_attn_bwd_smem(int k, int m) { return sizeof(float) * bwd_floats(k, m); }
size_t nbr_attn_bwd_gmem_smem(int k, int m) { return sizeof(float) * bwd_gmem_floats(k); }
int nbr_attn_chunk() { return kChunk; }
// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int nbr_attn_fwd(const float* g, const float* rx, const float* ry,
                 const float* rz, const float* sw, const float* mask,
                 const float* wq, const float* wk, const float* wv,
                 const float* wo, const float* gamma, const float* beta,
                 float* out, float* stash, int n, int k, int m, int h,
                 int layers, int heads, int bf16, float scale, void* stream) {
  StackArgs a{};
  a.g = g; a.rx = rx; a.ry = ry; a.rz = rz; a.sw = sw; a.mask = mask;
  a.wq = wq; a.wk = wk; a.wv = wv; a.wo = wo; a.gamma = gamma; a.beta = beta;
  a.out = out; a.stash = stash;
  a.n = n; a.k = k; a.m = m; a.h = h; a.layers = layers; a.heads = heads;
  a.scale = scale;
  const size_t smem = nbr_attn_fwd_smem(k, m);
  auto kern = bf16 ? &stack_fwd_kernel<true> : &stack_fwd_kernel<false>;
  return launch(kern, n, smem, (cudaStream_t)stream, a);
}

int nbr_attn_bwd(const float* stash, const float* rx, const float* ry,
                 const float* rz, const float* sw, const float* mask,
                 const float* wq, const float* wk, const float* wv,
                 const float* wo, const float* gamma, const float* beta,
                 const float* dout, float* dg, float* drx, float* dry,
                 float* drz, float* dsw, float* part, float* ws, int nblk,
                 int n, int k, int m, int h, int layers, int heads, int bf16,
                 float scale, void* stream) {
  StackArgs a{};
  a.stash = const_cast<float*>(stash);
  a.rx = rx; a.ry = ry; a.rz = rz; a.sw = sw; a.mask = mask;
  a.wq = wq; a.wk = wk; a.wv = wv; a.wo = wo; a.gamma = gamma; a.beta = beta;
  a.dout = dout; a.dg = dg; a.drx = drx; a.dry = dry; a.drz = drz; a.dsw = dsw;
  a.part = part; a.ws = ws;
  a.n = n; a.k = k; a.m = m; a.h = h; a.layers = layers; a.heads = heads;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (ws) {
    // persistent grid: nblk CTAs, one workspace slot each
    const size_t smem = nbr_attn_bwd_gmem_smem(k, m);
    if (part) {
      auto kern = bf16 ? &stack_bwd_kernel<true, true, true>
                       : &stack_bwd_kernel<false, true, true>;
      return launch(kern, nblk, smem, s, a);
    }
    auto kern = bf16 ? &stack_bwd_kernel<true, false, true>
                     : &stack_bwd_kernel<false, false, true>;
    return launch(kern, nblk, smem, s, a);
  }
  const size_t smem = nbr_attn_bwd_smem(k, m);
  if (part) {
    auto kern = bf16 ? &stack_bwd_kernel<true, true> : &stack_bwd_kernel<false, true>;
    return launch(kern, nblk, smem, s, a);
  }
  auto kern = bf16 ? &stack_bwd_kernel<true, false> : &stack_bwd_kernel<false, false>;
  return launch(kern, n, smem, s, a);
}

// CTAs of the GMEM backward that are resident at once (SMs x blocks per SM):
// its persistent grid and the number of workspace slots; <= 0 on error
int nbr_attn_bwd_gmem_blocks(int k, int m, int params, int bf16) {
  const size_t smem = nbr_attn_bwd_gmem_smem(k, m);
  auto kern = params ? (bf16 ? &stack_bwd_kernel<true, true, true>
                             : &stack_bwd_kernel<false, true, true>)
                     : (bf16 ? &stack_bwd_kernel<true, false, true>
                             : &stack_bwd_kernel<false, false, true>);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

int nbr_attn_reduce(const float* part, float* out, int nblk, long long size,
                    void* stream) {
  cudaGetLastError();
  const int threads = 256;
  long long blocks = (size + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  reduce_partials_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      part, out, nblk, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
