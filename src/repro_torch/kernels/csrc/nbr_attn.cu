// DPA-1 gated neighbour-attention stack: forward and analytic backward for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces repro/kernels/nbr_attn.py::_stack_fwd_kernel and
// ::_stack_bwd_kernel (custom VJP nbr_attention_stack).
//
// Work: per centre atom, l_a layers of QKV projections (M -> H), K x K
// scores, softmax x angular gate, value mix, out-projection (H -> M),
// residual and LayerNorm.  Per atom with n valid neighbours and layer: the
// forward 8nMH + 4n^2 H FLOPs, the backward without parameter gradients
// (forward recompute included) 16nMH + 12n^2 H, against ~n M words of
// activations, so the stack is bound by fp32 operations on the H100 (67
// TFLOP/s outside the tensor cores), not by bytes.  Everything stays fp32
// (the force gates are E rtol 1e-5, F atol 1e-4 x max|F|): no TF32.
//
// Which instance runs which code:
//
// * Compacted rows: the forward (every caller: the force path, inference
//   and training; nbr_attn_fwd_rows) and the force-path backward (no
//   parameter gradients; nbr_attn_bwd_rows).  The wrapper
//   (nbr_attn.py::compact_rows) gathers each atom's valid slots in
//   ascending slot order and stacks them, atoms longest first, into R rows;
//   the kernels never see a masked slot, and the wrapper's zero-filled
//   outputs keep exact zeros there (a fully masked atom costs nothing but
//   that fill).  Dropping the masked slots changes no sum but by +0 terms:
//   a masked key has p = 0 and a zero gate column, a masked row's output is
//   multiplied by its mask, 0, and in the backward dln = dg * mask is 0 on
//   it.  Per layer the forward runs four steps and the backward seven
//   (see "The stack over compacted rows" below): the four M <-> H
//   projections are GEMMs over all stacked rows of the pass
//   (rows_gemm_kernel: a 128 x 128 output tile per 256-thread CTA, 8 x 8
//   per thread, both operands staged k-major in shared memory through a
//   3-stage cp.async ring, so one weight tile serves 128 rows of many atoms
//   and every inner-loop read is a 16-byte load); each projection is
//   computed once per layer and kept in device memory (Q|K|V and dQ|dK|dV
//   as R x 3H, O then dO as R x H) until the next step has used it.  The
//   n x n attention parts run one CTA per atom (rows_attn_fwd_kernel,
//   rows_attn_bwd_kernel): P, and then W = P o gmul, dW, ds and dgmul, are
//   formed once per layer and head as n x n tiles in shared memory (the
//   gate is evaluated once per element, never inside a product's depth
//   loop), and every product runs 4 x 4 register tiles with 16-byte shared
//   loads, on 32-column chunks of the head.  The LayerNorm forward and
//   backward are one warp per row.  Rows are M wide with M a multiple of 4
//   (16-byte rows): the wrapper zero-pads any other width, and the
//   LayerNorm takes the true width apart from the row stride, so its
//   statistics see the true columns only and the padded ones stay 0.  The forward keeps every layer's input
//   rows (L x R x M, the stash) for the backward, which reads them where it
//   recomputes steps 1-3 through the same code, so both directions see the
//   same bits.  Shared memory per attention CTA is sized by the pass's
//   longest atom: two n x n tiles, two chunks and ten vectors, 177 KB at
//   n = 128 (one CTA of 256 threads per SM), 56 KB at n = 64 (four CTAs of
//   128 threads).  No persistent grid: atoms go out longest first, so the
//   tail holds the short ones.  K <= 128 = MAX_K, also for an atom whose
//   128 slots are all valid (the limit is nbr_attn_rows_smem(n) <= 227 KB:
//   n <= 148).  Passes of at most 2^20 stacked rows (nbr_attn.py::
//   ROW_PASS) bound the scratch memory (4.6 KB per row forward, 8.2 KB
//   backward).  No atomics, and every sum over a row's or an atom's terms
//   runs in an order fixed by that row or atom alone: an atom's result does
//   not depend on its place in a GEMM tile, its pass or its CTA's width,
//   and a repeated call gives the same bits.
//
// * Backward with parameter gradients (training, off the force path;
//   nbr_attn_bwd, stack_bwd_kernel): the earlier design, one 512-thread CTA
//   per atom over all K slots.  The TPU kernel += its parameter gradients
//   into accumulators that persist across a sequential grid; on a GPU that
//   is a race, so a fixed number of CTAs stride over atoms in a fixed order
//   into their own partial sums, and a second kernel adds the partials in
//   block order (no atomics).  Shared-memory instance for K <= 89 at
//   M = 128; above that (GMEM) the three K x M tiles live in a per-CTA
//   device workspace served by L2 and a persistent grid of one CTA per
//   workspace slot strides over atoms (K <= 152).
//
// bf16 mode (compute_dtype) rounds every matmul operand to bf16 where the
// JAX kernel casts it and accumulates in fp32, in every instance.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 512;      // 16 warps (the parameter-gradient backward)
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;          // H columns per streamed chunk
constexpr int kLdc = kChunk + 1;    // padded row stride of chunk buffers
constexpr float kLnEps = 1e-5f;

struct StackArgs {
  const float *rx, *ry, *rz, *sw, *mask;
  const float *wq, *wk, *wv, *wo, *gamma, *beta;
  const float *dout;
  float *stash;
  float *dg, *drx, *dry, *drz, *dsw, *part, *ws;
  int n, k, m, h, layers, heads;
  float scale;
};

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

template <bool BF16, bool GMEM = false>
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
  float* part = a.part + blockIdx.x * (L * (4 * mh + 2 * (size_t)m));
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
      {
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
          {
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
          {
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
          {
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

// ---------------------------------------------------------------------------
// The stack over compacted rows: the forward and the force-path backward
// (no parameter gradients).
//
// The wrapper gathers each atom's valid slots (ascending slot order) and
// stacks them, atom after atom, into R rows; atoms run longest first, in
// passes of consecutive atoms.  X_l holds layer l's input rows (X_0 =
// g[rows]); the forward keeps them all (the stash).  Forward, per layer:
//   1. QKV = X_l [Wq | Wk | Wv]                rows_gemm (3 launches)
//   2. O   = (P o gate) V                      rows_attn_fwd, one CTA/atom
//   3. Y   = X_l + O Wo                        rows_gemm
//   4. X_l+1 = (LN(Y) gamma + beta) mask       rows_ln_fwd, one warp/row (to
//                                              out at the slots, top layer)
// Backward, per layer from the top: steps 1-3 from the stash, then
//   4. dg1 = LayerNorm backward of Y, D        rows_ln_bwd, one warp/row
//   5. dO  = dg1 Wo^T                          rows_gemm
//   6. dQ, dK, dV; gate cotangent -> per row   rows_attn_bwd, one CTA/atom
//   7. D   = dg1 + [dQ dK dV] [Wq Wk Wv]^T     rows_gemm (scattered to dg at
//                                              the last layer)
// ---------------------------------------------------------------------------

constexpr int GBM = 128, GBN = 128, GBK = 8, GST = 3, GLD = GBM + 4;
constexpr int GTHREADS = 256;
constexpr int ATT_THREADS = 256;      // the most; 128 for atoms of <= 64
constexpr int CW = 32;                // head columns per streamed chunk
constexpr int CLD = CW + 4;           // row stride of a row-major chunk

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool BF16>
__device__ __forceinline__ float4 op4(float4 v) {
  return make_float4(op<BF16>(v.x), op<BF16>(v.y), op<BF16>(v.z),
                     op<BF16>(v.w));
}

// C[r] = A[r] B (+ E[r]) over R rows; A row r at a + a_rows[r] * lda (a_rows
// null: r * lda), the same for E and C.  B is Kd x N, row-major (b[0], ldb),
// or with b_trans B(k, n) = b[k / seg][n * ldb + k % seg] (the transposes
// of up to three matrices stacked along k; seg % GBK == 0).
struct GemmArgs {
  const float* a;
  const long long* a_rows;
  int lda;
  const float* b[3];
  int ldb, seg, b_trans;
  const float* add;
  const long long* add_rows;
  int ld_add;
  float* c;
  const long long* c_rows;
  int ldc;
  int R, N, Kd;
};

// 128 x 128 output tile per CTA, 8 x 8 per thread (two 4 x 4 quadrants),
// depth steps of 8 through a 3-stage cp.async ring; both operands are kept
// k-major in shared memory so every inner-loop read is a 16-byte load.
template <bool RND>
__global__ void __launch_bounds__(GTHREADS) rows_gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[GST][GBK][GLD];
  __shared__ __align__(16) float Bs[GST][GBK][GLD];
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // loader: 4 elements of each operand per thread and stage
  const float* arow[4];
  bool aok[4], bok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + GTHREADS * i;
    const int r = m0 + (e >> 3);
    aok[i] = r < g.R;
    arow[i] = aok[i] ? g.a + (g.a_rows ? g.a_rows[r] : (long long)r) * g.lda
                     : g.a;
    bok[i] = n0 + (g.b_trans ? e >> 3 : e & (GBN - 1)) < g.N;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // step `it` issues the loads of depth tile `it` (stage it % GST) and
  // computes tile it - (GST - 1)
  const int KT = (g.Kd + GBK - 1) / GBK;
  for (int it = 0; it < KT + GST - 1; ++it) {
    const int ct = it - (GST - 1);
    if (ct >= 0) {
      cp_async_wait<GST - 2>();
      __syncthreads();   // tile ct landed; the stage loaded below is consumed
    }
    if (it < KT) {
      const int k0 = it * GBK, st = it % GST;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + GTHREADS * i;
        {
          const int kk = e & 7, r = e >> 3, k = k0 + kk;
          const bool ok = aok[i] && k < g.Kd;
          cp_async4(&As[st][kk][r], ok ? arow[i] + k : g.a, ok);
        }
        if (g.b_trans) {
          const int kk = e & 7, nl = e >> 3, k = k0 + kk;
          // (no dynamic index into the parameter array: that would copy it
          // to the stack)
          const int sg = k0 / g.seg;
          const float* bs = sg == 0 ? g.b[0] : sg == 1 ? g.b[1] : g.b[2];
          const bool ok = bok[i] && k < g.Kd;
          const float* src =
              ok ? bs + (long long)(n0 + nl) * g.ldb + (k - sg * g.seg) : g.b[0];
          cp_async4(&Bs[st][kk][nl], src, ok);
        } else {
          const int kk = e >> 7, nl = e & (GBN - 1), k = k0 + kk;
          const bool ok = bok[i] && k < g.Kd;
          cp_async4(&Bs[st][kk][nl],
                    ok ? g.b[0] + (long long)k * g.ldb + n0 + nl : g.b[0], ok);
        }
      }
    }
    cp_async_commit();
    if (ct < 0) continue;
    const int st = ct % GST;
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      a0 = op4<RND>(a0);
      a1 = op4<RND>(a1);
      b0 = op4<RND>(b0);
      b1 = op4<RND>(b1);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= g.R) continue;
    float* crow = g.c + (g.c_rows ? g.c_rows[r] : (long long)r) * g.ldc;
    const float* erow =
        g.add ? g.add + (g.add_rows ? g.add_rows[r] : (long long)r) * g.ld_add
              : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= g.N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (erow) {
        const float4 e = *reinterpret_cast<const float4*>(erow + n);
        v = make_float4(e.x + v.x, e.y + v.y, e.z + v.z, e.w + v.w);
      }
      *reinterpret_cast<float4*>(crow + n) = v;
    }
  }
}

// C (rows x cols) = A B with A stored k-major (at[d * lda + r]) and B
// row-major (b[d * ldb + c]): 4 x 4 register tiles, 16-byte shared loads.
// rows and cols are multiples of 4; epi(r0, c0, acc) stores a tile.
template <bool RND, class Epi>
__device__ __forceinline__ void mm44(int rows, int cols, int depth,
                                     const float* at, int lda, const float* b,
                                     int ldb, Epi epi) {
  const int tc = cols >> 2, tiles = (rows >> 2) * tc;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int r0 = (t / tc) * 4, c0 = (t % tc) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* pa = at + r0;
    const float* pb = b + c0;
#pragma unroll 4
    for (int d = 0; d < depth; ++d) {
      const float4 a = op4<RND>(*reinterpret_cast<const float4*>(pa + d * lda));
      const float4 bb = op4<RND>(*reinterpret_cast<const float4*>(pb + d * ldb));
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    epi(r0, c0, acc);
  }
}

// Shared memory of the per-atom attention kernels for atoms of at most
// n_max valid neighbours: two n x n tiles, two column chunks, ten vectors.
__host__ __device__ inline int rows_np(int n) { return (n + 3) & ~3; }
__host__ __device__ inline size_t rows_attn_floats(int n_max) {
  const size_t np = rows_np(n_max), ldn = np + 4;
  const size_t chunk = CW * ldn > np * CLD ? CW * ldn : np * CLD;
  return 2 * np * ldn + 2 * chunk + 10 * np;
}

struct RowsArgs {
  const float *rx, *ry, *rz, *sw, *mask;   // (N, K) planes
  const long long* rows;                   // flat slot of each stacked row
  const long long* start;                  // first stacked row of each atom
  const long long* count;                  // valid slots of each atom
  long long r0;                            // stacked row of this pass's row 0
  const float* qkv;                        // (R, 3H): Q | K | V
  const float* dO;                         // (R, H)
  float* out;                              // O (R, H) or dQKV (R, 3H)
  float* gacc;                             // (R, 4): drx dry drz dsw so far
  float *drx, *dry, *drz, *dsw;            // (N, K), written at the last layer
  int h, heads, ldn, first, last;
  float scale;
};

// Per-atom set-up: geometry of the valid slots into shared memory.
struct AtomTiles {
  float *t1, *t2, *c1, *c2, *rx, *ry, *rz, *sw, *mk, *acc;
  int n, np;
  long long base;   // stacked row of the atom's first slot in this pass
};

__device__ __forceinline__ AtomTiles atom_setup(const RowsArgs& a,
                                                float* smem, int n_max_ldn) {
  AtomTiles t;
  const int atom = blockIdx.x;
  t.n = (int)a.count[atom];
  t.np = rows_np(t.n);
  t.base = a.start[atom] - a.r0;
  const int ldn = n_max_ldn, np_max = ldn - 4;
  const size_t chunk = (size_t)CW * ldn > (size_t)np_max * CLD
                           ? (size_t)CW * ldn : (size_t)np_max * CLD;
  t.t1 = smem;
  t.t2 = t.t1 + (size_t)np_max * ldn;
  t.c1 = t.t2 + (size_t)np_max * ldn;
  t.c2 = t.c1 + chunk;
  t.rx = t.c2 + chunk;
  t.ry = t.rx + np_max;
  t.rz = t.ry + np_max;
  t.sw = t.rz + np_max;
  t.mk = t.sw + np_max;
  t.acc = t.mk + np_max;    // 4 x np_max, then 1 x np_max spare
  for (int i = threadIdx.x; i < t.np; i += blockDim.x) {
    float x = 0.f, y = 0.f, z = 0.f, s = 0.f, m = 0.f;
    if (i < t.n) {
      const long long slot = a.rows[t.base + i];
      x = a.rx[slot]; y = a.ry[slot]; z = a.rz[slot];
      s = a.sw[slot]; m = a.mask[slot];
    }
    t.rx[i] = x; t.ry[i] = y; t.rz[i] = z; t.sw[i] = s; t.mk[i] = m;
  }
  return t;
}

// gmul of the reference: (r_i . r_j) (sw_i sw_j) (mask_i mask_j)
__device__ __forceinline__ float gmul_at(const AtomTiles& t, int i, int j) {
  const float gate = t.rx[i] * t.rx[j] + t.ry[i] * t.ry[j] + t.rz[i] * t.rz[j];
  return gate * (t.sw[i] * t.sw[j]) * (t.mk[i] * t.mk[j]);
}

// chunk of cw columns of the stacked (R, ld) matrix src, starting at col:
// transposed (dst[d * ldn + i]) or row-major (dst[i * CLD + d]); rows
// n..np-1 are zero.  cw is a multiple of 4.
template <bool BF16>
__device__ __forceinline__ void load_chunk_t(float* dst, int ldn,
                                             const float* src, int ld,
                                             const AtomTiles& t, int col,
                                             int cw) {
  const int q4 = cw >> 2;
  for (int e = threadIdx.x; e < t.np * q4; e += blockDim.x) {
    const int i = e % t.np, d = (e / t.np) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < t.n)
      v = op4<BF16>(*reinterpret_cast<const float4*>(
          src + (t.base + i) * ld + col + d));
    dst[d * ldn + i] = v.x;
    dst[(d + 1) * ldn + i] = v.y;
    dst[(d + 2) * ldn + i] = v.z;
    dst[(d + 3) * ldn + i] = v.w;
  }
}
template <bool BF16>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int ld, const AtomTiles& t,
                                           int col, int cw) {
  const int q4 = cw >> 2;
  for (int e = threadIdx.x; e < t.np * q4; e += blockDim.x) {
    const int i = e / q4, d = (e % q4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < t.n)
      v = op4<BF16>(*reinterpret_cast<const float4*>(
          src + (t.base + i) * ld + col + d));
    *reinterpret_cast<float4*>(dst + i * CLD + d) = v;
  }
}

// t1 <- P = softmax_j(scale * Q_h K_h^T) over the atom's n valid slots
// (rows and columns n..np-1 of P are zero).  Ends with a barrier.
template <bool BF16>
__device__ void rows_scores(const RowsArgs& a, const AtomTiles& t, int col0,
                            int hd) {
  const int ldn = a.ldn, ld = 3 * a.h;
  for (int c0 = 0; c0 < hd; c0 += CW) {
    const int cw = min(CW, hd - c0);
    __syncthreads();
    load_chunk_t<BF16>(t.c1, ldn, a.qkv, ld, t, col0 + c0, cw);
    load_chunk_t<BF16>(t.c2, ldn, a.qkv, ld, t, a.h + col0 + c0, cw);
    __syncthreads();
    mm44<false>(t.np, t.np, cw, t.c1, ldn, t.c2, ldn,
                [&](int r0, int cc0, const float (&acc)[4][4]) {
                  for (int i = 0; i < 4; ++i) {
                    float4* p = reinterpret_cast<float4*>(t.t1 + (r0 + i) * ldn + cc0);
                    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                    if (c0 > 0) {
                      const float4 o = *p;
                      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
                    }
                    *p = v;
                  }
                });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < t.np; i += nw) {
    float* row = t.t1 + i * ldn;
    if (i >= t.n) {
      for (int j = lane; j < t.np; j += 32) row[j] = 0.f;
      continue;
    }
    float mx = -FLT_MAX;
    for (int j = lane; j < t.n; j += 32) mx = fmaxf(mx, row[j] * a.scale);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < t.n; j += 32) {
      const float e = expf(row[j] * a.scale - mx);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < t.np; j += 32) row[j] = j < t.n ? row[j] / s : 0.f;
  }
  __syncthreads();
}

// O = (P o gmul) V, head by head, for one atom (step 2).
template <bool BF16>
__global__ void __launch_bounds__(ATT_THREADS) rows_attn_fwd_kernel(RowsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const AtomTiles t = atom_setup(a, smem, a.ldn);
  const int ldn = a.ldn, hd = a.h / a.heads, ld = 3 * a.h;
  for (int hh = 0; hh < a.heads; ++hh) {
    const int col0 = hh * hd;
    rows_scores<BF16>(a, t, col0, hd);
    // t2 <- W^T, W = P o gmul (the A operand of O = W V, k-major)
    for (int e = threadIdx.x; e < t.np * t.np; e += blockDim.x) {
      const int i = e / t.np, j = e % t.np;
      t.t2[j * ldn + i] = op<BF16>(t.t1[i * ldn + j] * gmul_at(t, i, j));
    }
    for (int c0 = 0; c0 < hd; c0 += CW) {
      const int cw = min(CW, hd - c0);
      __syncthreads();
      load_chunk<BF16>(t.c1, a.qkv, ld, t, 2 * a.h + col0 + c0, cw);
      __syncthreads();
      mm44<false>(t.np, cw, t.n, t.t2, ldn, t.c1, CLD,
                  [&](int r0, int cc0, const float (&acc)[4][4]) {
                    for (int i = 0; i < 4; ++i) {
                      if (r0 + i >= t.n) break;
                      *reinterpret_cast<float4*>(
                          a.out + (t.base + r0 + i) * a.h + col0 + c0 + cc0) =
                          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                    }
                  });
    }
  }
}

// dQ, dK, dV and the gate cotangent of one atom (step 6).
template <bool BF16>
__global__ void __launch_bounds__(ATT_THREADS) rows_attn_bwd_kernel(RowsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const AtomTiles t = atom_setup(a, smem, a.ldn);
  const int ldn = a.ldn, hd = a.h / a.heads, ld = 3 * a.h, h = a.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < 4 * t.np; i += blockDim.x) t.acc[i] = 0.f;
  auto store = [&](int col) {
    return [&, col](int r0, int cc0, const float (&acc)[4][4]) {
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= t.n) break;
        *reinterpret_cast<float4*>(a.out + (t.base + r0 + i) * ld + col + cc0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    };
  };
  for (int hh = 0; hh < a.heads; ++hh) {
    const int col0 = hh * hd;
    rows_scores<BF16>(a, t, col0, hd);              // t1 = P
    for (int e = threadIdx.x; e < t.np * t.np; e += blockDim.x) {
      const int i = e / t.np, j = e % t.np;         // t2 = W = P o gmul
      t.t2[i * ldn + j] = t.t1[i * ldn + j] * gmul_at(t, i, j);
    }
    // dV_c = W^T dO_c
    for (int c0 = 0; c0 < hd; c0 += CW) {
      const int cw = min(CW, hd - c0);
      __syncthreads();
      load_chunk<false>(t.c1, a.dO, h, t, col0 + c0, cw);
      __syncthreads();
      mm44<false>(t.np, cw, t.n, t.t2, ldn, t.c1, CLD,
                  store(2 * h + col0 + c0));
    }
    // t2 = dW = dO V^T
    for (int c0 = 0; c0 < hd; c0 += CW) {
      const int cw = min(CW, hd - c0);
      __syncthreads();
      load_chunk_t<false>(t.c1, ldn, a.dO, h, t, col0 + c0, cw);
      load_chunk_t<false>(t.c2, ldn, a.qkv, ld, t, 2 * h + col0 + c0, cw);
      __syncthreads();
      mm44<false>(t.np, t.np, cw, t.c1, ldn, t.c2, ldn,
                  [&](int r0, int cc0, const float (&acc)[4][4]) {
                    for (int i = 0; i < 4; ++i) {
                      float4* p = reinterpret_cast<float4*>(t.t2 + (r0 + i) * ldn + cc0);
                      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                      if (c0 > 0) {
                        const float4 o = *p;
                        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
                      }
                      *p = v;
                    }
                  });
    }
    __syncthreads();
    // softmax backward: t1 <- ds = P (dW gmul - sum_j dW gmul P) scale,
    // t2 <- dgmul = dW P (zero outside the n x n block)
    for (int i = warp; i < t.np; i += nw) {
      float* pr = t.t1 + i * ldn;
      float* wr = t.t2 + i * ldn;
      float dot = 0.f;
      for (int j = lane; j < t.n; j += 32) dot += wr[j] * gmul_at(t, i, j) * pr[j];
      dot = warp_sum(dot);
      for (int j = lane; j < t.np; j += 32) {
        const float dw = wr[j], p = pr[j];
        pr[j] = p * (dw * gmul_at(t, i, j) - dot) * a.scale;
        wr[j] = dw * p;
      }
    }
    __syncthreads();
    // gate expansion of this head's dgmul onto dr_hat and dsw
    for (int i = threadIdx.x; i < t.n; i += blockDim.x) {
      float ax = 0.f, ay = 0.f, az = 0.f, as = 0.f;
      for (int j = 0; j < t.n; ++j) {
        const float mm = t.mk[i] * t.mk[j];
        const float swsw = t.sw[i] * t.sw[j];
        const float gg = t.t2[i * ldn + j] + t.t2[j * ldn + i];
        const float sym = gg * swsw * mm;
        ax += sym * t.rx[j];
        ay += sym * t.ry[j];
        az += sym * t.rz[j];
        const float gate = t.rx[i] * t.rx[j] + t.ry[i] * t.ry[j] + t.rz[i] * t.rz[j];
        as += gg * gate * mm * t.sw[j];
      }
      t.acc[i] += ax;
      t.acc[t.np + i] += ay;
      t.acc[2 * t.np + i] += az;
      t.acc[3 * t.np + i] += as;
    }
    __syncthreads();
    // t2 <- ds^T
    for (int e = threadIdx.x; e < t.np * t.np; e += blockDim.x) {
      const int i = e / t.np, j = e % t.np;
      t.t2[j * ldn + i] = t.t1[i * ldn + j];
    }
    // dQ_c = ds K_c, dK_c = ds^T Q_c
    for (int c0 = 0; c0 < hd; c0 += CW) {
      const int cw = min(CW, hd - c0);
      __syncthreads();
      load_chunk<false>(t.c1, a.qkv, ld, t, h + col0 + c0, cw);
      load_chunk<false>(t.c2, a.qkv, ld, t, col0 + c0, cw);
      __syncthreads();
      mm44<false>(t.np, cw, t.n, t.t2, ldn, t.c1, CLD, store(col0 + c0));
      mm44<false>(t.np, cw, t.n, t.t1, ldn, t.c2, CLD, store(h + col0 + c0));
    }
    __syncthreads();
  }
  // gate cotangent: summed over layers per stacked row, written to the
  // (N, K) planes at the last layer
  for (int i = threadIdx.x; i < t.n; i += blockDim.x) {
    const long long r = t.base + i;
    float v[4];
    for (int q = 0; q < 4; ++q)
      v[q] = t.acc[q * t.np + i] + (a.first ? 0.f : a.gacc[r * 4 + q]);
    if (a.last) {
      const long long slot = a.rows[r];
      a.drx[slot] = v[0];
      a.dry[slot] = v[1];
      a.drz[slot] = v[2];
      a.dsw[slot] = v[3];
    } else {
      for (int q = 0; q < 4; ++q) a.gacc[r * 4 + q] = v[q];
    }
  }
}

// x[r] = g[rows[r]]: layer 0's input rows, one warp per row.
__global__ void __launch_bounds__(128) rows_gather_kernel(
    const float* __restrict__ g, const long long* __restrict__ rows,
    float* __restrict__ x, int R, int m) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* src = g + rows[r] * m;
  float* dst = x + r * m;
  for (int j = lane; j < m; j += 32) dst[j] = src[j];
}

// (LayerNorm(y[r]) gamma + beta) times the row's mask (step 4 of the
// forward), one warp per row, to dst[r] or, with dst_rows, to the flat slot
// dst_rows[r] of the (N, K, M) output.  Rows have the padded width m (the
// row stride); the statistics run over the true width mt <= m, and the
// padded columns are written as exact zeros.
__global__ void __launch_bounds__(128) rows_ln_fwd_kernel(
    const float* __restrict__ y, float* __restrict__ dst,
    const long long* __restrict__ dst_rows, const long long* __restrict__ rows,
    const float* __restrict__ mask, const float* __restrict__ gamma,
    const float* __restrict__ beta, int R, int m, int mt) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* yr = y + r * m;
  const float mk = mask[rows[r]];
  float s = 0.f;
  for (int j = lane; j < mt; j += 32) s += yr[j];
  const float mu = warp_sum(s) / mt;
  float v = 0.f;
  for (int j = lane; j < mt; j += 32) {
    const float c = yr[j] - mu;
    v += c * c;
  }
  const float inv = rsqrtf(warp_sum(v) / mt + kLnEps);
  float* dr = dst + (dst_rows ? dst_rows[r] : r) * m;
  for (int j = lane; j < m; j += 32)
    dr[j] = j < mt ? ((yr[j] - mu) * inv * gamma[j] + beta[j]) * mk : 0.f;
}

// x <- dg1 = LayerNorm backward of the pre-norm rows x (step 4), one warp
// per row; the cotangent is d[r] (or dout at the slot, at the top layer)
// times the row's mask.  As in the forward: stride m, statistics over the
// true width mt, exact zeros in the padded columns.
__global__ void __launch_bounds__(128) rows_ln_bwd_kernel(
    float* __restrict__ x, const float* __restrict__ d,
    const float* __restrict__ dout, const long long* __restrict__ rows,
    const float* __restrict__ mask, const float* __restrict__ gamma, int R,
    int m, int mt) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (r >= R) return;
  float* xr = x + r * m;
  const long long slot = rows[r];
  const float* dr = dout ? dout + slot * m : d + r * m;
  const float mk = mask[slot];
  float s = 0.f;
  for (int j = lane; j < mt; j += 32) s += xr[j];
  const float mu = warp_sum(s) / mt;
  float v = 0.f;
  for (int j = lane; j < mt; j += 32) {
    const float c = xr[j] - mu;
    v += c * c;
  }
  const float inv = rsqrtf(warp_sum(v) / mt + kLnEps);
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < mt; j += 32) {
    const float dxh = dr[j] * mk * gamma[j];
    s1 += dxh;
    s2 += dxh * (xr[j] - mu) * inv;
  }
  const float mean1 = warp_sum(s1) / mt, mean2 = warp_sum(s2) / mt;
  for (int j = lane; j < m; j += 32) {
    const float xhat = (xr[j] - mu) * inv;
    const float dxh = dr[j] * mk * gamma[j];
    xr[j] = j < mt ? inv * (dxh - mean1 - xhat * mean2) : 0.f;
  }
}

int rows_gemm(const GemmArgs& g, bool rnd, cudaStream_t s) {
  if (g.R == 0) return 0;
  dim3 grid((unsigned)((g.R + GBM - 1) / GBM), (unsigned)((g.N + GBN - 1) / GBN));
  if (rnd)
    rows_gemm_kernel<true><<<grid, GTHREADS, 0, s>>>(g);
  else
    rows_gemm_kernel<false><<<grid, GTHREADS, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// one CTA per atom: 128 threads while the pass's longest atom has at most
// 64 valid slots (several CTAs per SM), else 256
template <class Kern>
int launch_rows_attn(Kern kern, int n_atoms, int n_max, size_t smem,
                     cudaStream_t s, const RowsArgs& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = n_max > 64 ? ATT_THREADS : ATT_THREADS / 2;
  kern<<<n_atoms, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

#define RET_IF(x) if ((e = (x)) != 0) return e

RowsArgs rows_args(const float* rx, const float* ry, const float* rz,
                   const float* sw, const float* mask, const long long* rows,
                   const long long* start, const long long* count,
                   long long r0, int n_max, int h, int heads, float scale) {
  RowsArgs ra{};
  ra.rx = rx; ra.ry = ry; ra.rz = rz; ra.sw = sw; ra.mask = mask;
  ra.rows = rows; ra.start = start; ra.count = count; ra.r0 = r0;
  ra.h = h; ra.heads = heads; ra.ldn = rows_np(n_max) + 4; ra.scale = scale;
  return ra;
}

// Steps 1-3 of one layer over one pass, both directions: qkv = X [Wq Wk
// Wv], ob = O, y = X + O Wo, X the pass's n_rows input rows at x.
int layer_rows_fwd(const float* x, const float* wq, const float* wk,
                   const float* wv, const float* wo, RowsArgs ra, int n_atoms,
                   int n_rows, int n_max, float* qkv, float* ob, float* y,
                   int m, int h, int bf16, cudaStream_t s) {
  int e = 0;
  const float* w3[3] = {wq, wk, wv};
  for (int p = 0; p < 3; ++p) {
    GemmArgs g{};
    g.a = x; g.lda = m;
    g.b[0] = w3[p]; g.ldb = h; g.seg = m; g.b_trans = 0;
    g.c = qkv + p * h; g.ldc = 3 * h;
    g.R = n_rows; g.N = h; g.Kd = m;
    RET_IF(rows_gemm(g, bf16, s));
  }
  ra.qkv = qkv; ra.out = ob; ra.dO = nullptr; ra.first = ra.last = 0;
  auto fwd = bf16 ? &rows_attn_fwd_kernel<true> : &rows_attn_fwd_kernel<false>;
  RET_IF(launch_rows_attn(fwd, n_atoms, n_max,
                          sizeof(float) * rows_attn_floats(n_max), s, ra));
  GemmArgs g{};
  g.a = ob; g.lda = h;
  g.b[0] = wo; g.ldb = m; g.seg = h; g.b_trans = 0;
  g.add = x; g.ld_add = m;
  g.c = y; g.ldc = m;
  g.R = n_rows; g.N = m; g.Kd = h;
  return rows_gemm(g, bf16, s);
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

size_t nbr_attn_bwd_smem(int k, int m) { return sizeof(float) * bwd_floats(k, m); }
size_t nbr_attn_bwd_gmem_smem(int k, int m) { return sizeof(float) * bwd_gmem_floats(k); }
// every kernel library exports this name (loaded RTLD_LOCAL, one each)
const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// the parameter-gradient backward (the shared-memory instance, or with ws
// the device-workspace one over a persistent grid of nblk CTAs)
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
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  if (ws) {
    auto kern = bf16 ? &stack_bwd_kernel<true, true> : &stack_bwd_kernel<false, true>;
    return launch(kern, nblk, nbr_attn_bwd_gmem_smem(k, m), s, a);
  }
  auto kern = bf16 ? &stack_bwd_kernel<true> : &stack_bwd_kernel<false>;
  return launch(kern, nblk, nbr_attn_bwd_smem(k, m), s, a);
}

// CTAs of the parameter-gradient GMEM backward that are resident at once
// (SMs x blocks per SM): its persistent grid and the number of workspace
// slots; <= 0 on error
int nbr_attn_bwd_gmem_blocks(int k, int m, int bf16) {
  const size_t smem = nbr_attn_bwd_gmem_smem(k, m);
  auto kern = bf16 ? &stack_bwd_kernel<true, true> : &stack_bwd_kernel<false, true>;
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

// One pass of stacked rows, both directions (see "The stack over compacted
// rows" above).  rows (R,): flat slot (atom * K + slot) of each stacked row
// of the pass; start/count (A,): first stacked row (relative to r0 via
// start - r0) and valid slots of each atom of the pass, longest first;
// n_max: the pass's largest count.  Layer l's input rows are at x + (l %
// ring) * ld_layer: the stash (ring = layers, x at the pass's first row)
// or, in a forward that keeps no stash, two scratch buffers (ring = 2).

// The forward.  Scratch: qkv (R, 3H), ob (R, H), y (R, M).  out must hold
// zeros at the masked slots (the wrapper allocates it zeroed); its valid
// slots are written here.
int nbr_attn_fwd_rows(const float* g, const float* rx, const float* ry,
                      const float* rz, const float* sw, const float* mask,
                      const float* wq, const float* wk, const float* wv,
                      const float* wo, const float* gamma, const float* beta,
                      float* out, float* x, long long ld_layer, int ring,
                      const long long* rows, const long long* start,
                      const long long* count, long long r0, int n_atoms,
                      int n_rows, int n_max, float* qkv, float* ob, float* y,
                      int m, int m_true, int h, int layers, int heads,
                      int bf16, float scale, void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t mh = (size_t)m * h;
  const RowsArgs ra = rows_args(rx, ry, rz, sw, mask, rows, start, count, r0,
                                n_max, h, heads, scale);
  const unsigned blocks = (unsigned)((n_rows + 3) / 4);
  int e = 0;
  rows_gather_kernel<<<blocks, 128, 0, s>>>(g, rows, x, n_rows, m);
  RET_IF((int)cudaGetLastError());
  for (int l = 0; l < layers; ++l) {
    const float* xl = x + (l % ring) * ld_layer;
    RET_IF(layer_rows_fwd(xl, wq + l * mh, wk + l * mh, wv + l * mh,
                          wo + l * mh, ra, n_atoms, n_rows, n_max, qkv, ob, y,
                          m, h, bf16, s));
    const bool top = l == layers - 1;
    rows_ln_fwd_kernel<<<blocks, 128, 0, s>>>(
        y, top ? out : x + ((l + 1) % ring) * ld_layer, top ? rows : nullptr,
        rows, mask, gamma + l * m, beta + l * m, n_rows, m, m_true);
    RET_IF((int)cudaGetLastError());
  }
  return 0;
}

// The force-path backward from the forward's stash (ring = layers).
// Scratch: qkv and dqkv (R, 3H), ob (R, H), xb and db (R, M), gacc (R, 4).
// dg, drx, dry, drz, dsw must hold zeros at the masked slots (the wrapper
// allocates them zeroed); their valid slots are written here.
int nbr_attn_bwd_rows(const float* stash, long long ld_layer, const float* rx,
                      const float* ry, const float* rz, const float* sw,
                      const float* mask, const float* wq, const float* wk,
                      const float* wv, const float* wo, const float* gamma,
                      const float* dout, float* dg, float* drx, float* dry,
                      float* drz, float* dsw, const long long* rows,
                      const long long* start, const long long* count,
                      long long r0, int n_atoms, int n_rows, int n_max,
                      float* qkv, float* ob, float* xb, float* db,
                      float* dqkv, float* gacc, int m, int m_true, int h,
                      int layers, int heads, int bf16, float scale,
                      void* stream) {
  cudaGetLastError();  // clear an error left by earlier, unrelated work
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t mh = (size_t)m * h;
  const size_t smem = sizeof(float) * rows_attn_floats(n_max);
  RowsArgs ra = rows_args(rx, ry, rz, sw, mask, rows, start, count, r0, n_max,
                          h, heads, scale);
  ra.gacc = gacc;
  ra.drx = drx; ra.dry = dry; ra.drz = drz; ra.dsw = dsw;
  auto bwd = bf16 ? &rows_attn_bwd_kernel<true> : &rows_attn_bwd_kernel<false>;
  int e = 0;
  for (int l = layers - 1; l >= 0; --l) {
    const float* w3[3] = {wq + l * mh, wk + l * mh, wv + l * mh};
    const float* wol = wo + l * mh;
    // 1-3. Y = X_l + O Wo, with Q|K|V in qkv
    RET_IF(layer_rows_fwd(stash + l * ld_layer, w3[0], w3[1], w3[2], wol, ra,
                          n_atoms, n_rows, n_max, qkv, ob, xb, m, h, bf16, s));
    // 4. Y <- dg1
    rows_ln_bwd_kernel<<<(n_rows + 3) / 4, 128, 0, s>>>(
        xb, db, l == layers - 1 ? dout : nullptr, rows, mask, gamma + l * m,
        n_rows, m, m_true);
    RET_IF((int)cudaGetLastError());
    // 5. dO = dg1 Wo^T
    GemmArgs g{};
    g.a = xb; g.lda = m;
    g.b[0] = wol; g.ldb = m; g.seg = m; g.b_trans = 1;
    g.c = ob; g.ldc = h;
    g.R = n_rows; g.N = h; g.Kd = m;
    RET_IF(rows_gemm(g, false, s));
    // 6. dQ, dK, dV and the gate cotangent
    ra.qkv = qkv; ra.out = dqkv; ra.dO = ob;
    ra.first = l == layers - 1; ra.last = l == 0;
    RET_IF(launch_rows_attn(bwd, n_atoms, n_max, smem, s, ra));
    // 7. D = dg1 + [dQ dK dV] [Wq Wk Wv]^T (to dg at the slots, last layer)
    g = GemmArgs{};
    g.a = dqkv; g.lda = 3 * h;
    g.b[0] = w3[0]; g.b[1] = w3[1]; g.b[2] = w3[2];
    g.ldb = h; g.seg = h; g.b_trans = 1;
    g.add = xb; g.ld_add = m;
    g.c = l == 0 ? dg : db; g.c_rows = l == 0 ? rows : nullptr; g.ldc = m;
    g.R = n_rows; g.N = m; g.Kd = 3 * h;
    RET_IF(rows_gemm(g, false, s));
  }
  return 0;
}

// shared memory of the per-atom attention kernels for atoms of at most
// n_max valid slots (the rows instances' K limit)
size_t nbr_attn_rows_smem(int n_max) {
  return sizeof(float) * rows_attn_floats(n_max);
}

}  // extern "C"
