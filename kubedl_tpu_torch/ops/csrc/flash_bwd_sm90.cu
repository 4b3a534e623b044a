// Flash-attention backward redesigned for Hopper (sm_90a): TMA, mbarrier
// pipelines, wgmma and warp-specialized consumer warpgroups. bf16 in and
// out, f32 accumulation; plain C interface bound with ctypes by
// kubedl_tpu_torch/ops/flash_attention.py, which routes both kernels here
// at every head dim, zero-padded to 64, 128 or 256 (flash_bwd.cu, the
// mma.sync kernels, runs only when a caller asks for it by name).
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/flash_attention.py:291 _bwd_dq_kernel   (K2) -> flash_bwd_dq_sm90_kernel,
//                                                                 flash_bwd_dq256_sm90_kernel
//   kubedl_tpu/ops/flash_attention.py:336 _bwd_dkv_kernel  (K3) -> flash_bwd_dkv_sm90_kernel,
//                                                                 flash_bwd_dkv256_sm90_kernel
//
// What they compute is flash_bwd.cu's function: with s = (q . k) * sm_scale,
// then cap * tanh(s / cap) when softcap > 0, the mask {k_pos < S, q_pos < S,
// causal k_pos <= q_pos, window k_pos > q_pos - window} applied after the
// softcap, the forward's natural-log LSE and delta = rowsum(O * dO):
//   p  = exp(s - lse) where the mask keeps (q, k), else 0
//   ds = p * (dO . v - delta), times 1 - (s / cap)^2 when softcap > 0
//   dQ = sm_scale * sum_k ds . K                            (K2)
//   dV = sum_q p^T . dO,  dK = sm_scale * sum_q ds^T . Q    (K3)
// p and ds are rounded to bf16 before their products, every product
// accumulates in f32, dQ, dK, dV are written in bf16. K2 also computes
// delta (f32) and writes it, beside LSE * log2 e, for K3, which runs after
// it on the stream.
//
// Bound on an H100 SXM: 10 * b * hq * d * pairs FLOP at 989 TFLOP/s bf16
// (5 products a kept (q, k) pair) against q, k, v, o, dO, LSE read and dq,
// dk, dv written at 3.35 TB/s; at the 7B training shape (b 4, 32 heads,
// S 1023, d 128, causal) operations bound it. The two kernels run 7
// products a pair (each recomputes S and dO . V^T), so they can reach at
// most 0.71 of that bound; one kernel with 5 would have to sum dQ across
// CTAs, with atomics whose order (and bits) change from run to run. Design:
//   - both kernels: a CTA of three warpgroups, a producer (one thread issues
//     every TMA load; setmaxnreg gives its registers to the consumers) and
//     two consumers of 64 item rows each; a persistent grid walks the host's
//     schedule (ops/flash_attention.py sm90_schedule, kind "dq" / "dkv"):
//     L2 groups, the longest items first, each to the CTA that frees first;
//   - operands are read in place through 4-D tensor maps over (d, s, h, b)
//     with the caller's strides; TMA zero-fills the rows past S of each
//     (b, h); every mbarrier wait traps after ~4 s instead of hanging;
//   - K2 (dQ): an item is 128 query rows of one (b, q head). Q, dO and O
//     are loaded once an item, K and V stream through 3-stage rings of 64
//     key rows with their own full and empty barriers. A consumer runs
//     S = Q.K^T and dP = dO.V^T as wgmma with both operands K-major in
//     shared memory, releases V, computes ds on the accumulators, packs it
//     in place to bf16 A fragments and runs dQ += dS.K with K MN-major
//     (the transpose bit), then releases K. The next tile's S and dP go out
//     with this tile's dQ product as two commit groups, so the next tile's
//     ds runs under the dQ product. delta is the f32 rowsum of the
//     item's O and dO tiles, taken from shared memory while the item's
//     first S and dP run; rows past S take LSE +inf, so p is 0 there. K2
//     writes each row's LSE * log2 e and delta to a [2, B, Hq, S64] f32
//     buffer (S64: S rounded up to 64; +inf and 0 on the rows past S), so
//     K3's slices are whole 256-byte boxes inside one (b, h): a TMA box
//     must start 16-byte aligned, which a [B, Hq, S] row is not unless S is
//     a multiple of 4;
//   - K3 (dK, dV): an item is 128 key rows of one (b, KV head). K and V are
//     loaded once an item; Q, dO and their LSE and delta slices (a 1-D
//     tensor map over K2's padded buffer) stream through a 3-stage
//     ring of 64 query rows, for every query head of the GQA group and
//     every live q tile, in a fixed order. A consumer runs S^T = K.Q^T and
//     dP^T = V.dO^T (SS), computes p^T and ds^T with per-column LSE and
//     delta, and runs dV += P^T.dO and dK += dS^T.Q (RS, dO and Q MN-major),
//     the dV product first, so ds^T is computed under it.
//     GQA sums in registers over the query heads in a fixed order, so the
//     bits are the same from run to run. A q tile that reaches past S is a
//     masked tile: a column past S takes p = 0 by select;
//   - masks only where needed: on the causal diagonal, the window's edge
//     and the S tail, by select (never -1e30 arithmetic); tiles outside an
//     item's live range are never loaded;
//   - the exponentials run in the log2 domain: sm_scale * log2 e folded
//     into one multiply-add against LSE * log2 e;
//   - epilogues scale dQ and dK by sm_scale and write bf16 through the
//     caller's strides, rows below S and columns below Dv only;
//   - at d 256 (flash_bwd_dq256_sm90_kernel and
//     flash_bwd_dkv256_sm90_kernel, each with its own comment below): a
//     128-row item's tiles and a 64 x 256 f32 accumulator a consumer (128
//     registers, two of them in K3) do not fit, so an item is 64 rows and
//     the two consumers split the work twice over: the scores over the
//     streamed tile's rows, the gradients over the head dim, with the bf16
//     dS (and P^T) passed between them through shared memory.
//
// Layout rules: q, o, dO [B, Hq, S, D], k, v [B, Hkv, S, D], last dim
// contiguous, other strides whole 16-byte vectors, 16-byte aligned bases;
// lse [B, Hq, S] f32 contiguous; dq, dk, dv are written through
// their own strides. D is 64, 128 or 256 (the wrapper zero-pads other head
// dims and passes the true width as Dv).

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;               // rows an item: two consumer warpgroups x 64
constexpr int BN = 64;                // rows a streamed tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr int ROW = 128;              // bytes a box row: 64 bf16, the swizzle span
constexpr int ITEM_BOX = BM * ROW;    // a 64-column box of an item tile (16 KB)
constexpr int STREAM_BOX = BN * ROW;  // a 64-column box of a streamed tile (8 KB)
constexpr int SLICE = BN * 4;         // an f32 LSE or delta slice of a streamed tile

template <int D>
struct Tiles {
  static constexpr int ITEM = (D / 64) * ITEM_BOX;      // Q, dO, O (K2) or K, V (K3)
  static constexpr int STREAM = (D / 64) * STREAM_BOX;  // K, V (K2) or Q, dO (K3)
};

struct BwdArgs {
  int B, Hq, Hkv, S, Dv;
  int S64;                   // S rounded up to BN: the row stride of K2's LSE and delta
  int plane;                 // B * Hq * S64: delta's offset after the LSE
  int64_t a_sb, a_sh, a_ss;  // dq (K2) or dk (K3)
  int64_t b_sb, b_sh, b_ss;  // dv (K3); o, read for delta (K2 at d 256)
  float mul;                 // q . k -> log2 units: sm_scale * log2 e, or log2 e after the softcap
  float cap_in;              // sm_scale / softcap
  float softcap, inv_cap;
  float sm_scale;
  int causal;
  int window;                // <= 0: no window
  int vec_out;               // outputs take bf16x2 stores
};

__device__ __forceinline__ bool keep(int qp, int kp, const BwdArgs& p) {
  bool ok = kp < p.S && qp < p.S;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// K2's item: ROWS query rows q0.. of (b, h) (128, or 64 at d 256), its
// live 64-row K/V tiles [kb, ke)
struct DqItem {
  int b, h, hk, q0, kb, ke;
};

template <int ROWS>
__device__ __forceinline__ DqItem dq_item(int code, const BwdArgs& p) {
  const int bh_n = p.B * p.Hq, t = code / bh_n, bh = code - t * bh_n;
  DqItem w;
  w.b = bh / p.Hq;
  w.h = bh - w.b * p.Hq;
  w.hk = w.h / (p.Hq / p.Hkv);
  w.q0 = t * ROWS;
  w.ke = (p.S + BN - 1) / BN;
  if (p.causal) w.ke = min(w.ke, (w.q0 + ROWS - 1) / BN + 1);
  w.kb = 0;
  if (p.window > 0) {
    const int lo = w.q0 - p.window + 1;  // the first key row q0's window admits
    w.kb = lo > 0 ? lo / BN : 0;
  }
  return w;
}

// Does K tile kt hold a (query, key) pair of the item that a mask drops?
template <int ROWS>
__device__ __forceinline__ bool dq_masked(int kt, const DqItem& w, const BwdArgs& p) {
  const int k0 = kt * BN;
  return k0 + BN > p.S || (p.causal && k0 + BN - 1 > w.q0) ||
         (p.window > 0 && k0 <= w.q0 + ROWS - 1 - p.window);
}

// K3's item: ROWS key rows k0.. of (b, KV head hk) (128, or 64 at d 256),
// its live 64-row q tiles [qb, qe) of each of the rep query heads
struct DkvItem {
  int b, hk, k0, qb, qe;
};

template <int ROWS>
__device__ __forceinline__ DkvItem dkv_item(int code, const BwdArgs& p) {
  const int bk_n = p.B * p.Hkv, t = code / bk_n, bk = code - t * bk_n;
  DkvItem w;
  w.b = bk / p.Hkv;
  w.hk = bk - w.b * p.Hkv;
  w.k0 = t * ROWS;
  w.qb = p.causal ? w.k0 / BN : 0;
  w.qe = (p.S + BN - 1) / BN;
  if (p.window > 0) {
    const int k_last = min(w.k0 + ROWS, p.S) - 1;  // the last query row k_last's window reaches
    w.qe = min(w.qe, (k_last + p.window - 1) / BN + 1);
  }
  w.qe = max(w.qe, w.qb);
  return w;
}

template <int ROWS>
__device__ __forceinline__ bool dkv_masked(int qt, const DkvItem& w, const BwdArgs& p) {
  const int q0 = qt * BN;
  return q0 + BN > p.S || (p.causal && q0 < w.k0 + ROWS - 1) ||
         (p.window > 0 && q0 + BN - 1 - w.k0 >= p.window);
}

// acc[64 x 64] = A[64 rows of an item tile] . B[a streamed tile]^T over D:
// D / 16 products. A's 64-column boxes are 16 KB apart, B's 8 KB; a k16
// step is 32 bytes inside a box.
template <int D>
__device__ __forceinline__ void ss_products(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = 32 * (kk % 4);
    wgmma_ss_n64(acc, smem_desc(a + (kk / 4) * ITEM_BOX + col, 16, 1024),
                 smem_desc(b + (kk / 4) * STREAM_BOX + col, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += F[64 x 64] . B[64 rows x D]: F as bf16 A fragments
// (f[4kk .. 4kk + 3] the k16 step kk), B a streamed tile read MN-major: its
// 64-column boxes 8 KB apart (the leading byte offset), 8 rows 1 KB apart
// (the stride byte offset), a k16 step 16 rows = 2 KB.
template <int D>
__device__ __forceinline__ void rs_products(float (&acc)[D / 2], const uint32_t (&f)[16],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = smem_desc(b + 2048 * kk, STREAM_BOX, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3], db);
    else
      wgmma_rs_n64(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3], db);
  }
}

// bf16 A fragments straight from an accumulator's layout: x[4j + e] is row
// g + 8 (e / 2), column 8j + 2 tq + e % 2 of the warp's 16 rows.
template <int N>
__device__ __forceinline__ void pack(uint32_t (&f)[N / 2], const float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    f[2 * j] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[2 * j + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// K2's scores -> ds in place, for this thread's query rows qrow and qrow + 8
// (lse2: their LSE * log2 e, +inf past S; dl: their delta) and keys k0 +
// 8j + 2tq + {0, 1} (N / 4 column groups: 64 keys, or 32 at d 256).
template <bool SOFTCAP, bool MASKED, int N>
__device__ __forceinline__ void dq_grads(float (&s)[N], const float (&dp)[N],
                                         const float (&lse2)[2], const float (&dl)[2],
                                         const BwdArgs& p, int qrow, int k0, int tq) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[4 * j + e], pv;
      if constexpr (SOFTCAP) {
        x = p.softcap * tanhf(x * p.cap_in);
        pv = ex2(fmaf(x, LOG2E, -lse2[r]));
      } else {
        pv = ex2(fmaf(x, p.mul, -lse2[r]));
      }
      if constexpr (MASKED) {
        if (!keep(qrow + 8 * r, k0 + 8 * j + 2 * tq + (e & 1), p)) pv = 0.f;
      }
      float ds = pv * (dp[4 * j + e] - dl[r]);
      if constexpr (SOFTCAP) {
        const float t = x * p.inv_cap;
        ds *= 1.f - t * t;
      }
      s[4 * j + e] = ds;
    }
  }
}

template <bool SOFTCAP, int N>
__device__ __forceinline__ void dq_grads(bool masked, float (&s)[N], const float (&dp)[N],
                                         const float (&lse2)[2], const float (&dl)[2],
                                         const BwdArgs& p, int qrow, int k0, int tq) {
  if (masked)
    dq_grads<SOFTCAP, true>(s, dp, lse2, dl, p, qrow, k0, tq);
  else
    dq_grads<SOFTCAP, false>(s, dp, lse2, dl, p, qrow, k0, tq);
}

// K3's transposed scores, first half: p^T as bf16 A fragments in pf, and
// in s the factor ds^T takes beside (dP^T - delta): p^T, times 1 - (x /
// cap)^2 under the softcap. This thread's key rows are krow and krow + 8,
// its query columns q0 + 8j + 2tq + {0, 1}, whose LSE * log2 e is the
// tile's slice in shared memory.
template <bool SOFTCAP, bool MASKED, int N>
__device__ __forceinline__ void dkv_probs(float (&s)[N], uint32_t (&pf)[N / 2], const float* lse,
                                          const BwdArgs& p, int krow, int q0, int tq) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
    const float ll[2] = {l2.x, l2.y};
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float x = s[4 * j + e];
      if constexpr (SOFTCAP) {
        x = p.softcap * tanhf(x * p.cap_in);
        pv[e] = ex2(fmaf(x, LOG2E, -ll[c]));
      } else {
        pv[e] = ex2(fmaf(x, p.mul, -ll[c]));
      }
      if constexpr (MASKED) {
        if (!keep(q0 + 8 * j + 2 * tq + c, krow + 8 * (e >> 1), p)) pv[e] = 0.f;
      }
      if constexpr (SOFTCAP) {
        const float t = x * p.inv_cap;
        s[4 * j + e] = pv[e] * (1.f - t * t);
      } else {
        s[4 * j + e] = pv[e];
      }
    }
    pf[2 * j] = pack_bf16(pv[0], pv[1]);
    pf[2 * j + 1] = pack_bf16(pv[2], pv[3]);
  }
}

template <bool SOFTCAP, int N>
__device__ __forceinline__ void dkv_probs(bool masked, float (&s)[N], uint32_t (&pf)[N / 2],
                                          const float* lse, const BwdArgs& p, int krow, int q0,
                                          int tq) {
  if (masked)
    dkv_probs<SOFTCAP, true>(s, pf, lse, p, krow, q0, tq);
  else
    dkv_probs<SOFTCAP, false>(s, pf, lse, p, krow, q0, tq);
}

// The second half: ds^T = factor * (dP^T - delta) as bf16 A fragments in
// df, with the columns' delta from the tile's slice in shared memory.
template <int N>
__device__ __forceinline__ void dkv_ds(const float (&g)[N], const float (&dp)[N],
                                       uint32_t (&df)[N / 2], const float* delta, int tq) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * tq);
    df[2 * j] = pack_bf16(g[4 * j] * (dp[4 * j] - d2.x), g[4 * j + 1] * (dp[4 * j + 1] - d2.y));
    df[2 * j + 1] =
        pack_bf16(g[4 * j + 2] * (dp[4 * j + 2] - d2.x), g[4 * j + 3] * (dp[4 * j + 3] - d2.y));
  }
}

// acc + the dot product of 8 bf16 pairs, in f32.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(a2[k]), y = __bfloat1622float2(b2[k]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// delta of this thread's rows r and r + 8 of the item tiles O and dO in
// shared memory (r = the warp's first row + g): each of the 4 threads of a
// row sums every 4th 16-byte chunk, then the 4 partial sums meet. Chunk c
// of row r sits at chunk c ^ (r % 8) of its 128-byte row (the swizzle).
template <int D>
__device__ __forceinline__ void row_deltas(float (&dl)[2], const uint8_t* o, const uint8_t* dout,
                                           int r, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int ch = tq + 4 * i;
      const int off = (ch / 8) * ITEM_BOX + row * ROW + 16 * ((ch % 8) ^ (row % 8));
      acc = dot8(*reinterpret_cast<const uint4*>(o + off),
                 *reinterpret_cast<const uint4*>(dout + off), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[h] = acc;
  }
}

// This thread's part of a 64 x D accumulator (rows row and row + 8 of the
// warp, columns col0 + 8j + 2tq + {0, 1}) times `scale`, as bf16 through
// the output's strides: rows at or past S and columns at or past Dv are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float scale, bf16* out,
                                           int64_t ss, int row, int tq, const BwdArgs& p,
                                           int col0 = 0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= p.S) continue;
    bf16* dst = out + static_cast<int64_t>(row + 8 * h) * ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = col0 + 8 * j + 2 * tq;
      const float x = acc[4 * j + 2 * h] * scale, y = acc[4 * j + 2 * h + 1] * scale;
      if (p.vec_out && col + 1 < p.Dv) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < p.Dv) dst[col] = __float2bfloat16_rn(x);
        if (col + 1 < p.Dv) dst[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& base) {
  const uint32_t r = smem_u32(raw);
  base = (r + 1023) & ~1023u;
  return raw + (base - r);
}

// K2: dQ (and delta) for the items order[starts[blockIdx.x] .. starts[+1]).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_o,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const float* __restrict__ lse, float* __restrict__ rows,
                             bf16* __restrict__ dq, const int* __restrict__ order,
                             const int* __restrict__ starts, const BwdArgs p) {
  using T = Tiles<D>;
  constexpr int Q_OFF = 0, DO_OFF = T::ITEM, O_OFF = 2 * T::ITEM, K_OFF = 3 * T::ITEM;
  constexpr int V_OFF = K_OFF + STAGES * T::STREAM, BAR_OFF = V_OFF + STAGES * T::STREAM;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint8_t* gbase = aligned_smem(smem_raw, base);
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty of each stage
  const uint32_t q_full = base + BAR_OFF, q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES, v_empty = k_empty + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);   // the producer's arrive + the TMA bytes
    mbar_init(q_empty, 8);  // one arrive from each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int first = starts[blockIdx.x], last = starts[blockIdx.x + 1];

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_o);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const DqItem w = dq_item<BM>(order[j], p);
        mbar_wait(q_empty, (qi & 1) ^ 1);
        mbar_expect_tx(q_full, 3 * T::ITEM);  // whole boxes, zero-filled past S too
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_4d(base + Q_OFF + x * ITEM_BOX, &map_q, q_full, 64 * x, w.q0, w.h, w.b);
          tma_4d(base + DO_OFF + x * ITEM_BOX, &map_do, q_full, 64 * x, w.q0, w.h, w.b);
          tma_4d(base + O_OFF + x * ITEM_BOX, &map_o, q_full, 64 * x, w.q0, w.h, w.b);
        }
        for (int kt = w.kb; kt < w.ke; ++kt, ++it) {
          const int s = it % STAGES, free = ((it / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free);
          mbar_expect_tx(k_full + 8 * s, T::STREAM);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + K_OFF + s * T::STREAM + x * STREAM_BOX, &map_k, k_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
          mbar_wait(v_empty + 8 * s, free);
          mbar_expect_tx(v_full + 8 * s, T::STREAM);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + V_OFF + s * T::STREAM + x * STREAM_BOX, &map_v, v_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, g = lane / 4, tq = lane % 4;
  const int r_local = 64 * c + 16 * warp + g;       // this thread's first row of the item tile
  const uint32_t q_sm = base + Q_OFF + c * 64 * ROW;  // this warpgroup's 64 rows of each box
  const uint32_t do_sm = base + DO_OFF + c * 64 * ROW;
  float s_acc[32], dp_acc[32], dq_acc[D / 2];
  uint32_t f[16];
  zero(s_acc);
  zero(dp_acc);
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const DqItem w = dq_item<BM>(order[j], p);
    const int n = w.ke - w.kb, qrow = w.q0 + r_local;
    const int64_t row_base = (static_cast<int64_t>(w.b) * p.Hq + w.h) * p.S;
    float* row_out = rows + (static_cast<int64_t>(w.b) * p.Hq + w.h) * p.S64;
    float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)  // a row past S has p = exp2(-inf) = 0
      lse2[h] = qrow + 8 * h < p.S ? lse[row_base + qrow + 8 * h] * LOG2E : INFINITY;
    zero(dq_acc);
    mbar_wait(q_full, qi & 1);

    // the first tile's S and dP, alone, with the item's delta under them
    int s_cur = it % STAGES;
    mbar_wait(k_full + 8 * s_cur, (it / STAGES) & 1);
    mbar_wait(v_full + 8 * s_cur, (it / STAGES) & 1);
    __syncwarp();  // the warp meets again before the .aligned wgmma instructions
    fence_regs(s_acc);
    fence_regs(dp_acc);
    wg_fence();
    ss_products<D>(s_acc, q_sm, base + K_OFF + s_cur * T::STREAM);
    ss_products<D>(dp_acc, do_sm, base + V_OFF + s_cur * T::STREAM);
    wg_commit();
    row_deltas<D>(dl, gbase + O_OFF, gbase + DO_OFF, r_local, tq);
    if (tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (qrow + 8 * h < p.S64) {
          row_out[qrow + 8 * h] = lse2[h];
          row_out[p.plane + qrow + 8 * h] = dl[h];  // 0 past S: O and dO are zero-filled
        }
    }
    wg_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    if (lane == 0) {
      mbar_arrive(v_empty + 8 * s_cur);  // V of the first tile is read
      if (n == 1) mbar_arrive(q_empty);  // Q, dO, O of the item are read
    }
    dq_grads<SOFTCAP>(dq_masked<BM>(w.kb, w, p), s_acc, dp_acc, lse2, dl, p, qrow, w.kb * BN, tq);
    pack(f, s_acc);

    // Every tile but the last: the next tile's S and dP and this tile's
    // dQ += dS.K go out as two commit groups; the next tile's ds runs as
    // soon as its S and dP retire, under the dQ product. The body commits
    // the same two groups on every pass, so ptxas can follow which group
    // each wait retires.
    for (int i = 0; i + 1 < n; ++i, ++it) {
      const int s_next = (it + 1) % STAGES, ph = ((it + 1) / STAGES) & 1, kt = w.kb + i + 1;
      mbar_wait(k_full + 8 * s_next, ph);
      mbar_wait(v_full + 8 * s_next, ph);
      __syncwarp();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      fence_regs(dq_acc);
      fence_regs(f);
      wg_fence();
      ss_products<D>(s_acc, q_sm, base + K_OFF + s_next * T::STREAM);
      ss_products<D>(dp_acc, do_sm, base + V_OFF + s_next * T::STREAM);
      wg_commit();
      rs_products<D>(dq_acc, f, base + K_OFF + s_cur * T::STREAM);
      wg_commit();
      wg_wait<1>();  // S and dP of the next tile have retired; the dQ product runs on
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (lane == 0) {
        mbar_arrive(v_empty + 8 * s_next);     // V of the next tile is read
        if (i + 2 == n) mbar_arrive(q_empty);  // Q, dO, O of the item are read
      }
      dq_grads<SOFTCAP>(dq_masked<BM>(kt, w, p), s_acc, dp_acc, lse2, dl, p, qrow, kt * BN, tq);
      wg_wait<0>();
      fence_regs(dq_acc);
      fence_regs(f);
      if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);  // K of this tile is read
      pack(f, s_acc);
      s_cur = s_next;
    }
    // the last tile's dQ product
    __syncwarp();
    fence_regs(dq_acc);
    fence_regs(f);
    wg_fence();
    rs_products<D>(dq_acc, f, base + K_OFF + s_cur * T::STREAM);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq_acc);
    fence_regs(f);
    if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);
    ++it;
    store_rows<D>(dq_acc, p.sm_scale, dq + w.b * p.a_sb + w.h * p.a_sh, p.a_ss,
                  w.q0 + 64 * c + 16 * warp + g, tq, p);
  }
}

// K3: dK and dV for the items order[starts[blockIdx.x] .. starts[+1]).
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap map_rows,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const int* __restrict__ order, const int* __restrict__ starts,
                              const BwdArgs p) {
  using T = Tiles<D>;
  constexpr int K_OFF = 0, V_OFF = T::ITEM, Q_OFF = 2 * T::ITEM;
  constexpr int DO_OFF = Q_OFF + STAGES * T::STREAM, L_OFF = DO_OFF + STAGES * T::STREAM;
  constexpr int BAR_OFF = L_OFF + STAGES * 2 * SLICE;  // each stage: LSE slice, delta slice
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint8_t* gbase = aligned_smem(smem_raw, base);
  // kv_full, kv_empty, then q_full, q_empty of each stage
  const uint32_t kv_full = base + BAR_OFF, kv_empty = kv_full + 8;
  const uint32_t q_full = kv_full + 16, q_empty = q_full + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int first = starts[blockIdx.x], last = starts[blockIdx.x + 1];
  const int rep = p.Hq / p.Hkv;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_rows);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const DkvItem w = dkv_item<BM>(order[j], p);
        mbar_wait(kv_empty, (qi & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * T::ITEM);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_4d(base + K_OFF + x * ITEM_BOX, &map_k, kv_full, 64 * x, w.k0, w.hk, w.b);
          tma_4d(base + V_OFF + x * ITEM_BOX, &map_v, kv_full, 64 * x, w.k0, w.hk, w.b);
        }
        for (int h = w.hk * rep; h < (w.hk + 1) * rep; ++h) {
          const int row_base = (w.b * p.Hq + h) * p.S64;
          for (int qt = w.qb; qt < w.qe; ++qt, ++it) {
            const int s = it % STAGES;
            mbar_wait(q_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(q_full + 8 * s, 2 * T::STREAM + 2 * SLICE);
#pragma unroll
            for (int x = 0; x < D / 64; ++x) {
              tma_4d(base + Q_OFF + s * T::STREAM + x * STREAM_BOX, &map_q, q_full + 8 * s,
                     64 * x, qt * BN, h, w.b);
              tma_4d(base + DO_OFF + s * T::STREAM + x * STREAM_BOX, &map_do, q_full + 8 * s,
                     64 * x, qt * BN, h, w.b);
            }
            tma_1d(base + L_OFF + s * 2 * SLICE, &map_rows, q_full + 8 * s, row_base + qt * BN);
            tma_1d(base + L_OFF + s * 2 * SLICE + SLICE, &map_rows, q_full + 8 * s,
                   p.plane + row_base + qt * BN);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns key rows 64c .. 64c + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, g = lane / 4, tq = lane % 4;
  const uint32_t k_sm = base + K_OFF + c * 64 * ROW, v_sm = base + V_OFF + c * 64 * ROW;
  float s_acc[32], dp_acc[32], dk_acc[D / 2], dv_acc[D / 2];
  uint32_t pf[16], df[16];
  zero(s_acc);
  zero(dp_acc);
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const DkvItem w = dkv_item<BM>(order[j], p);
    const int nq = w.qe - w.qb, n = rep * nq;
    const int krow = w.k0 + 64 * c + 16 * warp + g;
    zero(dk_acc);
    zero(dv_acc);
    mbar_wait(kv_full, qi & 1);
    for (int i = 0; i < n; ++i, ++it) {
      const int s = it % STAGES, qt = w.qb + i % nq;
      const uint32_t q_sm = base + Q_OFF + s * T::STREAM, do_sm = base + DO_OFF + s * T::STREAM;
      const float* lse_sm = reinterpret_cast<const float*>(gbase + L_OFF + s * 2 * SLICE);
      mbar_wait(q_full + 8 * s, (it / STAGES) & 1);
      __syncwarp();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wg_fence();
      ss_products<D>(s_acc, k_sm, q_sm);
      ss_products<D>(dp_acc, v_sm, do_sm);
      wg_commit();
      wg_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (lane == 0 && i + 1 == n) mbar_arrive(kv_empty);  // K, V of the item are read
      // dV += P^T.dO goes out first; ds^T is computed under it
      dkv_probs<SOFTCAP>(dkv_masked<BM>(qt, w, p), s_acc, pf, lse_sm, p, krow, qt * BN, tq);
      __syncwarp();
      fence_regs(dv_acc);
      fence_regs(pf);
      wg_fence();
      rs_products<D>(dv_acc, pf, do_sm);
      wg_commit();
      dkv_ds(s_acc, dp_acc, df, lse_sm + BN, tq);
      __syncwarp();
      fence_regs(dk_acc);
      fence_regs(df);
      wg_fence();
      rs_products<D>(dk_acc, df, q_sm);
      wg_commit();
      wg_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pf);
      fence_regs(df);
      if (lane == 0) mbar_arrive(q_empty + 8 * s);  // Q, dO and the slices are read
    }
    if (lane == 0 && n == 0) mbar_arrive(kv_empty);
    store_rows<D>(dk_acc, p.sm_scale, dk + w.b * p.a_sb + w.hk * p.a_sh, p.a_ss, krow, tq, p);
    store_rows<D>(dv_acc, 1.f, dv + w.b * p.b_sb + w.hk * p.b_sh, p.b_ss, krow, tq, p);
  }
}

// K3 at head dim 256, where a 128-row item's K and V (64 KB each) and
// dK, dV accumulators of 256 columns (2 x 128 f32 a thread) do not fit: an
// item is 64 key rows, and the two consumers split the work twice over.
// Shared memory: K, V 32 KB each, 2 stages of Q and dO 32 KB each, two
// buffers of P^T and dS^T (8 KB each), the stages' LSE and delta slices.
struct Dkv256 {
  static constexpr int D = 256, ROWS = 64, STAGES = 2;
  static constexpr int BOX = 64 * ROW;          // a 64-column box of 64 rows (8 KB)
  static constexpr int TILE = (D / 64) * BOX;   // K, V, or a stage's Q or dO (32 KB)
  static constexpr int K_OFF = 0, V_OFF = TILE, Q_OFF = 2 * TILE;
  static constexpr int DO_OFF = Q_OFF + STAGES * TILE;
  static constexpr int P_OFF = DO_OFF + STAGES * TILE;  // buffer b: P^T at + 2b BOX, dS^T + BOX
  static constexpr int L_OFF = P_OFF + 2 * 2 * BOX;     // each stage: LSE slice, delta slice
  static constexpr int BAR_OFF = L_OFF + STAGES * 2 * SLICE;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + slack to align
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// s = A_s.B_s^T and dp = A_dp.B_dp^T, 64 item rows against this
// warpgroup's 32 rows of the streamed tile: m64n32k16 over D, both
// operands K-major, 64-column boxes 8 KB apart. K3 passes (K, V; its 32
// rows of the stage's Q, dO) for S^T and dP^T, K2 (Q, dO; its 32 rows of
// the stage's K, V) for S and dP.
__device__ __forceinline__ void score_products256(float (&s)[16], float (&dp)[16], uint32_t a_s,
                                                  uint32_t a_dp, uint32_t b_s, uint32_t b_dp) {
#pragma unroll
  for (int kk = 0; kk < Dkv256::D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Dkv256::BOX + 32 * (kk % 4);
    wgmma_ss_n32(s, smem_desc(a_s + off, 16, 1024), smem_desc(b_s + off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < Dkv256::D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Dkv256::BOX + 32 * (kk % 4);
    wgmma_ss_n32(dp, smem_desc(a_dp + off, 16, 1024), smem_desc(b_dp + off, 16, 1024), kk > 0);
  }
}

// acc[:, half] += A.B[:, half] over a stage's 64 rows: m64n128k16, A K-major
// (one 64 x 64 box), B the stage's tile MN-major through the transpose bit:
// the half's two 64-column boxes 8 KB apart (the leading byte offset), 8
// rows 1 KB apart (the stride byte offset), a k16 step 16 rows = 2 KB.
__device__ __forceinline__ void box_products256(float (&acc)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128_tb(acc, smem_desc(a + 32 * kk, 16, 1024),
                     smem_desc(b + 2048 * kk, Dkv256::BOX, 1024), 1);
}

// dV[:, half] += P^T.dO[:, half] and dK[:, half] += dS^T.Q[:, half] over
// the stage's 64 query rows.
__device__ __forceinline__ void grad_products256(float (&dv)[64], float (&dk)[64], uint32_t pt,
                                                 uint32_t dst, uint32_t dout, uint32_t q) {
  box_products256(dv, pt, dout);
  box_products256(dk, dst, q);
}

// This thread's bf16 pairs of P^T or dS^T (rows r and r + 8 of the item,
// query columns 32c + 8j + 2tq + {0, 1}; for K2's dS query rows and key
// columns) into a 64 x 64 K-major box:
// 16-byte chunk x of row r at chunk x ^ (r % 8), the 128-byte swizzle the
// wgmma descriptor reads (and conflict-free for these writes).
__device__ __forceinline__ void store_t(uint8_t* box, const uint32_t (&f)[8], int r, int c,
                                        int tq) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = 16 * ((4 * c + j) ^ (r % 8)) + 4 * tq;  // rows r and r + 8 swizzle alike
    *reinterpret_cast<uint32_t*>(box + r * ROW + off) = f[2 * j];
    *reinterpret_cast<uint32_t*>(box + (r + 8) * ROW + off) = f[2 * j + 1];
  }
}

// K3 at d 256: dK and dV for the items order[starts[blockIdx.x] ..
// starts[+1]), each 64 key rows of one (b, KV head). Each of the two
// consumers computes the transposed scores S^T and dP^T of the 64 keys
// against its 32 of a Q/dO tile's 64 query rows, forms p^T and ds^T and
// writes them to shared memory as bf16; the two meet on a named barrier;
// then each runs dV += P^T.dO and dK += dS^T.Q over the whole tile for its
// 128 of the 256 columns. The next tile's S^T and dP^T go out before this
// tile's gradient products, so its p^T and ds^T are computed under them;
// P^T and dS^T are double-buffered, so one barrier a tile is enough.
template <bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv256_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const __grid_constant__ CUtensorMap map_rows,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 const int* __restrict__ order, const int* __restrict__ starts,
                                 const BwdArgs p) {
  using T = Dkv256;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* gbase = aligned_smem(smem_raw, base);
  // kv_full, kv_empty, then q_full, q_empty of each stage
  const uint32_t kv_full = base + T::BAR_OFF, kv_empty = kv_full + 8;
  const uint32_t q_full = kv_full + 16, q_empty = q_full + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int first = starts[blockIdx.x], last = starts[blockIdx.x + 1];
  const int rep = p.Hq / p.Hkv;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_rows);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const DkvItem w = dkv_item<T::ROWS>(order[j], p);
        mbar_wait(kv_empty, (qi & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * T::TILE);
#pragma unroll
        for (int x = 0; x < T::D / 64; ++x) {
          tma_4d(base + T::K_OFF + x * T::BOX, &map_k, kv_full, 64 * x, w.k0, w.hk, w.b);
          tma_4d(base + T::V_OFF + x * T::BOX, &map_v, kv_full, 64 * x, w.k0, w.hk, w.b);
        }
        for (int h = w.hk * rep; h < (w.hk + 1) * rep; ++h) {
          const int row_base = (w.b * p.Hq + h) * p.S64;
          for (int qt = w.qb; qt < w.qe; ++qt, ++it) {
            const int s = it % STAGES;
            mbar_wait(q_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(q_full + 8 * s, 2 * T::TILE + 2 * SLICE);
#pragma unroll
            for (int x = 0; x < T::D / 64; ++x) {
              tma_4d(base + T::Q_OFF + s * T::TILE + x * T::BOX, &map_q, q_full + 8 * s,
                     64 * x, qt * BN, h, w.b);
              tma_4d(base + T::DO_OFF + s * T::TILE + x * T::BOX, &map_do, q_full + 8 * s,
                     64 * x, qt * BN, h, w.b);
            }
            tma_1d(base + T::L_OFF + s * 2 * SLICE, &map_rows, q_full + 8 * s, row_base + qt * BN);
            tma_1d(base + T::L_OFF + s * 2 * SLICE + SLICE, &map_rows, q_full + 8 * s,
                   p.plane + row_base + qt * BN);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes query columns 32c .. 32c + 31 of each
  // tile's scores and columns 128c .. 128c + 127 of dK and dV
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, g = lane / 4, tq = lane % 4;
  const int r_local = 16 * warp + g;  // this thread's first key row of the item
  const uint32_t k_sm = base + T::K_OFF, v_sm = base + T::V_OFF;
  float s_acc[16], dp_acc[16], dk_acc[64], dv_acc[64];
  uint32_t pf[8], df[8];
  zero(s_acc);
  zero(dp_acc);
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const DkvItem w = dkv_item<T::ROWS>(order[j], p);
    const int nq = w.qe - w.qb, n = rep * nq, krow = w.k0 + r_local;
    zero(dk_acc);
    zero(dv_acc);
    mbar_wait(kv_full, qi & 1);
    if (n == 0) {
      if (lane == 0) mbar_arrive(kv_empty);
    } else {
      // the first tile's S^T and dP^T, alone; p^T and ds^T of it
      int s = it % STAGES;
      mbar_wait(q_full + 8 * s, (it / STAGES) & 1);
      __syncwarp();  // the warp meets again before the .aligned wgmma instructions
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wg_fence();
      score_products256(s_acc, dp_acc, k_sm, v_sm, base + T::Q_OFF + s * T::TILE + 32 * c * ROW,
                        base + T::DO_OFF + s * T::TILE + 32 * c * ROW);
      wg_commit();
      wg_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (lane == 0 && n == 1) mbar_arrive(kv_empty);  // K, V of the item are read
      {
        const float* sl = reinterpret_cast<const float*>(gbase + T::L_OFF + s * 2 * SLICE);
        dkv_probs<SOFTCAP>(dkv_masked<T::ROWS>(w.qb, w, p), s_acc, pf, sl + 32 * c, p, krow,
                           w.qb * BN + 32 * c, tq);
        dkv_ds(s_acc, dp_acc, df, sl + SLICE / 4 + 32 * c, tq);
      }
      // Every tile but the last: its p^T and ds^T go to shared memory; the
      // next tile's S^T, dP^T and this tile's gradient products go out as
      // two commit groups; the next tile's p^T and ds^T are computed as
      // soon as its scores retire, under the gradient products. The body
      // commits the same two groups on every pass.
      for (int i = 0; i + 1 < n; ++i, ++it) {
        s = it % STAGES;
        const int s_next = (it + 1) % STAGES, qt = w.qb + (i + 1) % nq;
        const int pb = T::P_OFF + (it & 1) * 2 * T::BOX;
        store_t(gbase + pb, pf, r_local, c, tq);
        store_t(gbase + pb + T::BOX, df, r_local, c, tq);
        // the generic-proxy writes before wgmma reads them; both halves written
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        mbar_wait(q_full + 8 * s_next, ((it + 1) / STAGES) & 1);
        __syncwarp();
        fence_regs(s_acc);
        fence_regs(dp_acc);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        wg_fence();
        score_products256(s_acc, dp_acc, k_sm, v_sm,
                          base + T::Q_OFF + s_next * T::TILE + 32 * c * ROW,
                          base + T::DO_OFF + s_next * T::TILE + 32 * c * ROW);
        wg_commit();
        grad_products256(dv_acc, dk_acc, base + pb, base + pb + T::BOX,
                         base + T::DO_OFF + s * T::TILE + 2 * c * T::BOX,
                         base + T::Q_OFF + s * T::TILE + 2 * c * T::BOX);
        wg_commit();
        wg_wait<1>();  // the next tile's scores have retired; the gradient products run on
        fence_regs(s_acc);
        fence_regs(dp_acc);
        if (lane == 0 && i + 2 == n) mbar_arrive(kv_empty);  // K, V of the item are read
        const float* sl = reinterpret_cast<const float*>(gbase + T::L_OFF + s_next * 2 * SLICE);
        dkv_probs<SOFTCAP>(dkv_masked<T::ROWS>(qt, w, p), s_acc, pf, sl + 32 * c, p, krow,
                           qt * BN + 32 * c, tq);
        dkv_ds(s_acc, dp_acc, df, sl + SLICE / 4 + 32 * c, tq);
        wg_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        if (lane == 0) mbar_arrive(q_empty + 8 * s);  // Q, dO and the slices are read
      }
      // the last tile's gradient products
      s = it % STAGES;
      const int pb = T::P_OFF + (it & 1) * 2 * T::BOX;
      store_t(gbase + pb, pf, r_local, c, tq);
      store_t(gbase + pb + T::BOX, df, r_local, c, tq);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      __syncwarp();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wg_fence();
      grad_products256(dv_acc, dk_acc, base + pb, base + pb + T::BOX,
                       base + T::DO_OFF + s * T::TILE + 2 * c * T::BOX,
                       base + T::Q_OFF + s * T::TILE + 2 * c * T::BOX);
      wg_commit();
      wg_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(q_empty + 8 * s);
      ++it;
    }
    store_rows<128>(dk_acc, p.sm_scale, dk + w.b * p.a_sb + w.hk * p.a_sh, p.a_ss, krow, tq, p,
                    128 * c);
    store_rows<128>(dv_acc, 1.f, dv + w.b * p.b_sb + w.hk * p.b_sh, p.b_ss, krow, tq, p, 128 * c);
  }
}

// K2 at head dim 256, where a 128-row item's Q, dO and O (64 KB each) do
// not fit beside the K/V stages, nor a 64 x 256 f32 dQ accumulator beside
// the scores: an item is 64 query rows, and the two consumers split the
// work twice over, as Dkv256 does with the roles of the operands swapped.
// Budget a CTA (of 232,448 bytes and 512 registers a thread x 128):
//   - shared memory: Q 32 KB + dO 32 KB, loaded once an item; 2 stages of
//     K and V, 32 KB each (128 KB); two buffers of dS, 8 KB each; 80 bytes
//     of barriers and 1 KB to align: 214,096 bytes;
//   - registers: a consumer holds dq 64 + s 16 + dp 16 + ds fragments 8
//     live values and the item's two rows' LSE and delta (setmaxnreg 232,
//     the producer 40);
//   - delta: O (32 KB more) fits no stage, so each consumer reads its
//     threads' two rows of O straight from global memory, 8 16-byte
//     vectors a row a thread, under the item's first S and dP products,
//     and sums them against dO from shared memory for all 256 columns.
//     Both consumers read the same rows: 64 KB read an item, against n x
//     64 KB of K and V for its n tiles, and no barrier between the
//     consumers before the first ds.
struct Dq256 {
  static constexpr int D = 256, ROWS = 64, STAGES = 2;
  static constexpr int BOX = 64 * ROW;          // a 64-column box of 64 rows (8 KB)
  static constexpr int TILE = (D / 64) * BOX;   // Q, dO, or a stage's K or V (32 KB)
  static constexpr int Q_OFF = 0, DO_OFF = TILE, K_OFF = 2 * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int DS_OFF = V_OFF + STAGES * TILE;  // buffer b at + b BOX
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int BAR_OFF = DS_OFF + 2 * BOX;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;  // + slack to align
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// delta of this thread's rows r and r + 8 of the item (q0 + r < S, else 0):
// O's rows from global memory (o: the (b, h) plane, ss its row stride) in
// 16-byte vectors, dO's from the item tile in shared memory (64-column
// boxes 8 KB apart, chunk c of row r at chunk c ^ (r % 8)); each of the 4
// threads of a row sums every 4th 16-byte chunk of the 256 columns, then
// the 4 partial sums meet.
__device__ __forceinline__ void row_deltas256(float (&dl)[2], const bf16* o, int64_t ss,
                                              const uint8_t* dout, int r, int q0, int S, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    float acc = 0.f;
    if (q0 + row < S) {
      const uint4* src = reinterpret_cast<const uint4*>(o + static_cast<int64_t>(q0 + row) * ss);
      uint4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __ldg(src + tq + 4 * i);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ch = tq + 4 * i;
        acc = dot8(a[i], *reinterpret_cast<const uint4*>(
            dout + (ch / 8) * Dq256::BOX + row * ROW + 16 * ((ch % 8) ^ (row % 8))), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[h] = acc;
  }
}

// K2 at d 256: dQ (and delta) for the items order[starts[blockIdx.x] ..
// starts[+1]), each 64 query rows of one (b, q head). Each of the two
// consumers computes S and dP of the 64 query rows against its 32 of a
// K/V tile's 64 keys, forms ds and writes it to shared memory as bf16; the
// two meet on a named barrier; then each runs dQ += dS.K over the whole
// tile for its 128 of the 256 columns. The next tile's S and dP go out
// before this tile's dQ product, so its ds is computed under it; dS is
// double-buffered, so one barrier a tile is enough.
template <bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq256_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_do,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const float* __restrict__ lse, float* __restrict__ rows,
                                const bf16* __restrict__ o, bf16* __restrict__ dq,
                                const int* __restrict__ order, const int* __restrict__ starts,
                                const BwdArgs p) {
  using T = Dq256;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* gbase = aligned_smem(smem_raw, base);
  const uint32_t q_full = base + T::BAR_OFF, q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES, v_empty = k_empty + 8 * STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);   // the producer's arrive + the TMA bytes
    mbar_init(q_empty, 8);  // one arrive from each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int first = starts[blockIdx.x], last = starts[blockIdx.x + 1];

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const DqItem w = dq_item<T::ROWS>(order[j], p);
        mbar_wait(q_empty, (qi & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * T::TILE);  // whole boxes, zero-filled past S too
#pragma unroll
        for (int x = 0; x < T::D / 64; ++x) {
          tma_4d(base + T::Q_OFF + x * T::BOX, &map_q, q_full, 64 * x, w.q0, w.h, w.b);
          tma_4d(base + T::DO_OFF + x * T::BOX, &map_do, q_full, 64 * x, w.q0, w.h, w.b);
        }
        for (int kt = w.kb; kt < w.ke; ++kt, ++it) {
          const int s = it % STAGES, free = ((it / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free);
          mbar_expect_tx(k_full + 8 * s, T::TILE);
#pragma unroll
          for (int x = 0; x < T::D / 64; ++x)
            tma_4d(base + T::K_OFF + s * T::TILE + x * T::BOX, &map_k, k_full + 8 * s, 64 * x,
                   kt * BN, w.hk, w.b);
          mbar_wait(v_empty + 8 * s, free);
          mbar_expect_tx(v_full + 8 * s, T::TILE);
#pragma unroll
          for (int x = 0; x < T::D / 64; ++x)
            tma_4d(base + T::V_OFF + s * T::TILE + x * T::BOX, &map_v, v_full + 8 * s, 64 * x,
                   kt * BN, w.hk, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes keys 32c .. 32c + 31 of each tile's scores
  // and columns 128c .. 128c + 127 of dQ
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, g = lane / 4, tq = lane % 4;
  const int r_local = 16 * warp + g;  // this thread's first query row of the item
  const uint32_t q_sm = base + T::Q_OFF, do_sm = base + T::DO_OFF;
  const uint32_t k_own = base + T::K_OFF + 32 * c * ROW, v_own = base + T::V_OFF + 32 * c * ROW;
  const uint32_t k_half = base + T::K_OFF + 2 * c * T::BOX;
  float s_acc[16], dp_acc[16], dq_acc[64];
  uint32_t f[8];
  zero(s_acc);
  zero(dp_acc);
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const DqItem w = dq_item<T::ROWS>(order[j], p);
    const int n = w.ke - w.kb, qrow = w.q0 + r_local;  // n >= 1: the diagonal tile is live
    const int64_t bh = static_cast<int64_t>(w.b) * p.Hq + w.h;
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)  // a row past S has p = exp2(-inf) = 0
      lse2[h] = qrow + 8 * h < p.S ? lse[bh * p.S + qrow + 8 * h] * LOG2E : INFINITY;
    zero(dq_acc);
    mbar_wait(q_full, qi & 1);

    // the first tile's S and dP, alone, with the item's delta under them
    int s_cur = it % STAGES;
    mbar_wait(k_full + 8 * s_cur, (it / STAGES) & 1);
    mbar_wait(v_full + 8 * s_cur, (it / STAGES) & 1);
    __syncwarp();  // the warp meets again before the .aligned wgmma instructions
    fence_regs(s_acc);
    fence_regs(dp_acc);
    wg_fence();
    score_products256(s_acc, dp_acc, q_sm, do_sm, k_own + s_cur * T::TILE,
                      v_own + s_cur * T::TILE);
    wg_commit();
    row_deltas256(dl, o + w.b * p.b_sb + w.h * p.b_sh, p.b_ss, gbase + T::DO_OFF, r_local, w.q0,
                  p.S, tq);
    if (c == 0 && tq == 0) {
      float* row_out = rows + bh * p.S64;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (qrow + 8 * h < p.S64) {
          row_out[qrow + 8 * h] = lse2[h];
          row_out[p.plane + qrow + 8 * h] = dl[h];  // 0 past S: O is not read there
        }
    }
    wg_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    if (lane == 0) {
      mbar_arrive(v_empty + 8 * s_cur);  // V of the first tile is read
      if (n == 1) mbar_arrive(q_empty);  // Q and dO of the item are read
    }
    dq_grads<SOFTCAP>(dq_masked<T::ROWS>(w.kb, w, p), s_acc, dp_acc, lse2, dl, p, qrow,
                      w.kb * BN + 32 * c, tq);
    pack(f, s_acc);

    // Every tile but the last: its dS goes to shared memory; this tile's
    // dQ product goes out, then (once the next tile's K and V have landed)
    // the next tile's S and dP, as two commit groups. K of this tile is
    // released as soon as the dQ product retires, under the next scores, so
    // the producer's load of the tile after next has the next tile's
    // products and ds to land in (with 2 stages, releasing K after the
    // next ds would leave its load no slack). The body commits the same
    // two groups on every pass.
    for (int i = 0; i + 1 < n; ++i, ++it) {
      const int s_next = (it + 1) % STAGES, ph = ((it + 1) / STAGES) & 1, kt = w.kb + i + 1;
      const int pb = T::DS_OFF + (it & 1) * T::BOX;
      store_t(gbase + pb, f, r_local, c, tq);
      // the generic-proxy writes before wgmma reads them; both halves written
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      __syncwarp();
      fence_regs(dq_acc);
      wg_fence();
      box_products256(dq_acc, base + pb, k_half + s_cur * T::TILE);  // dQ[:, half] += dS.K
      wg_commit();
      mbar_wait(k_full + 8 * s_next, ph);
      mbar_wait(v_full + 8 * s_next, ph);
      __syncwarp();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wg_fence();
      score_products256(s_acc, dp_acc, q_sm, do_sm, k_own + s_next * T::TILE,
                        v_own + s_next * T::TILE);
      wg_commit();
      wg_wait<1>();  // this tile's dQ product has retired; the next tile's scores run on
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);  // K of this tile is read
      wg_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (lane == 0) {
        mbar_arrive(v_empty + 8 * s_next);     // V of the next tile is read
        if (i + 2 == n) mbar_arrive(q_empty);  // Q and dO of the item are read
      }
      dq_grads<SOFTCAP>(dq_masked<T::ROWS>(kt, w, p), s_acc, dp_acc, lse2, dl, p, qrow,
                        kt * BN + 32 * c, tq);
      pack(f, s_acc);
      s_cur = s_next;
    }
    // the last tile's dQ product
    const int pb = T::DS_OFF + (it & 1) * T::BOX;
    store_t(gbase + pb, f, r_local, c, tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __syncwarp();
    fence_regs(dq_acc);
    wg_fence();
    box_products256(dq_acc, base + pb, k_half + s_cur * T::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq_acc);
    if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);
    ++it;
    store_rows<128>(dq_acc, p.sm_scale, dq + w.b * p.a_sb + w.h * p.a_sh, p.a_ss, qrow, tq, p,
                    128 * c);
  }
}

// Shared memory of each kernel: its tiles and barriers + slack to align to 1024.
template <int D>
constexpr int dq_smem() {
  return 3 * Tiles<D>::ITEM + 2 * STAGES * Tiles<D>::STREAM + 8 * (2 + 4 * STAGES) + 1024;
}

template <int D>
constexpr int dkv_smem() {
  return 2 * Tiles<D>::ITEM + 2 * STAGES * Tiles<D>::STREAM + 2 * STAGES * SLICE +
         8 * (2 + 2 * STAGES) + 1024;
}

template <int D, bool SOFTCAP>
int launch_dq(const CUtensorMap (&m)[5], const float* lse, float* rows, void* dq,
              const int* order, const int* starts, int n_ctas, const BwdArgs& p,
              cudaStream_t stream) {
  static uint64_t set = 0;
  const cudaError_t err = allow_smem(flash_bwd_dq_sm90_kernel<D, SOFTCAP>, dq_smem<D>(), set);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel<D, SOFTCAP><<<n_ctas, NTHREADS, dq_smem<D>(), stream>>>(
      m[0], m[1], m[2], m[3], m[4], lse, rows, static_cast<bf16*>(dq), order, starts, p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
int launch_dkv(const CUtensorMap (&m)[5], void* dk, void* dv, const int* order,
               const int* starts, int n_ctas, const BwdArgs& p, cudaStream_t stream) {
  static uint64_t set = 0;
  const cudaError_t err = allow_smem(flash_bwd_dkv_sm90_kernel<D, SOFTCAP>, dkv_smem<D>(), set);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel<D, SOFTCAP><<<n_ctas, NTHREADS, dkv_smem<D>(), stream>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<bf16*>(dk), static_cast<bf16*>(dv), order, starts,
      p);
  return cudaGetLastError();
}

template <bool SOFTCAP>
int launch_dq256(const CUtensorMap (&m)[5], const float* lse, float* rows, const void* o,
                 void* dq, const int* order, const int* starts, int n_ctas, const BwdArgs& p,
                 cudaStream_t stream) {
  static uint64_t set = 0;
  const cudaError_t err = allow_smem(flash_bwd_dq256_sm90_kernel<SOFTCAP>, Dq256::BYTES, set);
  if (err != cudaSuccess) return err;
  flash_bwd_dq256_sm90_kernel<SOFTCAP><<<n_ctas, NTHREADS, Dq256::BYTES, stream>>>(
      m[0], m[1], m[3], m[4], lse, rows, static_cast<const bf16*>(o), static_cast<bf16*>(dq),
      order, starts, p);
  return cudaGetLastError();
}

template <bool SOFTCAP>
int launch_dkv256(const CUtensorMap (&m)[5], void* dk, void* dv, const int* order,
                  const int* starts, int n_ctas, const BwdArgs& p, cudaStream_t stream) {
  static uint64_t set = 0;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv256_sm90_kernel<SOFTCAP>, Dkv256::BYTES, set);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv256_sm90_kernel<SOFTCAP><<<n_ctas, NTHREADS, Dkv256::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<bf16*>(dk), static_cast<bf16*>(dv), order, starts,
      p);
  return cudaGetLastError();
}

// A 1-D f32 map over n values, boxes of BN, no swizzle; zero-filled past n.
int map_1d_f32(CUtensorMap* map, const float* ptr, int64_t n) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)}, no_strides[1] = {0};
  const cuuint32_t box[1] = {BN}, unit[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
                        no_strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// Can an output take bf16x2 stores with these (b, h, s) element strides?
bool even_ok(const void* ptr, int64_t a, int64_t b, int64_t c) {
  return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && a % 2 == 0 && b % 2 == 0 && c % 2 == 0;
}

// The checks and arguments both kernels share; false for what they do not take.
bool fill(BwdArgs& p, int B, int Hq, int Hkv, int S, int D, int Dv, float sm_scale, int causal,
          int window, float softcap, const int* order, const int* starts, int n_ctas) {
  if ((D != 64 && D != 128 && D != 256) || B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 ||
      Hq % Hkv != 0 || Dv <= 0 || Dv > D || order == nullptr || starts == nullptr || n_ctas <= 0 ||
      2 * static_cast<int64_t>(B) * Hq * (S + BN) > 0x7fffffff)
    return false;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.Dv = Dv;
  p.S64 = (S + BN - 1) / BN * BN;
  p.plane = B * Hq * p.S64;
  const bool cap = softcap > 0.f;
  p.mul = sm_scale * LOG2E;
  p.cap_in = cap ? sm_scale / softcap : 0.f;
  p.softcap = softcap;
  p.inv_cap = cap ? 1.f / softcap : 0.f;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  return true;
}

}  // namespace

extern "C" {

// K2. q, k, v, o, dout as flash_bwd.cu's kubedl_flash_bwd_dq_bf16 takes
// them (o beside them, read for delta), lse [B, Hq, S] f32; writes `rows`,
// [2, B, Hq, S64] f32 (S64 = S rounded up to 64): each row's LSE * log2 e,
// then its delta, for K3; and dq through its strides. Strides come in (b, h, s)
// triples in the order q, k, v, o, dout, dq. Then the persistent schedule:
// n_ctas CTAs, CTA c taking order[starts[c] .. starts[c + 1]), each item
// coded q_tile * B * Hq + b * Hq + h (ops/flash_attention.py sm90_schedule,
// kind "dq"; an item is 128 query rows, or 64 at D 256). Returns 0, a
// cudaError_t, 1 (cudaErrorInvalidValue) for a head dim other than 64, 128
// or 256 or a layout the tensor maps cannot take, or 1001 / 2000 + CUresult
// when a tensor map cannot be made.
int kubedl_flash_bwd_dq_sm90_bf16(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const float* lse, float* rows, void* dq,
                                  int B, int Hq, int Hkv, int S, int D, int Dv,
                                  int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                  int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                  int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                  int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb,
                                  int64_t dq_sh, int64_t dq_ss, float sm_scale, int causal,
                                  int window, float softcap, const int* order, const int* starts,
                                  int n_ctas, void* stream) {
  BwdArgs p = {};
  if (!fill(p, B, Hq, Hkv, S, D, Dv, sm_scale, causal, window, softcap, order, starts, n_ctas) ||
      !vec_ok(q, q_sb, q_sh, q_ss) || !vec_ok(k, k_sb, k_sh, k_ss) ||
      !vec_ok(v, v_sb, v_sh, v_ss) || !vec_ok(o, o_sb, o_sh, o_ss) ||
      !vec_ok(dout, do_sb, do_sh, do_ss) || lse == nullptr || rows == nullptr)
    return cudaErrorInvalidValue;
  p.a_sb = dq_sb;
  p.a_sh = dq_sh;
  p.a_ss = dq_ss;
  p.b_sb = o_sb;  // the d 256 kernel reads O from global memory, the others through m[2]
  p.b_sh = o_sh;
  p.b_ss = o_ss;
  p.vec_out = even_ok(dq, dq_sb, dq_sh, dq_ss);
  CUtensorMap m[5];
  const int item_rows = D == 256 ? Dq256::ROWS : BM;  // query rows an item
  int err = map_4d(&m[0], q, D, S, Hq, B, q_sb, q_sh, q_ss, item_rows);
  if (!err) err = map_4d(&m[1], dout, D, S, Hq, B, do_sb, do_sh, do_ss, item_rows);
  if (!err && D != 256) err = map_4d(&m[2], o, D, S, Hq, B, o_sb, o_sh, o_ss, BM);
  if (!err) err = map_4d(&m[3], k, D, S, Hkv, B, k_sb, k_sh, k_ss, BN);
  if (!err) err = map_4d(&m[4], v, D, S, Hkv, B, v_sb, v_sh, v_ss, BN);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (D == 256)
    return cap ? launch_dq256<true>(m, lse, rows, o, dq, order, starts, n_ctas, p, st)
               : launch_dq256<false>(m, lse, rows, o, dq, order, starts, n_ctas, p, st);
  if (D == 64)
    return cap ? launch_dq<64, true>(m, lse, rows, dq, order, starts, n_ctas, p, st)
               : launch_dq<64, false>(m, lse, rows, dq, order, starts, n_ctas, p, st);
  return cap ? launch_dq<128, true>(m, lse, rows, dq, order, starts, n_ctas, p, st)
             : launch_dq<128, false>(m, lse, rows, dq, order, starts, n_ctas, p, st);
}

// K3. q, k, v, dout as above, `rows` as K2 wrote it; writes dk, dv through
// their strides. Strides in (b, h, s) triples in the order q, k, v, dout,
// dk, dv. The schedule's items are coded k_tile * B * Hkv + b * Hkv + hk
// (kind "dkv"; a k_tile is 128 key rows, or 64 at D 256). D is 64, 128 or
// 256. Returns as K2's.
int kubedl_flash_bwd_dkv_sm90_bf16(const void* q, const void* k, const void* v,
                                   const void* dout, const float* rows, void* dk, void* dv,
                                   int B, int Hq, int Hkv, int S, int D, int Dv, int64_t q_sb,
                                   int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                   int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dk_sb,
                                   int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                                   int64_t dv_ss, float sm_scale, int causal, int window,
                                   float softcap, const int* order, const int* starts, int n_ctas,
                                   void* stream) {
  BwdArgs p = {};
  if (!fill(p, B, Hq, Hkv, S, D, Dv, sm_scale, causal, window, softcap, order, starts, n_ctas) ||
      !vec_ok(q, q_sb, q_sh, q_ss) || !vec_ok(k, k_sb, k_sh, k_ss) ||
      !vec_ok(v, v_sb, v_sh, v_ss) || !vec_ok(dout, do_sb, do_sh, do_ss) ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0)
    return cudaErrorInvalidValue;
  p.a_sb = dk_sb;
  p.a_sh = dk_sh;
  p.a_ss = dk_ss;
  p.b_sb = dv_sb;
  p.b_sh = dv_sh;
  p.b_ss = dv_ss;
  p.vec_out = even_ok(dk, dk_sb, dk_sh, dk_ss) && even_ok(dv, dv_sb, dv_sh, dv_ss);
  CUtensorMap m[5];
  const int item_rows = D == 256 ? Dkv256::ROWS : BM;  // key rows an item
  int err = map_4d(&m[0], k, D, S, Hkv, B, k_sb, k_sh, k_ss, item_rows);
  if (!err) err = map_4d(&m[1], v, D, S, Hkv, B, v_sb, v_sh, v_ss, item_rows);
  if (!err) err = map_4d(&m[2], q, D, S, Hq, B, q_sb, q_sh, q_ss, BN);
  if (!err) err = map_4d(&m[3], dout, D, S, Hq, B, do_sb, do_sh, do_ss, BN);
  if (!err) err = map_1d_f32(&m[4], rows, 2 * static_cast<int64_t>(p.plane));
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (D == 64)
    return cap ? launch_dkv<64, true>(m, dk, dv, order, starts, n_ctas, p, st)
               : launch_dkv<64, false>(m, dk, dv, order, starts, n_ctas, p, st);
  if (D == 128)
    return cap ? launch_dkv<128, true>(m, dk, dv, order, starts, n_ctas, p, st)
               : launch_dkv<128, false>(m, dk, dv, order, starts, n_ctas, p, st);
  return cap ? launch_dkv256<true>(m, dk, dv, order, starts, n_ctas, p, st)
             : launch_dkv256<false>(m, dk, dv, order, starts, n_ctas, p, st);
}

const char* kubedl_flash_bwd_sm90_error_string(int err) { return sm90_error_string(err); }

}  // extern "C"
