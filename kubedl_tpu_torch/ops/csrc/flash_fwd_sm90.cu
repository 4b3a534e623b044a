// Flash-attention forward redesigned for Hopper (sm_90a): TMA, mbarrier
// pipelines, wgmma and warp-specialized consumer warpgroups. bf16 in and
// out, f32 softmax state and accumulation; plain C interface bound with
// ctypes by kubedl_tpu_torch/ops/flash_attention.py, which routes every
// head dim here, zero-padded to 64, 128 or 256 (flash_fwd.cu, the mma.sync
// kernel, runs only when a caller asks for it by name).
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/flash_attention.py:107 _fwd_kernel          (K1)
//   kubedl_tpu/ops/flash_attention.py:191 _fwd_streamed_kernel (K4)
// Both compute the same function; this kernel streams K/V tiles at every
// length, so one kernel covers both.
//
// What it computes is flash_fwd.cu's function, per (batch, q head):
//   s = (q . k) * sm_scale, then cap * tanh(s / cap) when softcap > 0, then
//   masked to -1e30 outside {k_pos < S, causal k_pos <= q_pos, window
//   k_pos > q_pos - window}; online softmax over the K/V tiles; O = acc / l
//   and LSE = m + log(l) in natural log, l floored at 1e-30 so no row is
//   NaN. GQA reads KV head h / (Hq / Hkv). The exponentials run in the log2
//   domain (sm_scale * log2 e folded into one multiply-add); the LSE that
//   the backward kernels read is written in natural log.
//
// Bound on an H100 SXM: 4 * b * hq * S^2 * d FLOP (x 1/2 causal) at 989
// TFLOP/s bf16 against (q + k + v + o) bytes at 3.35 TB/s; the 7B prefill
// and training shapes (S ~ 1024) sit near the ridge, S >= 2048 is bound by
// the tensor cores, and at d 256 (Gemma-2) every shape the model runs is
// bound by the tensor cores. What the design does about it:
//   - a CTA takes 128 query rows with three warpgroups: a producer (one
//     thread issues every TMA load; the warpgroup gives its registers back
//     with setmaxnreg) and two consumers of 64 rows each;
//   - TMA loads Q once an item and K, V through rings of key-row tiles, K
//     and V each with their own full and empty barriers: Q.K^T starts
//     before V lands, and a K stage is refilled as soon as its Q.K^T has
//     retired, a tile before its V; every wait traps after ~4 s;
//   - q, k, v are read in place through 4-D tensor maps over (d, s, h, b)
//     with the caller's strides (the model's [b, s, h, d] views need no
//     copy); TMA zero-fills the rows past S of each (b, h);
//   - S = Q.K^T is wgmma with both operands K-major in shared memory; O +=
//     P.V is wgmma with P in registers (the f32 scores rounded in place to
//     bf16 A fragments, no shuffle) and V MN-major through the transpose
//     bit;
//   - a consumer issues the next tile's Q.K^T and this tile's P.V as two
//     commit groups and takes the next tile's exponentials (and the
//     softcap's tanh) as soon as the Q.K^T retires, under the P.V; O is
//     rescaled after. The two consumers are not made to take turns: each
//     one's softmax also runs under the other's products as the warp
//     schedulers interleave them (ping-pong on named barriers measured no
//     faster on the H100; PERF.md);
//   - masks only where needed: a tile is masked only on the causal
//     diagonal, the window's lower edge or the S tail; other tiles skip
//     all position arithmetic. Tiles wholly above the diagonal or below
//     the window are never loaded;
//   - a persistent grid (one CTA an SM) walks (q-tile, b, h) items in the
//     host's schedule (ops/flash_attention.py sm90_schedule, cached per
//     shape, costed in this head dim's K/V tiles): groups of (b, h) whose
//     K/V fit in half the L2, so the CTAs running at once read each K/V
//     tile from device memory about once; inside a group the longest
//     causal rows first and the query heads of one GQA group adjacent;
//     each item to the CTA that frees first, so the CTAs end together. The
//     producer loads the next item's Q and K/V while the consumers finish
//     the last one.
//
// The tile geometry is a traits struct a head dim (Fwd<D>), within the
// 227 KB of shared memory a block may have and 255 registers a thread:
//   - D 64, 128: K/V tiles of 128 key rows in 3 stages (Q 32 KB + 3 x 2 x
//     32 KB at 128: 224 KB), S = Q.K^T m64n128k16, O += P.V m64n{64,128}k16
//     over 8 k16 steps; consumers at 232 registers (o[64] + s[64] +
//     pf[32]). The epilogue normalizes O, rounds it to bf16 through the V
//     tile the item read last (released after) and leaves as 16-byte
//     stores;
//   - D 256: a 128-key tile would be 64 KB, and Q plus 3 stages of K and V
//     448 KB, so K/V tiles are 64 key rows (32 KB) in 2 stages: Q 64 KB +
//     2 x (32 + 32) KB = 192 KB. S = Q.K^T is m64n64k16 over 16 k16 steps,
//     O += P.V one m64n256k16 over 4 k16 steps; a consumer holds o[128] +
//     s[32] + pf[16], ~176 live f32 (setmaxnreg 240, the producer 24). The
//     staged O would be 64 KB against a 32 KB V stage, and staging it in
//     the Q tile would hold the next item's Q load behind the epilogue, so
//     O leaves straight from the accumulators as bf16 pairs (64 4-byte
//     stores a thread an item instead of 16 16-byte ones; the rows' halves
//     meet in L2) and the last V stage is released before them.
//   One thread a row writes the LSE.
//
// Layout rules: q [B, Hq, S, D], k/v [B, Hkv, S, D] with the last dim
// contiguous, other strides whole 16-byte vectors and 16-byte aligned
// bases; o is written through its own strides, lse is [B, Hq, S] f32.
// D is 64, 128 or 256 (the wrapper zero-pads other head dims and passes
// the true width as Dv).

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // query rows an item: two consumer warpgroups x 64
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int ROW = 128;       // bytes a box row: 64 bf16, the swizzle span

// The shared-memory map and register split of a head dim: key rows a K/V
// tile, ring stages, whether O is staged through a V tile, and setmaxnreg's
// counts for the consumers and the producer (2 x consumers + producer <=
// 504 of the 512 a thread of the block may take, 65,536 / 128).
template <int D_, int BN_, int STAGES_, bool STAGE_O_, int CONSUMER_REGS_, int PRODUCER_REGS_>
struct Geometry {
  static constexpr int D = D_, BN = BN_, STAGES = STAGES_;
  static constexpr bool STAGE_O = STAGE_O_;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_, PRODUCER_REGS = PRODUCER_REGS_;
  static constexpr int Q_BOX = BM * ROW;   // a 64-column box of the Q tile
  static constexpr int KV_BOX = BN * ROW;  // a 64-column box of a K or V tile
  static constexpr int Q_TILE = (D / 64) * Q_BOX;
  static constexpr int KV_TILE = (D / 64) * KV_BOX;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;  // + slack to align to 1024
  // the staged epilogue puts O in the V tile the item read last: 16 rows
  // of 2D bytes for each consumer warp, its 16-byte chunks swizzled by row
  static constexpr int EPI_WARP = 16 * 2 * D;
  static_assert(!STAGE_O || 8 * EPI_WARP == KV_TILE, "O staging fills one V tile");
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  static_assert(2 * CONSUMER_REGS + PRODUCER_REGS <= 504, "the register file");
};

template <int D>
struct Fwd : Geometry<D, 128, 3, true, 232, 40> {};
template <>
struct Fwd<256> : Geometry<256, 64, 2, false, 240, 24> {};

struct FwdArgs {
  int B, Hq, Hkv, S, Dv;
  int64_t o_sb, o_sh, o_ss;
  float mul;      // a score's value -> log2 units: sm_scale * log2 e, or log2 e after the softcap
  float lse_mul;  // a row max -> natural log units: sm_scale, or 1 after the softcap
  float cap_in;   // sm_scale / softcap
  float softcap;
  float mask_v;   // a masked score: -1e30 after scaling, in the values' units
  int causal;
  int window;     // <= 0: no window
  int vec_out;    // o rows and columns take 16-byte stores
};

// One (q-tile, batch, q head) item and its live K/V tiles [kb, ke).
struct Item {
  int b, h, hk, q0, kb, ke;
};

// Item `code` of the host's schedule: q_tile * B * Hq + (b * Hq + h); K/V
// tiles of BN key rows.
template <int BN>
__device__ __forceinline__ Item item_of(int code, const FwdArgs& p) {
  const int bh_n = p.B * p.Hq, qt = code / bh_n, bh = code - qt * bh_n;
  Item w;
  w.b = bh / p.Hq;
  w.h = bh - w.b * p.Hq;
  w.hk = w.h / (p.Hq / p.Hkv);
  w.q0 = qt * BM;
  w.ke = (p.S + BN - 1) / BN;
  if (p.causal) w.ke = min(w.ke, (w.q0 + BM - 1) / BN + 1);
  w.kb = 0;
  if (p.window > 0) {
    const int lo = w.q0 - p.window + 1;  // the first key row q0's window admits
    w.kb = lo > 0 ? lo / BN : 0;
  }
  return w;
}

// Does tile kt hold a (query, key) pair of the item that a mask drops?
template <int BN>
__device__ __forceinline__ bool tile_masked(int kt, const Item& w, const FwdArgs& p) {
  const int k0 = kt * BN;
  return k0 + BN > p.S || (p.causal && k0 + BN - 1 > w.q0) ||
         (p.window > 0 && k0 <= w.q0 + BM - 1 - p.window);
}

// s = Q[64 rows of this warpgroup] . K_tile^T over D: D / 16 products. Q
// and K are K-major 64-wide boxes (Q_BOX and KV_BOX apart); a k16 step is
// 32 bytes inside a box.
template <class L>
__device__ __forceinline__ void qk_products(float (&s)[L::BN / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < L::D / 16; ++kk) {
    const uint32_t col = 32 * (kk % 4);
    const uint64_t da = smem_desc(q + (kk / 4) * L::Q_BOX + col, 16, 1024);
    const uint64_t db = smem_desc(k + (kk / 4) * L::KV_BOX + col, 16, 1024);
    if constexpr (L::BN == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// o += P . V_tile over the tile's keys: BN / 16 products. V is MN-major (d
// contiguous): 64-wide boxes KV_BOX apart (the leading byte offset), 8 key
// rows 1 KB apart (the stride byte offset), a k16 step 16 rows = 2 KB.
template <class L>
__device__ __forceinline__ void pv_products(float (&o)[L::D / 2], const uint32_t (&pf)[L::BN / 4],
                                            uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
    const uint64_t dv = smem_desc(v + 2048 * kk, L::KV_BOX, 1024);
    if constexpr (L::D == 256)
      wgmma_rs_n256(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3], dv);
    else if constexpr (L::D == 128)
      wgmma_rs_n128(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3], dv);
    else
      wgmma_rs_n64(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3], dv);
  }
}

// One tile's online softmax for this thread's rows qrow and qrow + 8, in
// place: s holds the tile's N / 2 scores a row (s[4j + e]: row + 8 (e /
// 2), key k0 + 8j + 2tq + e % 2) and leaves with their exponentials; m is
// the rows' running max in the values' units, l the thread's partial row
// sums, corr the factor the rows' O takes for the new max.
template <bool SOFTCAP, bool MASKED, int N>
__device__ __forceinline__ void tile_exp(float (&s)[N], float (&m)[2], float (&l)[2],
                                         float (&corr)[2], const FwdArgs& p, int qrow, int k0,
                                         int tq) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if constexpr (SOFTCAP) x = p.softcap * tanhf(x * p.cap_in);
      if constexpr (MASKED) {
        const int qp = qrow + (e >> 1) * 8, kp = k0 + 8 * j + 2 * tq + (e & 1);
        bool ok = kp < p.S;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        if (!ok) x = p.mask_v;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] * p.mul;
    // (m - mx) first: m and mx may both be the huge masked value, whose
    // product with mul a fused multiply-add would leave ~1e23 off zero
    corr[r] = ex2((m[r] - mx[r]) * p.mul);  // 0 while m is still -inf
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // an unmasked tile holds no masked value: one fused multiply-add
      const float pv = MASKED ? ex2((s[4 * j + e] - mx[e >> 1]) * p.mul)
                              : ex2(fmaf(s[4 * j + e], p.mul, -ms[e >> 1]));
      s[4 * j + e] = pv;
      rs[e >> 1] += pv;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}

template <bool SOFTCAP, int N>
__device__ __forceinline__ void tile_exp(bool masked, float (&s)[N], float (&m)[2],
                                         float (&l)[2], float (&corr)[2], const FwdArgs& p,
                                         int qrow, int k0, int tq) {
  if (masked)
    tile_exp<SOFTCAP, true>(s, m, l, corr, p, qrow, k0, tq);
  else
    tile_exp<SOFTCAP, false>(s, m, l, corr, p, qrow, k0, tq);
}

// P as bf16 A fragments straight from the exponentials' accumulator layout
// (pf[4kk .. 4kk + 3] is the k16 step kk), and O rescaled for the new max.
template <int D, int N>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2], uint32_t (&pf)[N / 2],
                                             const float (&s)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    pf[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pf[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// The rows' sums over the 4 threads of a row, floored, and their inverses.
__device__ __forceinline__ void row_sums(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
}

// One thread of each row (tq 0) writes the LSE of rows row0 + g, + 8.
__device__ __forceinline__ void store_lse(const float (&m)[2], const float (&l)[2], const Item& w,
                                          const FwdArgs& p, float* __restrict__ lse, int row0,
                                          int lane) {
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < p.S)
        lse[(static_cast<int64_t>(w.b) * p.Hq + w.h) * p.S + row] = m[r] * p.lse_mul + __logf(l[r]);
    }
  }
}

// Normalize this warp's 16 x D rows, round to bf16 through its staging
// buffer (16-byte chunk c of row r at chunk c ^ (r % 8): conflict-free) and
// write them with 16-byte stores (element stores when the output's strides
// or width are not whole vectors); rows at or past S and columns at or past
// Dv are not written. Then the rows' LSE.
template <int D>
__device__ __forceinline__ void store_rows(float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                           uint8_t* buf, const Item& w, const FwdArgs& p,
                                           bf16* __restrict__ out, float* __restrict__ lse,
                                           int row0, int lane) {
  constexpr int PITCH = 2 * D;
  const int g = lane / 4, tq = lane % 4;
  float inv[2];
  row_sums(l, inv);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int off = 16 * (j ^ g) + 4 * tq;  // rows g and g + 8 swizzle alike
    *reinterpret_cast<__nv_bfloat162*>(buf + g * PITCH + off) =
        __floats2bfloat162_rn(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(buf + (g + 8) * PITCH + off) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = out + w.b * p.o_sb + w.h * p.o_sh;
  constexpr int VPR = D / 8;  // 16-byte vectors a row
#pragma unroll
  for (int i = 0; i < 16 * VPR / 32; ++i) {
    const int v = i * 32 + lane, rr = v / VPR, col = (v % VPR) * 8, row = row0 + rr;
    if (row < p.S && col < p.Dv) {
      const uint8_t* src = buf + rr * PITCH + 16 * ((v % VPR) ^ (rr % 8));
      bf16* dst = ob + static_cast<int64_t>(row) * p.o_ss + col;
      if (p.vec_out) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < p.Dv; ++e) dst[e] = reinterpret_cast<const bf16*>(src)[e];
      }
    }
  }
  __syncwarp();  // the warp's reads are done before the tile is released
  store_lse(m, l, w, p, lse, row0, lane);
}

// D 256: normalize this warp's 16 x D rows and write them from the
// accumulators as bf16 pairs (rows g and g + 8, columns 8j + 2tq; element
// stores when the output's strides or width are not whole vectors), rows
// at or past S and columns at or past Dv not written. Then the rows' LSE.
template <int D>
__device__ __forceinline__ void store_rows_direct(const float (&o)[D / 2], float (&m)[2],
                                                  float (&l)[2], const Item& w, const FwdArgs& p,
                                                  bf16* __restrict__ out,
                                                  float* __restrict__ lse, int row0, int lane) {
  const int g = lane / 4, tq = lane % 4;
  float inv[2];
  row_sums(l, inv);
  bf16* ob = out + w.b * p.o_sb + w.h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.S) continue;
    bf16* dst = ob + static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float x = o[4 * j + 2 * r] * inv[r], y = o[4 * j + 2 * r + 1] * inv[r];
      if (p.vec_out && col + 1 < p.Dv) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < p.Dv) dst[col] = __float2bfloat16_rn(x);
        if (col + 1 < p.Dv) dst[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
  store_lse(m, l, w, p, lse, row0, lane);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                          float* __restrict__ lse, const int* __restrict__ order,
                          const int* __restrict__ starts, const FwdArgs p) {
  using L = Fwd<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 8;
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
  const int first = starts[blockIdx.x], last = starts[blockIdx.x + 1];  // this CTA's items

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const Item w = item_of<BN>(order[j], p);
        mbar_wait(q_empty, (qi & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_TILE);  // whole boxes, zero-filled past S too
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_4d(base + L::Q_OFF + x * L::Q_BOX, &map_q, q_full, 64 * x, w.q0, w.h, w.b);
        for (int kt = w.kb; kt < w.ke; ++kt, ++it) {
          const int s = it % STAGES, free = ((it / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free);
          mbar_expect_tx(k_full + 8 * s, L::KV_TILE);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + L::K_OFF + s * L::KV_TILE + x * L::KV_BOX, &map_k, k_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
          mbar_wait(v_empty + 8 * s, free);
          mbar_expect_tx(v_full + 8 * s, L::KV_TILE);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + L::V_OFF + s * L::KV_TILE + x * L::KV_BOX, &map_v, v_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, tq = lane % 4;
  const uint32_t q_smem = base + L::Q_OFF + c * 64 * ROW;  // this warpgroup's 64 rows of each box
  float s_acc[BN / 2], o_acc[D / 2];
  uint32_t pf[BN / 4];
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const Item w = item_of<BN>(order[j], p);
    const int n = w.ke - w.kb;
    const int row0 = w.q0 + 64 * c + 16 * warp, qrow = row0 + lane / 4;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;

    // the first tile's Q.K^T, alone
    mbar_wait(q_full, qi & 1);
    mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
    __syncwarp();  // the warp meets again before the .aligned wgmma instructions
    fence_regs(s_acc);
    wg_fence();
    qk_products<L>(s_acc, q_smem, base + L::K_OFF + (it % STAGES) * L::KV_TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(s_acc);
    if (lane == 0) {
      mbar_arrive(k_empty + 8 * (it % STAGES));  // K of the first tile is read
      if (n == 1) mbar_arrive(q_empty);          // the item's last Q.K^T is done
    }

    float corr[2];
    tile_exp<SOFTCAP>(tile_masked<BN>(w.kb, w, p), s_acc, m, l, corr, p, qrow, w.kb * BN, tq);
    rescale_pack<D>(o_acc, pf, s_acc, corr);

    // Every tile but the last: the next tile's Q.K^T and this tile's P.V go
    // out as two commit groups; the next tile's exponentials run as soon as
    // the Q.K^T retires, under the P.V. The body commits the same two groups
    // on every pass, so ptxas can follow which group each wait retires.
    for (int i = 0; i + 1 < n; ++i, ++it) {
      const int s = it % STAGES, s_next = (it + 1) % STAGES, kt = w.kb + i + 1;
      mbar_wait(k_full + 8 * s_next, ((it + 1) / STAGES) & 1);
      mbar_wait(v_full + 8 * s, (it / STAGES) & 1);
      __syncwarp();  // the warp meets again before the .aligned wgmma instructions
      fence_regs(o_acc);
      fence_regs(pf);
      fence_regs(s_acc);
      wg_fence();
      qk_products<L>(s_acc, q_smem, base + L::K_OFF + s_next * L::KV_TILE);
      wg_commit();
      pv_products<L>(o_acc, pf, base + L::V_OFF + s * L::KV_TILE);
      wg_commit();
      wg_wait<1>();  // the Q.K^T has retired; the P.V runs on
      fence_regs(s_acc);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * s_next);     // K of the next tile is read
        if (i + 2 == n) mbar_arrive(q_empty);  // the item's last Q.K^T is done
      }
      tile_exp<SOFTCAP>(tile_masked<BN>(kt, w, p), s_acc, m, l, corr, p, qrow, kt * BN, tq);
      wg_wait<0>();
      fence_regs(o_acc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(v_empty + 8 * s);  // V of this tile is read
      rescale_pack<D>(o_acc, pf, s_acc, corr);
    }
    // the last tile's P.V
    const int s_last = it % STAGES;
    mbar_wait(v_full + 8 * s_last, (it / STAGES) & 1);
    __syncwarp();
    fence_regs(o_acc);
    fence_regs(pf);
    wg_fence();
    pv_products<L>(o_acc, pf, base + L::V_OFF + s_last * L::KV_TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(o_acc);
    fence_regs(pf);
    ++it;
    if constexpr (L::STAGE_O) {
      // its V tile stages O before it is released: both consumers' last P.V
      // have read the tile before either stages O in it
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int epi_off = L::V_OFF + (threadIdx.x / 32 - 4) * L::EPI_WARP;
      store_rows<D>(o_acc, m, l, gbase + epi_off + s_last * L::KV_TILE, w, p, out, lse, row0,
                    lane);
      // the staging writes were generic-proxy; TMA writes the tile next
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) mbar_arrive(v_empty + 8 * s_last);
    } else {
      if (lane == 0) mbar_arrive(v_empty + 8 * s_last);  // V of the last tile is read
      store_rows_direct<D>(o_acc, m, l, w, p, out, lse, row0, lane);
    }
  }
}

template <int D, bool SOFTCAP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
           float* lse, const int* order, const int* starts, int n_ctas, const FwdArgs& p,
           cudaStream_t stream) {
  constexpr int smem = Fwd<D>::BYTES;
  static uint64_t set = 0;
  const cudaError_t err = allow_smem(flash_fwd_sm90_kernel<D, SOFTCAP>, smem, set);
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_kernel<D, SOFTCAP><<<n_ctas, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, order, starts, p);
  return cudaGetLastError();
}

template <int D>
int launch(bool cap, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           void* out, float* lse, const int* order, const int* starts, int n_ctas,
           const FwdArgs& p, cudaStream_t stream) {
  return cap ? launch<D, true>(mq, mk, mv, out, lse, order, starts, n_ctas, p, stream)
             : launch<D, false>(mq, mk, mv, out, lse, order, starts, n_ctas, p, stream);
}

}  // namespace

extern "C" {

// The arguments of flash_fwd.cu's kubedl_flash_fwd_bf16, then the
// persistent schedule: n_ctas CTAs, CTA c taking the items
// order[starts[c] .. starts[c + 1]) (ops/flash_attention.py sm90_schedule),
// each coded as q_tile * B * Hq + b * Hq + h; every item exactly once.
// Returns 0, a cudaError_t, 1 (cudaErrorInvalidValue) for a head dim other
// than 64, 128 or 256 or a layout the tensor maps cannot take, or 1001 / 2000 +
// CUresult when a tensor map cannot be made.
int kubedl_flash_fwd_sm90_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                               int B, int Hq, int Hkv, int S, int D, int Dv, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                               int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                               int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale,
                               int causal, int window, float softcap, const int* order,
                               const int* starts, int n_ctas, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      Dv <= 0 || Dv > D || !vec_ok(q, q_sb, q_sh, q_ss) || !vec_ok(k, k_sb, k_sh, k_ss) ||
      !vec_ok(v, v_sb, v_sh, v_ss) || order == nullptr || starts == nullptr || n_ctas <= 0)
    return cudaErrorInvalidValue;
  FwdArgs p;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.Dv = Dv;
  if (static_cast<int64_t>(B) * Hq * ((S + BM - 1) / BM) > 0x7fffffff) return cudaErrorInvalidValue;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  const bool cap = softcap > 0.f;
  p.mul = cap ? LOG2E : sm_scale * LOG2E;
  p.lse_mul = cap ? 1.f : sm_scale;
  p.cap_in = cap ? sm_scale / softcap : 0.f;
  p.softcap = softcap;
  p.mask_v = cap ? -1e30f : -1e30f / sm_scale;
  p.causal = causal;
  p.window = window;
  p.vec_out = Dv % 8 == 0 && vec_ok(o, o_sb, o_sh, o_ss);
  CUtensorMap mq, mk, mv;
  const int bn = D == 256 ? Fwd<256>::BN : Fwd<128>::BN;  // key rows a K/V box
  int err = map_4d(&mq, q, D, S, Hq, B, q_sb, q_sh, q_ss, BM);
  if (!err) err = map_4d(&mk, k, D, S, Hkv, B, k_sb, k_sh, k_ss, bn);
  if (!err) err = map_4d(&mv, v, D, S, Hkv, B, v_sb, v_sh, v_ss, bn);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(cap, mq, mk, mv, o, lse, order, starts, n_ctas, p, st);
  if (D == 128) return launch<128>(cap, mq, mk, mv, o, lse, order, starts, n_ctas, p, st);
  return launch<256>(cap, mq, mk, mv, o, lse, order, starts, n_ctas, p, st);
}

const char* kubedl_flash_fwd_sm90_error_string(int err) { return sm90_error_string(err); }

}  // extern "C"
