// Flash-attention forward redesigned for Hopper (sm_90a): TMA, mbarrier
// pipelines, wgmma and warp-specialized consumer warpgroups. bf16 in and
// out, f32 softmax state and accumulation; plain C interface bound with
// ctypes by kubedl_tpu_torch/ops/flash_attention.py, which routes head
// dims padded to 64 or 128 here (flash_fwd.cu keeps 256).
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
//   flash_bwd.cu reads is written in natural log.
//
// Bound on an H100 SXM: 4 * b * hq * S^2 * d FLOP (x 1/2 causal) at 989
// TFLOP/s bf16 against (q + k + v + o) bytes at 3.35 TB/s; the 7B prefill
// and training shapes (S ~ 1024) sit near the ridge, S >= 2048 is bound by
// the tensor cores. What the design does about it:
//   - a CTA takes 128 query rows with three warpgroups: a producer (one
//     thread issues every TMA load; the warpgroup gives its registers back
//     with setmaxnreg) and two consumers of 64 rows each (setmaxnreg 232);
//   - TMA loads Q once an item and K, V through rings of 3 stages of 128
//     key rows, K and V each with their own full and empty barriers: Q.K^T
//     starts before V lands, and a K stage is refilled as soon as its
//     Q.K^T has retired, a tile before its V; every wait traps after ~4 s;
//   - q, k, v are read in place through 4-D tensor maps over (d, s, h, b)
//     with the caller's strides (the model's [b, s, h, d] views need no
//     copy); TMA zero-fills the rows past S of each (b, h);
//   - S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; O += P.V is wgmma with P in registers (the f32 scores rounded
//     in place to bf16 A fragments, no shuffle) and V MN-major through the
//     transpose bit;
//   - a consumer issues the next tile's Q.K^T and this tile's P.V as two
//     commit groups and takes the next tile's exponentials as soon as the
//     Q.K^T retires, under the P.V; O is rescaled after. The two consumers
//     are not made to take turns: each one's softmax also runs under the
//     other's products as the warp schedulers interleave them (ping-pong
//     on named barriers measured no faster on the H100; PERF.md);
//   - masks only where needed: a tile is masked only on the causal
//     diagonal, the window's lower edge or the S tail; other tiles skip
//     all position arithmetic. Tiles wholly above the diagonal or below
//     the window are never loaded;
//   - a persistent grid (one CTA an SM) walks (q-tile, b, h) items in the
//     host's schedule (ops/flash_attention.py sm90_schedule, cached per
//     shape): groups of (b, h) whose K/V fit in half the L2, so the CTAs
//     running at once read each K/V tile from device memory about once;
//     inside a group the longest causal rows first and the query heads of
//     one GQA group adjacent; each item to the CTA that frees first, so
//     the CTAs end together. The producer loads the next item's Q and K/V
//     while the consumers finish the last one;
//   - the epilogue normalizes O, rounds it to bf16 through the V tile the
//     item read last (released after; so the 3rd stage fits in shared
//     memory) and leaves as 16-byte stores; one thread a row writes the LSE.
//
// Layout rules: q [B, Hq, S, D], k/v [B, Hkv, S, D] with the last dim
// contiguous, other strides whole 16-byte vectors and 16-byte aligned
// bases; o is written through its own strides, lse is [B, Hq, S] f32.
// D is 64 or 128 (the wrapper zero-pads other head dims and passes the
// true width as Dv).

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                // query rows an item: two consumer warpgroups x 64
constexpr int BN = 128;                // key rows a K/V tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;          // producer warpgroup + two consumer warpgroups
constexpr int BOX_BYTES = 128 * 128;   // 128 rows x 64 bf16 (128 bytes, the swizzle span)

template <int D>
struct Smem {
  static constexpr int TILE = (D / 64) * BOX_BYTES;  // a Q, K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;  // + slack to align to 1024
  // the epilogue stages O in the V tile the item read last: 16 rows of 2D
  // bytes for each consumer warp, its 16-byte chunks swizzled by row
  static constexpr int EPI_WARP = 16 * 2 * D;
  static_assert(8 * EPI_WARP == TILE, "O staging fills one V tile");
};

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

// Item `code` of the host's schedule: q_tile * B * Hq + (b * Hq + h).
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
__device__ __forceinline__ bool tile_masked(int kt, const Item& w, const FwdArgs& p) {
  const int k0 = kt * BN;
  return k0 + BN > p.S || (p.causal && k0 + BN - 1 > w.q0) ||
         (p.window > 0 && k0 <= w.q0 + BM - 1 - p.window);
}

// s[64 x 128] (+)= A[64 x 16] . B[16 x 128], both operands K-major in
// shared memory; scale_d 0 overwrites s.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// s = Q[64 rows of this warpgroup] . K_tile^T over D: D / 16 products. Q and
// K are K-major 64-wide boxes of 128 rows (16 KB apart); a k16 step is 32
// bytes inside a box.
template <int D>
__device__ __forceinline__ void qk_products(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + 32 * (kk % 4);
    wgmma_ss_n128(s, smem_desc(q + off, 16, 1024), smem_desc(k + off, 16, 1024), kk > 0);
  }
}

// o += P . V_tile over the 128 keys: 8 products. V is MN-major (d
// contiguous): 64-wide boxes 16 KB apart (the leading byte offset), 8 key
// rows 1 KB apart (the stride byte offset), a k16 step 16 rows = 2 KB.
template <int D>
__device__ __forceinline__ void pv_products(float (&o)[D / 2], const uint32_t (&pf)[32],
                                            uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = smem_desc(v + 2048 * kk, BOX_BYTES, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3], dv);
    else
      wgmma_rs_n64(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3], dv);
  }
}

// One tile's online softmax for this thread's rows qrow and qrow + 8, in
// place: s holds the tile's scores (s[4j + e]: row + 8 (e / 2), key k0 +
// 8j + 2tq + e % 2) and leaves with their exponentials; m is the rows'
// running max in the values' units, l the thread's partial row sums, corr
// the factor the rows' O takes for the new max.
template <bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void tile_exp(float (&s)[64], float (&m)[2], float (&l)[2],
                                         float (&corr)[2], const FwdArgs& p, int qrow, int k0,
                                         int tq) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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

template <bool SOFTCAP>
__device__ __forceinline__ void tile_exp(bool masked, float (&s)[64], float (&m)[2],
                                         float (&l)[2], float (&corr)[2], const FwdArgs& p,
                                         int qrow, int k0, int tq) {
  if (masked)
    tile_exp<SOFTCAP, true>(s, m, l, corr, p, qrow, k0, tq);
  else
    tile_exp<SOFTCAP, false>(s, m, l, corr, p, qrow, k0, tq);
}

// P as bf16 A fragments straight from the exponentials' accumulator layout
// (pf[4kk .. 4kk + 3] is the k16 step kk), and O rescaled for the new max.
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2], uint32_t (&pf)[32],
                                             const float (&s)[64], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
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
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < p.S)
        lse[(static_cast<int64_t>(w.b) * p.Hq + w.h) * p.S + row] = m[r] * p.lse_mul + __logf(l[r]);
    }
  }
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                          float* __restrict__ lse, const int* __restrict__ order,
                          const int* __restrict__ starts, const FwdArgs p) {
  using L = Smem<D>;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      int it = 0, qi = 0;
      for (int j = first; j < last; ++j, ++qi) {
        const Item w = item_of(order[j], p);
        mbar_wait(q_empty, (qi & 1) ^ 1);
        mbar_expect_tx(q_full, L::TILE);  // whole boxes, zero-filled past S too
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_4d(base + L::Q_OFF + x * BOX_BYTES, &map_q, q_full, 64 * x, w.q0, w.h, w.b);
        for (int kt = w.kb; kt < w.ke; ++kt, ++it) {
          const int s = it % STAGES, free = ((it / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free);
          mbar_expect_tx(k_full + 8 * s, L::TILE);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + L::K_OFF + s * L::TILE + x * BOX_BYTES, &map_k, k_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
          mbar_wait(v_empty + 8 * s, free);
          mbar_expect_tx(v_full + 8 * s, L::TILE);
#pragma unroll
          for (int x = 0; x < D / 64; ++x)
            tma_4d(base + L::V_OFF + s * L::TILE + x * BOX_BYTES, &map_v, v_full + 8 * s,
                   64 * x, kt * BN, w.hk, w.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, tq = lane % 4;
  const int epi_off = L::V_OFF + (threadIdx.x / 32 - 4) * L::EPI_WARP;  // in a V tile
  const uint32_t q_smem = base + L::Q_OFF + c * 64 * 128;  // this warpgroup's 64 rows of each box
  float s_acc[64], o_acc[D / 2];
  uint32_t pf[32];
  int it = 0, qi = 0;
  for (int j = first; j < last; ++j, ++qi) {
    const Item w = item_of(order[j], p);
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
    qk_products<D>(s_acc, q_smem, base + L::K_OFF + (it % STAGES) * L::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(s_acc);
    if (lane == 0) {
      mbar_arrive(k_empty + 8 * (it % STAGES));  // K of the first tile is read
      if (n == 1) mbar_arrive(q_empty);          // the item's last Q.K^T is done
    }

    float corr[2];
    tile_exp<SOFTCAP>(tile_masked(w.kb, w, p), s_acc, m, l, corr, p, qrow, w.kb * BN, tq);
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
      qk_products<D>(s_acc, q_smem, base + L::K_OFF + s_next * L::TILE);
      wg_commit();
      pv_products<D>(o_acc, pf, base + L::V_OFF + s * L::TILE);
      wg_commit();
      wg_wait<1>();  // the Q.K^T has retired; the P.V runs on
      fence_regs(s_acc);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * s_next);     // K of the next tile is read
        if (i + 2 == n) mbar_arrive(q_empty);  // the item's last Q.K^T is done
      }
      tile_exp<SOFTCAP>(tile_masked(kt, w, p), s_acc, m, l, corr, p, qrow, kt * BN, tq);
      wg_wait<0>();
      fence_regs(o_acc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(v_empty + 8 * s);  // V of this tile is read
      rescale_pack<D>(o_acc, pf, s_acc, corr);
    }
    // the last tile's P.V; its V tile stages O before it is released
    const int s_last = it % STAGES;
    mbar_wait(v_full + 8 * s_last, (it / STAGES) & 1);
    __syncwarp();
    fence_regs(o_acc);
    fence_regs(pf);
    wg_fence();
    pv_products<D>(o_acc, pf, base + L::V_OFF + s_last * L::TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(o_acc);
    fence_regs(pf);
    ++it;
    // both consumers' last P.V have read the tile before either stages O in it
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    store_rows<D>(o_acc, m, l, gbase + epi_off + s_last * L::TILE, w, p, out, lse, row0, lane);
    // the staging writes were generic-proxy; TMA writes the tile next
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_arrive(v_empty + 8 * s_last);
  }
}

template <int D, bool SOFTCAP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
           float* lse, const int* order, const int* starts, int n_ctas, const FwdArgs& p,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static uint64_t set = 0;
  const cudaError_t err = allow_smem(flash_fwd_sm90_kernel<D, SOFTCAP>, smem, set);
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_kernel<D, SOFTCAP><<<n_ctas, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, order, starts, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of flash_fwd.cu's kubedl_flash_fwd_bf16, then the
// persistent schedule: n_ctas CTAs, CTA c taking the items
// order[starts[c] .. starts[c + 1]) (ops/flash_attention.py sm90_schedule),
// each coded as q_tile * B * Hq + b * Hq + h; every item exactly once.
// Returns 0, a cudaError_t, 1 (cudaErrorInvalidValue) for a head dim other
// than 64 or 128 or a layout the tensor maps cannot take, or 1001 / 2000 +
// CUresult when a tensor map cannot be made.
int kubedl_flash_fwd_sm90_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                               int B, int Hq, int Hkv, int S, int D, int Dv, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                               int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                               int64_t o_sb, int64_t o_sh, int64_t o_ss, float sm_scale,
                               int causal, int window, float softcap, const int* order,
                               const int* starts, int n_ctas, void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
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
  int err = map_4d(&mq, q, D, S, Hq, B, q_sb, q_sh, q_ss, BN);
  if (!err) err = map_4d(&mk, k, D, S, Hkv, B, k_sb, k_sh, k_ss, BN);
  if (!err) err = map_4d(&mv, v, D, S, Hkv, B, v_sb, v_sh, v_ss, BN);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return cap ? launch<64, true>(mq, mk, mv, o, lse, order, starts, n_ctas, p, st) : launch<64, false>(mq, mk, mv, o, lse, order, starts, n_ctas, p, st);
  return cap ? launch<128, true>(mq, mk, mv, o, lse, order, starts, n_ctas, p, st) : launch<128, false>(mq, mk, mv, o, lse, order, starts, n_ctas, p, st);
}

const char* kubedl_flash_fwd_sm90_error_string(int err) { return sm90_error_string(err); }

}  // extern "C"
