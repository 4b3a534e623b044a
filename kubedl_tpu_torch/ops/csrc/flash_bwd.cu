// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in and
// out, f32 accumulation, plain C interface bound with ctypes by
// kubedl_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/flash_attention.py:291 _bwd_dq_kernel   (K2) -> flash_bwd_dq_kernel
//   kubedl_tpu/ops/flash_attention.py:336 _bwd_dkv_kernel  (K3) -> flash_bwd_dkv_kernel
//
// What they compute, with s = (q . k) * sm_scale, then cap * tanh(s / cap)
// when softcap > 0, the mask {k_pos < S, q_pos < S, causal k_pos <= q_pos,
// window k_pos > q_pos - window} applied after the softcap, and the
// forward's per-row LSE and delta = rowsum(O * dO) (computed by the
// wrapper):
//   p  = exp(s - lse) where the mask keeps (q, k), else 0
//   ds = p * (dO . v - delta), times 1 - (s / cap)^2 when softcap > 0
//   dQ = sm_scale * sum_k ds . K            (K2)
//   dV = sum_q p^T . dO,  dK = sm_scale * sum_q ds^T . Q   (K3)
// p and ds are rounded to bf16 before their products, as the TPU kernels'
// .astype(k.dtype) does; every product accumulates in f32; dQ, dK, dV are
// written in bf16.
//
// Design. K2 is one block per (batch, q head, 64-row q tile); it reads KV
// head h / rep and streams 64-row K/V tiles through a double-buffered
// cp.async ring. K3 is one block per (batch, KV head, 64-row k tile); it
// loops over the rep query heads of its group and, for each, over the live
// 32-row q tiles (Q and dO double-buffered, LSE and delta read per column),
// so GQA's dK and dV are summed in registers: no atomics, and the gradients
// are the same bits from run to run. Tiles wholly above the causal diagonal
// or outside the window are skipped in both kernels. Every product is
// mma.sync m16n8k16 (bf16 -> f32) on fragments loaded with ldmatrix from
// shared-memory rows padded by 16 bytes, the forward kernel's machinery.
// Each warp owns 16 rows; an accumulator row block holds at most 128 head
// columns (128 f32 registers a thread for K3's dK + dV at d = 128), so at
// d = 256 two warps share each 16 rows and split the columns (8 warps).
//
// Bound on an H100 SXM: the least work is 2.5 x the forward's products,
// 10 * b * hq * d * pairs FLOP at 989 TFLOP/s bf16, against q, k, v, o, dO
// read and dq, dk, dv written at 3.35 TB/s; at the 7B training shape
// (b = 4, 32 heads, S = 1023, d = 128, causal) operations bound it. The two
// kernels recompute s and dO . v^T each (7 products a score, not 5), use
// neither wgmma nor TMA, and cannot reach the bound; that is later work.
//
// Layout: q, dO, dQ [B, Hq, S, D]; k, v, dK, dV [B, Hkv, S, D]; any strides
// with the last dim contiguous and the other strides of the inputs
// multiples of 8 elements (16-byte cp.async); lse and delta [B, Hq, S] f32
// contiguous. D is a template parameter in {64, 128, 256}; the wrapper
// zero-pads other head dims and passes the true width as Dv: only columns
// below Dv are written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DQ_BM = 64;   // K2: q rows a block (16 a warp row group)
constexpr int DQ_BN = 64;   // K2: k rows a K/V tile
constexpr int DKV_BN = 64;  // K3: k rows a block
constexpr int DKV_BM = 32;  // K3: q rows a Q/dO tile

struct Params {
  int B, Hq, Hkv, S, Dv;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  float sm_scale;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
};

template <int D>
struct Cfg {
  static constexpr int DC = D > 128 ? 128 : D;  // accumulator columns a warp
  static constexpr int NSPLIT = D / DC;         // warps sharing 16 rows
  static constexpr int NWARPS = 4 * NSPLIT;
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int STRIDE = D + 8;  // +16 bytes a row: ldmatrix rows hit distinct banks
  // K2: Q, dO, 2 stages of (K, V); K3: K, V, 2 stages of (Q, dO)
  static constexpr int DQ_SMEM = (2 * DQ_BM + 4 * DQ_BN) * STRIDE * 2;
  static constexpr int DKV_SMEM = (2 * DKV_BN + 4 * DKV_BM) * STRIDE * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 shared bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [row0, row0 + ROWS) of a [S, D] matrix with row stride rs -> shared
// tile; rows at or past S are zero-filled (so 0 * pad never makes NaN)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int64_t rs, int row0, int S,
                                          int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
#pragma unroll
  for (int i = tid; i < ROWS * VPR; i += Cfg<D>::NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    const bf16* src = ok ? g + static_cast<int64_t>(row) * rs + c : g;
    cp_async16(sm + r * Cfg<D>::STRIDE + c, src, ok);
  }
}

// c[16 x N] = A[a_row0 : a_row0 + 16, :D] . B[0:N, :D]^T, both row-major in
// shared memory (the forward's q . k^T): c as N/8 mma accumulator tiles
template <int D, int N>
__device__ __forceinline__ void gemm_abt(float (&c)[N / 8][4], const bf16* sA, int a_row0,
                                         const bf16* sB, int lane) {
  constexpr int STRIDE = Cfg<D>::STRIDE;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    unsigned a[4];
    ldsm_x4(a, sA + (a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE + kc * 16 +
                   (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {  // B rows np*16 .. np*16+15
      unsigned bb[4];
      ldsm_x4(bb, sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * STRIDE + kc * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[16 x DC] += P[16 x K] (f32 accumulator tiles, rounded to bf16) .
// B[0:K, col0 : col0 + DC], B row-major in shared memory (the forward's p . v)
template <int D, int K, int DC>
__device__ __forceinline__ void gemm_pb(float (&acc)[DC / 8][4], const float (&p)[K / 8][4],
                                        const bf16* sB, int col0, int lane) {
  constexpr int STRIDE = Cfg<D>::STRIDE;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    unsigned a[4];
    a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DC / 16; ++dp) {  // columns col0 + dp*16 .. +15
      unsigned bb[4];
      ldsm_x4_trans(bb, sB + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE + col0 +
                            dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
      mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
    }
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, const Params& p) {
  bool ok = kp < p.S && qp < p.S;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// score -> (p, ds) for one element: x = q.k (unscaled), dpv = dO.v
__device__ __forceinline__ void grad_elem(float x, float dpv, float lse, float delta, bool ok,
                                          const Params& p, float& pv, float& ds) {
  x *= p.sm_scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  pv = ok ? __expf(x - lse) : 0.f;
  ds = pv * (dpv - delta);
  if (p.softcap > 0.f) {
    const float t = x / p.softcap;
    ds *= 1.f - t * t;
  }
}

// K2: dQ for one 64-row q tile of one (batch, q head)
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, const Params p) {
  using C = Cfg<D>;
  constexpr int QE = DQ_BM * C::STRIDE;
  constexpr int KE = DQ_BN * C::STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + QE;
  bf16* sK = sdO + QE;      // stage s at sK + s * KE
  bf16* sV = sK + 2 * KE;   // stage s at sV + s * KE

  const int S = p.S;
  const int bh = blockIdx.x;
  const int n_qt = (S + DQ_BM - 1) / DQ_BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest causal rows first
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * DQ_BM;

  const bf16* qb = q + b * p.q_sb + h * p.q_sh;
  const bf16* dob = dout + b * p.do_sb + h * p.do_sh;
  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;

  // live K/V tiles: none wholly above the diagonal or below the window
  int kt_end = (S + DQ_BN - 1) / DQ_BN;
  if (p.causal) kt_end = min(kt_end, (q0 + DQ_BM - 1) / DQ_BN + 1);
  int kt_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;  // first key row q0's window admits
    kt_begin = lo > 0 ? lo / DQ_BN : 0;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = warp % 4, col0 = (warp / 4) * C::DC;
  const int row_a = q0 + rg * 16 + g;  // this thread's rows: row_a, row_a + 8

  load_tile<D, DQ_BM>(sQ, qb, p.q_ss, q0, S, tid);
  load_tile<D, DQ_BM>(sdO, dob, p.do_ss, q0, S, tid);
  if (kt_begin < kt_end) {
    load_tile<D, DQ_BN>(sK, kb, p.k_ss, kt_begin * DQ_BN, S, tid);
    load_tile<D, DQ_BN>(sV, vb, p.v_ss, kt_begin * DQ_BN, S, tid);
  }
  cp_async_commit();

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const bool ok = row < S;
    lse_r[r] = ok ? lse[static_cast<int64_t>(bh) * S + row] : 0.f;
    dl_r[r] = ok ? delta[static_cast<int64_t>(bh) * S + row] : 0.f;
  }

  float acc[C::DC / 8][4];
#pragma unroll
  for (int i = 0; i < C::DC / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // prefetch the next tile into the other stage
      load_tile<D, DQ_BN>(sK + (stage ^ 1) * KE, kb, p.k_ss, (kt + 1) * DQ_BN, S, tid);
      load_tile<D, DQ_BN>(sV + (stage ^ 1) * KE, vb, p.v_ss, (kt + 1) * DQ_BN, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * KE;
    const bf16* cV = sV + stage * KE;

    float s[DQ_BN / 8][4], dp[DQ_BN / 8][4];
    gemm_abt<D, DQ_BN>(s, sQ, rg * 16, cK, lane);   // q . k^T
    gemm_abt<D, DQ_BN>(dp, sdO, rg * 16, cV, lane); // dO . v^T
    const int k0 = kt * DQ_BN;
#pragma unroll
    for (int nt = 0; nt < DQ_BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qp = row_a + r * 8;
        const int kp = k0 + nt * 8 + tig * 2 + (e & 1);
        float pv, ds;
        grad_elem(s[nt][e], dp[nt][e], lse_r[r], dl_r[r], keep(qp, kp, p), p, pv, ds);
        s[nt][e] = ds;
      }
    }
    gemm_pb<D, DQ_BN, C::DC>(acc, s, cK, col0, lane);  // ds . k
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= S) continue;
    bf16* drow = dqb + static_cast<int64_t>(row) * p.dq_ss;
#pragma unroll
    for (int i = 0; i < C::DC / 8; ++i) {
      const int col = col0 + i * 8 + tig * 2;
      if (col < p.Dv) drow[col] = __float2bfloat16_rn(acc[i][2 * r] * p.sm_scale);
      if (col + 1 < p.Dv) drow[col + 1] = __float2bfloat16_rn(acc[i][2 * r + 1] * p.sm_scale);
    }
  }
}

// K3: dK and dV for one 64-row k tile of one (batch, KV head), summed over
// the rep query heads of its group
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, const Params p) {
  using C = Cfg<D>;
  constexpr int KE = DKV_BN * C::STRIDE;
  constexpr int QE = DKV_BM * C::STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + KE;
  bf16* sQ = sV + KE;        // stage s at sQ + s * QE
  bf16* sdO = sQ + 2 * QE;   // stage s at sdO + s * QE

  const int S = p.S;
  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int rep = p.Hq / p.Hkv;
  const int k0 = static_cast<int>(blockIdx.y) * DKV_BN;

  // live q tiles: causal rows from k0 on; window rows below k_last + window
  const int n_qt = (S + DKV_BM - 1) / DKV_BM;
  const int qt_begin = p.causal ? k0 / DKV_BM : 0;
  int qt_end = n_qt;
  if (p.window > 0) {
    const int k_last = min(k0 + DKV_BN, S) - 1;
    qt_end = min(n_qt, (k_last + p.window - 1) / DKV_BM + 1);
  }
  const int n_live = max(qt_end - qt_begin, 0);
  const int n_it = rep * n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = warp % 4, col0 = (warp / 4) * C::DC;
  const int krow_a = k0 + rg * 16 + g;  // this thread's k rows: krow_a, krow_a + 8

  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;
  load_tile<D, DKV_BN>(sK, kb, p.k_ss, k0, S, tid);
  load_tile<D, DKV_BN>(sV, vb, p.v_ss, k0, S, tid);
  // iteration it -> (query head hk * rep + it / n_live, q tile qt_begin + it % n_live)
  if (n_it > 0) {
    const int h = hk * rep;
    load_tile<D, DKV_BM>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, qt_begin * DKV_BM, S, tid);
    load_tile<D, DKV_BM>(sdO, dout + b * p.do_sb + h * p.do_sh, p.do_ss, qt_begin * DKV_BM, S,
                         tid);
  }
  cp_async_commit();

  float dk_acc[C::DC / 8][4], dv_acc[C::DC / 8][4];
#pragma unroll
  for (int i = 0; i < C::DC / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const int h = hk * rep + it / n_live;
    const int q0 = (qt_begin + it % n_live) * DKV_BM;
    // LSE and delta of this thread's q columns, read before the wait
    float lse_c[DKV_BM / 8][2], dl_c[DKV_BM / 8][2];
    const int64_t rowbase = (static_cast<int64_t>(b) * p.Hq + h) * S;
#pragma unroll
    for (int nt = 0; nt < DKV_BM / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qp = q0 + nt * 8 + tig * 2 + c;
        const bool ok = qp < S;
        lse_c[nt][c] = ok ? lse[rowbase + qp] : 0.f;
        dl_c[nt][c] = ok ? delta[rowbase + qp] : 0.f;
      }
    }
    if (it + 1 < n_it) {  // prefetch the next (head, q tile) into the other stage
      const int hn = hk * rep + (it + 1) / n_live;
      const int qn = (qt_begin + (it + 1) % n_live) * DKV_BM;
      load_tile<D, DKV_BM>(sQ + (stage ^ 1) * QE, q + b * p.q_sb + hn * p.q_sh, p.q_ss, qn, S,
                           tid);
      load_tile<D, DKV_BM>(sdO + (stage ^ 1) * QE, dout + b * p.do_sb + hn * p.do_sh, p.do_ss,
                           qn, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + stage * QE;
    const bf16* cdO = sdO + stage * QE;

    float st[DKV_BM / 8][4], dpt[DKV_BM / 8][4];
    gemm_abt<D, DKV_BM>(st, sK, rg * 16, cQ, lane);    // (q . k^T)^T = k . q^T
    gemm_abt<D, DKV_BM>(dpt, sV, rg * 16, cdO, lane);  // (dO . v^T)^T = v . dO^T
#pragma unroll
    for (int nt = 0; nt < DKV_BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = krow_a + (e >> 1) * 8;
        const int qp = q0 + nt * 8 + tig * 2 + (e & 1);
        float pv, ds;
        grad_elem(st[nt][e], dpt[nt][e], lse_c[nt][e & 1], dl_c[nt][e & 1], keep(qp, kp, p), p,
                  pv, ds);
        st[nt][e] = pv;
        dpt[nt][e] = ds;
      }
    }
    gemm_pb<D, DKV_BM, C::DC>(dv_acc, st, cdO, col0, lane);  // p^T . dO
    gemm_pb<D, DKV_BM, C::DC>(dk_acc, dpt, cQ, col0, lane);  // ds^T . q
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  bf16* dkb = dk + b * p.dk_sb + hk * p.dk_sh;
  bf16* dvb = dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow_a + r * 8;
    if (row >= S) continue;
    bf16* krow = dkb + static_cast<int64_t>(row) * p.dk_ss;
    bf16* vrow = dvb + static_cast<int64_t>(row) * p.dv_ss;
#pragma unroll
    for (int i = 0; i < C::DC / 8; ++i) {
      const int col = col0 + i * 8 + tig * 2;
      if (col < p.Dv) {
        krow[col] = __float2bfloat16_rn(dk_acc[i][2 * r] * p.sm_scale);
        vrow[col] = __float2bfloat16_rn(dv_acc[i][2 * r]);
      }
      if (col + 1 < p.Dv) {
        krow[col + 1] = __float2bfloat16_rn(dk_acc[i][2 * r + 1] * p.sm_scale);
        vrow[col + 1] = __float2bfloat16_rn(dv_acc[i][2 * r + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Params& p,
                      cudaStream_t stream) {
  constexpr int smem = Cfg<D>::DQ_SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hq, (p.S + DQ_BM - 1) / DQ_BM);
  flash_bwd_dq_kernel<D><<<grid, Cfg<D>::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, const Params& p,
                       cudaStream_t stream) {
  constexpr int smem = Cfg<D>::DKV_SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hkv, (p.S + DKV_BN - 1) / DKV_BN);
  flash_bwd_dkv_kernel<D><<<grid, Cfg<D>::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      p);
  return cudaGetLastError();
}

bool fill(Params& p, int B, int Hq, int Hkv, int S, int Dv, float sm_scale, int causal,
          int window, float softcap) {
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.Dv = Dv;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  return B > 0 && S > 0 && Hkv > 0 && Hq % Hkv == 0 && (S + DKV_BM - 1) / DKV_BM <= 65535;
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a
// head dim other than 64, 128 or 256 or a grid the card cannot launch.
int kubedl_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, int B, int Hq,
                             int Hkv, int S, int D, int Dv, int64_t q_sb, int64_t q_sh,
                             int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                             int64_t v_sh, int64_t v_ss, int64_t do_sb, int64_t do_sh,
                             int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                             float sm_scale, int causal, int window, float softcap,
                             void* stream) {
  Params p = {};
  if (!fill(p, B, Hq, Hkv, S, Dv, sm_scale, causal, window, softcap)) return cudaErrorInvalidValue;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, p, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, p, st);
    case 256: return launch_dq<256>(q, k, v, dout, lse, delta, dq, p, st);
    default: return cudaErrorInvalidValue;
  }
}

int kubedl_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int B,
                              int Hq, int Hkv, int S, int D, int Dv, int64_t q_sb, int64_t q_sh,
                              int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                              int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
                              int64_t do_sh, int64_t do_ss, int64_t dk_sb, int64_t dk_sh,
                              int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                              float sm_scale, int causal, int window, float softcap,
                              void* stream) {
  Params p = {};
  if (!fill(p, B, Hq, Hkv, S, Dv, sm_scale, causal, window, softcap)) return cudaErrorInvalidValue;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, p, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, p, st);
    case 256: return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, p, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* kubedl_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
