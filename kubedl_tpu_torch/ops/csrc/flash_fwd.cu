// Flash-attention forward for Hopper (sm_90a): bf16 in and out, f32 softmax
// state and accumulation, plain C interface bound with ctypes by
// kubedl_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/flash_attention.py:107 _fwd_kernel          (K1)
//   kubedl_tpu/ops/flash_attention.py:191 _fwd_streamed_kernel (K4)
// Both compute the same function; K4 exists only because the TPU kernel
// holds the whole K/V sequence in VMEM below 8192 tokens. This kernel always
// streams K/V tiles through shared memory, so one kernel covers both.
//
// What it computes, per (batch, q head) and 64-row query tile:
//   s = (q . k) * sm_scale, then cap * tanh(s / cap) when softcap > 0, then
//   masked to -1e30 outside {k_pos < S, causal k_pos <= q_pos, window
//   k_pos > q_pos - window}; online softmax over the K/V tiles; O = acc / l and
//   LSE = m + log(l), with l floored at 1e-30 so no row produces NaN.
//   GQA reads KV head h / (Hq / Hkv); nothing is repeated in memory.
//
// Bound on an H100 SXM: 4 * b * hq * S^2 * d FLOP (x 1/2 when causal) at
// 989 TFLOP/s bf16 against (q + k + v + o) bytes at 3.35 TB/s. With hq = hkv
// that is S / 4 FLOP a byte causal (S / 2 not), against the card's ridge of
// ~295: the 7B prefill shapes sit on both sides of it. S = 512 is bound by
// memory, S >= 2048 by tensor-core operations (the crossing is S ~ 1180).
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16 bf16 -> f32, fragments loaded with ldmatrix), the S x S
// scores never leave registers, K/V tiles are double-buffered with cp.async
// so the next tile's load overlaps this tile's math, and tiles wholly above
// the causal diagonal or below the sliding window are never loaded. It does
// not use wgmma, TMA or warp specialisation, so it cannot reach the bound;
// that is later work.
//
// Layout: q [B, Hq, S, D], k/v [B, Hkv, S, D], any strides with the last dim
// contiguous and the other strides multiples of 8 elements (16-byte
// cp.async); o is written through its own strides, lse is [B, Hq, S] f32.
// D is a template parameter in {64, 128, 256}; the wrapper zero-pads other
// head dims up to the next of them and passes the true width as Dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;             // query rows per block (16 per warp)
constexpr int BN = 64;             // key rows per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // finite: -inf - -inf would be NaN

struct Params {
  int B, Hq, Hkv, S, Dv, n_qt;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float sm_scale;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
};

template <int D>
struct Tile {
  static constexpr int STRIDE = D + 8;  // +16 bytes a row: ldmatrix rows hit distinct banks
  static constexpr int ELEMS = BM * STRIDE;
  static constexpr int SMEM_BYTES = 5 * ELEMS * 2;  // Q + 2 stages of (K, V)
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

// rows [row0, row0 + 64) of a [S, D] matrix with row stride rs -> shared
// tile; rows at or past S are zero-filled (so 0 * pad never makes NaN)
template <int D>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int64_t rs, int row0, int S,
                                          int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
#pragma unroll
  for (int i = tid; i < BM * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    const bf16* src = ok ? g + static_cast<int64_t>(row) * rs + c : g;
    cp_async16(sm + r * Tile<D>::STRIDE + c, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const Params p) {
  constexpr int STRIDE = Tile<D>::STRIDE;
  constexpr int ELEMS = Tile<D>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + ELEMS;      // stage s at sK + s * ELEMS
  bf16* sV = sK + 2 * ELEMS;  // stage s at sV + s * ELEMS

  const int bh = blockIdx.x;
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.y);  // longest causal rows first
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int S = p.S;
  const int q0 = qt * BM;

  const bf16* qb = q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;

  // live K/V tiles: none wholly above the diagonal or below the window
  int kt_end = (S + BN - 1) / BN;
  if (p.causal) kt_end = min(kt_end, (q0 + BM - 1) / BN + 1);
  int kt_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;  // first key row q0's window admits
    kt_begin = lo > 0 ? lo / BN : 0;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

  load_tile<D>(sQ, qb, p.q_ss, q0, S, tid);
  if (kt_begin < kt_end) {
    load_tile<D>(sK, kb, p.k_ss, kt_begin * BN, S, tid);
    load_tile<D>(sV, vb, p.v_ss, kt_begin * BN, S, tid);
  }
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // thread-partial row sums, quad-reduced at the end

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // prefetch the next tile into the other stage
      load_tile<D>(sK + (stage ^ 1) * ELEMS, kb, p.k_ss, (kt + 1) * BN, S, tid);
      load_tile<D>(sV + (stage ^ 1) * ELEMS, vb, p.v_ss, (kt + 1) * BN, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * ELEMS;
    const bf16* cV = sV + stage * ELEMS;

    // s[16 x 64] = q_warp . k_tile^T as 8 n8-tiles of mma accumulators
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      unsigned a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE + kc * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // key rows np*16 .. np*16+15
        unsigned bb[4];
        ldsm_x4(bb, cK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * STRIDE + kc * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, softcap, then mask (the TPU kernel's order)
    const int k0 = kt * BN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row_a + (e >> 1) * 8;
        const int kp = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < S;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        x = ok ? x : NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = pv;
        rs[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc[16 x D] += p[16 x 64] (bf16, straight from the s accumulators) . v_tile
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {  // head-dim columns dp*16 .. dp*16+15
        unsigned bb[4];
        ldsm_x4_trans(bb, cV + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

  bf16* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row_a + r * 8;
    if (row >= S) continue;
    const float inv = 1.f / l;
    bf16* orow = ob + static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + tig * 2;
      if (col < p.Dv) orow[col] = __float2bfloat16_rn(acc[i][2 * r] * inv);
      if (col + 1 < p.Dv) orow[col + 1] = __float2bfloat16_rn(acc[i][2 * r + 1] * inv);
    }
    if (tig == 0) lse[static_cast<int64_t>(bh) * S + row] = m_r[r] + __logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Params& p, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.Hq, p.n_qt);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for a
// head dim other than 64, 128 or 256 or a grid the card cannot launch.
int kubedl_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                          int B, int Hq, int Hkv, int S, int D, int Dv, int64_t q_sb,
                          int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                          int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                          int64_t o_ss, float sm_scale, int causal, int window, float softcap,
                          void* stream) {
  Params p;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.Dv = Dv;
  p.n_qt = (S + BM - 1) / BM;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || p.n_qt > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, p, st);
    case 128: return launch<128>(q, k, v, o, lse, p, st);
    case 256: return launch<256>(q, k, v, o, lse, p, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
