// K6 of the dropless MoE FFN on int8 weights, for Hopper (sm_90a): bf16
// activations, an int8 weight stack widened to bf16 inside the kernel, f32
// accumulation, plain C interface bound with ctypes by
// kubedl_tpu_torch/ops/gmm.py. Every other grouped product (K5, K8 on bf16
// and int8 weights, K6 on bf16 weights, K7) runs the TMA/wgmma kernels of
// gmm_sm90.cu. K6 on int8 weights runs only in the backward through an
// int8 stack, which no path of the port takes (training never sees a
// quantized tree), so this first mma.sync design stays as it is.
//
// Replaces the TPU kernel
//   kubedl_tpu/ops/gmm.py:130 _gmm_kernel  (K6, int8 rhs)  gmm_kernel<TRANS>
//
// What it computes. lhs [M, K] is cut into row tiles of row_tile rows
// (M / len(tile_expert), a multiple of 128); tile i multiplies the weights
// of expert te[i] (clamped to [0, E)): out[i] = bf16(lhs[i] @ rhs[te[i]]).
//
// Weights are read in place through strides. TRANS=false reads a K-major
// [K, N] block per expert (N contiguous); TRANS=true reads the backward's
// rhs.transpose(1, 2) view (K contiguous) without a copy, with ldmatrix
// without .trans. The int8 weights are copied into shared memory as bytes
// with cp.async and widened to bf16 there (|q| <= 127 is exact in bf16), so
// no bf16 copy of an int8 stack ever exists in device memory.
//
// Bound on an H100 SXM: 2 * R * K * N FLOP over the routed rows R at 989
// TFLOP/s against the weights of the experts that own a row plus the
// activations at 3.35 TB/s. What the design does about it: every product
// runs on the tensor cores (mma.sync m16n8k16 bf16 -> f32, fragments from
// ldmatrix), 128 x 128 output tiles with a 64 x 32 tile per warp, cp.async
// double buffering of 32-deep K slices, blocks rastered in groups of 8 row
// tiles so a weight slice is reused from L2 by the row tiles of one expert.
// It uses neither wgmma nor TMA, and it computes every padded row of the
// layout (m_pad, not R).
//
// Layout: lhs rows with any row stride that is a whole 16-byte vector; K
// and N multiples of 16; out [M, N] with row stride ldo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;           // output rows a block (divides every row tile)
constexpr int BN = 128;           // output columns a block
constexpr int BK = 32;            // contraction slice a pipeline stage
constexpr int NTHREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int GROUP_M = 8;        // row blocks rastered together
constexpr int A_STRIDE = BK + 8;  // +16 bytes a row: ldmatrix rows hit distinct banks
constexpr int A_ELEMS = BM * A_STRIDE;
constexpr int BN_STRIDE = BN + 8;  // K-major weight tile [BK][BN + 8]
constexpr int BT_STRIDE = BK + 8;  // transposed weight tile [BN][BK + 8]
constexpr int B_ELEMS = (BK * BN_STRIDE > BN * BT_STRIDE) ? BK * BN_STRIDE : BN * BT_STRIDE;
constexpr int RAW_BYTES = BK * BN;  // one int8 weight slice, unpadded

struct GmmParams {
  int M, N, K, row_tile, E;
  int64_t lda, ldb, sbe, ldo;
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

// ---------------------------------------------------------------------------
// K6 on int8 weights
// ---------------------------------------------------------------------------

template <bool TRANS>
struct WeightTile {
  // 16-byte copies of one [BK x BN] int8 weight slice and where each lands
  static constexpr int PER_ROW = (TRANS ? BK : BN) / 16;  // copies a tile row
  static constexpr int COPIES = BK * BN / 16;
  static constexpr int STRIDE = TRANS ? BT_STRIDE : BN_STRIDE;
};

// Start the cp.asyncs of k slice k0 of expert e's weights into the raw byte
// buffer (widened after the wait).
template <bool TRANS>
__device__ __forceinline__ void load_weight(unsigned char* raw, const int8_t* B, int e, int n0,
                                            int k0, const GmmParams& p, int tid) {
  typedef WeightTile<TRANS> W;
#pragma unroll
  for (int i = tid; i < W::COPIES; i += NTHREADS) {
    const int r = i / W::PER_ROW, c = (i % W::PER_ROW) * 16;
    // K-major: r is a k row and c an n column; transposed: r is n, c is k
    const int kk = TRANS ? k0 + c : k0 + r;
    const int nn = TRANS ? n0 + r : n0 + c;
    const bool ok = kk < p.K && nn < p.N;
    const int64_t off = static_cast<int64_t>(e) * p.sbe +
                        (TRANS ? static_cast<int64_t>(nn) * p.ldb + kk
                               : static_cast<int64_t>(kk) * p.ldb + nn);
    cp_async16(raw + r * (TRANS ? BK : BN) + c, ok ? B + off : B, ok);
  }
}

// Widen this thread's own int8 copies (visible to it after its wait) to bf16.
template <bool TRANS>
__device__ __forceinline__ void widen_weight(bf16* tile, const unsigned char* raw, int tid) {
  typedef WeightTile<TRANS> W;
#pragma unroll
  for (int i = tid; i < W::COPIES; i += NTHREADS) {
    const int r = i / W::PER_ROW, c = (i % W::PER_ROW) * 16;
    const int4 v = *reinterpret_cast<const int4*>(raw + r * (TRANS ? BK : BN) + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    __align__(16) bf16 h[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) h[j] = __float2bfloat16_rn(static_cast<float>(b[j]));
    int4* dst = reinterpret_cast<int4*>(tile + r * W::STRIDE + c);
    dst[0] = reinterpret_cast<const int4*>(h)[0];
    dst[1] = reinterpret_cast<const int4*>(h)[1];
  }
}

constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2 + RAW_BYTES;
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;

template <bool TRANS>
__global__ void __launch_bounds__(NTHREADS, 1)
    gmm_kernel(const bf16* __restrict__ A, const int8_t* __restrict__ B,
               bf16* __restrict__ out, const int* __restrict__ te, const GmmParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // grouped raster: GROUP_M row blocks sweep the column blocks together
  const int m_blocks = p.M / BM, n_blocks = (p.N + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int in_group = GROUP_M * n_blocks;
  const int first_m = (pid / in_group) * GROUP_M;
  const int gm = min(m_blocks - first_m, GROUP_M);
  const int mb = first_m + (pid % in_group) % gm;
  const int nb = (pid % in_group) / gm;
  const int m0 = mb * BM, n0 = nb * BN;
  const int e = min(max(te[m0 / p.row_tile], 0), p.E - 1);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // this warp's 64 x 32 output tile
  const int g = lane >> 2, tig = lane & 3;

  auto a_tile = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * STAGE_BYTES); };
  auto b_tile = [&](int st) { return a_tile(st) + A_ELEMS; };
  auto raw_tile = [&](int st) {
    return smem_raw + st * STAGE_BYTES + (A_ELEMS + B_ELEMS) * 2;
  };

  auto load_stage = [&](int st, int k0) {
    // activations: 128 rows x 32 columns, four 16-byte copies a row
#pragma unroll
    for (int i = tid; i < BM * BK / 8; i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = k0 + c < p.K;
      const bf16* src = ok ? A + static_cast<int64_t>(m0 + r) * p.lda + k0 + c : A;
      cp_async16(a_tile(st) + r * A_STRIDE + c, src, ok);
    }
    load_weight<TRANS>(raw_tile(st), B, e, n0, k0, p, tid);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (p.K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next slice into the other stage
      load_stage(st ^ 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    widen_weight<TRANS>(b_tile(st), raw_tile(st), tid);
    __syncthreads();
    const bf16* sA = a_tile(st);
    const bf16* sB = b_tile(st);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], sA + (wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_STRIDE +
                           kk * 16 + (lane >> 4) * 8);
      unsigned b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // columns wn*32 + np*16 .. +15
        if (TRANS)
          ldsm_x4(b[np], sB + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * BT_STRIDE +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_trans(b[np], sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BN_STRIDE +
                                   wn * 32 + np * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mi][2 * np], a[mi], b[np][0], b[np][1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[np][2], b[np][3]);
        }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // one bf16 write of the f32 accumulators
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + tig * 2;
    if (col >= p.N) continue;  // N % 16 == 0: col + 1 < N too
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 64 + mi * 16 + g + r * 8;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * p.ldo + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
      }
  }
}

template <bool TRANS>
cudaError_t launch_gmm(const void* A, const void* B, void* out, const int* te,
                       const GmmParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gmm_kernel<TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M / BM) * ((p.N + BN - 1) / BN);
  gmm_kernel<TRANS><<<blocks, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(A), static_cast<const int8_t*>(B), static_cast<bf16*>(out), te,
      p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 on int8 weights. Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take. b_trans: B
// is the transpose(1, 2) view of an [E, N, K] stack (ldb its N stride),
// else [E, K, N] with ldb its K stride; sbe is the expert stride; all
// strides in elements.
int kubedl_gmm(const void* A, const void* B, void* out, const int* te, int M, int N, int K,
               int row_tile, int E, int64_t lda, int64_t ldb, int64_t sbe, int64_t ldo,
               int b_trans, void* stream) {
  GmmParams p;
  p.M = M;
  p.N = N;
  p.K = K;
  p.row_tile = row_tile;
  p.E = E;
  p.lda = lda;
  p.ldb = ldb;
  p.sbe = sbe;
  p.ldo = ldo;
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || row_tile <= 0 || row_tile % BM || M % row_tile ||
      N % 16 || K % 16 || ldo % 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_trans) return launch_gmm<true>(A, B, out, te, p, st);
  return launch_gmm<false>(A, B, out, te, p, st);
}

const char* kubedl_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
