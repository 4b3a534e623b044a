// Grouped matrix products K5-K8 of the dropless MoE FFN, written for Hopper
// (sm_90a) with TMA, mbarrier pipelines and wgmma. Plain C interface, bound
// with ctypes by kubedl_tpu_torch/ops/gmm.py.
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/gmm.py:130 _gmm_kernel         (K6)  gmm_sm90_gmm_kernel<TRANS>
//   kubedl_tpu/ops/gmm.py:147 _gmm_scaled_kernel  (K8)  epi_sm90_gmm_kernel<EPI_SCALE, *, *>
//   kubedl_tpu/ops/gmm.py:170 _gmm_swiglu_kernel  (K5)  epi_sm90_gmm_kernel<EPI_SWIGLU, *, 2>
//   kubedl_tpu/ops/gmm.py:276 _tgmm_kernel        (K7)  tgmm_sm90_gmm_kernel<OUT_BF16>
// (gmm.cu keeps only K6 on int8 weights, which no path of the port runs.)
//
// What they compute. lhs [M, K] is cut into row tiles of row_tile rows (a
// multiple of 128); tile i belongs to expert e = te[i], clamped to [0, E):
//   K6  out[tile i] = bf16(lhs[tile i] @ rhs[e]),   rhs [E, K, N] bf16
//   K8  out[tile i] = bf16((lhs[tile i] @ rhs[e]) * s[e, :]), rhs bf16 or int8
//   K5  out[tile i] = bf16(silu(lhs[tile i] @ w1[e] * s1[e]) *
//                          (lhs[tile i] @ w3[e] * s3[e])),   w1, w3 bf16 or int8
//   K7  out[e] = sum over the row tiles i with te[i] == e of
//       lhs[tile i]^T @ dout[tile i], [E, K, N], accumulated in f32 and
//       written as f32 or, for a caller that casts to bf16 weights anyway,
//       rounded once to bf16 (the same bits as the separate cast). An expert
//       that owns no tile gets exact zeros.
//
// Bound on an H100 SXM: 2 * R * K * N FLOP a product over the routed rows R
// at 989 TFLOP/s against the owning experts' weights plus the activations
// at 3.35 TB/s; at the training and prefill shapes (R ~ 8k, 4096 x 14336)
// the tensor cores bound every kernel, at decode (R = 16) the weight bytes.
// What the design does about it:
//   - wgmma (bf16 -> f32) on 128-row output tiles: two consumer warpgroups
//     own 64 rows each (64 or 128 columns each in the transposed int8
//     products), 128 f32 accumulators a thread (setmaxnreg 232): K6 and K7
//     one m64n256k16 a k16 step; K5 two m64n128k16 (w1 and w3 at the same
//     128 columns); K8 one or two m64n128k16 (a 128- or 256-wide tile, the
//     host's choice: 128 when 256-wide tiles would make fewer than two
//     waves of the SMs, as at decode);
//   - one producer thread (its warpgroup gives its registers back with
//     setmaxnreg 40) keeps a ring of 4 (int8: 6) stages of 64-deep slices
//     full with TMA, each stage with a full and an empty mbarrier; a
//     consumer frees a stage once the wgmma that read it has retired
//     (wgmma.wait_group 1), so the next slice's products are queued while
//     the last one finishes;
//   - int8 weights: wgmma has no bf16 x int8 form, and the activations stay
//     bf16 (weight-only quantization). TMA brings each slice as bytes (half
//     the bf16 bytes); the product is taken transposed (out^T = w^T x^T) so
//     that the weights are wgmma's register operand: each consumer warp
//     loads its codes with ldmatrix .trans (two adjacent columns an
//     element, k the matrix's rows), which leaves two codes of one product
//     row in bytes 0 and 2 (or 1 and 3) of a register; it widens them to
//     the A fragments of the next slice while the last slice's products
//     run (RS wgmma, two fragment buffers), and the activations are the
//     shared-memory B. The widening is exact (|q| <= 127 is a bf16) and
//     takes no convert instruction: two masks make 128 + (q & 127) and
//     -128 or -256 of a pair of codes, and one bf16x2 fused multiply-add
//     sums the two. No bf16 copy of an int8 slice exists, in device or in
//     shared memory;
//   - a persistent grid (one CTA an SM) walks the output tiles in a static
//     order, so the producer loads the next tile's slices while the
//     consumers write the last tile: K5, K6 and K8 in a grouped raster (8
//     row blocks, about one expert, sweep a weight panel together and reuse
//     it from L2), K7 expert by expert, 8 K-blocks of lhs^T sweeping dout's
//     N-blocks;
//   - every operand is read in place in its own layout through the wgmma
//     transpose bits: the A of K5, K6 and K8 is lhs (K-major); their B is the
//     K-major weight stack (N contiguous: MN-major, 64-wide TMA boxes under
//     the 128-byte swizzle) or, for K6, the backward's rhs.transpose(1, 2)
//     view (K contiguous: K-major, one 256-row box); K7's A is lhs^T and its
//     B is dout, both MN-major;
//   - the epilogue scales (K8) or gates (K5) the f32 accumulators in
//     registers, one scale load a column pair; K6, K7 and the bf16 K5/K8
//     go through a 16-row staging buffer of each warp and leave as 16-byte
//     stores, the transposed int8 tiles as bf16x2 stores that fill 32-byte
//     sectors; no split-K and no atomics: each tile sums its slices in one
//     order, so two launches give the same bits.
// It still computes every padded row of the layout (m_pad, not R).
//
// Layout rules: K and N multiples of 16 (K5, K6, K8) or 8 (K7); lhs/dout
// row strides whole 16-byte vectors, weight strides whole 16-byte vectors,
// base addresses 16-byte aligned.

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // output rows a tile (two consumer warpgroups x 64)
constexpr int BN = 256;          // output columns a tile (one wgmma n256)
constexpr int BK = 64;           // contraction slice a stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int GROUP = 8;         // row blocks (K6) or K-blocks (K7) rastered together
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BK * BN * 2;          // 32 KB
constexpr int BOX_BYTES = 64 * 64 * 2;        // one 64 x 64 box under the 128-byte swizzle
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int PANEL_BYTES = 2 * BOX_BYTES;    // K5/K8: a 64 x 128 bf16 weight panel
constexpr int RAW_PANEL = 64 * 128;           // K5/K8: a 64 x 128 int8 weight panel
constexpr int EPI_PITCH = 144;                // 128 bytes a row + 16: conflict-free writes
constexpr int EPI_WARP = 16 * EPI_PITCH;
constexpr int MAX_E = 1024;

enum { EPI_SCALE = 1, EPI_SWIGLU = 2 };  // ops/gmm.py's EPI_* codes

struct GmmArgs {
  int M, N, K, row_tile, E, n_items;
  int64_t ldo;
};

struct TgmmArgs {
  int M, K, N, row_tile, n_tiles, E, n_items;
};

// d[64 x 256] += A[64 x 16] . B[16 x 256]; TA/TB: operand MN-major (1) or
// K-major (0). Thread t of the warpgroup holds row 16 (t / 32) + (t % 32) / 4
// (+ 8 for d[4j + 2], d[4j + 3]) and columns 8j + 2 (t % 4) (+ 1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      "%125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A K-major, B MN-major, both in
// shared memory; the register layout is wgmma_n256's first 64 accumulators.
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ int clamp_expert(int e, int n) { return min(max(e, 0), n - 1); }

// A shared-memory ring of NST stages of STAGE bytes each, then its full and
// empty barriers, then (where the kernel stages its stores) each consumer
// warp's staging buffer.
template <int STAGE_, int NST_>
struct Ring {
  static constexpr int STAGE = STAGE_, NST = NST_;
  static constexpr int BAR_OFF = NST * STAGE;
  static constexpr int EPI_OFF = BAR_OFF + 2 * NST * 8;
  static_assert(STAGE % 1024 == 0, "stages must stay 1024-aligned for the 128-byte swizzle");
  uint32_t base;   // shared address of stage 0, 1024-aligned
  uint8_t* gbase;  // the same byte as a generic pointer
  uint32_t full, empty;

  __device__ __forceinline__ uint32_t a(int s) const { return base + s * STAGE; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ __forceinline__ uint8_t* staging(int consumer_warp) const {
    return gbase + EPI_OFF + consumer_warp * EPI_WARP;
  }
};

// K6 and K7: 4 stages of the 128 x 64 A slice and the 64 x 256 B slice.
typedef Ring<STAGE_BYTES, STAGES> MainRing;
constexpr int OWNED_OFF = MainRing::EPI_OFF + 8 * EPI_WARP;  // K7: row tiles each expert owns
constexpr int SMEM_BYTES = OWNED_OFF + 4 * MAX_E + 1024;     // + slack to align to 1024

template <class R>
__device__ __forceinline__ R setup_ring(uint8_t* smem_raw) {
  R r;
  const uint32_t raw = smem_u32(smem_raw);
  r.base = (raw + 1023) & ~1023u;
  r.gbase = smem_raw + (r.base - raw);
  r.full = r.base + R::BAR_OFF;
  r.empty = r.full + R::NST * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::NST; ++s) {
      mbar_init(r.full + 8 * s, 1);   // the producer's arrive + the TMA bytes
      mbar_init(r.empty + 8 * s, 8);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The first N of the 128 accumulators, fenced as fence_regs fences all.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// One slice's four k16 steps of a consumer warpgroup's products, `run`
// from the stage's A at `a` and B at `b`, into the first ACC accumulators.
// A: K-major rows of 128 bytes (step 32 bytes) or MN-major 64 x 64 boxes
// (step 16 rows = 2048 bytes); B likewise, MN-major as 64 x 64 boxes 8 KB
// apart. K6 and K7: one m64n256k16 a step.
template <int TA, int TB>
struct N256 {
  static constexpr int ACC = 128;
  __device__ __forceinline__ static void run(float (&acc)[128], uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? smem_desc(a + 2048 * kk, BOX_BYTES, 1024)
                             : smem_desc(a + 32 * kk, 16, 1024);
      const uint64_t db = TB ? smem_desc(b + 2048 * kk, BOX_BYTES, 1024)
                             : smem_desc(b + 32 * kk, 16, 1024);
      wgmma_n256<TA, TB>(acc, da, db);
    }
  }
};

// K5 and K8 on bf16 weights: A K-major, B NP MN-major panels of 64 x 128
// (two boxes each); one m64n128k16 a panel and step, panel q into acc[64 q ..].
template <int NP>
struct N128 {
  static constexpr int ACC = 64 * NP;
  __device__ __forceinline__ static void run(float (&acc)[128], uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = smem_desc(a + 32 * kk, 16, 1024);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        wgmma_n128(acc + 64 * q, da, smem_desc(b + q * PANEL_BYTES + 2048 * kk, BOX_BYTES, 1024));
    }
  }
};

// The consumer side of `n` slices starting at ring position `it`: wait for
// each stage, queue its products, and free the stage before it once that
// stage's products have retired.
template <class P, class R>
__device__ __forceinline__ void consume(float (&acc)[128], const R& ring, int& it, int n,
                                        uint32_t a_off, int lane) {
#pragma unroll
  for (int i = 0; i < P::ACC; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i, ++it) {
    const int s = it % R::NST;
    mbar_wait(ring.full + 8 * s, (it / R::NST) & 1);
    __syncwarp();  // the warp meets again before the .aligned wgmma instructions
    fence_acc<P::ACC>(acc);
    wg_fence();
    P::run(acc, ring.a(s) + a_off, ring.b(s));
    wg_commit();
    fence_acc<P::ACC>(acc);
    wg_wait<1>();
    fence_acc<P::ACC>(acc);
    if (i > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((it - 1) % R::NST));
  }
  wg_wait<0>();  // also with n == 0: the epilogue then reads the zeros
  fence_acc<P::ACC>(acc);
  if (n > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((it - 1) % R::NST));
}

// Write this warp's 16 x COLS accumulator rows (COLS / 8 of the n256
// layout's column groups) to out (row stride ld) at (row0, col0) through
// its staging buffer, 16 bytes a store; rows at or past `rows` and columns
// at or past `cols` are not written.
template <typename T, int COLS = BN>
__device__ __forceinline__ void store_tile(const float (&acc)[128], uint8_t* buf, T* out,
                                           int64_t ld, int row0, int rows, int col0, int cols,
                                           int lane) {
  constexpr int PER = 128 / sizeof(T);  // columns a 128-byte staging row holds: 64 bf16, 32 f32
  const int r = lane / 4, cq = (lane % 4) * 2;
#pragma unroll
  for (int q = 0; q < COLS / PER; ++q) {
#pragma unroll
    for (int j8 = 0; j8 < PER / 8; ++j8) {
      const int j = q * (PER / 8) + j8;
      const int off = (8 * j8 + cq) * static_cast<int>(sizeof(T));
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(buf + r * EPI_PITCH + off) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(buf + (r + 8) * EPI_PITCH + off) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        *reinterpret_cast<float2*>(buf + r * EPI_PITCH + off) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(buf + (r + 8) * EPI_PITCH + off) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 16 rows x 8 vectors of 16 bytes
      const int v = i * 32 + lane, rr = v / 8, cv = v % 8;
      const int row = row0 + rr, col = col0 + q * PER + cv * (16 / static_cast<int>(sizeof(T)));
      if (row < rows && col < cols)
        *reinterpret_cast<int4*>(out + static_cast<int64_t>(row) * ld + col) =
            *reinterpret_cast<const int4*>(buf + rr * EPI_PITCH + cv * 16);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K6: out[tile] = bf16(lhs[tile] @ rhs[te[tile]])
// ---------------------------------------------------------------------------

// Tile `t` of the grouped raster: GROUP row blocks sweep the column blocks.
__device__ __forceinline__ void gmm_tile(int t, int m_blocks, int n_blocks, int& mb, int& nb) {
  const int in_group = GROUP * n_blocks;
  const int first_m = (t / in_group) * GROUP;
  const int gm = min(m_blocks - first_m, GROUP);
  mb = first_m + (t % in_group) % gm;
  nb = (t % in_group) / gm;
}

template <bool TRANS>
__global__ void __launch_bounds__(NTHREADS, 1)
    gmm_sm90_gmm_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, void* __restrict__ out,
                        const int* __restrict__ te, const GmmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const MainRing ring = setup_ring<MainRing>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int m_blocks = p.M / BM, n_blocks = (p.N + BN - 1) / BN, nk = (p.K + BK - 1) / BK;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      int it = 0;
      for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
        int mb, nb;
        gmm_tile(t, m_blocks, n_blocks, mb, nb);
        const int e = clamp_expert(te[mb * BM / p.row_tile], p.E);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(ring.empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t bar = ring.full + 8 * s;
          mbar_expect_tx(bar, STAGE_BYTES);  // whole boxes, zero-filled past the edges too
          tma_2d(ring.a(s), &map_a, bar, kb * BK, mb * BM);
          if (TRANS) {
            tma_3d(ring.b(s), &map_b, bar, kb * BK, nb * BN, e);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_3d(ring.b(s) + j * BOX_BYTES, &map_b, bar, nb * BN + 64 * j, kb * BK, e);
          }
        }
      }
    }
  } else {  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, cw = warp - 4;
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
      int mb, nb;
      gmm_tile(t, m_blocks, n_blocks, mb, nb);
      consume<N256<0, TRANS ? 0 : 1>>(acc, ring, it, nk, c * (A_BYTES / 2), lane);
      store_tile<bf16>(acc, ring.staging(cw), static_cast<bf16*>(out), p.ldo, mb * BM + c * 64 + (cw % 4) * 16, p.M,
                       nb * BN, p.N, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// K7: out[e] = sum over e's row tiles of lhs_tile^T @ dout_tile
// ---------------------------------------------------------------------------

// Item `t`: expert-major; inside an expert GROUP K-blocks sweep the N-blocks.
__device__ __forceinline__ void tgmm_item(int t, int k_blocks, int n_blocks, int& e, int& kb,
                                          int& nb) {
  const int per_e = k_blocks * n_blocks;
  e = t / per_e;
  gmm_tile(t % per_e, k_blocks, n_blocks, kb, nb);
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
    tgmm_sm90_gmm_kernel(const __grid_constant__ CUtensorMap map_l,
                         const __grid_constant__ CUtensorMap map_d, void* __restrict__ out,
                         const int* __restrict__ te, const TgmmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const MainRing ring = setup_ring<MainRing>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int k_blocks = (p.K + BM - 1) / BM, n_blocks = (p.N + BN - 1) / BN;
  const int per_tile = p.row_tile / BK;
  // the row tiles of each expert, counted once: the consumers' slice counts
  int* owned = reinterpret_cast<int*>(ring.gbase + OWNED_OFF);
  for (int i = threadIdx.x; i < p.E; i += NTHREADS) owned[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < p.n_tiles; i += NTHREADS)
    atomicAdd(&owned[clamp_expert(te[i], p.E)], 1);
  __syncthreads();

  if (wg == 0) {  // producer: expert e's row tiles in order, 64 rows a stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_l);
      prefetch_map(&map_d);
      int it = 0;
      for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
        int e, kb, nb;
        tgmm_item(t, k_blocks, n_blocks, e, kb, nb);
        for (int tile = 0, left = owned[e]; left > 0; ++tile) {
          if (clamp_expert(te[tile], p.E) != e) continue;
          --left;
          for (int j = 0; j < per_tile; ++j, ++it) {
            const int s = it % STAGES, row = tile * p.row_tile + j * BK;
            mbar_wait(ring.empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            const uint32_t bar = ring.full + 8 * s;
            mbar_expect_tx(bar, STAGE_BYTES);
            tma_2d(ring.a(s), &map_l, bar, kb * BM, row);
            tma_2d(ring.a(s) + BOX_BYTES, &map_l, bar, kb * BM + 64, row);
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_2d(ring.b(s) + q * BOX_BYTES, &map_d, bar, nb * BN + 64 * q, row);
          }
        }
      }
    }
  } else {  // consumers: warpgroup c owns K rows 64c .. 64c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, cw = warp - 4;
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
      int e, kb, nb;
      tgmm_item(t, k_blocks, n_blocks, e, kb, nb);
      consume<N256<1, 1>>(acc, ring, it, owned[e] * per_tile, c * BOX_BYTES, lane);
      const int64_t base = static_cast<int64_t>(e) * p.K * p.N;
      const int row0 = kb * BM + c * 64 + (cw % 4) * 16;
      if (OUT_BF16)
        store_tile<bf16>(acc, ring.staging(cw), static_cast<bf16*>(out) + base, p.N, row0, p.K,
                         nb * BN, p.N, lane);
      else
        store_tile<float>(acc, ring.staging(cw), static_cast<float*>(out) + base, p.N, row0,
                          p.K, nb * BN, p.N, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// K5 and K8: a scale or SwiGLU epilogue on bf16 or int8 weights
// ---------------------------------------------------------------------------

// A stage holds the activations' 128 x 64 slice (as K6's A) and NP weight
// panels of 64 (k) x 128 (n): K8 one stack at NP 128-column offsets, K5 w1
// (panel 0) and w3 (panel 1) at the same columns.
//   bf16 weights (SS): a panel is two 64 x 64 TMA boxes under the 128-byte
//     swizzle, read in place as wgmma's MN-major B, as K6 reads its B; each
//     consumer warpgroup owns 64 output rows and runs NP m64n128k16.
//   int8 weights (RS): wgmma has no bf16 x int8 form, so the product is
//     taken transposed, out^T = w^T x^T: a panel is one 128-byte x 64-row
//     TMA box of codes under the 128-byte swizzle; each consumer warp
//     loads its columns of it with ldmatrix, widens them in registers to
//     wgmma's A fragments (the weights' columns are the product's rows),
//     and the activations' slice is wgmma's K-major B (all 128 rows). Each
//     consumer warpgroup owns 64 (K5, K8 at 128 wide) or 128 (K8 at 256
//     wide) of the tile's output columns and all of its rows. No widened copy of a
//     slice is written anywhere: a ring of widened bf16 slices in shared
//     memory measured 2-2.7x slower, its stores competing with wgmma's
//     operand reads.

// The ring of a K5/K8 kernel: 4 stages (int8: 6, the stages being smaller)
// of the A slice and NP panels; bf16 NP 2 is K6's ring. Its shared memory:
// the ring, the SS epilogue's staging buffers and slack to align to 1024.
template <bool INT8, int NP>
using EpiRing = Ring<A_BYTES + NP * (INT8 ? RAW_PANEL : PANEL_BYTES), INT8 ? 6 : STAGES>;

template <bool INT8, int NP>
constexpr int epi_smem() {
  return EpiRing<INT8, NP>::EPI_OFF + (INT8 ? 0 : 8 * EPI_WARP) + 1024;
}

// In registers, before the staged store: K8 multiplies each accumulator by
// s1[e, col]; K5 turns the first 64 (g, w1's columns) into silu(g s1[e,
// col]) (u s3[e, col]) with u the next 64 (w3's). A thread's columns are
// col0 + 8j + 2 (lane % 4) (+ 1), one float2 of scales each; columns at or
// past N read no scale.
template <int EPI, int TN>
__device__ __forceinline__ void epilogue_ss(float (&acc)[128], const float* __restrict__ s1,
                                            const float* __restrict__ s3, int e, int N,
                                            int col0, int lane) {
  const int64_t row = static_cast<int64_t>(e) * N;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    float2 a = make_float2(0.f, 0.f), b = a;
    if (col < N) {
      a = __ldg(reinterpret_cast<const float2*>(s1 + row + col));
      if (EPI == EPI_SWIGLU) b = __ldg(reinterpret_cast<const float2*>(s3 + row + col));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sa = (i & 1) ? a.y : a.x;
      if (EPI == EPI_SCALE) {
        acc[4 * j + i] *= sa;
      } else {
        const float g = acc[4 * j + i] * sa, u = acc[64 + 4 * j + i] * ((i & 1) ? b.y : b.x);
        acc[4 * j + i] = g / (1.f + __expf(-g)) * u;  // silu(g) * u
      }
    }
  }
}

// -- int8 weights: widened in registers ----------------------------------------

// Two int8 codes, in bytes 0 and 2 of t (bytes 1 and 3 are ignored), to bf16x2,
// exactly and with no convert instruction: 0x4300 | (x & 127) is the bf16
// 128 + (x & 127), 0xC300 | (x & 128) the bf16 -128, or -256 where x < 0;
// their sum, one bf16x2 fused multiply-add by 1, is x.
__device__ __forceinline__ uint32_t widen2(uint32_t t) {
  const uint32_t v = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (t & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(c));
  return d;
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A as bf16 fragments in
// registers, B K-major in shared memory (no transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_kmajor(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A consumer warp's codes of a raw stage, as 8 x 8 matrices of 16-bit
// elements: rows are k, an element is two adjacent weight columns, and the
// warp's 16 columns (its 16 product rows, 16w .. 16w + 15 of the
// warpgroup's 64) are one 16-byte chunk of each row. ldmatrix .trans hands
// thread (g = lane / 4, t = lane % 4) element (k 2t, columns 2g, 2g + 1)
// in its low half and (k 2t + 1, same columns) in its high half: bytes 0
// and 2 are the A fragment of product row g (column 2g), bytes 1 and 3 that
// of row g + 8 (column 2g + 1). One .x4 takes k rows 0-31 of the slice
// (two k16 steps, rows 0-7 and 8-15 of each), a second rows 32-63. Lane l
// addresses row 8 (l / 8) + l % 8 of matrix l / 8, whose swizzled chunk is
// the warp's chunk XOR l % 8: the lane's byte offset in the stage.
__device__ __forceinline__ uint32_t rs_offset(int panel, int col, int lane) {
  const int r = lane & 7;  // col: the warp's first weight column in the panel
  return panel * RAW_PANEL + ((lane >> 3) * 8 + r) * 128 + (((col >> 4) ^ r) << 4);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A fragments of one slice for NT tiles: f[16 i + 4 kk + r] is register r
// of k16 step kk of tile i (rows g, g + 8 x k 2t .. 2t + 1, then + 8).
template <int NT>
__device__ __forceinline__ void load_fragments(uint32_t (&f)[16 * NT], uint32_t raw,
                                               const uint32_t (&off)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t m[4];
      ldsm_x4_trans(m, raw + off[i] + half * 32 * 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* a = f + 16 * i + 4 * (2 * half + h);
        a[0] = widen2(m[2 * h]);
        a[1] = widen2(m[2 * h] >> 8);
        a[2] = widen2(m[2 * h + 1]);
        a[3] = widen2(m[2 * h + 1] >> 8);
      }
    }
}

// One slice's products from fragments `cur`, then, while they run, the
// next slice's fragments into `nxt` once the products that read `nxt`
// have retired. Slice i of n, ring position it + i.
template <int NT, int NST>
__device__ __forceinline__ void rs_step(float (&acc)[128], uint32_t (&cur)[16 * NT],
                                        uint32_t (&nxt)[16 * NT], const EpiRing<true, NT>& ring,
                                        const uint32_t (&o)[NT], int it, int i, int n,
                                        int lane) {
  const int s = (it + i) % NST;
  fence_acc<64 * NT>(acc);
  fence_regs(cur);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = smem_desc(ring.a(s) + 32 * kk, 16, 1024);
#pragma unroll
    for (int q = 0; q < NT; ++q) wgmma_rs_n128_kmajor(acc + 64 * q, cur + 16 * q + 4 * kk, db);
  }
  wg_commit();
  fence_acc<64 * NT>(acc);
  wg_wait<1>();
  fence_acc<64 * NT>(acc);
  fence_regs(nxt);  // the products of slice i - 1, which read nxt, have retired
  if (i > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((it + i - 1) % NST));
  if (i + 1 < n) {
    const int sn = (it + i + 1) % NST;
    mbar_wait(ring.full + 8 * sn, ((it + i + 1) / NST) & 1);
    __syncwarp();
    load_fragments<NT>(nxt, ring.b(sn), o);
  }
}

template <int NT>
__device__ __forceinline__ void consume_rs(float (&acc)[128], const EpiRing<true, NT>& ring,
                                           int& it, int n, const uint32_t (&o)[NT], int lane) {
  constexpr int NST = EpiRing<true, NT>::NST;
#pragma unroll
  for (int i = 0; i < 64 * NT; ++i) acc[i] = 0.f;
  if (n == 0) return;
  uint32_t fa[16 * NT], fb[16 * NT];
  mbar_wait(ring.full + 8 * (it % NST), (it / NST) & 1);
  __syncwarp();
  load_fragments<NT>(fa, ring.b(it % NST), o);
  for (int i = 0;;) {
    rs_step<NT, NST>(acc, fa, fb, ring, o, it, i, n, lane);
    if (++i == n) break;
    rs_step<NT, NST>(acc, fb, fa, ring, o, it, i, n, lane);
    if (++i == n) break;
  }
  wg_wait<0>();
  fence_acc<64 * NT>(acc);
  fence_regs(fa);
  fence_regs(fb);
  if (lane == 0) mbar_arrive(ring.empty + 8 * ((it + n - 1) % NST));
  it += n;
}

// The transposed tile's epilogue and store: accumulator i holds output
// columns col[i], col[i] + 1 (its rows g, g + 8) of output rows row0 + 8j +
// 2t (+ 1) (its columns), so each thread's two scales are loaded once and
// each store is one bf16x2; eight threads fill 32 bytes of one row.
template <int EPI, int NT>
__device__ __forceinline__ void store_rs(const float (&acc)[128], const float* __restrict__ s1,
                                         const float* __restrict__ s3, int e, int N,
                                         const int (&col)[NT], bf16* __restrict__ out,
                                         int64_t ld, int row0, int lane) {
  constexpr int OUTS = EPI == EPI_SWIGLU ? 1 : NT;  // K5's two accumulators make one output
  const int64_t srow = static_cast<int64_t>(e) * N;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    if (col[i] >= N) continue;  // N % 16 == 0: col + 1 < N too
    const float2 a = __ldg(reinterpret_cast<const float2*>(s1 + srow + col[i]));
    float2 b = make_float2(0.f, 0.f);
    if (EPI == EPI_SWIGLU) b = __ldg(reinterpret_cast<const float2*>(s3 + srow + col[i]));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v[4];  // (col, row), (col, row + 1), (col + 1, row), (col + 1, row + 1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sa = r < 2 ? a.x : a.y;
        if (EPI == EPI_SCALE) {
          v[r] = acc[64 * i + 4 * j + r] * sa;
        } else {
          const float g = acc[4 * j + r] * sa, u = acc[64 + 4 * j + r] * (r < 2 ? b.x : b.y);
          v[r] = g / (1.f + __expf(-g)) * u;  // silu(g) * u
        }
      }
      const int64_t row = row0 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(out + row * ld + col[i]) = pack_bf16(v[0], v[2]);
      *reinterpret_cast<uint32_t*>(out + (row + 1) * ld + col[i]) = pack_bf16(v[1], v[3]);
    }
  }
}

template <int EPI, bool INT8, int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
    epi_sm90_gmm_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b1,
                        const __grid_constant__ CUtensorMap map_b3, const float* __restrict__ s1,
                        const float* __restrict__ s3, bf16* __restrict__ out,
                        const int* __restrict__ te, const GmmArgs p) {
  typedef EpiRing<INT8, NP> L;
  constexpr int TN = EPI == EPI_SWIGLU ? 128 : 128 * NP;  // output columns a tile
  extern __shared__ uint8_t smem_raw[];
  const L ring = setup_ring<L>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int m_blocks = p.M / BM, n_blocks = (p.N + TN - 1) / TN, nk = (p.K + BK - 1) / BK;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b1);
      if (EPI == EPI_SWIGLU) prefetch_map(&map_b3);
      int it = 0;
      for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
        int mb, nb;
        gmm_tile(t, m_blocks, n_blocks, mb, nb);
        const int e = clamp_expert(te[mb * BM / p.row_tile], p.E);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % L::NST;
          mbar_wait(ring.empty + 8 * s, ((it / L::NST) & 1) ^ 1);
          const uint32_t bar = ring.full + 8 * s;
          mbar_expect_tx(bar, L::STAGE);  // whole boxes, zero-filled past the edges
          tma_2d(ring.a(s), &map_a, bar, kb * BK, mb * BM);
#pragma unroll
          for (int q = 0; q < NP; ++q) {
            const CUtensorMap* map = (EPI == EPI_SWIGLU && q == 1) ? &map_b3 : &map_b1;
            const int col = nb * TN + (EPI == EPI_SWIGLU ? 0 : 128 * q);
            if (INT8) {
              tma_3d(ring.b(s) + q * RAW_PANEL, map, bar, col, kb * BK, e);
            } else {
              tma_3d(ring.b(s) + q * PANEL_BYTES, map, bar, col, kb * BK, e);
              tma_3d(ring.b(s) + q * PANEL_BYTES + BOX_BYTES, map, bar, col + 64, kb * BK, e);
            }
          }
        }
      }
    }
  } else if constexpr (INT8) {
    // consumers: warpgroup c owns weight columns (K5, K8 at 128 wide) 64c ..
    // 64c + 63 of the tile, or (K8 at 256 wide) panel c's 128
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    constexpr int NT = NP;  // A tiles a warpgroup: K5's w1 and w3, or K8's NP of 64 columns
    const int c = wg - 1, w = (warp - 4) & 3;
    uint32_t o[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int panel = EPI == EPI_SWIGLU ? i : (NP == 2 ? c : 0);
      const int pcol = (NP == 2 && EPI != EPI_SWIGLU ? 64 * i : 64 * c) + 16 * w;
      o[i] = rs_offset(panel, pcol, lane);
    }
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
      int mb, nb;
      gmm_tile(t, m_blocks, n_blocks, mb, nb);
      const int e = clamp_expert(te[mb * BM / p.row_tile], p.E);
      consume_rs<NT>(acc, ring, it, nk, o, lane);
      int col[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        col[i] = nb * TN + (NP == 2 && EPI != EPI_SWIGLU ? 128 * c + 64 * i : 64 * c) + 16 * w +
                 2 * (lane >> 2);
      store_rs<EPI, NT>(acc, s1, s3, e, p.N, col, out, p.ldo, mb * BM, lane);
    }
  } else {  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, cw = warp - 4;
    float acc[128];
    int it = 0;
    for (int t = blockIdx.x; t < p.n_items; t += gridDim.x) {
      int mb, nb;
      gmm_tile(t, m_blocks, n_blocks, mb, nb);
      const int e = clamp_expert(te[mb * BM / p.row_tile], p.E);
      consume<N128<NP>>(acc, ring, it, nk, c * (A_BYTES / 2), lane);
      epilogue_ss<EPI, TN>(acc, s1, s3, e, p.N, nb * TN, lane);
      store_tile<bf16, TN>(acc, ring.staging(cw), out, p.ldo, mb * BM + c * 64 + (cw % 4) * 16,
                           p.M, nb * TN, p.N, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel, typename Args>
int launch(Kernel kernel, const CUtensorMap& m0, const CUtensorMap& m1, void* out, const int* te,
           const Args& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(p.n_items), NTHREADS, SMEM_BYTES, stream>>>(m0, m1, out, te, p);
  return cudaGetLastError();
}

template <int EPI, bool INT8, int NP>
int launch_epi(const CUtensorMap& ma, const CUtensorMap& m1, const CUtensorMap& m3,
               const float* s1, const float* s3, void* out, const int* te, const GmmArgs& p,
               cudaStream_t stream) {
  static uint64_t smem_set = 0;
  constexpr int smem = epi_smem<INT8, NP>();
  static_assert(smem <= 232448, "shared memory");
  cudaError_t err = allow_smem(epi_sm90_gmm_kernel<EPI, INT8, NP>, smem, smem_set);
  if (err != cudaSuccess) return err;
  epi_sm90_gmm_kernel<EPI, INT8, NP><<<grid_for(p.n_items), NTHREADS, smem, stream>>>(
      ma, m1, m3, s1, s3, static_cast<bf16*>(out), te, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 on bf16 weights. Returns 0, a cudaError_t, 1 (cudaErrorInvalidValue)
// for a shape the kernel does not take, or 1001 / 2000 + CUresult when a
// tensor map cannot be made. b_trans: rhs is the transpose(1, 2) view of
// an [E, N, K] stack (ldb its N stride), else [E, K, N] with ldb its K
// stride; sbe is the expert stride; all strides in elements.
int kubedl_gmm_sm90(const void* A, const void* B, void* out, const int* te, int M, int N, int K,
                    int row_tile, int E, int64_t lda, int64_t ldb, int64_t sbe, int64_t ldo,
                    int b_trans, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || E <= 0 || row_tile <= 0 || row_tile % BM || M % row_tile ||
      N % 16 || K % 16 || lda % 8 || ldb % 8 || sbe % 8 || ldo % 8 || lda < K ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(B) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  GmmArgs p;
  p.M = M;
  p.N = N;
  p.K = K;
  p.row_tile = row_tile;
  p.E = E;
  p.ldo = ldo;
  p.n_items = (M / BM) * ((N + BN - 1) / BN);
  CUtensorMap ma, mb;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(lda) * 2};
  const cuuint32_t a_box[2] = {BK, BM};
  int err = make_map(&ma, A, 2, a_dims, a_strides, a_box);
  if (err) return err;
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(ldb) * 2,
                                   static_cast<cuuint64_t>(sbe) * 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_trans) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(E)};
    const cuuint32_t box[3] = {BK, BN, 1};
    if ((err = make_map(&mb, B, 3, dims, b_strides, box))) return err;
    return launch(gmm_sm90_gmm_kernel<true>, ma, mb, out, te, p, st);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint32_t box[3] = {64, BK, 1};
  if ((err = make_map(&mb, B, 3, dims, b_strides, box))) return err;
  return launch(gmm_sm90_gmm_kernel<false>, ma, mb, out, te, p, st);
}

// K8 (epi 1: times s1 [E, N] f32) and K5 (epi 2: silu(x w1 s1) (x w3 s3))
// on bf16 or (b_int8) int8 K-major weights [E, K, N], ldb the K stride and
// sbe the expert stride in elements; tile_n is the output tile's width:
// 128, or for K8 256. B3 and s3 are read by K5 only. Same return codes.
int kubedl_gmm_sm90_epi(const void* A, const void* B1, const void* B3, const float* s1,
                        const float* s3, void* out, const int* te, int M, int N, int K,
                        int row_tile, int E, int64_t lda, int64_t ldb, int64_t sbe, int64_t ldo,
                        int epi, int b_int8, int tile_n, void* stream) {
  const bool swiglu = epi == EPI_SWIGLU;
  const int64_t vec = b_int8 ? 16 : 8;  // elements a 16-byte vector
  if ((epi != EPI_SCALE && !swiglu) || (tile_n != 128 && (tile_n != 256 || swiglu)) || M <= 0 ||
      N <= 0 || K <= 0 || E <= 0 || row_tile <= 0 || row_tile % BM || M % row_tile || N % 16 ||
      K % 16 || lda % 8 || lda < K || ldo % 8 || ldb % vec || sbe % vec || ldb < N ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(B1) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || s1 == nullptr ||
      reinterpret_cast<uintptr_t>(s1) % 8 ||
      (swiglu && (B3 == nullptr || reinterpret_cast<uintptr_t>(B3) % 16 || s3 == nullptr ||
                  reinterpret_cast<uintptr_t>(s3) % 8)))
    return cudaErrorInvalidValue;
  GmmArgs p;
  p.M = M;
  p.N = N;
  p.K = K;
  p.row_tile = row_tile;
  p.E = E;
  p.ldo = ldo;
  p.n_items = (M / BM) * ((N + tile_n - 1) / tile_n);
  CUtensorMap ma, m1, m3;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(lda) * 2};
  const cuuint32_t a_box[2] = {BK, BM};
  int err = make_map(&ma, A, 2, a_dims, a_strides, a_box);
  if (err) return err;
  const int elem = b_int8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldb) * elem,
                                 static_cast<cuuint64_t>(sbe) * elem};
  // int8: one 128-byte x 64-row box a panel; bf16: two 64 x 64 boxes
  const cuuint32_t box8[3] = {128, BK, 1}, box16[3] = {64, BK, 1};
  for (int i = 0; i < (swiglu ? 2 : 1); ++i) {
    CUtensorMap* m = i ? &m3 : &m1;
    const void* B = i ? B3 : B1;
    err = b_int8 ? make_map(m, B, 3, dims, strides, box8, CU_TENSOR_MAP_DATA_TYPE_UINT8)
                 : make_map(m, B, 3, dims, strides, box16);
    if (err) return err;
  }
  if (!swiglu) m3 = m1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = (swiglu ? 4 : 0) + (b_int8 ? 2 : 0) + (tile_n == 256 ? 1 : 0);
  switch (code) {
    case 0: return launch_epi<EPI_SCALE, false, 1>(ma, m1, m3, s1, s3, out, te, p, st);
    case 1: return launch_epi<EPI_SCALE, false, 2>(ma, m1, m3, s1, s3, out, te, p, st);
    case 2: return launch_epi<EPI_SCALE, true, 1>(ma, m1, m3, s1, s3, out, te, p, st);
    case 3: return launch_epi<EPI_SCALE, true, 2>(ma, m1, m3, s1, s3, out, te, p, st);
    case 4: return launch_epi<EPI_SWIGLU, false, 2>(ma, m1, m3, s1, s3, out, te, p, st);
    case 6: return launch_epi<EPI_SWIGLU, true, 2>(ma, m1, m3, s1, s3, out, te, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// K7: [E, K, N] into `out`, f32 or (out_bf16) bf16. Same return codes.
int kubedl_tgmm_sm90(const void* lhs, const void* dout, void* out, const int* te, int M, int K,
                     int N, int row_tile, int n_tiles, int E, int64_t lda, int64_t ldd,
                     int out_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || E > MAX_E || row_tile <= 0 || row_tile % BK ||
      static_cast<int64_t>(n_tiles) * row_tile != M || K % 8 || N % 8 || lda % 8 || ldd % 8 ||
      lda < K || ldd < N || reinterpret_cast<uintptr_t>(lhs) % 16 ||
      reinterpret_cast<uintptr_t>(dout) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  TgmmArgs p;
  p.M = M;
  p.K = K;
  p.N = N;
  p.row_tile = row_tile;
  p.n_tiles = n_tiles;
  p.E = E;
  const int64_t items = static_cast<int64_t>(E) * ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  p.n_items = static_cast<int>(items);
  CUtensorMap ml, md;
  const cuuint32_t box[2] = {64, BK};
  const cuuint64_t l_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t l_strides[1] = {static_cast<cuuint64_t>(lda) * 2};
  int err = make_map(&ml, lhs, 2, l_dims, l_strides, box);
  if (err) return err;
  const cuuint64_t d_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t d_strides[1] = {static_cast<cuuint64_t>(ldd) * 2};
  if ((err = make_map(&md, dout, 2, d_dims, d_strides, box))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch(tgmm_sm90_gmm_kernel<true>, ml, md, out, te, p, st);
  return launch(tgmm_sm90_gmm_kernel<false>, ml, md, out, te, p, st);
}

const char* kubedl_gmm_sm90_error_string(int err) { return sm90_error_string(err); }

}  // extern "C"
