// Grouped matrix products K6 and K7 of the dropless MoE FFN, written for
// Hopper (sm_90a) with TMA, mbarrier pipelines and wgmma. Plain C interface,
// bound with ctypes by kubedl_tpu_torch/ops/gmm.py.
//
// Replaces the TPU kernels
//   kubedl_tpu/ops/gmm.py:130 _gmm_kernel   (K6)  gmm_sm90_gmm_kernel<TRANS>
//   kubedl_tpu/ops/gmm.py:276 _tgmm_kernel  (K7)  tgmm_sm90_gmm_kernel<OUT_BF16>
// (gmm.cu keeps K5, K8 and K6 on int8 weights.)
//
// What they compute. lhs [M, K] is cut into row tiles of row_tile rows (a
// multiple of 128); tile i belongs to expert te[i], clamped to [0, E):
//   K6  out[tile i] = bf16(lhs[tile i] @ rhs[te[i]]),   rhs [E, K, N] bf16
//   K7  out[e] = sum over the row tiles i with te[i] == e of
//       lhs[tile i]^T @ dout[tile i], [E, K, N], accumulated in f32 and
//       written as f32 or, for a caller that casts to bf16 weights anyway,
//       rounded once to bf16 (the same bits as the separate cast). An expert
//       that owns no tile gets exact zeros.
//
// Bound on an H100 SXM: 2 * R * K * N FLOP over the routed rows R at 989
// TFLOP/s against the owning experts' weights plus the activations at 3.35
// TB/s; at the training and prefill shapes (R ~ 8k, 4096 x 14336) the
// tensor cores bound both kernels. What the design does about it:
//   - wgmma m64n256k16 (bf16 -> f32) on a 128 x 256 output tile: two
//     consumer warpgroups own 64 rows each, 128 f32 accumulators a thread
//     (setmaxnreg 232), so every shared-memory byte feeds 2x more products
//     than the 128 x 128 mma.sync tile did;
//   - one producer thread (its warpgroup gives its registers back with
//     setmaxnreg 40) keeps a ring of 4 stages of 64-deep slices full with
//     TMA (48 KB a stage, 192 KB in all), each stage with a full and an
//     empty mbarrier; a consumer frees a stage once the wgmma that read it
//     has retired (wgmma.wait_group 1), so the next slice's products are
//     queued while the last one finishes;
//   - a persistent grid (one CTA an SM) walks the output tiles in a static
//     order, so the producer loads the next tile's slices while the
//     consumers write the last tile: K6 in a grouped raster (8 row blocks,
//     about one expert, sweep a weight panel together and reuse it from L2),
//     K7 expert by expert, 8 K-blocks of lhs^T sweeping dout's N-blocks;
//   - every operand is read in place in its own layout through the wgmma
//     transpose bits: K6's A is lhs (K-major); its B is the K-major weight
//     stack (N contiguous: MN-major, four 64-wide TMA boxes under the
//     128-byte swizzle) or the backward's rhs.transpose(1, 2) view (K
//     contiguous: K-major, one 256-row box); K7's A is lhs^T and its B is
//     dout, both MN-major;
//   - the epilogue goes through a 16-row staging buffer of each warp and
//     leaves as 16-byte stores; no split-K and no atomics: each tile sums
//     its slices in one order, so two launches give the same bits.
// It still computes every padded row of the layout (m_pad, not R).
//
// Layout rules: K and N multiples of 16 (K6) or 8 (K7); lhs/dout row
// strides whole 16-byte vectors, base addresses 16-byte aligned.

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
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int EPI_OFF = BAR_OFF + 2 * STAGES * 8;
constexpr int EPI_PITCH = 144;                // 128 bytes a row + 16: conflict-free writes
constexpr int EPI_WARP = 16 * EPI_PITCH;
constexpr int OWNED_OFF = EPI_OFF + 8 * EPI_WARP;  // K7: row tiles each expert owns
constexpr int MAX_E = 1024;
constexpr int SMEM_BYTES = OWNED_OFF + 4 * MAX_E + 1024;  // + slack to align to 1024

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

__device__ __forceinline__ int clamp_expert(int e, int n) { return min(max(e, 0), n - 1); }

// The shared-memory ring of stages, its full and empty barriers and the
// epilogue's staging buffers, laid out the same way by both kernels.
struct Ring {
  uint32_t base;   // shared address of stage 0, 1024-aligned
  uint8_t* gbase;  // the same byte as a generic pointer
  uint32_t full, empty;

  __device__ __forceinline__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ __forceinline__ uint8_t* staging(int consumer_warp) const {
    return gbase + EPI_OFF + consumer_warp * EPI_WARP;
  }
};

__device__ __forceinline__ Ring setup_ring(uint8_t* smem_raw) {
  Ring r;
  const uint32_t raw = smem_u32(smem_raw);
  r.base = (raw + 1023) & ~1023u;
  r.gbase = smem_raw + (r.base - raw);
  r.full = r.base + BAR_OFF;
  r.empty = r.full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, 1);   // the producer's arrive + the TMA bytes
      mbar_init(r.empty + 8 * s, 8);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// One slice's four k16 products of a consumer warpgroup. A: K-major rows of
// 128 bytes (step 32 bytes) or MN-major 64 x 64 boxes (step 16 rows = 2048
// bytes); B likewise, MN-major as four boxes 8 KB apart.
template <int TA, int TB>
__device__ __forceinline__ void slice_products(float (&acc)[128], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = TA ? smem_desc(a + 2048 * kk, BOX_BYTES, 1024)
                           : smem_desc(a + 32 * kk, 16, 1024);
    const uint64_t db = TB ? smem_desc(b + 2048 * kk, BOX_BYTES, 1024)
                           : smem_desc(b + 32 * kk, 16, 1024);
    wgmma_n256<TA, TB>(acc, da, db);
  }
}

// The consumer side of `n` slices starting at ring position `it`: wait for
// each stage, queue its products, and free the stage before it once that
// stage's products have retired.
template <int TA, int TB>
__device__ __forceinline__ void consume(float (&acc)[128], const Ring& ring, int& it, int n,
                                        uint32_t a_off, int lane) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i, ++it) {
    const int s = it % STAGES;
    mbar_wait(ring.full + 8 * s, (it / STAGES) & 1);
    __syncwarp();  // the warp meets again before the .aligned wgmma instructions
    fence_regs(acc);
    wg_fence();
    slice_products<TA, TB>(acc, ring.a(s) + a_off, ring.b(s));
    wg_commit();
    fence_regs(acc);
    wg_wait<1>();
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((it - 1) % STAGES));
  }
  wg_wait<0>();  // also with n == 0: the epilogue then reads the zeros
  fence_regs(acc);
  if (n > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((it - 1) % STAGES));
}

// Write this warp's 16 x 256 accumulator rows to out (row stride ld) at
// (row0, col0) through its staging buffer, 16 bytes a store; rows at or
// past `rows` and columns at or past `cols` are not written.
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[128], uint8_t* buf, T* out,
                                           int64_t ld, int row0, int rows, int col0, int cols,
                                           int lane) {
  constexpr int PER = 128 / sizeof(T);  // columns a 128-byte staging row holds: 64 bf16, 32 f32
  const int r = lane / 4, cq = (lane % 4) * 2;
#pragma unroll
  for (int q = 0; q < BN / PER; ++q) {
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
  const Ring ring = setup_ring(smem_raw);
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
      consume<0, TRANS ? 0 : 1>(acc, ring, it, nk, c * (A_BYTES / 2), lane);
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
  const Ring ring = setup_ring(smem_raw);
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
      consume<1, 1>(acc, ring, it, owned[e] * per_tile, c * BOX_BYTES, lane);
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
