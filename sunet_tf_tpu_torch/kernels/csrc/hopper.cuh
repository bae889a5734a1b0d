// Hopper building blocks of the cluster kernels (swin_cluster.cu, ln_mlp.cu):
// mbarriers, TMA loads of weight boxes with the 128-byte swizzle, wgmma
// m64n64k16 (bf16 in, fp32 sums) on shared-memory descriptors, the K-major
// activation layout wgmma reads as its A operand, and the weight ring.
//
// Operands of one product D (64 x 64) += A (64 x K) @ W[k0:k0+K, n0:n0+64]:
// - A (64 rows) lives in shared memory in the K-major layout with the
//   128-byte swizzle: panels of 64 columns (8 KB: 64 rows of 128 bytes),
//   8-row atoms 1024 bytes apart (SBO), the 16-byte chunks of row r XOR-ed
//   with r % 8, so that the eight row groups a wgmma reads fall in different
//   banks. A k16 step inside a panel advances the start address by 32
//   bytes. The kernels write it themselves (LayerNorm rows, ctx, GELU
//   output).
// - W is the row-major (in, out) weight matrix in global memory. A TMA box
//   of 64 columns x R rows lands as R rows of 128 bytes with the 128-byte
//   swizzle: the MN-major layout with 8-row groups 1024 bytes apart (SBO);
//   wgmma reads it transposed (tnsp-b = 1).
// - The ring: S slots, each holding one K chunk of every 64-column box of
//   the current product; a full barrier per slot (the TMA bytes) and an
//   empty barrier per slot (one arrival per consumer thread). One thread
//   issues the loads S chunks ahead of the consumers, across products, so
//   the next product's first weights are in flight while the CTA runs its
//   LayerNorm or attention.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sunet {
namespace hop {

typedef __nv_bfloat16 bf16;

constexpr int kBox = 64;           // columns of one weight box (128 bytes)
constexpr int kWgThreads = 128;    // one warpgroup

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ inline void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at (column c0, row r0) into dst, completing on bar.
__device__ inline void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// Generic-proxy writes to shared memory, visible to wgmma (the async proxy).
__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ inline void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ inline void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ inline void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Named barrier over the first n threads (the consumer warpgroups).
__device__ inline void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout (0: no swizzle, 1: 128-byte swizzle).
__device__ inline uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                     uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

constexpr int kPanel = 64 * 128;   // bytes of one 64-column panel of A

// Byte offset of A[r][k] (r < 64) in the swizzled K-major layout.
__host__ __device__ inline uint32_t a_off(int r, int k) {
  return (uint32_t)((k >> 6) * kPanel + (r >> 3) * 1024 + (r & 7) * 128 +
                    ((((k >> 3) & 7) ^ (r & 7)) << 4) + (k & 7) * 2);
}

// Bytes of a 64 x K A operand.
__host__ __device__ inline size_t a_bytes(int K) { return (size_t)(K + 63) / 64 * kPanel; }

// A operand descriptor at column k0 (a multiple of 16).
__device__ inline uint64_t a_desc(const void* base, int k0) {
  return make_desc(smem_u32(base) + (uint32_t)(k0 >> 6) * kPanel + (uint32_t)(k0 & 63) * 2, 16,
                   1024, 1);
}

// B operand descriptor of a weight box (rows of 128 swizzled bytes) at row kk.
__device__ inline uint64_t b_desc(const void* box, int kk) {
  return make_desc(smem_u32(box) + (uint32_t)kk * 128, 8192, 1024, 1);
}

// D (64 x 64 fp32, 32 per thread) (+)= A @ B over 16 of K; scale_d 0
// overwrites D.
__device__ inline void wgmma64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 16 fp32, 8 per thread) (+)= A @ B over 16 of K, B K-major (not
// transposed: N rows of K, the layout of A); scale_d 0 overwrites D.
__device__ inline void wgmma16_kmajor(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64 fp32) (+)= A @ B over 16 of K, B K-major (N rows of K, the
// layout of A: the rows of a weight W used as W^T); scale_d 0 overwrites D.
__device__ inline void wgmma64_kmajor(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64 fp32) (+)= A @ B over 16 of K with A transposed (M-major: K
// rows of 64 M values, the layout of a TMA box of a token matrix, read as
// its transpose) and B N-major (b_desc); scale_d 0 overwrites D.
__device__ inline void wgmma64_tt(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Row and column within the 64 x 64 tile of accumulator i of thread t
// (0..127) of the warpgroup.
__device__ inline int acc_row(int t, int i) { return (t >> 5) * 16 + ((t & 31) >> 2) + ((i >> 1) & 1) * 8; }
__device__ inline int acc_col(int t, int i) { return (i >> 2) * 8 + (t & 3) * 2 + (i & 1); }

// ---------------------------------------------------------------- the ring

// One product of the sequence: `nb` boxes of 64 columns of `map`; box j at
// column c0 + (j / per) * rstride + (j % per) * 64; rows r0 .. r0 + K in
// chunks of `bk` rows (the map's box height).
struct Product {
  const CUtensorMap* map;
  int c0, per, rstride, nb, r0, K, bk;
  __device__ int col(int j) const { return c0 + (j / per) * rstride + (j % per) * kBox; }
  __device__ int chunks() const { return (K + bk - 1) / bk; }
};

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* slots;
  int S;
  uint32_t slot_bytes;
  // the product sequence, and the producer's position in it
  const Product* seq;
  int nseq;
  int issued;       // chunks issued so far (producer thread only)
  int pi, pc;       // producer: product index, chunk within it
  int consumed;     // chunks consumed so far (every consumer thread)

  __device__ unsigned char* slot(int i) const { return slots + (size_t)(i % S) * slot_bytes; }

  // Producer (one thread): issue the sequence's chunks up to (not
  // including) chunk `upto`, each once its slot has been released.
  __device__ void produce(int upto) {
    while (pi < nseq && issued < upto) {
      const Product& p = seq[pi];
      const int s = issued % S;
      if (issued >= S) mbar_wait(&empty[s], ((issued / S) - 1) & 1);
      const int r = p.r0 + pc * p.bk;
      mbar_expect_tx(&full[s], (uint32_t)(p.nb * p.bk * 128));
      unsigned char* dst = slot(issued);
      for (int j = 0; j < p.nb; ++j)
        tma_load(dst + (size_t)j * p.bk * 128, p.map, &full[s], p.col(j), r);
      ++issued;
      if (++pc == p.chunks()) {
        pc = 0;
        ++pi;
      }
    }
  }
};

// The chunk loop of one product for a warpgroup that owns NJ boxes (wg,
// wg + nwg, ...): no branch around the wgmmas. Each chunk's products stay
// in flight while the next chunk's barrier is awaited; a slot is released
// (every consumer thread arrives) once the products that read it are done,
// and the producer thread then refills it.
template <int NJ, int MJ>
__device__ inline void consume(Ring& ring, const Product& p, const void* a,
                               float (&acc)[MJ][32], int wg, int nwg, bool producer) {
  const int nch = p.chunks();
  if (producer) ring.produce(ring.consumed + ring.S);
  for (int c = 0; c < nch; ++c) {
    const int g = ring.consumed;
    mbar_wait(&ring.full[g % ring.S], (g / ring.S) & 1);
    if constexpr (NJ > 0) {
      const unsigned char* slot = ring.slot(g);
      wg_fence();
      for (int kk = 0; kk < p.bk; kk += 16) {
        const uint64_t ad = a_desc(a, c * p.bk + kk);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          wgmma64(acc[jj], ad, b_desc(slot + (size_t)(wg + jj * nwg) * p.bk * 128, kk), 1);
      }
      wg_commit();
      wg_wait1();
    }
    if (c > 0) mbar_arrive(&ring.empty[(g - 1) % ring.S]);
    ring.consumed = g + 1;
    if (producer) ring.produce(ring.consumed + ring.S - 1);
  }
  if constexpr (NJ > 0) wg_wait0();
  mbar_arrive(&ring.empty[(ring.consumed - 1) % ring.S]);
}

// One product on the ring, by the consumer warpgroups: warpgroup wg owns
// boxes wg, wg + nwg, ... (at most MJ); acc[jj] gets box wg + jj * nwg.
// `a` is the A operand (the swizzled K-major layout, the product's K
// columns). Thread `producer` (one consumer thread) keeps the
// ring S chunks ahead. Ends with every consumer's sums complete.
template <int MJ>
__device__ inline void run_product(Ring& ring, const Product& p, const void* a,
                                   float (&acc)[MJ][32], int wg, int nwg, bool producer) {
  const int nj = p.nb > wg ? (p.nb - wg + nwg - 1) / nwg : 0;
#pragma unroll
  for (int jj = 0; jj < MJ; ++jj)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[jj][i] = 0.f;
  switch (nj) {
    case 0: consume<0>(ring, p, a, acc, wg, nwg, producer); break;
    case 1: consume<1>(ring, p, a, acc, wg, nwg, producer); break;
    case 2:
      if constexpr (MJ >= 2) consume<2>(ring, p, a, acc, wg, nwg, producer);
      break;
    default:
      if constexpr (MJ >= 3) consume<3>(ring, p, a, acc, wg, nwg, producer);
      break;
  }
}

// ---------------------------------------------------------------- plans

__host__ __device__ inline size_t align1024(size_t v) { return (v + 1023) & ~size_t(1023); }

// 64-column boxes of a product of `cols` columns.
__host__ __device__ inline int nboxes(int cols) { return (cols + kBox - 1) / kBox; }

// Rows per chunk of a product of nb boxes over K rows, in a ring slot of
// `slot` bytes: the most k16 steps that fit and divide K, at most 256 (a
// TMA box's height); 0 when none does.
__host__ __device__ inline int chunk_rows(int slot, int nb, int K) {
  for (int bk = 256; bk >= 16; bk -= 16)
    if (bk * nb * 128 <= slot && K % bk == 0) return bk;
  return 0;
}

// ---------------------------------------------------------------- host side

// Launch `kernel` on clusters of G CTAs along x (grid.x a multiple of G).
template <class Kernel, class... Args>
inline cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                                  cudaStream_t st, int G, const Args&... args) {
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = G;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (libcuda.so.1 is loaded by the CUDA runtime).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// Map of a rows x cols bf16 row-major matrix in boxes of 64 columns x
// box_rows rows, 128-byte swizzle; reads past the matrix fill zeros.
inline cudaError_t weight_map(CUtensorMap* m, const void* w, int rows, int cols,
                              int box_rows) {
  const EncodeTiledFn f = encode_tiled();
  if (f == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  if (cols % 8 || box_rows < 8 || box_rows > 256 || box_rows % 8 ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return cudaErrorInvalidValue;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dim,
                       stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hop
}  // namespace sunet
