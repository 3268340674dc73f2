// Building blocks of the port's bf16 tensor-core kernels (sm_90a):
// swizzled shared-memory tiles, 16-byte cp.async loads, ldmatrix and
// mma.sync.m16n8k16 with float32 accumulators.  Included by ssd_fwd.cu and
// flash_attention_fwd.cu; each is compiled into its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// a shared-memory tile of bf16 rows: row stride in 16-byte chunks, and the
// mask XORed into a chunk's index by its row
struct Tile {
  int rsc, xm;
};

// rows of `cols` bf16 values: XOR-swizzled where a row is a multiple of 8
// chunks, else padded by one chunk, so the 8 rows an `ldmatrix` phase reads
// fall in 8 different bank groups
__host__ __device__ inline Tile tile_of(int cols) {
  const int nch = cols / 8;
  return nch % 8 == 0 ? Tile{nch, 7} : Tile{nch + 1, 0};
}

// element offset of (row, col) in a tile
__device__ __forceinline__ int toff(Tile t, int row, int col) {
  return (row * t.rsc + ((col >> 3) ^ (row & t.xm))) * 8 + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
