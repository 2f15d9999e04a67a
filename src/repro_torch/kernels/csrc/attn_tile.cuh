// Tile math shared by the attention kernels K1 (spec_verify_attn.cu) and K4
// (flash_attn.cu) on Hopper (sm_90a): 16-byte cp.async copies, ldmatrix,
// mma.sync in bf16 and tf32 (fp32 as three tf32 products), and the scan
// that finds the key tiles some query of a block may see from the keys'
// absolute positions.
//
// The position mask both kernels apply: key row j is visible to a query at
// position qp iff
//   0 <= kpos[j] <= qp  and  kpos[j] > qp - window    (window optional)
//   or 0 <= kpos[j] < prefix_len.
// The helpers that read it take any parameter struct P with the fields
// k_pos, L, kp_sb, has_window, window and prefix_len.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename P>
__device__ __forceinline__ bool visible(const P& p, int qp, int kp) {
  bool o = kp >= 0 && kp <= qp;
  if (p.has_window) o = o && kp > qp - p.window;
  if (p.prefix_len) o = o || (kp >= 0 && kp < p.prefix_len);
  return o;
}

// Could a key at kp be seen by some query of a tile whose valid positions
// span [qlo, qhi]?  Never false when one can (a tile it rejects is skipped).
template <typename P>
__device__ __forceinline__ bool key_maybe_visible(const P& p, int kp, int qlo, int qhi) {
  bool v = kp >= 0 && kp <= qhi;
  if (p.has_window) v = v && kp > qlo - p.window;
  if (p.prefix_len) v = v || (kp >= 0 && kp < p.prefix_len);
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ big + small, both tf32; x - big is exact in fp32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a * b in three tf32 products (the small*small term is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Which key tiles of a window of SCAN tiles (at most 32) some query of the
// block may see (key_maybe_visible), and which every query of the block
// sees whole (then the tile needs no mask).  qmin is the least position of
// the block's rows, -1 if one of them is never attended.  Every lane of the
// warp computes the same bits, so a loop over them stays uniform.
struct TileScan {
  int base;            // first tile of the window
  unsigned vis, full;  // bit t: tile base + t
};

template <int BK, int SCAN, typename P>
__device__ __forceinline__ void scan_tiles(const P& p, int b, int base, int qmin, int qlo,
                                           int qhi, int lane, TileScan& sc) {
  static_assert(SCAN <= 32 && BK % 32 == 0, "scan window");
  constexpr int KPL = BK / 32;
  int kp[SCAN][KPL];
#pragma unroll
  for (int t = 0; t < SCAN; ++t)
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int jj = (base + t) * BK + lane + 32 * i;
      kp[t][i] = jj < p.L ? p.k_pos[b * p.kp_sb + jj] : -1;
    }
  sc.base = base;
  sc.vis = sc.full = 0;
#pragma unroll
  for (int t = 0; t < SCAN; ++t) {
    bool v = false, f = qmin >= 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int x = kp[t][i];
      v |= key_maybe_visible(p, x, qlo, qhi);
      f &= x >= 0 && x <= qmin && (!p.has_window || x > qhi - p.window);
    }
    if (__any_sync(0xffffffffu, v)) sc.vis |= 1u << t;
    if (__all_sync(0xffffffffu, f)) sc.full |= 1u << t;
  }
}

// The first tile at or after jt that may be visible, or ntiles; `full` as
// above.  Positions are read a window at a time, so a run of invisible
// tiles costs one round trip per SCAN tiles.
template <int BK, int SCAN, typename P>
__device__ __forceinline__ int next_tile(const P& p, int b, int jt, int ntiles, int qmin,
                                         int qlo, int qhi, int lane, TileScan& sc, bool& full) {
  while (jt < ntiles) {
    if (jt >= sc.base + SCAN) scan_tiles<BK, SCAN>(p, b, jt, qmin, qlo, qhi, lane, sc);
    const unsigned v = sc.vis >> (jt - sc.base);
    if (v) {
      jt += __ffs(v) - 1;
      full = (sc.full >> (jt - sc.base)) & 1u;
      return jt;
    }
    jt = sc.base + SCAN;
  }
  full = false;
  return ntiles;
}

}  // namespace
