// RMSNorm for Hopper (sm_90a), forward and backward, plain C interface.
//
// Replaces the TPU kernel `rmsnorm_pallas` (src/repro/kernels/rmsnorm.py,
// body `_rmsnorm_kernel`) and the model's `rms_norm`
// (src/repro/models/common.py), which compute, per row of x [n, d]:
//   rstd = rsqrt(mean(x^2) + eps)          (fp32)
//   y    = (x * rstd).to(x.dtype) * gamma  (the product in x's dtype)
// The backward is the one JAX's autodiff takes through that expression:
//   g     = (dy * gamma).to(x.dtype), widened to fp32
//   dx    = rstd * (g - xh * mean(g * xh)),  xh = x * rstd in fp32
//   dgamma = sum over rows of dy * xh.to(x.dtype), in fp32
//
// What bounds it on an H100: bytes.  A row of d values takes 3 operations
// per element against 2 (forward) or 3 (backward) element reads and writes,
// far below the ~20 fp32 operations per byte where arithmetic would bind.
// Forward, one device kernel a call, `rmsnorm_fwd_kernel`: groups of
// `lanes` threads (a power of two up to 256: a few lanes, a warp or several
// warps; several groups a block), each owning one row.  Thread t of a group
// owns accesses j = t + k * lanes (k < chunks) of the row, 16 bytes each (4
// fp32 or 8 bf16 values; one value where d or a base is not 16-byte
// aligned), gamma's among them, in straight-line code with one register
// set.  (Several rows a group, the next row's loads in a second register
// set ahead of this row's stores, cost registers and won at no shape in the
// sweep, so it is not kept.)  A row's sum of squares is taken in fp64
// (each square exact, the sum all but exact, so the fp32 mean is nearly
// always the correctly rounded one whatever the order; an fp32 sum in this
// order moved chip_smoke's int8 codes and greedy tokens away from the
// CPU's): each thread's own over its accesses in order, a butterfly of
// shuffles over the group's lanes inside a warp (blocks of whole warps),
// then, for groups of several warps, the warps in order after one barrier
// of the block (no named barriers: a kernel whose barrier ids are registers
// reserves all 16, which caps the blocks an SM holds).  So a row's bits
// depend on d, the dtype and the alignment (which set lanes and the
// accesses), never on n: groups a block only change which block takes a
// row.
// Backward, two device kernels a call, neither with atomics, so dx and
// dgamma do not change from run to run:
// - `rmsnorm_bwd_rows`: units of `wpr` warps (several a block), each unit
//   owning a contiguous, fixed range of `rpu` rows.  A thread owns the same
//   16-byte accesses of every row (4 fp32 or 8 bf16 values; one value where
//   d or a base is not 16-byte aligned), so it keeps its columns' fp32
//   dgamma partial in registers across the unit's rows.  The next row's x
//   and dy are fetched into a second set of registers before the current
//   row's sum and stores, so one row's round trip overlaps the next one's
//   loads (where a thread's share of a row is at most 64 bytes); a row's
//   sum is warp shuffles plus, for wpr > 1, one named barrier of the
//   unit's warps (two slots alternate by row parity).  Each unit writes its
//   partial once: row u of a [units, ldp] fp32 scratch.  (A ring of bulk
//   copies into shared memory, every row of a unit asked for at once, was
//   no faster in the sweep and is not kept.)
// - `rmsnorm_bwd_dgamma`: the partials summed in a fixed order over blocks
//   of `strip` 4-column groups x (256 / strip) row groups (each thread adds
//   rows rg, rg + groups, ... in order, then a shuffle tree and the warps in
//   order), as a programmatic dependent launch whose blocks wait for the
//   rows kernel to finish before reading.
// The wrapper (kernels/rmsnorm.py, `fwd_plan` and `bwd_plan`) chooses the
// grids and sizes the scratch; the rules were set from
// tools/rmsnorm_variants.py's sweeps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 8192;    // the widest row either direction takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x's dtype round trip: the cast that the model applies before gamma
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// what the forward and the backward share

// One access of VEC values of T: loaded as raw bits (R), widened on use.
template <typename T, int VEC> struct Acc;

template <> struct Acc<float, 4> {
  using R = uint4;
  static __device__ __forceinline__ R load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const R& r, int i) {
    return __uint_as_float(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Acc<__nv_bfloat16, 8> {
  using R = uint4;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const R& r, int i) {
    const uint32_t w = i / 2 == 0 ? r.x : i / 2 == 1 ? r.y : i / 2 == 2 ? r.z : r.w;
    return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
};

template <typename T> struct Acc<T, 1> {
  using R = T;
  static __device__ __forceinline__ R load(const T* p) { return *p; }
  static __device__ __forceinline__ float get(const R& r, int) { return to_f(r); }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = from_f<T>(v[0]);
  }
};

// ---------------------------------------------------------------------------
// forward

constexpr int FWD_NT = 256;  // threads of a forward block at most: groups x lanes <= 256

struct FwdArgs {
  const void* x;
  const void* gamma;
  void* y;
  float* rstd;            // [n] fp32, or null
  int n, d;
  float eps;
  int lanes, gpb;         // lanes a group, groups a block
};

// Group g = blockIdx.x * gpb + threadIdx.x / lanes owns row g (none where g
// >= n); its thread t owns accesses j = t + k * lanes (k < C) of the row,
// columns [j * VEC, (j + 1) * VEC).  A group past the last row loads and
// stores nothing but still meets the block's barrier for groups of several
// warps.
template <typename T, int VEC, int C>
__global__ void __launch_bounds__(FWD_NT) rmsnorm_fwd_kernel(const FwdArgs a) {
  using A = Acc<T, VEC>;
  using R = typename A::R;
  __shared__ double red[FWD_NT / 32];
  const int L = a.lanes, shift = __ffs(L) - 1;  // L a power of two
  const int gi = threadIdx.x >> shift, t = threadIdx.x & (L - 1), lane = threadIdx.x % 32;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int nacc = (a.d + VEC - 1) / VEC;  // accesses a row (VEC > 1: d % VEC == 0)
  const long long r = static_cast<long long>(blockIdx.x) * a.gpb + gi;
  const bool live = r < a.n;
  const long long off = r * a.d;
  // gamma kept in registers, except for one-value accesses above 8 a
  // thread (read where used, from L1), which would spill
  constexpr bool keep_gamma = VEC > 1 || C <= 8;
  const T* gamma = static_cast<const T*>(a.gamma);
  R gm[keep_gamma ? C : 1];
  if constexpr (keep_gamma) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * L;
      gm[k] = j < nacc && live ? A::load(gamma + j * VEC) : R{};
    }
  }
  auto gam = [&](int k, int j) -> R {
    if constexpr (keep_gamma) return gm[k];
    else return A::load(gamma + j * VEC);
  };
  R xv[C];
  if (live) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * L;
      if (j < nacc) xv[k] = A::load(x + off + j * VEC);
    }
  }

  double ss = 0.0;
  if (live) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * L;
      if (j < nacc) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = A::get(xv[k], e);
          ss = fma(static_cast<double>(v), static_cast<double>(v), ss);
        }
      }
    }
  }
  // every lane of the block's warps takes every step (the blocks hold whole
  // warps), so the shuffles need no mask of their own; an offset below L
  // stays inside the group
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < L) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (L > 32) {  // the group's warps add their sums in a fixed order
    double* slot = red + (gi << (shift - 5));
    if (lane == 0) slot[t >> 5] = ss;
    __syncthreads();
    ss = 0.0;
#pragma unroll
    for (int w = 0; w < FWD_NT / 32; ++w)
      if (w < (L >> 5)) ss += slot[w];
  }
  if (!live) return;
  // the mean rounded once to fp32, then as the model: + eps, rsqrt, in fp32
  const float rs = rsqrtf(static_cast<float>(ss / a.d) + a.eps);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = t + k * L;
    if (j < nacc) {
      const R gk = gam(k, j);
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = round_to<T>(A::get(xv[k], e) * rs) * A::get(gk, e);
      A::store(y + off + j * VEC, o);
    }
  }
  if (a.rstd != nullptr && t == 0) a.rstd[r] = rs;
}

// ---------------------------------------------------------------------------
// backward

constexpr int BWD_NT = 256;       // threads of a rows block at most: units x warps <= 8
constexpr int BWD_MAX_UNITS = 8;  // units a block at most (one warp each)
constexpr int BWD_MAX_WPR = 8;    // warps a unit at most
constexpr int COMBINE_NT = 256;   // threads of a combine block

__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// a barrier of `threads` threads (a unit's warps) under id `id` (1..8)
__device__ __forceinline__ void unit_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

struct BwdArgs {
  const void* x;
  const void* gamma;
  const void* dy;
  const float* rstd;
  void* dx;
  float* part;            // [units, ldp] fp32: one dgamma partial a unit
  int n, d, ldp;
  int wpr, upb, rpu, units;  // warps a unit, units a block, rows a unit, units
};

// Unit u = blockIdx.x * upb + threadIdx.x / (32 * wpr) owns rows
// [u * rpu, min(n, (u + 1) * rpu)); its thread t owns accesses j = t + k *
// 32 * wpr (k < C) of every row, columns [j * VEC, (j + 1) * VEC).
template <typename T, int VEC, int C>
__global__ void __launch_bounds__(BWD_NT) rmsnorm_bwd_rows(const BwdArgs a) {
  using A = Acc<T, VEC>;
  using R = typename A::R;
  __shared__ float red[BWD_MAX_UNITS][2][BWD_MAX_WPR];
  const int G = 32 * a.wpr;
  const int gi = threadIdx.x / G, t = threadIdx.x % G, w = t / 32, lane = t % 32;
  const int u = blockIdx.x * a.upb + gi;
  if (u >= a.units) return;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const int nacc = (a.d + VEC - 1) / VEC;  // accesses a row (VEC > 1: d % VEC == 0)
  const int r0 = u * a.rpu, r1 = min(a.n, r0 + a.rpu);
  // gamma kept in registers, except for one-value accesses above 8 a
  // thread (read where used, from L1), which would spill
  constexpr bool keep_gamma = VEC > 1 || C <= 8;
  const T* gamma = static_cast<const T*>(a.gamma);
  R gm[keep_gamma ? C : 1];
  float dg[C][VEC];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = t + k * G;
    if constexpr (keep_gamma) gm[k] = j < nacc ? A::load(gamma + j * VEC) : R{};
#pragma unroll
    for (int e = 0; e < VEC; ++e) dg[k][e] = 0.f;
  }
  auto gam = [&](int k, int j) -> R {
    if constexpr (keep_gamma) return gm[k];
    else return A::load(gamma + j * VEC);
  };

  auto fetch = [&](int r, R(&xv)[C], R(&yv)[C], float& rs) {
    const long long off = static_cast<long long>(r) * a.d;
    rs = a.rstd[r];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * G;
      if (j < nacc) {
        xv[k] = A::load(x + off + j * VEC);
        yv[k] = A::load(dy + off + j * VEC);
      }
    }
  };

  auto row = [&](int r, const R(&xv)[C], const R(&yv)[C], float rs) {
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * G;
      if (j < nacc) {
        const R gk = gam(k, j);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = A::get(xv[k], e) * rs, dyv = A::get(yv[k], e);
          const float g = round_to<T>(dyv * A::get(gk, e));
          dg[k][e] = fmaf(dyv, round_to<T>(xh), dg[k][e]);
          dot = fmaf(g, xh, dot);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (a.wpr > 1) {  // the row's warps add their sums in a fixed order
      float* slot = red[gi][r & 1];
      if (lane == 0) slot[w] = dot;
      unit_barrier(1 + gi, G);
      dot = 0.f;
      for (int i = 0; i < a.wpr; ++i) dot += slot[i];
    }
    const float mean = dot / a.d;
    const long long off = static_cast<long long>(r) * a.d;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = t + k * G;
      if (j < nacc) {
        const R gk = gam(k, j);
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = A::get(xv[k], e) * rs;
          const float g = round_to<T>(A::get(yv[k], e) * A::get(gk, e));
          o[e] = rs * (g - xh * mean);
        }
        A::store(dx + off + j * VEC, o);
      }
    }
  };

  R xa[C], ya[C];
  float ra;
  if constexpr (C * sizeof(R) <= 64) {
    // rows in pairs, two register sets in turn (a copy between them would
    // wait for the loads it copies)
    R xb[C], yb[C];
    float rb;
    fetch(r0, xa, ya, ra);
    for (int r = r0; r < r1; r += 2) {
      if (r + 1 < r1) fetch(r + 1, xb, yb, rb);
      row(r, xa, ya, ra);
      if (r + 1 >= r1) break;
      if (r + 2 < r1) fetch(r + 2, xa, ya, ra);
      row(r + 1, xb, yb, rb);
    }
  } else {
    // a thread's share of a row above 64 bytes: one set, or it would spill
    for (int r = r0; r < r1; ++r) {
      fetch(r, xa, ya, ra);
      row(r, xa, ya, ra);
    }
  }
  allow_dependents();
  float* pr = a.part + static_cast<long long>(u) * a.ldp;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = t + k * G;
    if (j < nacc) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC; q += 4)
          *reinterpret_cast<float4*>(pr + j * VEC + q) =
              make_float4(dg[k][q], dg[k][q + 1], dg[k][q + 2], dg[k][q + 3]);
      } else {
        pr[j] = dg[k][0];
      }
    }
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// dgamma[col] = the sum of part[p, col] over the units p: block b takes
// columns [4 * strip * b, 4 * strip * (b + 1)); its thread (rg, c) adds rows
// rg, rg + groups, ... of its 4 columns in order, then the row groups are
// added by a shuffle tree inside each warp and the warps in order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_NT) rmsnorm_bwd_dgamma(
    const float* __restrict__ part, T* __restrict__ dgamma, int units, int d, int ldp,
    int strip) {
  __shared__ float4 red[COMBINE_NT / 32][32];
  const int c = threadIdx.x % strip, rg = threadIdx.x / strip, groups = COMBINE_NT / strip;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (blockIdx.x * strip + c) * 4;
  wait_for_prior_grid();
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d) {
#pragma unroll 4
    for (int p = rg; p < units; p += groups)
      add4(s, __ldcg(reinterpret_cast<const float4*>(part + static_cast<long long>(p) * ldp
                                                     + col)));
  }
  for (int o = 16; o >= strip; o >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if (lane < strip) red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && lane < strip && col < d) {
    float4 tot = red[0][lane];
#pragma unroll
    for (int i = 1; i < COMBINE_NT / 32; ++i) add4(tot, red[i][lane]);
    const float v[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < d) dgamma[col + e] = from_f<T>(v[e]);
  }
}

using FwdKernel = void (*)(const FwdArgs);

// the forward kernel for `chunks` accesses a thread a row: 1, 2, 4 or
// (fp32) 8 of 16 bytes, or 1-32 (powers of two) of one value; null for any
// other count
template <typename T>
FwdKernel fwd_kernel(bool vec, int chunks) {
  constexpr int VW = 16 / sizeof(T);
  if (vec) {
    switch (chunks) {
      case 1: return rmsnorm_fwd_kernel<T, VW, 1>;
      case 2: return rmsnorm_fwd_kernel<T, VW, 2>;
      case 4: return rmsnorm_fwd_kernel<T, VW, 4>;
      case 8:
        if constexpr (VW == 4) return rmsnorm_fwd_kernel<T, VW, 8>;
    }
    return nullptr;
  }
  switch (chunks) {
    case 1: return rmsnorm_fwd_kernel<T, 1, 1>;
    case 2: return rmsnorm_fwd_kernel<T, 1, 2>;
    case 4: return rmsnorm_fwd_kernel<T, 1, 4>;
    case 8: return rmsnorm_fwd_kernel<T, 1, 8>;
    case 16: return rmsnorm_fwd_kernel<T, 1, 16>;
    case 32: return rmsnorm_fwd_kernel<T, 1, 32>;
  }
  return nullptr;
}

FwdKernel fwd_kernel(int dtype, bool vec, int chunks) {
  if (dtype == 0) return fwd_kernel<float>(vec, chunks);
  if (dtype == 1) return fwd_kernel<__nv_bfloat16>(vec, chunks);
  return nullptr;
}

using RowsKernel = void (*)(const BwdArgs);

// the rows kernel for `chunks` accesses a thread a row: 1, 2, 4 or (fp32)
// 8 of 16 bytes, or 2, 8 or 32 of one value; null for any other count
template <typename T>
RowsKernel rows_kernel(bool vec, int chunks) {
  constexpr int VW = 16 / sizeof(T);
  if (vec) {
    switch (chunks) {
      case 1: return rmsnorm_bwd_rows<T, VW, 1>;
      case 2: return rmsnorm_bwd_rows<T, VW, 2>;
      case 4: return rmsnorm_bwd_rows<T, VW, 4>;
      case 8:
        if constexpr (VW == 4) return rmsnorm_bwd_rows<T, VW, 8>;
    }
    return nullptr;
  }
  switch (chunks) {
    case 2: return rmsnorm_bwd_rows<T, 1, 2>;
    case 8: return rmsnorm_bwd_rows<T, 1, 8>;
    case 32: return rmsnorm_bwd_rows<T, 1, 32>;
  }
  return nullptr;
}

RowsKernel rows_kernel(int dtype, bool vec, int chunks) {
  if (dtype == 0) return rows_kernel<float>(vec, chunks);
  if (dtype == 1) return rows_kernel<__nv_bfloat16>(vec, chunks);
  return nullptr;
}

// kern<<<grid, block, 0, s>>>(args...), as a programmatic dependent launch
template <typename... Args>
cudaError_t launch_after(void (*kern)(Args...), dim3 grid, dim3 block, cudaStream_t s,
                         Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x, y [n, d] and gamma [d]
// contiguous in one dtype; rstd [n] fp32, or null when no backward follows.
// The grid is the wrapper's plan (fwd_plan in kernels/rmsnorm.py): vec 1
// for one-value accesses, else 16 / sizeof(T) (d a multiple of it, x,
// gamma and y 16-byte aligned); lanes a group (a power of two up to 256),
// chunks accesses a thread a row, gpb groups a block (lanes * gpb a
// multiple of 32 up to 256: whole warps); one row a group, so ceil(n /
// gpb) blocks.  One launch; anything else is refused before it.  Returns a
// cudaError_t (0 = launched).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* gamma, void* y,
                           void* rstd, int n, int d, float eps, int vec, int lanes,
                           int chunks, int gpb, void* stream) {
  const int es = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (es == 0 || n <= 0 || d <= 0 || d > MAX_D) return cudaErrorInvalidValue;
  if (vec != 1 && !(vec == 16 / es && d % vec == 0 && aligned16(x) && aligned16(gamma)
                    && aligned16(y)))
    return cudaErrorInvalidValue;
  const FwdKernel kern = fwd_kernel(dtype, vec != 1, chunks);
  if (kern == nullptr || lanes < 1 || lanes > FWD_NT || (lanes & (lanes - 1)) != 0
      || gpb < 1 || lanes * gpb > FWD_NT || lanes * gpb % 32 != 0
      || static_cast<long long>(chunks) * lanes * vec < d)
    return cudaErrorInvalidValue;
  const FwdArgs a = {x, gamma, y, static_cast<float*>(rstd), n, d, eps, lanes, gpb};
  kern<<<(n + gpb - 1) / gpb, lanes * gpb, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Blocks per SM of the forward kernel at a plan's (dtype, vec, chunks,
// lanes, gpb), as the CUDA runtime's occupancy calculator gives them.
extern "C" int rmsnorm_fwd_occupancy(int dtype, int vec, int chunks, int lanes, int gpb,
                                     int* blocks) {
  const FwdKernel kern = fwd_kernel(dtype, vec != 1, chunks);
  if (kern == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, lanes * gpb, 0);
}

// dx [n, d] and dgamma [d] in x's dtype from the forward's rstd [n]; part is
// fp32 scratch [units, ldp].  The grid is the wrapper's plan (bwd_plan in
// kernels/rmsnorm.py): vec 1 for one-value accesses, else 16 / sizeof(T)
// (d a multiple of it, x, gamma, dy and dx 16-byte aligned); wpr warps a
// unit, upb units a block (wpr * upb <= 8), chunks accesses a thread a row,
// rpu rows a unit, units = ceil(n / rpu) units in blocks = ceil(units / upb)
// blocks; ldp >= d a multiple of 4; strip 4-column groups a combine block (a
// power of two up to 32).  Two launches on one stream; anything else is
// refused before either.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* gamma, const void* dy,
                           const void* rstd, void* dx, void* dgamma, void* part, int n,
                           int d, int vec, int wpr, int chunks, int upb, int rpu, int units,
                           int blocks, int ldp, int strip, void* stream) {
  const int es = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (es == 0 || n <= 0 || d <= 0 || d > MAX_D) return cudaErrorInvalidValue;
  if (vec != 1 && !(vec == 16 / es && d % vec == 0 && aligned16(x) && aligned16(gamma)
                    && aligned16(dy) && aligned16(dx)))
    return cudaErrorInvalidValue;
  const RowsKernel kern = rows_kernel(dtype, vec != 1, chunks);
  if (kern == nullptr || (wpr & (wpr - 1)) != 0 || wpr < 1 || upb < 1
      || wpr * upb > BWD_NT / 32 || static_cast<long long>(chunks) * 32 * wpr * vec < d
      || rpu < 1 || units != (n + rpu - 1) / rpu || blocks != (units + upb - 1) / upb
      || ldp < d || ldp % 4 != 0 || !aligned16(part) || strip < 1 || strip > 32
      || (strip & (strip - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a = {x, gamma, dy, static_cast<const float*>(rstd), dx,
                     static_cast<float*>(part), n, d, ldp, wpr, upb, rpu, units};
  kern<<<blocks, 32 * wpr * upb, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((ldp / 4 + strip - 1) / strip);
  const float* pc = static_cast<const float*>(part);
  e = dtype == 0 ? launch_after(rmsnorm_bwd_dgamma<float>, grid, dim3(COMBINE_NT), s, pc,
                                static_cast<float*>(dgamma), units, d, ldp, strip)
                 : launch_after(rmsnorm_bwd_dgamma<__nv_bfloat16>, grid, dim3(COMBINE_NT), s,
                                pc, static_cast<__nv_bfloat16*>(dgamma), units, d, ldp, strip);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Blocks per SM of the rows kernel at a plan's (dtype, vec, chunks, wpr,
// upb), as the CUDA runtime's occupancy calculator gives them.
extern "C" int rmsnorm_bwd_occupancy(int dtype, int vec, int chunks, int wpr, int upb,
                                     int* blocks) {
  const RowsKernel kern = rows_kernel(dtype, vec != 1, chunks);
  if (kern == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, 32 * wpr * upb, 0);
}
