// Speculative-verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `spec_verify_attn_pallas`
// (src/repro/kernels/spec_verify_attn.py, body `_verify_kernel`) and the
// head folding of its wrapper `ops.spec_verify_attn`
// (src/repro/kernels/ops.py).  It computes GQA attention of T query rows per
// request against a contiguous ring cache, masked by absolute position:
// key row j is visible to a query at position qp iff
//   0 <= kpos[j] <= qp  and  kpos[j] > qp - window    (window optional)
//   or 0 <= kpos[j] < prefix_len.
// Softmax runs online in fp32; a fully masked query row outputs zeros.
//
// What bounds it on an H100: bytes.  At the verify shapes (T = s+1 <= 9
// rows per request) every K/V byte is used for a handful of dot products,
// far below the ~295 operations per byte where the tensor cores would be
// the limit; the target's verify reads 33.5 MB of K/V per layer at B = 8,
// L = 256, hd = 128, 32 kv-heads, bf16.  What the design does about it:
//   * it reads the cache in its [B, L, KVH, hd] layout through strides, so
//     no folded copy of K/V is made per call (the TPU wrapper transposes the
//     whole cache to [B*KVH, L, hd] first);
//   * one block owns one (request, kv-head, query tile) and folds the G
//     query heads of that kv-head into its rows (row g*T + t), so each K/V
//     tile is read from device memory once for all G heads;
//   * a K/V tile that no query row of the block can see is skipped before
//     it is loaded, as the TPU kernel's `@pl.when(vis.any())` skips it
//     (numerically free: such a tile leaves every row's state unchanged);
//   * the ragged cache tail is masked in the kernel (no padding copy) and
//     query tiles of up to 64 folded rows go on a grid axis, so prompt-long
//     prefill calls do not have to fit in one block.
// This first version uses plain fp32 FMA from shared memory; wgmma, TMA and
// a multi-stage pipeline are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  const void* k_scale;
  const void* v_scale;
  void* out;
  int B, T, H, KVH, L;
  long long q_sb, q_st;    // q strides over (b, t); heads and hd contiguous
  long long k_sb, k_sl;    // k strides over (b, l); kv-heads and hd contiguous
  long long v_sb, v_sl;
  long long s_sb, s_sl;    // scale strides over (b, l); kv-heads contiguous
  long long qp_sb, kp_sb;  // position strides over b; t / l contiguous
  float scale;
  int has_window, window, prefix_len;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int BQ>
constexpr size_t smem_bytes() {
  // Qs [BQ][HD], Ks [BK][HD+4], Vs [BK][HD], Ps [BQ][BK], M/L/C [BQ] floats,
  // QP [BQ] and KP [BK] ints
  return sizeof(float) * (BQ * HD + BK * (HD + 4) + BK * HD + BQ * BK + 3 * BQ) +
         sizeof(int) * (BQ + BK);
}

// QT: query / output type; KT: cache type (QT, or int8_t with ST scales).
template <typename QT, typename KT, typename ST, int HD, int BQ>
__global__ void __launch_bounds__(NT) verify_kernel(const Params p) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int KS = HD + 4;       // padded K row: float4 reads stay conflict-free
  constexpr int SG = NT / BK;      // score-phase row groups
  constexpr int RSC = BQ / SG;     // score rows per thread
  constexpr int RS = NT / HD;      // PV-phase row groups
  constexpr int RA = BQ / RS;      // accumulator rows per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * HD;
  float* Mr = Ps + BQ * BK;
  float* Lr = Mr + BQ;
  float* Cr = Lr + BQ;
  int* QP = reinterpret_cast<int*>(Cr + BQ);
  int* KP = QP + BQ;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = blockIdx.x * BQ;
  const int nr = min(BQ, G * p.T - r0);

  // query tile: folded row r0 + r = g*T + t holds head kvh*G + g at time t
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r < nr) {
      const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
      x = to_f(q[b * p.q_sb + t * p.q_st + static_cast<long long>(kvh * G + g) * HD + d]);
    }
    Qs[e] = x;
  }
  if (tid < BQ) {
    QP[tid] = tid < nr ? p.q_pos[b * p.qp_sb + (r0 + tid) % p.T] : -1;
    Mr[tid] = -INFINITY;
    Lr[tid] = 0.f;
  }
  __syncthreads();

  // tile-level visibility bounds (the TPU kernel's q_hi / q_lo)
  int qhi = -1, qlo = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    const int x = QP[r];
    qhi = max(qhi, x);
    if (x >= 0) qlo = min(qlo, x);
  }

  const int jc = tid % BK, sg = tid / BK;   // score phase: key column, row group
  const int dc = tid % HD, rg = tid / HD;   // PV phase: output column, row group
  const int warp = tid / 32, lane = tid % 32;
  float acc[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) acc[i] = 0.f;

  const KT* kg = static_cast<const KT*>(p.k);
  const KT* vg = static_cast<const KT*>(p.v);
  const ST* ksg = static_cast<const ST*>(p.k_scale);
  const ST* vsg = static_cast<const ST*>(p.v_scale);

  for (int j0 = 0; j0 < p.L; j0 += BK) {
    int vis = 0;
    if (tid < BK) {
      const int j = j0 + tid;
      const int kp = j < p.L ? p.k_pos[b * p.kp_sb + j] : -1;
      KP[tid] = kp;
      bool v = kp >= 0 && kp <= qhi;
      if (p.has_window) v = v && kp > qlo - p.window;
      if (p.prefix_len) v = v || (kp >= 0 && kp < p.prefix_len);
      vis = v;
    }
    if (!__syncthreads_or(vis)) continue;

    // stage the K/V tile in fp32 (int8 rows dequantized with their scales)
    for (int e = tid; e < BK * HD; e += NT) {
      const int j = e / HD, d = e % HD, jj = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (jj < p.L) {
        kx = to_f(kg[b * p.k_sb + jj * p.k_sl + kvh * HD + d]);
        vx = to_f(vg[b * p.v_sb + jj * p.v_sl + kvh * HD + d]);
        if constexpr (QUANT) {
          const long long so = b * p.s_sb + jj * p.s_sl + kvh;
          kx *= to_f(ksg[so]);
          vx *= to_f(vsg[so]);
        }
      }
      Ks[j * KS + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores: thread (sg, jc) computes rows sg, sg+SG, ... against key jc
    {
      float s[RSC];
#pragma unroll
      for (int i = 0; i < RSC; ++i) s[i] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(Ks + jc * KS);
#pragma unroll 4
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kx = kr[d4];
#pragma unroll
        for (int i = 0; i < RSC; ++i) {
          const float4 qx = reinterpret_cast<const float4*>(Qs + (sg + i * SG) * HD)[d4];
          s[i] = fmaf(qx.x, kx.x, s[i]);
          s[i] = fmaf(qx.y, kx.y, s[i]);
          s[i] = fmaf(qx.z, kx.z, s[i]);
          s[i] = fmaf(qx.w, kx.w, s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RSC; ++i) {
        const int r = sg + i * SG;
        if (r < nr) Ps[r * BK + jc] = s[i] * p.scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < nr; r += NT / 32) {
      const int qp = QP[r];
      float sv[2];
      bool ok[2];
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = KP[lane + 32 * c];
        bool o = kp >= 0 && kp <= qp;
        if (p.has_window) o = o && kp > qp - p.window;
        if (p.prefix_len) o = o || (kp >= 0 && kp < p.prefix_len);
        ok[c] = o;
        sv[c] = Ps[r * BK + lane + 32 * c];
        if (o) mt = fmaxf(mt, sv[c]);
      }
      mt = warp_max(mt);
      const float m_prev = Mr[r];
      const float m_new = fmaxf(m_prev, mt);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float pv = ok[c] ? expf(sv[c] - m_safe) : 0.f;
        Ps[r * BK + lane + 32 * c] = pv;
        ps += pv;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        Mr[r] = m_new;
        Lr[r] = Lr[r] * corr + ps;
        Cr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V; rows past nr compute garbage that is never stored
#pragma unroll
    for (int i = 0; i < RA; ++i) acc[i] *= Cr[rg + i * RS];
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      const float v0 = Vs[(j + 0) * HD + dc], v1 = Vs[(j + 1) * HD + dc];
      const float v2 = Vs[(j + 2) * HD + dc], v3 = Vs[(j + 3) * HD + dc];
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const float4 pr = reinterpret_cast<const float4*>(Ps + (rg + i * RS) * BK + j)[0];
        float a = acc[i];
        a = fmaf(pr.x, v0, a);
        a = fmaf(pr.y, v1, a);
        a = fmaf(pr.z, v2, a);
        a = fmaf(pr.w, v3, a);
        acc[i] = a;
      }
    }
  }

  QT* o = static_cast<QT*>(p.out);  // [B, T, H, HD], contiguous
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = rg + i * RS;
    if (r < nr) {
      const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
      const long long off =
          ((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * HD + dc;
      o[off] = from_f<QT>(acc[i] / fmaxf(Lr[r], 1e-30f));
    }
  }
}

template <typename QT, typename KT, typename ST, int HD, int BQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ>();
  auto kern = verify_kernel<QT, KT, ST, HD, BQ>;
  // above 48 KB only as opted-in dynamic shared memory, set once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const dim3 grid((p.T * (p.H / p.KVH) + BQ - 1) / BQ, p.KVH, p.B);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, typename ST, int HD>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  // decode and verify calls have few folded rows: a 16-row tile wastes less
  if (p.T * (p.H / p.KVH) <= 16) return launch<QT, KT, ST, HD, 16>(p, stream);
  return launch<QT, KT, ST, HD, 64>(p, stream);
}

template <typename QT, typename KT, typename ST>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_rows<QT, KT, ST, 64>(p, stream);
  if (hd == 128) return launch_rows<QT, KT, ST, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  Scales take the query
// dtype.  Returns a cudaError_t (0 = launched).
extern "C" int spec_verify_attn(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* k_scale, const void* v_scale,
    void* out, int B, int T, int H, int KVH, int L, int hd,
    long long q_sb, long long q_st, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long s_sb, long long s_sl,
    long long qp_sb, long long kp_sb, float scale, int has_window, int window,
    int prefix_len, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.k_scale = k_scale; p.v_scale = v_scale; p.out = out;
  p.B = B; p.T = T; p.H = H; p.KVH = KVH; p.L = L;
  p.q_sb = q_sb; p.q_st = q_st; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl; p.s_sb = s_sb; p.s_sl = s_sl;
  p.qp_sb = qp_sb; p.kp_sb = kp_sb;
  p.scale = scale; p.has_window = has_window; p.window = window;
  p.prefix_len = prefix_len;
  if (B <= 0 || T <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_hd<float, float, float>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_hd<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(p, hd, s);
  if (q_dtype == 0 && kv_dtype == 2) return launch_hd<float, int8_t, float>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_hd<__nv_bfloat16, int8_t, __nv_bfloat16>(p, hd, s);
  return cudaErrorInvalidValue;
}
