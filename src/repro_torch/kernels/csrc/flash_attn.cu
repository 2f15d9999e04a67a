// Position-masked flash attention for Hopper (sm_90a), forward and
// backward, plain C interface.
//
// Replaces the TPU kernel `flash_attn_pallas` (src/repro/kernels/flash_attn.py,
// body `_flash_kernel`) with the head folding of its wrapper
// `ops.flash_attn` (src/repro/kernels/ops.py), and the jnp attention the
// JAX model trains and prefills with (`flash_attention_train`,
// `flash_attention_tri` in src/repro/models/common.py): GQA attention of T
// query rows against L key rows, masked by absolute position.  Key row j is
// visible to a query at position qp iff
//   0 <= kpos[j] <= qp  and  kpos[j] > qp - window    (window optional)
//   or 0 <= kpos[j] < prefix_len.
// Softmax is in fp32; a fully masked query row outputs zeros and a
// logsumexp of -inf.  The backward is FlashAttention-2's: with the forward's
// logsumexp it recomputes P = exp(S - lse) tile by tile, D = rowsum(dO * O),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K * scale,  dK = dS^T Q * scale,
// in two kernels so that no sum crosses blocks and nothing needs atomics
// (the gradients do not change from run to run):
//   * the dQ kernel, one block per (b, kv-head, q-tile), loops over the key
//     tiles its queries see; it also writes D for the second kernel;
//   * the dK/dV kernel, one block per (b, kv-head, k-tile), loops over the
//     query tiles that see its keys; its rows fold the G query heads of the
//     kv-head, so dK and dV sum over the group inside the block.
//
// What bounds it on an H100: at the training shapes (T = 128, hd 64-128)
// operations, not bytes: a (q-tile, k-tile) pair does 64 x 64 x hd x 2 FMA
// for 2 x 64 x hd elements loaded.  This first version runs them as fp32
// FMA from shared memory, not on the tensor cores, so it sits far above
// that bound; what the design does:
//   * q, k and v are read in their [B, T, heads, hd] layout through strides,
//     with no folded copy;
//   * one block folds the G query heads of a kv-head into its rows
//     (row g*T + t), so each K/V tile is read once for all G heads;
//   * a tile pair that no (query, key) pair of it can see is skipped before
//     it is loaded (the causal upper triangle, tiles outside the window),
//     so causal attention does about half the square's work;
//   * ragged tails (T or L not a multiple of 64) are masked in the kernel.
// wgmma or mma.sync tiles, TMA and a multi-stage pipeline are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NT_F = 128;  // forward threads per block
constexpr int NT_B = 256;  // backward threads per block
constexpr int BQ = 64;     // folded query rows per tile
constexpr int BK = 64;     // key rows per tile
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;          // forward output [B, T, H, hd], contiguous
  float* lse;         // [B, H, T] fp32, or null (forward without a backward)
  const void* o;      // backward: the forward's output, contiguous
  const void* dout;   // backward: dL/d out, contiguous
  float* dsum;        // backward: D = rowsum(dO * O), [B, H, T] fp32 scratch
  void* dq;           // [B, T, H, hd], contiguous
  void* dk;           // [B, L, KVH, hd], contiguous
  void* dv;
  int B, T, H, KVH, L;
  long long q_sb, q_st;    // q strides over (b, t); heads and hd contiguous
  long long k_sb, k_sl;    // k strides over (b, l); kv-heads and hd contiguous
  long long v_sb, v_sl;
  long long qp_sb, kp_sb;  // position strides over b; t / l contiguous
  float scale;
  int has_window, window, prefix_len;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool o = kp >= 0 && kp <= qp;
  if (p.has_window) o = o && kp > qp - p.window;
  if (p.prefix_len) o = o || (kp >= 0 && kp < p.prefix_len);
  return o;
}

// Could a key at kp be seen by some query of a tile whose valid positions
// span [qlo, qhi]?  Never false when one can (a tile it rejects is skipped).
__device__ __forceinline__ bool key_maybe_visible(const Params& p, int kp, int qlo, int qhi) {
  bool v = kp >= 0 && kp <= qhi;
  if (p.has_window) v = v && kp > qlo - p.window;
  if (p.prefix_len) v = v || (kp >= 0 && kp < p.prefix_len);
  return v;
}

// folded row fr = g*T + t of kv-head kvh: element offset of (b, t, head) in q
__device__ __forceinline__ long long q_off(const Params& p, int b, int kvh, int fr, int HD) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return b * p.q_sb + t * p.q_st + static_cast<long long>(kvh * G + g) * HD;
}

// the same row in a contiguous [B, T, H, hd] tensor (out, o, dout, dq)
__device__ __forceinline__ long long o_off(const Params& p, int b, int kvh, int fr, int HD) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return ((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * HD;
}

// the row's index in a [B, H, T] fp32 array (lse, dsum)
__device__ __forceinline__ long long row_idx(const Params& p, int b, int kvh, int fr) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return (static_cast<long long>(b) * p.H + kvh * G + g) * p.T + t;
}

// Stage the K and V rows [j0, j0 + BK) of kv-head kvh in fp32 (rows past L
// are zeros), each row padded to KS floats; KP gets their positions (-1
// past L) when not null.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_kv(const Params& p, int b, int kvh, int j0, float* Ks,
                                        float* Vs, int* KP) {
  constexpr int KS = HD + 4;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  for (int e = threadIdx.x; e < BK * HD; e += NT) {
    const int j = e / HD, d = e % HD, jj = j0 + j;
    float kx = 0.f, vx = 0.f;
    if (jj < p.L) {
      kx = to_f(kg[b * p.k_sb + jj * p.k_sl + kvh * HD + d]);
      vx = to_f(vg[b * p.v_sb + jj * p.v_sl + kvh * HD + d]);
    }
    Ks[j * KS + d] = kx;
    Vs[j * KS + d] = vx;
  }
  if (KP != nullptr && threadIdx.x < BK) {
    const int jj = j0 + threadIdx.x;
    KP[threadIdx.x] = jj < p.L ? p.k_pos[b * p.kp_sb + jj] : -1;
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (q-tile, kv-head, b); online softmax over key tiles

template <int HD>
constexpr size_t fwd_smem() {
  // Qs [BQ][HD], Ks [BK][HD+4], Vs [BK][HD+4], Ps [BQ][BK], M/L/C [BQ]; QP, KP
  return sizeof(float) * (BQ * HD + 2 * BK * (HD + 4) + BQ * BK + 3 * BQ) +
         sizeof(int) * (BQ + BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT_F) fwd_kernel(const Params p) {
  constexpr int NT = NT_F;
  constexpr int KS = HD + 4;
  constexpr int SG = NT / BK;      // score-phase row groups
  constexpr int RSC = BQ / SG;     // score rows per thread
  constexpr int RS = NT / HD;      // PV-phase row groups
  constexpr int RA = BQ / RS;      // accumulator rows per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * KS;
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

  const T* q = static_cast<const T*>(p.q);
  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[e] = r < nr ? to_f(q[q_off(p, b, kvh, r0 + r, HD) + d]) : 0.f;
  }
  if (tid < BQ) {
    QP[tid] = tid < nr ? p.q_pos[b * p.qp_sb + (r0 + tid) % p.T] : -1;
    Mr[tid] = -INFINITY;
    Lr[tid] = 0.f;
  }
  __syncthreads();

  int qhi = -1, qlo = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    const int x = QP[r];
    qhi = max(qhi, x);
    if (x >= 0) qlo = min(qlo, x);
  }

  const int jc = tid % BK, sg = tid / BK;
  const int dc = tid % HD, rg = tid / HD;
  const int warp = tid / 32, lane = tid % 32;
  float acc[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < p.L; j0 += BK) {
    int vis = 0;
    if (tid < BK) {
      const int j = j0 + tid;
      vis = key_maybe_visible(p, j < p.L ? p.k_pos[b * p.kp_sb + j] : -1, qlo, qhi);
    }
    if (!__syncthreads_or(vis)) continue;
    load_kv<T, HD, NT>(p, b, kvh, j0, Ks, Vs, KP);
    __syncthreads();

    {  // scores: thread (sg, jc) computes rows sg, sg+SG, ... against key jc
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
        ok[c] = visible(p, qp, KP[lane + 32 * c]);
        sv[c] = Ps[r * BK + lane + 32 * c];
        if (ok[c]) mt = fmaxf(mt, sv[c]);
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
      const float v0 = Vs[(j + 0) * KS + dc], v1 = Vs[(j + 1) * KS + dc];
      const float v2 = Vs[(j + 2) * KS + dc], v3 = Vs[(j + 3) * KS + dc];
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
    __syncthreads();
  }

  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = rg + i * RS;
    if (r < nr) o[o_off(p, b, kvh, r0 + r, HD) + dc] = from_f<T>(acc[i] / fmaxf(Lr[r], 1e-30f));
  }
  if (p.lse != nullptr && tid < nr) {
    const float l = Lr[tid];
    p.lse[row_idx(p, b, kvh, r0 + tid)] = l > 0.f ? Mr[tid] + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward, shared part: for one (q-tile, k-tile) pair, P and dS of every
// (row, key) from the staged Q, dO, K, V and the rows' lse and D.  Thread
// (sg, jc) computes rows sg, sg + SG, ... against key jc and hands each
// (r, jc, p, ds) to `put`.

template <int HD, typename Put>
__device__ __forceinline__ void pair_grads(const Params& p, const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs, const int* QP,
                                           const int* KP, const float* LSE, const float* Dr,
                                           Put put) {
  constexpr int KS = HD + 4;
  constexpr int SG = NT_B / BK;
  constexpr int RSC = BQ / SG;
  const int jc = threadIdx.x % BK, sg = threadIdx.x / BK;
  float s[RSC], dp[RSC];
#pragma unroll
  for (int i = 0; i < RSC; ++i) s[i] = dp[i] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(Ks + jc * KS);
  const float4* vr = reinterpret_cast<const float4*>(Vs + jc * KS);
#pragma unroll 2
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kx = kr[d4], vx = vr[d4];
#pragma unroll
    for (int i = 0; i < RSC; ++i) {
      const float4 qx = reinterpret_cast<const float4*>(Qs + (sg + i * SG) * HD)[d4];
      const float4 ox = reinterpret_cast<const float4*>(dOs + (sg + i * SG) * HD)[d4];
      s[i] = fmaf(qx.x, kx.x, s[i]);
      s[i] = fmaf(qx.y, kx.y, s[i]);
      s[i] = fmaf(qx.z, kx.z, s[i]);
      s[i] = fmaf(qx.w, kx.w, s[i]);
      dp[i] = fmaf(ox.x, vx.x, dp[i]);
      dp[i] = fmaf(ox.y, vx.y, dp[i]);
      dp[i] = fmaf(ox.z, vx.z, dp[i]);
      dp[i] = fmaf(ox.w, vx.w, dp[i]);
    }
  }
  const int kp = KP[jc];
#pragma unroll
  for (int i = 0; i < RSC; ++i) {
    const int r = sg + i * SG;
    const float lse = LSE[r];
    const bool ok = lse != -INFINITY && visible(p, QP[r], kp);
    const float pv = ok ? expf(s[i] * p.scale - lse) : 0.f;
    put(r, jc, pv, pv * (dp[i] - Dr[r]));
  }
}

// Stage a query tile for the backward: Q and dO rows in fp32 (zeros past
// nr), with each row's position, lse (-inf past nr) and, when `o` is given,
// D = rowsum(dO * O) computed here and written to dsum; otherwise D is read
// from dsum.
template <typename T, int HD>
__device__ __forceinline__ void load_q_tile(const Params& p, int b, int kvh, int r0, int nr,
                                            float* Qs, float* dOs, int* QP, float* LSE,
                                            float* Dr, bool make_d) {
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  for (int e = threadIdx.x; e < BQ * HD; e += NT_B) {
    const int r = e / HD, d = e % HD;
    float qx = 0.f, ox = 0.f;
    if (r < nr) {
      qx = to_f(q[q_off(p, b, kvh, r0 + r, HD) + d]);
      ox = to_f(dout[o_off(p, b, kvh, r0 + r, HD) + d]);
    }
    Qs[e] = qx;
    dOs[e] = ox;
  }
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    QP[r] = r < nr ? p.q_pos[b * p.qp_sb + (r0 + r) % p.T] : -1;
    LSE[r] = r < nr ? p.lse[row_idx(p, b, kvh, r0 + r)] : -INFINITY;
    if (!make_d) Dr[r] = r < nr ? p.dsum[row_idx(p, b, kvh, r0 + r)] : 0.f;
  }
  if (make_d) {
    __syncthreads();
    const T* o = static_cast<const T*>(p.o);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < BQ; r += NT_B / 32) {
      float acc = 0.f;
      if (r < nr) {
        const long long off = o_off(p, b, kvh, r0 + r, HD);
        for (int d = lane; d < HD; d += 32) acc = fmaf(dOs[r * HD + d], to_f(o[off + d]), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        Dr[r] = acc;
        if (r < nr) p.dsum[row_idx(p, b, kvh, r0 + r)] = acc;
      }
    }
  }
}

template <int HD>
constexpr size_t dq_smem() {
  // Qs, dOs [BQ][HD]; Ks, Vs [BK][HD+4]; dS [BQ][BK]; LSE, D [BQ]; QP [BQ], KP [BK]
  return sizeof(float) * (2 * BQ * HD + 2 * BK * (HD + 4) + BQ * BK + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// dQ: one block per (q-tile, kv-head, b)
template <typename T, int HD>
__global__ void __launch_bounds__(NT_B) dq_kernel(const Params p) {
  constexpr int KS = HD + 4;
  constexpr int RS = NT_B / HD;
  constexpr int RA = BQ / RS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * HD;
  float* Ks = dOs + BQ * HD;
  float* Vs = Ks + BK * KS;
  float* dS = Vs + BK * KS;
  float* LSE = dS + BQ * BK;
  float* Dr = LSE + BQ;
  int* QP = reinterpret_cast<int*>(Dr + BQ);
  int* KP = QP + BQ;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = blockIdx.x * BQ;
  const int nr = min(BQ, G * p.T - r0);
  load_q_tile<T, HD>(p, b, kvh, r0, nr, Qs, dOs, QP, LSE, Dr, true);
  __syncthreads();

  int qhi = -1, qlo = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    const int x = QP[r];
    qhi = max(qhi, x);
    if (x >= 0) qlo = min(qlo, x);
  }
  const int dc = tid % HD, rg = tid / HD;
  float acc[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < p.L; j0 += BK) {
    int vis = 0;
    if (tid < BK) {
      const int j = j0 + tid;
      vis = key_maybe_visible(p, j < p.L ? p.k_pos[b * p.kp_sb + j] : -1, qlo, qhi);
    }
    if (!__syncthreads_or(vis)) continue;
    load_kv<T, HD, NT_B>(p, b, kvh, j0, Ks, Vs, KP);
    __syncthreads();
    pair_grads<HD>(p, Qs, dOs, Ks, Vs, QP, KP, LSE, Dr,
                   [&](int r, int j, float, float ds) { dS[r * BK + j] = ds; });
    __syncthreads();
    // dQ += dS @ K
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      const float k0 = Ks[(j + 0) * KS + dc], k1 = Ks[(j + 1) * KS + dc];
      const float k2 = Ks[(j + 2) * KS + dc], k3 = Ks[(j + 3) * KS + dc];
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const float4 d4 = reinterpret_cast<const float4*>(dS + (rg + i * RS) * BK + j)[0];
        float a = acc[i];
        a = fmaf(d4.x, k0, a);
        a = fmaf(d4.y, k1, a);
        a = fmaf(d4.z, k2, a);
        a = fmaf(d4.w, k3, a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = rg + i * RS;
    if (r < nr) dq[o_off(p, b, kvh, r0 + r, HD) + dc] = from_f<T>(acc[i] * p.scale);
  }
}

template <int HD>
constexpr size_t dkv_smem() {
  // Ks, Vs [BK][HD+4]; Qs, dOs [BQ][HD]; P^T, dS^T [BK][BQ+4]; LSE, D [BQ]; QP, KP
  return sizeof(float) * (2 * BK * (HD + 4) + 2 * BQ * HD + 2 * BK * (BQ + 4) + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// dK, dV: one block per (k-tile, kv-head, b), over every query row of the
// group's G heads that sees one of its keys
template <typename T, int HD>
__global__ void __launch_bounds__(NT_B) dkv_kernel(const Params p) {
  constexpr int KS = HD + 4;
  constexpr int PS = BQ + 4;       // P^T row: float4 reads over query rows
  constexpr int RS = NT_B / HD;
  constexpr int RA = BK / RS;      // key rows per thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KS;
  float* Qs = Vs + BK * KS;
  float* dOs = Qs + BQ * HD;
  float* PT = dOs + BQ * HD;
  float* dST = PT + BK * PS;
  float* LSE = dST + BK * PS;
  float* Dr = LSE + BQ;
  int* QP = reinterpret_cast<int*>(Dr + BQ);
  int* KP = QP + BQ;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int j0 = blockIdx.x * BK;
  const int nk = min(BK, p.L - j0);
  load_kv<T, HD, NT_B>(p, b, kvh, j0, Ks, Vs, KP);
  __syncthreads();

  // the span of this tile's valid key positions, and whether one is a prefix key
  int klo = INT_MAX, khi = -1, kpre = 0;
  for (int j = 0; j < nk; ++j) {
    const int x = KP[j];
    if (x < 0) continue;
    klo = min(klo, x);
    khi = max(khi, x);
    kpre |= x < p.prefix_len;
  }
  const int dc = tid % HD, rg = tid / HD;
  float dk[RA], dv[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) dk[i] = dv[i] = 0.f;

  for (int r0 = 0; khi >= 0 && r0 < G * p.T; r0 += BQ) {
    const int nr = min(BQ, G * p.T - r0);
    int vis = 0;
    if (tid < nr) {
      const int qp = p.q_pos[b * p.qp_sb + (r0 + tid) % p.T];
      vis = kpre || (klo <= qp && (!p.has_window || khi > qp - p.window));
    }
    if (!__syncthreads_or(vis)) continue;
    load_q_tile<T, HD>(p, b, kvh, r0, nr, Qs, dOs, QP, LSE, Dr, false);
    __syncthreads();
    pair_grads<HD>(p, Qs, dOs, Ks, Vs, QP, KP, LSE, Dr, [&](int r, int j, float pv, float ds) {
      PT[j * PS + r] = pv;
      dST[j * PS + r] = ds;
    });
    __syncthreads();
    // dV += P^T @ dO, dK += dS^T @ Q over the tile's query rows
#pragma unroll 1
    for (int r = 0; r < BQ; r += 4) {
      float o4[4], q4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o4[c] = dOs[(r + c) * HD + dc];
        q4[c] = Qs[(r + c) * HD + dc];
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int j = rg + i * RS;
        const float4 pp = reinterpret_cast<const float4*>(PT + j * PS + r)[0];
        const float4 dd = reinterpret_cast<const float4*>(dST + j * PS + r)[0];
        dv[i] = fmaf(pp.x, o4[0], fmaf(pp.y, o4[1], fmaf(pp.z, o4[2], fmaf(pp.w, o4[3], dv[i]))));
        dk[i] = fmaf(dd.x, q4[0], fmaf(dd.y, q4[1], fmaf(dd.z, q4[2], fmaf(dd.w, q4[3], dk[i]))));
      }
    }
    __syncthreads();
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int j = rg + i * RS;
    if (j < nk) {
      const long long off =
          ((static_cast<long long>(b) * p.L + j0 + j) * p.KVH + kvh) * HD + dc;
      dkg[off] = from_f<T>(dk[i] * p.scale);
      dvg[off] = from_f<T>(dv[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool* configured) {
  // above 48 KB only as opted-in dynamic shared memory, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_fwd(const Params& p, cudaStream_t s) {
  static bool configured[kMaxDevices] = {};
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t e = allow_smem(fwd_kernel<T, HD>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T * (p.H / p.KVH) + BQ - 1) / BQ, p.KVH, p.B);
  fwd_kernel<T, HD><<<grid, NT_F, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const Params& p, cudaStream_t s) {
  static bool conf_q[kMaxDevices] = {}, conf_kv[kMaxDevices] = {};
  constexpr size_t sq = dq_smem<HD>(), skv = dkv_smem<HD>();
  cudaError_t e = allow_smem(dq_kernel<T, HD>, sq, conf_q);
  if (e != cudaSuccess) return e;
  e = allow_smem(dkv_kernel<T, HD>, skv, conf_kv);
  if (e != cudaSuccess) return e;
  const dim3 gq((p.T * (p.H / p.KVH) + BQ - 1) / BQ, p.KVH, p.B);
  dq_kernel<T, HD><<<gq, NT_B, sq, s>>>(p);  // writes dsum, which dkv_kernel reads
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gkv((p.L + BK - 1) / BK, p.KVH, p.B);
  dkv_kernel<T, HD><<<gkv, NT_B, skv, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, bool backward, cudaStream_t s) {
  if (hd == 64) return backward ? launch_bwd<T, 64>(p, s) : launch_fwd<T, 64>(p, s);
  if (hd == 128) return backward ? launch_bwd<T, 128>(p, s) : launch_fwd<T, 128>(p, s);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* k_pos, int B, int T, int H, int KVH, int L, long long q_sb,
                   long long q_st, long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, long long qp_sb, long long kp_sb, float scale,
                   int has_window, int window, int prefix_len) {
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.B = B; p.T = T; p.H = H; p.KVH = KVH; p.L = L;
  p.q_sb = q_sb; p.q_st = q_st; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl; p.qp_sb = qp_sb; p.kp_sb = kp_sb;
  p.scale = scale; p.has_window = has_window; p.window = window;
  p.prefix_len = prefix_len;
  return p;
}

bool bad_shape(int B, int T, int H, int KVH, int L) {
  return B <= 0 || T <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  out [B, T, H, hd] contiguous;
// lse [B, H, T] fp32, or null.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, void* lse, int B, int T, int H, int KVH, int L, int hd,
    long long q_sb, long long q_st, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, long long qp_sb, long long kp_sb, float scale, int has_window,
    int window, int prefix_len, void* stream) {
  if (bad_shape(B, T, H, KVH, L)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, q_pos, k_pos, B, T, H, KVH, L, q_sb, q_st, k_sb, k_sl,
                         v_sb, v_sl, qp_sb, kp_sb, scale, has_window, window, prefix_len);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, hd, false, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, hd, false, s);
  return cudaErrorInvalidValue;
}

// o, dout, dq [B, T, H, hd] and dk, dv [B, L, KVH, hd] contiguous in q's
// dtype; lse from the forward; dsum [B, H, T] fp32 scratch.  Two launches
// on one stream (dQ, then dK/dV).
extern "C" int flash_attn_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, const void* k_pos, void* dsum,
    void* dq, void* dk, void* dv, int B, int T, int H, int KVH, int L, int hd,
    long long q_sb, long long q_st, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, long long qp_sb, long long kp_sb, float scale, int has_window,
    int window, int prefix_len, void* stream) {
  if (bad_shape(B, T, H, KVH, L)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, q_pos, k_pos, B, T, H, KVH, L, q_sb, q_st, k_sb, k_sl,
                         v_sb, v_sl, qp_sb, kp_sb, scale, has_window, window, prefix_len);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.o = o; p.dout = dout;
  p.dsum = static_cast<float*>(dsum);
  p.dq = dq; p.dk = dk; p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, hd, true, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, hd, true, s);
  return cudaErrorInvalidValue;
}
