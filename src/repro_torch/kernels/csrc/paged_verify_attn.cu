// Paged speculative-verify attention for Hopper (sm_90a), plain C interface:
// K2 (dense walk of the block table) and K3 (ragged walk of the live
// blocks), one source, one tile math.
//
// Replaces the TPU kernels `paged_verify_attn_pallas` (K2) and
// `ragged_paged_verify_attn_pallas` (K3) of
// src/repro/kernels/paged_verify_attn.py, with the q folding of `_fold_q`.
// Both compute GQA attention of T query rows per slot against the shared
// paged KV pool
//   k/v [NB, bs, KVH, hd], pos [NB, bs] (absolute position, -1 unwritten),
// read through the slot's row of the block table bt [B, MAXB] (-1 unused),
// masked by absolute position as `_flash_tile` / `_tile_visible` do: key
// row j is visible to a query at position qp iff
//   0 <= pos[j] <= qp  and  pos[j] > qp - window    (window optional)
//   or 0 <= pos[j] < prefix_len.
// Softmax runs online in fp32; a row that sees nothing outputs zeros.
//
// The two differ only in how a block learns which pool blocks to visit:
//   * K2 walks all MAXB entries of its table row in logical order and skips
//     the -1 entries (dead loop iterations);
//   * K3 reads cu_blocks [B + 1] on the device (per-slot steps
//     max(live, 1), from kernels/tuning.py `host_cu_blocks`), compacts its
//     row's live entries in ascending logical order with one warp ballot
//     per 32 entries, and takes exactly cu[b+1] - cu[b] steps; an empty
//     slot's single step is dead and its rows come out as zeros.  The
//     launch is sized from B, KVH and T alone, so the host never reads
//     cu_blocks and the launch shape never depends on the data.
// Both then feed the same sequence of live, visible blocks, in ascending
// logical order, into the same tile math with the same grouping (BK / bs
// blocks per shared-memory tile), so K3 is bit-identical to K2 on every
// pattern of raggedness.
//
// What bounds it on an H100: bytes.  A verify step's T = s + 1 <= 9 rows
// per slot use every K/V byte for a handful of dot products, far below the
// ~295 operations per byte where the tensor cores would be the limit.
// What the design does about it:
//   * one block owns one (slot, kv-head, query tile) and folds the G query
//     heads of that kv-head into its rows (row g*T + t), so each pool block
//     is read from device memory once for all G heads; q is read in place,
//     no folded or padded copy of it is made;
//   * pool blocks are read in place through the table and strides, with no
//     gathered [B, MAXB*bs, ...] view;
//   * a pool block that no query row of the block can see is skipped before
//     its K/V is loaded (the TPU kernel's `_tile_visible`; numerically free,
//     such a block would leave every row's state unchanged).
// This first version uses plain fp32 FMA from shared memory; wgmma, TMA and
// split-KV over long tables are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int BK = 64;   // key rows per shared-memory tile (BK / bs pool blocks)
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* pos;
  const int* bt;
  const int* cu;           // K3 only
  const void* k_scale;
  const void* v_scale;
  void* out;
  int B, T, H, KVH, bs, MAXB;
  long long q_sb, q_st;    // q strides over (b, t); heads and hd contiguous
  long long k_sn, k_sl;    // pool strides over (block, row); kv-heads and hd contiguous
  long long v_sn, v_sl;
  long long s_sn, s_sl;    // scale strides over (block, row); kv-heads contiguous
  long long qp_sb, pos_sn, bt_sb;
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
  // Qs [BQ][HD], Ks [BK][HD+4], Vs [BK][HD], Ps [BQ][BK], M/L/C [BQ] floats;
  // QP [BQ], KP [BK] and the tile's block ids TB [BK] ints (K3 appends its
  // compacted table row, MAXB ints)
  return sizeof(float) * (BQ * HD + BK * (HD + 4) + BK * HD + BQ * BK + 3 * BQ) +
         sizeof(int) * (BQ + 2 * BK);
}

// QT: query / output type; KT: pool type (QT, or int8_t with ST scales).
template <typename QT, typename KT, typename ST, int HD, int BQ, bool RAGGED>
__global__ void __launch_bounds__(NT) paged_verify_kernel(const Params p) {
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
  int* TB = KP + BK;
  int* LB = TB + BK;
  __shared__ int n_live;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = blockIdx.x * BQ;
  const int nr = min(BQ, G * p.T - r0);
  const int bs = p.bs;
  const int* bt_row = p.bt + b * p.bt_sb;

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
  int steps = p.MAXB;
  if constexpr (RAGGED) {
    // compact the row's live entries, ascending logical order
    if (tid < 32) {
      int n = 0;
      for (int j0 = 0; j0 < p.MAXB; j0 += 32) {
        const int j = j0 + tid;
        const int e = j < p.MAXB ? bt_row[j] : -1;
        const unsigned m = __ballot_sync(0xffffffffu, e >= 0);
        if (e >= 0) LB[n + __popc(m & ((1u << tid) - 1u))] = e;
        n += __popc(m);
      }
      if (tid == 0) n_live = n;
    }
    steps = p.cu[b + 1] - p.cu[b];
  }
  __syncthreads();
  const int nlive = RAGGED ? n_live : 0;

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

  // Walk the slot's blocks in ascending logical order and gather the
  // visible ones BK / bs at a time into a tile; the pass after the last
  // step folds the partial tile.  One fold site: the accumulators stay in
  // registers.
  const int per_tile = BK / bs;
  int nt = 0;
  for (int step = 0; step <= steps; ++step) {
    const bool end = step == steps;
    if (!end) {
      int blk;
      if constexpr (RAGGED) blk = step < nlive ? LB[step] : -1;
      else blk = bt_row[step];
      if (blk < 0) continue;                 // K2: a hole; K3: an empty slot's step
      int vis = 0;
      if (tid < bs) {
        const int kp = p.pos[blk * p.pos_sn + tid];
        KP[nt * bs + tid] = kp;
        bool v = kp >= 0 && kp <= qhi;
        if (p.has_window) v = v && kp > qlo - p.window;
        if (p.prefix_len) v = v || (kp >= 0 && kp < p.prefix_len);
        vis = v;
      }
      if (!__syncthreads_or(vis)) continue;
      if (tid == 0) TB[nt] = blk;
      ++nt;
    }
    if (nt == 0 || (nt < per_tile && !end)) continue;

    // fold the nt pool blocks TB[0..nt) (tile row j = i*bs + off) into the state
    __syncthreads();                         // TB and KP of the tile are set
    const int rows = nt * bs;
    if (tid >= rows && tid < BK) KP[tid] = -1;
    for (int e = tid; e < BK * HD; e += NT) {
      const int j = e / HD, d = e % HD;
      float kx = 0.f, vx = 0.f;
      if (j < rows) {
        const long long blk = TB[j / bs];
        const int off = j % bs;
        kx = to_f(kg[blk * p.k_sn + off * p.k_sl + kvh * HD + d]);
        vx = to_f(vg[blk * p.v_sn + off * p.v_sl + kvh * HD + d]);
        if constexpr (QUANT) {
          const long long so = blk * p.s_sn + off * p.s_sl + kvh;
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
    nt = 0;
  }
  __syncthreads();                           // Lr of the last tile (or of the init)

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

template <typename QT, typename KT, typename ST, int HD, int BQ, bool RAGGED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, BQ>() + (RAGGED ? sizeof(int) * p.MAXB : 0);
  auto kern = paged_verify_kernel<QT, KT, ST, HD, BQ, RAGGED>;
  // above 48 KB only as opted-in dynamic shared memory, raised per device
  // to the largest size asked for so far
  static size_t configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured[dev] = smem;
  }
  const dim3 grid((p.T * (p.H / p.KVH) + BQ - 1) / BQ, p.KVH, p.B);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, typename ST, int HD, bool RAGGED>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  // verify calls have few folded rows: a 16-row tile wastes less
  if (p.T * (p.H / p.KVH) <= 16) return launch<QT, KT, ST, HD, 16, RAGGED>(p, stream);
  return launch<QT, KT, ST, HD, 64, RAGGED>(p, stream);
}

template <typename QT, typename KT, typename ST, bool RAGGED>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_rows<QT, KT, ST, 64, RAGGED>(p, stream);
  if (hd == 128) return launch_rows<QT, KT, ST, 128, RAGGED>(p, stream);
  return cudaErrorInvalidValue;
}

template <bool RAGGED>
int dispatch(int q_dtype, int kv_dtype, const Params& p, int hd, void* stream) {
  if (p.B <= 0 || p.T <= 0 || p.MAXB <= 0 || p.KVH <= 0 || p.H % p.KVH != 0 ||
      p.bs <= 0 || p.bs > BK || BK % p.bs != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_hd<float, float, float, RAGGED>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_hd<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, RAGGED>(p, hd, s);
  if (q_dtype == 0 && kv_dtype == 2) return launch_hd<float, int8_t, float, RAGGED>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_hd<__nv_bfloat16, int8_t, __nv_bfloat16, RAGGED>(p, hd, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  Scales take the query
// dtype.  `cu` is read only when `ragged` is set (K3); K2 passes null.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_verify_attn(
    int ragged, int q_dtype, int kv_dtype, const void* q, const void* k,
    const void* v, const void* q_pos, const void* pos, const void* bt,
    const void* cu, const void* k_scale, const void* v_scale, void* out,
    int B, int T, int H, int KVH, int bs, int MAXB, int hd,
    long long q_sb, long long q_st, long long k_sn, long long k_sl,
    long long v_sn, long long v_sl, long long s_sn, long long s_sl,
    long long qp_sb, long long pos_sn, long long bt_sb, float scale,
    int has_window, int window, int prefix_len, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.pos = static_cast<const int*>(pos);
  p.bt = static_cast<const int*>(bt);
  p.cu = static_cast<const int*>(cu);
  p.k_scale = k_scale; p.v_scale = v_scale; p.out = out;
  p.B = B; p.T = T; p.H = H; p.KVH = KVH; p.bs = bs; p.MAXB = MAXB;
  p.q_sb = q_sb; p.q_st = q_st; p.k_sn = k_sn; p.k_sl = k_sl;
  p.v_sn = v_sn; p.v_sl = v_sl; p.s_sn = s_sn; p.s_sl = s_sl;
  p.qp_sb = qp_sb; p.pos_sn = pos_sn; p.bt_sb = bt_sb;
  p.scale = scale; p.has_window = has_window; p.window = window;
  p.prefix_len = prefix_len;
  if (ragged) {
    if (cu == nullptr) return cudaErrorInvalidValue;
    return dispatch<true>(q_dtype, kv_dtype, p, hd, stream);
  }
  return dispatch<false>(q_dtype, kv_dtype, p, hd, stream);
}
