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
// for 2 x 64 x hd elements loaded.  What the design does about it, both
// directions:
//   * q, k and v are read in their [B, T, heads, hd] layout through strides,
//     with no folded copy;
//   * one block folds the G query heads of a kv-head into its rows
//     (row g*T + t), so each K/V tile is read once for all G heads;
//   * a tile pair that no (query, key) pair of it can see is skipped before
//     it is loaded (the causal upper triangle, tiles outside the window),
//     so causal attention does about half the square's work;
//   * ragged tails (T or L not a multiple of the tile) are masked in the
//     kernel.
// The forward runs its products on the tensor cores (mma.sync: bf16, and
// fp32 as three tf32 products), warps owning rows, behind a double-buffered
// cp.async pipeline, at two (fp32) or four (bf16) blocks an SM at hd 128
// (its section below).  The backward still runs fp32 FMA from shared
// memory, far above the bound.
#include <climits>
#include <math.h>

#include "attn_tile.cuh"

namespace {

constexpr int NT_B = 256;  // backward threads per block
constexpr int BQ = 64;     // backward: folded query rows per tile
constexpr int BK = 64;     // backward: key rows per tile
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
// forward: one block of FWD_WARPS warps per (q-tile of FBQ folded rows,
// kv-head, b).  Each warp owns 16 folded rows and runs the whole key loop
// for them: S = Q K^T and O += P V are mma.sync tiles with fp32
// accumulators in registers, and the online softmax runs on the
// accumulator fragments (a row lives on the 4 lanes of a quad).  K/V tiles
// are double-buffered in shared memory by 16-byte cp.async copies, the next
// visible tile in flight while the current one computes.
//
// bf16: m16n8k16 with Q and K fragments by ldmatrix and V by
// ldmatrix.trans; P is packed to bf16 in registers and fed back as the A
// operand of P V.
// fp32: m16n8k8 tf32 as three products per tile, big*big + big*small +
// small*big with big = tf32(x), small = tf32(x - big) (about 21 bits;
// one tf32 product keeps 10 and misses the fp32 tolerance).  The k index
// of Q K^T is permuted within each step of 8 (slot t <-> d 2t, slot t+4 <->
// d 2t+1) so that each lane reads its A and B pairs as float2; P V takes
// the same permutation over keys, which is the layout the S accumulator
// already has, so P is split in registers and never leaves them.

constexpr int FWD_WARPS = 4;
constexpr int FWD_NT = 32 * FWD_WARPS;  // forward threads per block
constexpr int FBQ = 16 * FWD_WARPS;     // folded query rows per forward block

// key rows per tile, row padding (elements) of the Q/K and V tiles, and
// blocks an SM (registers and shared memory allow at hd 128).  The
// padding makes the fragment loads free of bank conflicts: fp32 Q/K rows
// at 8 mod 32 words (float2 per lane), fp32 V rows at 4 mod 16 words (rows
// 2t and 2t+1 per lane), bf16 rows at 4 mod 32 words (ldmatrix).  bf16
// reads its Q fragments from shared memory at each step and runs four
// blocks an SM, within 128 registers a thread: more warps to cover the
// latency between a tile's softmax and its products.
template <typename T> struct Fwd;
template <> struct Fwd<float> {
  static constexpr int BK = 32, PADK = 8, PADV = 4, MIN_BLOCKS = 2;
};
template <> struct Fwd<__nv_bfloat16> {
  static constexpr int BK = 32, PADK = 8, PADV = 8, MIN_BLOCKS = 4;
};

template <typename T, int HD>
constexpr size_t fwd_smem() {
  // Qs [FBQ][HD+PADK], Ks [2][BK][HD+PADK], Vs [2][BK][HD+PADV], KP [2][BK]
  return sizeof(T) * ((FBQ + 2 * Fwd<T>::BK) * (HD + Fwd<T>::PADK) +
                      2 * Fwd<T>::BK * (HD + Fwd<T>::PADV)) +
         sizeof(int) * 2 * Fwd<T>::BK;
}

// key tiles tested per round trip of next_tile (attn_tile.cuh)
constexpr int SCAN = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(FWD_NT, Fwd<T>::MIN_BLOCKS) fwd_kernel(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int BK = Fwd<T>::BK;
  constexpr int RK = HD + Fwd<T>::PADK;  // Q and K row stride (elements)
  constexpr int RV = HD + Fwd<T>::PADV;  // V row stride
  constexpr int EPC = 16 / sizeof(T);    // elements per 16-byte copy
  constexpr int CPR = HD / EPC;          // copies per row
  constexpr int NS = BK / 8;             // n8 tiles of a score row
  constexpr int NO = HD / 8;             // n8 tiles of an output row

  extern __shared__ __align__(16) unsigned char fwd_smem_raw[];
  T* Qs = reinterpret_cast<T*>(fwd_smem_raw);
  T* Ks = Qs + FBQ * RK;
  T* Vs = Ks + 2 * BK * RK;
  int* KP = reinterpret_cast<int*>(Vs + 2 * BK * RV);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, lane in quad
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  // the last row tiles, which see the most keys under a causal mask, first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * FBQ;
  const int nr = min(FBQ, G * p.T - r0);
  const int ntiles = (p.L + BK - 1) / BK;
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  // each thread copies 16-byte chunk c of rows jr, jr + RPC, ...
  constexpr int RPC = FWD_NT / CPR;  // rows per pass of the block
  static_assert(FWD_NT % CPR == 0 && BK % RPC == 0 && FBQ % RPC == 0, "copy layout");
  const int c = tid % CPR, jr = tid / CPR;

  // Q, once, zeros past nr
#pragma unroll
  for (int i = 0; i < FBQ / RPC; ++i) {
    const int r = jr + i * RPC;
    const bool ok = r < nr;
    cp_async16(Qs + r * RK + c * EPC, qg + (ok ? q_off(p, b, kvh, r0 + r, HD) : 0) + c * EPC,
               ok);
  }
  cp_async_commit();

  // positions of this lane's two fragment rows, and the span of the block's
  // valid positions (every warp computes the same)
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    qp[h] = r < nr ? p.q_pos[b * p.qp_sb + (r0 + r) % p.T] : -1;
  }
  int qhi = -1, qlo = INT_MAX, qmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < FBQ / 32; ++i) {
    const int r = lane + 32 * i;
    if (r >= nr) break;
    const int x = p.q_pos[b * p.qp_sb + (r0 + r) % p.T];
    qhi = max(qhi, x);
    qmin = min(qmin, x);
    if (x >= 0) qlo = min(qlo, x);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, sh));
    qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, sh));
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, sh));
  }

  // K/V rows [jt*BK, jt*BK + BK) and their positions into stage st; rows
  // past L are zeros (V must be finite where P is 0) at position -1
  const T* kc = kg + b * p.k_sb + kvh * HD + c * EPC;
  const T* vc = vg + b * p.v_sb + kvh * HD + c * EPC;
  const long long k_step = RPC * p.k_sl, v_step = RPC * p.v_sl;
  auto load_tile = [&](int jt, int st) {
    const int j0 = jt * BK + jr;
    const T* kr = kc + j0 * p.k_sl;
    const T* vr = vc + j0 * p.v_sl;
    T* ks = Ks + st * BK * RK + jr * RK + c * EPC;
    T* vs = Vs + st * BK * RV + jr * RV + c * EPC;
#pragma unroll
    for (int i = 0; i < BK / RPC; ++i) {
      const bool ok = j0 + i * RPC < p.L;
      cp_async16(ks + i * RPC * RK, ok ? kr : kg, ok);
      cp_async16(vs + i * RPC * RV, ok ? vr : vg, ok);
      kr += k_step;
      vr += v_step;
    }
    if (tid < BK) {
      const int jj = jt * BK + tid;
      if (jj < p.L)
        cp_async4(KP + st * BK + tid, p.k_pos + b * p.kp_sb + jj);
      else
        KP[st * BK + tid] = -1;
    }
  };

  TileScan scan = {-SCAN, 0u, 0u};
  bool full;
  int jt = next_tile<BK, SCAN>(p, b, 0, ntiles, qmin, qlo, qhi, lane, scan, full);
  if (jt < ntiles) load_tile(jt, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  const T* qw = Qs + warp * 16 * RK;

  for (int st = 0; jt < ntiles; st ^= 1) {
    bool full_n;
    const int jn = next_tile<BK, SCAN>(p, b, jt + 1, ntiles, qmin, qlo, qhi, lane, scan, full_n);
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with stage st^1
    if (jn < ntiles) load_tile(jn, st ^ 1);
    cp_async_commit();
    const T* ks = Ks + st * BK * RK;
    const T* vs = Vs + st * BK * RV;
    const int* kp = KP + st * BK;

    // S = Q K^T: element e of tile n is row g + 8*(e/2), key 8n + 2*tig + e%2
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * RK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RK + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int d = kk * 8 + 2 * tig;
        const float2 q0 = *reinterpret_cast<const float2*>(qw + g * RK + d);
        const float2 q1 = *reinterpret_cast<const float2*>(qw + (g + 8) * RK + d);
        uint32_t ab[4], as[4];
        split_tf32(q0.x, ab[0], as[0]);
        split_tf32(q1.x, ab[1], as[1]);
        split_tf32(q0.y, ab[2], as[2]);
        split_tf32(q1.y, ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 kx = *reinterpret_cast<const float2*>(ks + (n * 8 + g) * RK + d);
          mma_3xtf32(s[n], ab, as, kx.x, kx.y);
        }
      }
    }

    // mask (unless every key of the tile is seen), online softmax on the
    // fragments; a row's max over its quad.  fp32 keeps m in scaled units
    // and uses expf; bf16 keeps m in raw units and folds the scale into
    // exp2 (one FFMA and one MUFU a score).
    const float sm = kBf16 ? 1.f : p.scale;
    float mt[2] = {-INFINITY, -INFINITY};
    if (full) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!kBf16) s[n][e] *= sm;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = visible(p, qp[e >> 1], kp[n * 8 + 2 * tig + (e & 1)])
                              ? s[n][e] * sm
                              : -INFINITY;
          s[n][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
    }
    const float c2 = p.scale * 1.4426950408889634f;  // bf16: scale * log2(e)
    float ms[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      ms[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = m[h] == -INFINITY ? 0.f
                                  : (kBf16 ? ex2((m[h] - ms[h]) * c2) : expf(m[h] - ms[h]));
      m[h] = m_new;
      l[h] *= corr[h];
      if (kBf16) ms[h] *= c2;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // 0 at masked keys (-inf)
        const float pv =
            kBf16 ? ex2(fmaf(s[n][e], c2, -ms[e >> 1])) : expf(s[n][e] - ms[e >> 1]);
        s[n][e] = pv;
        l[e >> 1] += pv;
      }
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RV + np * 16 +
                            (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        // A slot tig <-> key 8kk + 2tig, slot tig+4 <-> key 8kk + 2tig + 1
        uint32_t pb[4], ps[4];
        split_tf32(s[kk][0], pb[0], ps[0]);
        split_tf32(s[kk][2], pb[1], ps[1]);
        split_tf32(s[kk][1], pb[2], ps[2]);
        split_tf32(s[kk][3], pb[3], ps[3]);
        const T* v0 = vs + (kk * 8 + 2 * tig) * RV + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) mma_3xtf32(o[n], pb, ps, v0[n * 8], v0[RV + n * 8]);
      }
    }
    jt = jn;
    full = full_n;
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int r = warp * 16 + g + 8 * h;
    if (r >= nr) continue;
    const float den = fmaxf(lh, 1e-30f);
    T* orow = og + o_off(p, b, kvh, r0 + r, HD) + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) store2(orow + n * 8, o[n][2 * h] / den, o[n][2 * h + 1] / den);
    if (p.lse != nullptr && tig == 0)
      p.lse[row_idx(p, b, kvh, r0 + r)] =
          lh > 0.f ? (kBf16 ? m[h] * p.scale : m[h]) + logf(lh) : -INFINITY;
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
cudaError_t allow_smem(K kern, size_t bytes, bool* configured, int carveout = -1) {
  // above 48 KB only as opted-in dynamic shared memory, and the carveout
  // (percent of the SM's memory as shared) when one is given, set once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    if (carveout >= 0) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
      if (e != cudaSuccess) return e;
    }
    configured[dev] = true;
  }
  return cudaSuccess;
}

// the forward takes the largest carveout, room for Fwd<T>::MIN_BLOCKS blocks an SM
template <typename T, int HD>
cudaError_t fwd_attributes() {
  static bool configured[kMaxDevices] = {};
  return allow_smem(fwd_kernel<T, HD>, fwd_smem<T, HD>(), configured,
                    (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int HD>
cudaError_t fwd_occupancy(int* blocks, int* smem_bytes) {
  cudaError_t e = fwd_attributes<T, HD>();
  if (e != cudaSuccess) return e;
  *smem_bytes = (int)fwd_smem<T, HD>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fwd_kernel<T, HD>, FWD_NT,
                                                       fwd_smem<T, HD>());
}

template <typename T, int HD>
cudaError_t launch_fwd(const Params& p, cudaStream_t s) {
  cudaError_t e = fwd_attributes<T, HD>();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T * (p.H / p.KVH) + FBQ - 1) / FBQ, p.KVH, p.B);
  fwd_kernel<T, HD><<<grid, FWD_NT, fwd_smem<T, HD>(), s>>>(p);
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

// The forward's blocks per SM and dynamic shared memory per block at
// (dtype, hd), into *blocks and *smem_bytes: the runtime's occupancy
// calculator, which also counts register granularity and the carveout.
extern "C" int flash_attn_fwd_occupancy(int dtype, int hd, int* blocks, int* smem_bytes) {
  if (dtype == 0 && hd == 64) return fwd_occupancy<float, 64>(blocks, smem_bytes);
  if (dtype == 0 && hd == 128) return fwd_occupancy<float, 128>(blocks, smem_bytes);
  if (dtype == 1 && hd == 64) return fwd_occupancy<__nv_bfloat16, 64>(blocks, smem_bytes);
  if (dtype == 1 && hd == 128) return fwd_occupancy<__nv_bfloat16, 128>(blocks, smem_bytes);
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
