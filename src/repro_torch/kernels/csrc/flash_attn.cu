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
// q and k share one head dim (dk), v may have another (dv): the output and
// dO have dv, dQ and dK have dk.  The instantiated (dk, dv) pairs are (64,
// 64), (128, 128) and (192, 128), the last DeepSeek-V2's MLA attention
// (128 + 64 RoPE dims of q and k, 128 of v), and for the forward alone
// (256, 256), PaliGemma's heads; any other pair is an error.
// Softmax is in fp32; a fully masked query row outputs zeros and a
// logsumexp of -inf.  The backward is FlashAttention-2's: with the forward's
// logsumexp it recomputes P = exp(S - lse) tile by tile, D = rowsum(dO * O),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K * scale,  dK = dS^T Q * scale,
// in two kernels (and a combine where the dK/dV work is split), with no
// atomics, so that the gradients do not change from run to run:
//   * the dQ kernel, one block per (b, kv-head, q-tile), loops over the key
//     tiles its queries see; it also writes D for the second kernel;
//   * the dK/dV kernel, one block per (b, kv-head, k-tile, split), loops over
//     the query tiles that see its keys; its rows fold the G query heads of
//     the kv-head, so dK and dV sum over the group inside the block.  Where
//     the (b, kv-head, k-tile) blocks are too few for the card (GQA, small
//     batches), the folded query rows are split into ordered ranges, each a
//     block of its own writing fp32 partials, and a combine kernel sums them
//     in split order.
//
// What bounds it on an H100: at the training shapes (T = 128, hd 64-128)
// bytes, by a small margin over operations, once the products run on the
// tensor cores: a (q-tile, k-tile) pair does 64 x 64 x hd x 2 FMA per
// product for 2 x 64 x hd elements loaded.  What the design does about it,
// both directions:
//   * q, k and v are read in their [B, T, heads, hd] layout through strides,
//     with no folded copy;
//   * one block folds the G query heads of a kv-head into its rows
//     (row g*T + t), so each K/V tile is read once for all G heads;
//   * a tile pair that no (query, key) pair of it can see is skipped before
//     it is loaded (the causal upper triangle, tiles outside the window),
//     so causal attention does about half the square's work;
//   * ragged tails (T or L not a multiple of the tile) are masked in the
//     kernel.
// Both directions run their products on the tensor cores (mma.sync: bf16,
// and fp32 as three tf32 products), warps owning rows, behind
// double-buffered 16-byte cp.async pipelines (each section below).
#include <climits>
#include <math.h>

#include "attn_tile.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;          // forward output [B, T, H, dv], contiguous
  float* lse;         // [B, H, T] fp32, or null (forward without a backward)
  const void* o;      // backward: the forward's output, contiguous
  const void* dout;   // backward: dL/d out, contiguous
  float* dsum;        // backward: D = rowsum(dO * O), [B, H, T] fp32 scratch
  void* dq;           // [B, T, H, dk], contiguous
  void* dk;           // [B, L, KVH, dk], contiguous
  void* dv;           // [B, L, KVH, dv], contiguous
  float* ws;          // backward, n_splits > 1: fp32 dK partials [n_splits][B, L, KVH, dk],
                      // then dV partials [n_splits][B, L, KVH, dv]
  int n_splits;       // backward: blocks sharing one (b, kv-head, k-tile)'s query rows
  int B, T, H, KVH, L;
  long long q_sb, q_st;    // q strides over (b, t); heads and hd contiguous
  long long k_sb, k_sl;    // k strides over (b, l); kv-heads and hd contiguous
  long long v_sb, v_sl;
  long long qp_sb, kp_sb;  // position strides over b; t / l contiguous
  float scale;
  int has_window, window, prefix_len;
};

// folded row fr = g*T + t of kv-head kvh: element offset of (b, t, head) in q
// (rows of D = dk elements)
__device__ __forceinline__ long long q_off(const Params& p, int b, int kvh, int fr, int D) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return b * p.q_sb + t * p.q_st + static_cast<long long>(kvh * G + g) * D;
}

// the same row in a contiguous [B, T, H, D] tensor (out, o, dout: D = dv;
// dq: D = dk)
__device__ __forceinline__ long long o_off(const Params& p, int b, int kvh, int fr, int D) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return ((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * D;
}

// the row's index in a [B, H, T] fp32 array (lse, dsum)
__device__ __forceinline__ long long row_idx(const Params& p, int b, int kvh, int fr) {
  const int G = p.H / p.KVH, g = fr / p.T, t = fr % p.T;
  return (static_cast<long long>(b) * p.H + kvh * G + g) * p.T + t;
}

// The 16-byte copies of the tiles a kernel stages, by NT threads: rows of
// dv elements (V, dO) and rows of dk >= dv elements (Q, K).  The first dv
// elements of a Q or K row are copied as the dv-wide rows are, chunk c of
// rows jr, jr + RPC, ... by thread tid (c = tid % CPR, jr = tid / CPR),
// each K chunk beside its V chunk (each Q chunk beside its dO chunk); the
// last dk - dv (MLA's RoPE columns; none where dk == dv) after them, chunk
// xc of rows xjr, xjr + XRPC, ... (xc = tid % XC, xjr = tid / XC).
template <typename T, int DK, int DV, int NT>
struct Copies {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a copy
  static constexpr int CPR = DV / EPC;                           // copies of dv elements
  static constexpr int RPC = NT / CPR;                           // rows a pass
  static constexpr int XCPR = (DK - DV) / EPC;                   // copies of the rest
  static constexpr int XC = XCPR > 0 ? XCPR : 1;
  static constexpr int XRPC = XCPR > 0 ? NT / XCPR : 1;          // rows a pass of the rest
  static_assert(DK >= DV && DV % EPC == 0 && (DK - DV) % EPC == 0 && NT % CPR == 0 &&
                    NT % XC == 0,
                "copy layout");
};

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

// key rows per tile and row padding (elements) of the Q/K and V tiles.
// The padding makes the fragment loads free of bank conflicts: fp32 Q/K
// rows at 8 mod 32 words (float2 per lane), fp32 V rows at 4 mod 16 words
// (rows 2t and 2t+1 per lane), bf16 rows at 4 mod 32 words (ldmatrix).
template <typename T> struct Fwd;
template <> struct Fwd<float> {
  static constexpr int BK = 32, PADK = 8, PADV = 4;
};
template <> struct Fwd<__nv_bfloat16> {
  static constexpr int BK = 32, PADK = 8, PADV = 8;
};

// Blocks an SM the registers are cut for.  Up to dv 128 shared memory
// allows two fp32 blocks an SM (one at (192, 128)) and bf16 runs four,
// within 128 registers a thread: it reads its Q fragments from shared
// memory at each step, and more warps cover the latency between a tile's
// softmax and its products.  At dv 256 the output accumulator alone is 128
// fp32 registers a thread, so both types take 255 (two bf16 blocks an SM by
// shared memory, 101.6 KB each; one fp32 block, 197 KB).
template <typename T, int DV>
constexpr int fwd_min_blocks() {
  return sizeof(T) == 2 && DV <= 128 ? 4 : 2;
}

template <typename T, int DK, int DV>
constexpr size_t fwd_smem() {
  // Qs [FBQ][DK+PADK], Ks [2][BK][DK+PADK], Vs [2][BK][DV+PADV], KP [2][BK]
  return sizeof(T) * ((FBQ + 2 * Fwd<T>::BK) * (DK + Fwd<T>::PADK) +
                      2 * Fwd<T>::BK * (DV + Fwd<T>::PADV)) +
         sizeof(int) * 2 * Fwd<T>::BK;
}

// key tiles tested per round trip of next_tile (attn_tile.cuh)
constexpr int SCAN = 8;

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(FWD_NT, fwd_min_blocks<T, DV>()) fwd_kernel(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int BK = Fwd<T>::BK;
  constexpr int RK = DK + Fwd<T>::PADK;  // Q and K row stride (elements)
  constexpr int RV = DV + Fwd<T>::PADV;  // V row stride
  constexpr int NS = BK / 8;             // n8 tiles of a score row
  constexpr int NO = DV / 8;             // n8 tiles of an output row
  using C = Copies<T, DK, DV, FWD_NT>;
  constexpr int EPC = C::EPC, RPC = C::RPC, XRPC = C::XRPC;
  static_assert(BK % RPC == 0 && FBQ % RPC == 0 && BK % XRPC == 0 && FBQ % XRPC == 0,
                "copy layout");

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

  const int c = tid % C::CPR, jr = tid / C::CPR, xc = tid % C::XC, xjr = tid / C::XC;

  // Q, once, zeros past nr: its first dv columns, then the rest
#pragma unroll
  for (int i = 0; i < FBQ / RPC; ++i) {
    const int r = jr + i * RPC;
    const bool ok = r < nr;
    cp_async16(Qs + r * RK + c * EPC, qg + (ok ? q_off(p, b, kvh, r0 + r, DK) : 0) + c * EPC,
               ok);
  }
  if constexpr (C::XCPR > 0) {
#pragma unroll
    for (int i = 0; i < FBQ / XRPC; ++i) {
      const int r = xjr + i * XRPC;
      const bool ok = r < nr;
      cp_async16(Qs + r * RK + DV + xc * EPC,
                 qg + (ok ? q_off(p, b, kvh, r0 + r, DK) : 0) + DV + xc * EPC, ok);
    }
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
  const T* kc = kg + b * p.k_sb + kvh * DK + c * EPC;
  const T* vc = vg + b * p.v_sb + kvh * DV + c * EPC;
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
    if constexpr (C::XCPR > 0) {  // K's last dk - dv columns
      const int x0 = jt * BK + xjr;
      const T* kx = kg + b * p.k_sb + kvh * DK + DV + xc * EPC + x0 * p.k_sl;
      T* kxs = Ks + st * BK * RK + xjr * RK + DV + xc * EPC;
#pragma unroll
      for (int i = 0; i < BK / XRPC; ++i) {
        const bool ok = x0 + i * XRPC < p.L;
        cp_async16(kxs + i * XRPC * RK, ok ? kx : kg, ok);
        kx += XRPC * p.k_sl;
      }
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
      for (int kk = 0; kk < DK / 16; ++kk) {
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
      for (int kk = 0; kk < DK / 8; ++kk) {
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
    T* orow = og + o_off(p, b, kvh, r0 + r, DV) + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) store2(orow + n * 8, o[n][2 * h] / den, o[n][2 * h + 1] / den);
    if (p.lse != nullptr && tig == 0)
      p.lse[row_idx(p, b, kvh, r0 + r)] =
          lh > 0.f ? (kBf16 ? m[h] * p.scale : m[h]) + logf(lh) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward: the forward's tile scheme, twice.  Both kernels have BWD_WARPS
// warps of 16 rows on mma.sync (bf16 m16n8k16 with P and dS rounded to bf16
// as A operands; fp32 as three tf32 m16n8k8 products with the forward's k
// permutation and a cheaper operand split, bwd_split), and a
// double-buffered ring of 16-byte cp.async copies.
//
// dQ (flash_bwd_dq): a block per (q-tile of BWD_ROWS folded rows, kv-head,
// b); warps own 16 folded rows, walk the visible 32-key K/V tiles
// (next_tile), and form S = Q K^T and dP = dO V^T (V as K, the B operand),
// then P = exp(S * scale - lse) and dS = P * (dP - D) on the accumulator
// fragments, each row's lse and D in registers, and dQ += dS K with dS as
// the A operand straight from registers (K as the forward's V).  It first
// computes D = rowsum(dO * O) in fp32 and writes it for the dK/dV kernel.
//
// dK/dV (flash_bwd_dkv): a block per (k-tile of BWD_ROWS keys, split,
// kv-head, b); warps own 16 keys, hold K and V of them in shared memory for
// the whole walk, and go over BWD_BQ-row tiles of folded query rows (Q, dO,
// their positions, lse and D through the ring): S^T = K Q^T and dP^T = V
// dO^T, P^T and dS^T on the fragments, then dV += P^T dO and dK += dS^T Q
// with P^T and dS^T as A operands from registers.  In fp32 that reads dO
// and Q in the permuted row order, as the forward reads V.  A query tile
// that no key of the block can see is skipped before any byte of it is
// copied (the causal triangle, the window, the prefix: scan_qtiles).
// With n_splits > 1 the visible query tiles of a (b, kv-head, k-tile) are
// cut into n_splits ordered ranges, a block each; the blocks write fp32
// partials and flash_bwd_combine sums them in split order, then scales dK
// and casts both.

constexpr int BWD_WARPS = 4;
constexpr int BWD_NT = 32 * BWD_WARPS;  // backward threads per block
constexpr int BWD_ROWS = 16 * BWD_WARPS; // dQ: folded query rows a block; dK/dV: keys a block
constexpr int BWD_BK = 32;               // dQ: keys per tile of its ring
constexpr int BWD_BQ = 32;               // dK/dV: folded query rows per tile of its ring
constexpr int QSCAN = 8;                 // dK/dV: query tiles tested per round trip
// Row padding (elements) of every staged tile: bf16 rows at 4 mod 32 words
// (ldmatrix), fp32 rows at 8 mod 32 words (float2 fragment reads; the row
// pairs 2t, 2t+1 of the dS K / P^T dO operands take a 2-way conflict).
// Q and K rows hold dk elements, V and dO rows dv.
constexpr int BWD_PAD = 8;

template <typename T, int DK, int DV>
constexpr size_t dq_smem() {
  // Qs [BWD_ROWS][DK+PAD], dOs [BWD_ROWS][DV+PAD], Ks [2][BWD_BK][DK+PAD],
  // Vs [2][BWD_BK][DV+PAD], KP [2][BWD_BK]
  return sizeof(T) * (BWD_ROWS + 2 * BWD_BK) * (DK + DV + 2 * BWD_PAD) +
         sizeof(int) * 2 * BWD_BK;
}

template <typename T, int DK, int DV>
constexpr size_t dkv_smem() {
  // Ks [BWD_ROWS][DK+PAD], Vs [BWD_ROWS][DV+PAD], Qs [2][BWD_BQ][DK+PAD],
  // dOs [2][BWD_BQ][DV+PAD], QP, LSE, D [2][BWD_BQ]
  return sizeof(T) * (BWD_ROWS + 2 * BWD_BQ) * (DK + DV + 2 * BWD_PAD) +
         sizeof(float) * 6 * BWD_BQ;
}

// The backward's fp32 operand split for its three tf32 products: big = x
// with its low 13 bits cleared (tf32 by truncation, one bit mask where the
// forward's split_tf32 converts twice), small = x - big, exact in fp32 and
// handed to the tensor cores as it is: they read a tf32 operand's top 19
// bits, so small is truncated there; big + small keeps about 20 bits of x.
__device__ __forceinline__ void bwd_split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b in three tf32 products with bwd_split (cf. mma_3xtf32)
__device__ __forceinline__ void bwd_mma3(float (&c)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  bwd_split(b0, bb0, bs0);
  bwd_split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// Programmatic dependent launch: the dK/dV kernel and the combine are
// launched so that their blocks may start while the kernel before them
// drains; each waits for that kernel to have finished, its writes
// visible, before it reads what it wrote (dsum, the partials).
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the fp32 sum of the products of two 16-byte chunks
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

// One k step of acc = A B^T for a warp's 16 rows against N rows of B: A
// [16][R] and B [N][R] in shared memory; bf16 steps are 16 deep, fp32 ones
// 8 (the k slot t <-> index 2t, slot t+4 <-> 2t+1: float2 per lane).
template <typename T, int N, int R>
__device__ __forceinline__ void product_step(float (&acc)[N / 8][4], const T* a, const T* b,
                                             int kk, int lane) {
  const int g = lane / 4, tig = lane % 4;
  if constexpr (sizeof(T) == 2) {
    uint32_t fa[4];
    ldsm_x4(fa, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * R + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * R + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  } else {
    const int d = kk * 8 + 2 * tig;
    const float2 x0 = *reinterpret_cast<const float2*>(a + g * R + d);
    const float2 x1 = *reinterpret_cast<const float2*>(a + (g + 8) * R + d);
    uint32_t ab[4], as[4];
    bwd_split(x0.x, ab[0], as[0]);
    bwd_split(x1.x, ab[1], as[1]);
    bwd_split(x0.y, ab[2], as[2]);
    bwd_split(x1.y, ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 u = *reinterpret_cast<const float2*>(b + (n * 8 + g) * R + d);
      bwd_mma3(acc[n], ab, as, u.x, u.y);
    }
  }
}

// S = A B^T and dP = A2 B2^T for a warp's 16 rows against N rows of B (N / 8
// n8 tiles): A [16][R1] and B [N][R1] in shared memory, k over D1 (dk);
// A2 [16][R2] and B2 [N][R2], k over D2 (dv).  Element e of tile n is row
// g + 8*(e/2), column 8n + 2*tig + e%2.  The two products run interleaved
// over their common depth, then the deeper one alone; each accumulator
// takes its k steps in order.
template <typename T, int D1, int D2, int N, int R1, int R2>
__device__ __forceinline__ void two_products(float (&s)[N / 8][4], float (&dp)[N / 8][4],
                                             const T* a, const T* a2, const T* b, const T* b2,
                                             int lane) {
  constexpr int KS = sizeof(T) == 2 ? 16 : 8;  // depth of a k step
  constexpr int D0 = D1 < D2 ? D1 : D2;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < D0 / 16; ++kk) {
      uint32_t fa[4], fa2[4];
      const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(fa, a + ar * R1 + ac);
      ldsm_x4(fa2, a2 + ar * R2 + ac);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t fb[4], fb2[4];
        const int br = np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int bc = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(fb, b + br * R1 + bc);
        ldsm_x4(fb2, b2 + br * R2 + bc);
        mma_bf16(s[2 * np], fa, fb[0], fb[1]);
        mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
        mma_bf16(dp[2 * np], fa2, fb2[0], fb2[1]);
        mma_bf16(dp[2 * np + 1], fa2, fb2[2], fb2[3]);
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < D0 / 8; ++kk) {
      // k slot t <-> hd index 2t, slot t+4 <-> 2t+1 (float2 per lane)
      const int d = kk * 8 + 2 * tig;
      const float2 x0 = *reinterpret_cast<const float2*>(a + g * R1 + d);
      const float2 x1 = *reinterpret_cast<const float2*>(a + (g + 8) * R1 + d);
      const float2 y0 = *reinterpret_cast<const float2*>(a2 + g * R2 + d);
      const float2 y1 = *reinterpret_cast<const float2*>(a2 + (g + 8) * R2 + d);
      uint32_t ab[4], as[4], cb[4], cs[4];
      bwd_split(x0.x, ab[0], as[0]);
      bwd_split(x1.x, ab[1], as[1]);
      bwd_split(x0.y, ab[2], as[2]);
      bwd_split(x1.y, ab[3], as[3]);
      bwd_split(y0.x, cb[0], cs[0]);
      bwd_split(y1.x, cb[1], cs[1]);
      bwd_split(y0.y, cb[2], cs[2]);
      bwd_split(y1.y, cb[3], cs[3]);
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const float2 u = *reinterpret_cast<const float2*>(b + (n * 8 + g) * R1 + d);
        const float2 w = *reinterpret_cast<const float2*>(b2 + (n * 8 + g) * R2 + d);
        bwd_mma3(s[n], ab, as, u.x, u.y);
        bwd_mma3(dp[n], cb, cs, w.x, w.y);
      }
    }
  }
  // the deeper product's remaining steps (none where D1 == D2)
#pragma unroll 2
  for (int kk = D0 / KS; kk < D1 / KS; ++kk) product_step<T, N, R1>(s, a, b, kk, lane);
#pragma unroll 2
  for (int kk = D0 / KS; kk < D2 / KS; ++kk) product_step<T, N, R2>(dp, a2, b2, kk, lane);
}

// acc[16 rows][HD] += X Y with X the warp's 16 x K fragments in the
// accumulator layout of two_products (x[K / 8][4], K over Y's rows) and Y
// [K][R] in shared memory (its rows the k index).  bf16: X packed to bf16
// as the A operand, Y by ldmatrix.trans.  fp32: the k index permuted
// within each step of 8 (slot t <-> row 2t, slot t+4 <-> row 2t+1), which
// is the layout x already has, so X is split in registers.
template <typename T, int HD, int K, int R>
__device__ __forceinline__ void acc_product(float (&acc)[HD / 8][4], const float (&x)[K / 8][4],
                                            const T* y, int lane) {
  const int g = lane / 4, tig = lane % 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t yb[4];
        ldsm_x4_t(yb, y + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * R + np * 16 +
                          (lane >> 4) * 8);
        mma_bf16(acc[2 * np], xa, yb[0], yb[1]);
        mma_bf16(acc[2 * np + 1], xa, yb[2], yb[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t xb[4], xs[4];
      bwd_split(x[kk][0], xb[0], xs[0]);
      bwd_split(x[kk][2], xb[1], xs[1]);
      bwd_split(x[kk][1], xb[2], xs[2]);
      bwd_split(x[kk][3], xb[3], xs[3]);
      const T* y0 = y + (kk * 8 + 2 * tig) * R + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) bwd_mma3(acc[n], xb, xs, y0[n * 8], y0[R + n * 8]);
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(BWD_NT, 2) flash_bwd_dq(const Params p) {
  constexpr int BK = BWD_BK;
  constexpr int RQ = DK + BWD_PAD;     // Q and K row stride (elements)
  constexpr int RO = DV + BWD_PAD;     // dO and V row stride
  constexpr int NS = BK / 8, NO = DK / 8;
  using C = Copies<T, DK, DV, BWD_NT>;
  constexpr int EPC = C::EPC, CPR = C::CPR, RPC = C::RPC, XRPC = C::XRPC;
  static_assert(BK % RPC == 0 && BWD_ROWS % RPC == 0 && BK % XRPC == 0 &&
                    BWD_ROWS % XRPC == 0, "copy layout");

  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  T* Qs = reinterpret_cast<T*>(bwd_smem_raw);
  T* dOs = Qs + BWD_ROWS * RQ;
  T* Ks = dOs + BWD_ROWS * RO;
  T* Vs = Ks + 2 * BK * RQ;
  int* KP = reinterpret_cast<int*>(Vs + 2 * BK * RO);

  allow_dependents();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BWD_ROWS;  // the most keys first
  const int nr = min(BWD_ROWS, G * p.T - r0);
  const int ntiles = (p.L + BK - 1) / BK;
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const T* dog = static_cast<const T*>(p.dout);
  const int c = tid % CPR, jr = tid / CPR, xc = tid % C::XC, xjr = tid / C::XC;

  // Q and dO, once, zeros past nr; then Q's last dk - dv columns
#pragma unroll
  for (int i = 0; i < BWD_ROWS / RPC; ++i) {
    const int r = jr + i * RPC;
    const bool ok = r < nr;
    cp_async16(Qs + r * RQ + c * EPC, qg + (ok ? q_off(p, b, kvh, r0 + r, DK) : 0) + c * EPC,
               ok);
    cp_async16(dOs + r * RO + c * EPC,
               dog + (ok ? o_off(p, b, kvh, r0 + r, DV) : 0) + c * EPC, ok);
  }
  if constexpr (C::XCPR > 0) {
#pragma unroll
    for (int i = 0; i < BWD_ROWS / XRPC; ++i) {
      const int r = xjr + i * XRPC;
      const bool ok = r < nr;
      cp_async16(Qs + r * RQ + DV + xc * EPC,
                 qg + (ok ? q_off(p, b, kvh, r0 + r, DK) : 0) + DV + xc * EPC, ok);
    }
  }
  cp_async_commit();

  // positions of this lane's two fragment rows, the span of the block's
  // valid positions (as the forward), and the rows' lse in log2 units
  // (+inf where the row saw no key, so that its P is 0)
  int qp[2];
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    qp[h] = r < nr ? p.q_pos[b * p.qp_sb + (r0 + r) % p.T] : -1;
    const float l = r < nr ? p.lse[row_idx(p, b, kvh, r0 + r)] : -INFINITY;
    lse2[h] = l == -INFINITY ? INFINITY : l * LOG2E;
  }
  int qhi = -1, qlo = INT_MAX, qmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < BWD_ROWS / 32; ++i) {
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
  // past L are zeros at position -1
  const T* kc = kg + b * p.k_sb + kvh * DK + c * EPC;
  const T* vc = vg + b * p.v_sb + kvh * DV + c * EPC;
  auto load_tile = [&](int jt, int st) {
    T* ks = Ks + st * BK * RQ + c * EPC;
    T* vs = Vs + st * BK * RO + c * EPC;
#pragma unroll
    for (int i = 0; i < BK / RPC; ++i) {
      const int j = jr + i * RPC, jj = jt * BK + j;
      const bool ok = jj < p.L;
      cp_async16(ks + j * RQ, ok ? kc + jj * p.k_sl : kg, ok);
      cp_async16(vs + j * RO, ok ? vc + jj * p.v_sl : vg, ok);
    }
    if constexpr (C::XCPR > 0) {  // K's last dk - dv columns
      T* kxs = Ks + st * BK * RQ + DV + xc * EPC;
      const T* kx = kg + b * p.k_sb + kvh * DK + DV + xc * EPC;
#pragma unroll
      for (int i = 0; i < BK / XRPC; ++i) {
        const int j = xjr + i * XRPC, jj = jt * BK + j;
        const bool ok = jj < p.L;
        cp_async16(kxs + j * RQ, ok ? kx + jj * p.k_sl : kg, ok);
      }
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

  // D = rowsum(dO * O) of rows g and g+8: the lane sums 16-byte chunks tig,
  // tig + 4, ... and the quad adds its four parts; written for the dK/dV
  // kernel, zero past nr
  cp_async_wait<1>();
  __syncthreads();  // Q and dO landed
  const T* og = static_cast<const T*>(p.o);
  float dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    float acc = 0.f;
    if (r < nr) {
      const T* orow = og + o_off(p, b, kvh, r0 + r, DV);
#pragma unroll
      for (int cc = tig; cc < CPR; cc += 4)
        acc += dot16(dOs + r * RO + cc * EPC, orow + cc * EPC);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dsum[h] = acc;
    if (tig == 0 && r < nr) p.dsum[row_idx(p, b, kvh, r0 + r)] = acc;
  }

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const T* qw = Qs + warp * 16 * RQ;
  const T* ow = dOs + warp * 16 * RO;
  const float c2 = p.scale * LOG2E;

  for (int st = 0; jt < ntiles; st ^= 1) {
    bool full_n;
    const int jn = next_tile<BK, SCAN>(p, b, jt + 1, ntiles, qmin, qlo, qhi, lane, scan, full_n);
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with stage st^1
    if (jn < ntiles) load_tile(jn, st ^ 1);
    cp_async_commit();
    const T* ks = Ks + st * BK * RQ;
    const T* vs = Vs + st * BK * RO;
    const int* kp = KP + st * BK;

    // S = Q K^T, dP = dO V^T; then P and dS (in s) on the fragments
    float s[NS][4], dp[NS][4];
    two_products<T, DK, DV, BK, RQ, RO>(s, dp, qw, ow, ks, vs, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = full || visible(p, qp[h], kp[n * 8 + 2 * tig + (e & 1)]);
        const float pv = ok ? ex2(fmaf(s[n][e], c2, -lse2[h])) : 0.f;
        s[n][e] = pv * (dp[n][e] - dsum[h]);
      }
    // dQ += dS K
    acc_product<T, DK, BK, RQ>(dq, s, ks, lane);
    jt = jn;
    full = full_n;
  }
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= nr) continue;
    T* row = dqg + o_off(p, b, kvh, r0 + r, DK) + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(row + n * 8, dq[n][2 * h] * p.scale, dq[n][2 * h + 1] * p.scale);
  }
}

// The valid key positions of a dK/dV block: least, greatest, whether one
// is a prefix key, whether every key of the block is valid.
struct KeySpan {
  int lo, hi;
  bool pre, all;
};

// Could a query at qp see some key of the block?  Never false when one can.
__device__ __forceinline__ bool query_maybe_visible(const Params& p, int qp, const KeySpan& ks) {
  if (ks.hi < 0) return false;
  if (ks.pre) return true;  // a prefix key is seen by every row
  return qp >= ks.lo && (!p.has_window || qp - p.window < ks.hi);
}

// Does a query at qp see every key of the block?  (Then no mask is needed.)
__device__ __forceinline__ bool query_sees_all(const Params& p, int qp, const KeySpan& ks) {
  return ks.all && qp >= ks.hi && (!p.has_window || qp - p.window < ks.lo);
}

// Which query tiles of [base, base + QSCAN) some key of the block may see,
// and which see every key of it whole (scan_tiles with the roles swapped).
// Every lane computes the same bits.
template <int BQ>
__device__ __forceinline__ void scan_qtiles(const Params& p, int b, int base, int GT,
                                            const KeySpan& ks, int lane, TileScan& sc) {
  constexpr int QPL = (BQ + 31) / 32;
  int qp[QSCAN][QPL];
#pragma unroll
  for (int t = 0; t < QSCAN; ++t)
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int r = lane + 32 * i, fr = (base + t) * BQ + r;
      qp[t][i] = r < BQ && fr < GT ? p.q_pos[b * p.qp_sb + fr % p.T] : INT_MIN;
    }
  sc.base = base;
  sc.vis = sc.full = 0;
#pragma unroll
  for (int t = 0; t < QSCAN; ++t) {
    bool v = false, f = true;
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      if (lane + 32 * i >= BQ) continue;
      const int x = qp[t][i];
      v |= x != INT_MIN && query_maybe_visible(p, x, ks);
      f &= x != INT_MIN && query_sees_all(p, x, ks);
    }
    if (__any_sync(0xffffffffu, v)) sc.vis |= 1u << t;
    if (__all_sync(0xffffffffu, f)) sc.full |= 1u << t;
  }
}

// The first query tile at or after it that may be visible, or ntq; the
// window in sc is scanned anew only when it does not hold it
template <int BQ>
__device__ __forceinline__ int next_qtile(const Params& p, int b, int it, int ntq, int GT,
                                          const KeySpan& ks, int lane, TileScan& sc,
                                          bool& full) {
  while (it < ntq) {
    if (it < sc.base || it >= sc.base + QSCAN) scan_qtiles<BQ>(p, b, it, GT, ks, lane, sc);
    const unsigned v = sc.vis >> (it - sc.base);
    if (v) {
      it += __ffs(v) - 1;
      full = (sc.full >> (it - sc.base)) & 1u;
      return it;
    }
    it = sc.base + QSCAN;
  }
  full = false;
  return ntq;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(BWD_NT, 2) flash_bwd_dkv(const Params p) {
  constexpr int BQ = BWD_BQ;
  constexpr int RQ = DK + BWD_PAD;     // K and Q row stride (elements)
  constexpr int RO = DV + BWD_PAD;     // V and dO row stride
  constexpr int NQ = BQ / 8, NK = DK / 8, NV = DV / 8, NO = NK > NV ? NK : NV;
  using C = Copies<T, DK, DV, BWD_NT>;
  constexpr int EPC = C::EPC, RPC = C::RPC, XRPC = C::XRPC;
  static_assert(BQ % RPC == 0 && BWD_ROWS % RPC == 0 && BQ % XRPC == 0 &&
                    BWD_ROWS % XRPC == 0 && BQ % 16 == 0, "copy layout");

  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  T* Ks = reinterpret_cast<T*>(bwd_smem_raw);
  T* Vs = Ks + BWD_ROWS * RQ;
  T* Qs = Vs + BWD_ROWS * RO;
  T* dOs = Qs + 2 * BQ * RQ;
  int* QP = reinterpret_cast<int*>(dOs + 2 * BQ * RO);
  float* LSE = reinterpret_cast<float*>(QP + 2 * BQ);
  float* Dd = LSE + 2 * BQ;

  allow_dependents();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int split = blockIdx.x % p.n_splits;
  const int j0 = (blockIdx.x / p.n_splits) * BWD_ROWS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH, GT = G * p.T;
  const int ntq = (GT + BQ - 1) / BQ;
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const T* dog = static_cast<const T*>(p.dout);
  const int c = tid % C::CPR, jr = tid / C::CPR, xc = tid % C::XC, xjr = tid / C::XC;

  // K and V rows of the block, once, zeros past L; then K's last dk - dv
  // columns
#pragma unroll
  for (int i = 0; i < BWD_ROWS / RPC; ++i) {
    const int j = jr + i * RPC, jj = j0 + j;
    const bool ok = jj < p.L;
    cp_async16(Ks + j * RQ + c * EPC, ok ? kg + b * p.k_sb + jj * p.k_sl + kvh * DK + c * EPC : kg,
               ok);
    cp_async16(Vs + j * RO + c * EPC, ok ? vg + b * p.v_sb + jj * p.v_sl + kvh * DV + c * EPC : vg,
               ok);
  }
  if constexpr (C::XCPR > 0) {
#pragma unroll
    for (int i = 0; i < BWD_ROWS / XRPC; ++i) {
      const int j = xjr + i * XRPC, jj = j0 + j;
      const bool ok = jj < p.L;
      cp_async16(Ks + j * RQ + DV + xc * EPC,
                 ok ? kg + b * p.k_sb + jj * p.k_sl + kvh * DK + DV + xc * EPC : kg, ok);
    }
  }
  cp_async_commit();

  // positions of this lane's two fragment keys and the block's key span
  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = j0 + warp * 16 + g + 8 * h;
    kp[h] = jj < p.L ? p.k_pos[b * p.kp_sb + jj] : -1;
  }
  KeySpan ks = {INT_MAX, -1, false, true};
#pragma unroll
  for (int i = 0; i < BWD_ROWS / 32; ++i) {
    const int jj = j0 + lane + 32 * i;
    const int x = jj < p.L ? p.k_pos[b * p.kp_sb + jj] : -1;
    if (x >= 0) {
      ks.lo = min(ks.lo, x);
      ks.hi = max(ks.hi, x);
      ks.pre |= x < p.prefix_len;
    } else {
      ks.all = false;
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    ks.lo = min(ks.lo, __shfl_xor_sync(0xffffffffu, ks.lo, sh));
    ks.hi = max(ks.hi, __shfl_xor_sync(0xffffffffu, ks.hi, sh));
  }
  ks.pre = __any_sync(0xffffffffu, ks.pre);
  ks.all = __all_sync(0xffffffffu, ks.all);

  // this split's share: visible query tiles [first, first + count) of the
  // ordered list (all of them when n_splits == 1); left counts the tiles
  // it may still take after the current one
  TileScan scan = {-QSCAN, 0u, 0u};
  int first = 0, count = INT_MAX;
  if (p.n_splits > 1) {
    int nvis = 0;
    for (int base = 0; base < ntq; base += QSCAN) {
      scan_qtiles<BQ>(p, b, base, GT, ks, lane, scan);
      nvis += __popc(scan.vis);
    }
    const int per = (nvis + p.n_splits - 1) / p.n_splits;
    first = split * per;
    count = max(0, min(per, nvis - first));
  }
  bool full = false;
  int it = count > 0 ? next_qtile<BQ>(p, b, 0, ntq, GT, ks, lane, scan, full) : ntq;
  for (int i = 0; i < first && it < ntq; ++i)
    it = next_qtile<BQ>(p, b, it + 1, ntq, GT, ks, lane, scan, full);
  int left = count - 1;
  auto next = [&](int t, bool& f) {
    f = false;
    if (t >= ntq || left <= 0) return ntq;
    --left;
    return next_qtile<BQ>(p, b, t + 1, ntq, GT, ks, lane, scan, f);
  };

  // Q, dO rows [t*BQ, t*BQ + BQ) of the folded rows, their positions, lse
  // and D into stage st; rows past G*T are zeros at position -1 with lse
  // -inf (P = 0)
  const long long rbase = (static_cast<long long>(b) * p.H + kvh * G) * p.T;  // [B,H,T] row 0
  auto load_qtile = [&](int t, int st) {
    T* qs = Qs + st * BQ * RQ + c * EPC;
    T* os = dOs + st * BQ * RO + c * EPC;
#pragma unroll
    for (int i = 0; i < BQ / RPC; ++i) {
      const int r = jr + i * RPC, fr = t * BQ + r;
      const bool ok = fr < GT;
      cp_async16(qs + r * RQ, ok ? qg + q_off(p, b, kvh, fr, DK) + c * EPC : qg, ok);
      cp_async16(os + r * RO, ok ? dog + o_off(p, b, kvh, fr, DV) + c * EPC : dog, ok);
    }
    if constexpr (C::XCPR > 0) {  // Q's last dk - dv columns
      T* qxs = Qs + st * BQ * RQ + DV + xc * EPC;
#pragma unroll
      for (int i = 0; i < BQ / XRPC; ++i) {
        const int r = xjr + i * XRPC, fr = t * BQ + r;
        const bool ok = fr < GT;
        cp_async16(qxs + r * RQ, ok ? qg + q_off(p, b, kvh, fr, DK) + DV + xc * EPC : qg, ok);
      }
    }
    if (tid < BQ) {
      const int fr = t * BQ + tid, o = st * BQ + tid;
      if (fr < GT) {
        cp_async4(QP + o, p.q_pos + b * p.qp_sb + fr % p.T);
        cp_async4(LSE + o, p.lse + rbase + fr);
        cp_async4(Dd + o, p.dsum + rbase + fr);
      } else {
        QP[o] = -1;
        LSE[o] = -INFINITY;
        Dd[o] = 0.f;
      }
    }
  };
  wait_for_prior_grid();  // the dQ kernel's dsum
  if (it < ntq) load_qtile(it, 0);
  cp_async_commit();

  float dk[NK][4], dv[NV][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n < NK) dk[n][e] = 0.f;
      if (n < NV) dv[n][e] = 0.f;
    }
  const T* kw = Ks + warp * 16 * RQ;
  const T* vw = Vs + warp * 16 * RO;
  const float c2 = p.scale * LOG2E;

  for (int st = 0; it < ntq; st ^= 1) {
    bool full_n;
    const int in = next(it, full_n);
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with stage st^1
    if (in < ntq) load_qtile(in, st ^ 1);
    cp_async_commit();
    const T* qs = Qs + st * BQ * RQ;
    const T* os = dOs + st * BQ * RO;
    const int* qps = QP + st * BQ;
    const float* lses = LSE + st * BQ;
    const float* ds = Dd + st * BQ;

    // S^T = K Q^T, dP^T = V dO^T; then P^T (in sT) and dS^T (in dpT)
    float sT[NQ][4], dpT[NQ][4];
    two_products<T, DK, DV, BQ, RQ, RO>(sT, dpT, kw, vw, qs, os, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int q = n * 8 + 2 * tig;
      const int2 qq = *reinterpret_cast<const int2*>(qps + q);
      const float2 ll = *reinterpret_cast<const float2*>(lses + q);
      const float2 dd = *reinterpret_cast<const float2*>(ds + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = e & 1 ? qq.y : qq.x;
        const float l = e & 1 ? ll.y : ll.x;
        const bool ok = l != -INFINITY && (full || visible(p, qpos, kp[h]));
        const float pv = ok ? ex2(fmaf(sT[n][e], c2, -l * LOG2E)) : 0.f;
        sT[n][e] = pv;
        dpT[n][e] = pv * (dpT[n][e] - (e & 1 ? dd.y : dd.x));
      }
    }
    // dV += P^T dO, dK += dS^T Q
    acc_product<T, DV, BQ, RO>(dv, sT, os, lane);
    acc_product<T, DK, BQ, RQ>(dk, dpT, qs, lane);
    it = in;
    full = full_n;
  }
  cp_async_wait<0>();

  // dK (scaled) and dV, or this split's fp32 partials: nel dK and nelv dV
  // elements (the dK partials of every split come first)
  const long long nel = static_cast<long long>(p.B) * p.L * p.KVH * DK;
  const long long nelv = DK == DV ? nel : nel / DK * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = j0 + warp * 16 + g + 8 * h;
    if (jj >= p.L) continue;
    const long long row = (static_cast<long long>(b) * p.L + jj) * p.KVH + kvh;
    const long long off = row * DK + 2 * tig, offv = DK == DV ? off : row * DV + 2 * tig;
    if (p.n_splits == 1) {
      T* dkr = static_cast<T*>(p.dk) + off;
      T* dvr = static_cast<T*>(p.dv) + offv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n < NK) store2(dkr + n * 8, dk[n][2 * h] * p.scale, dk[n][2 * h + 1] * p.scale);
        if (n < NV) store2(dvr + n * 8, dv[n][2 * h], dv[n][2 * h + 1]);
      }
    } else {
      float* dkr = p.ws + split * nel + off;
      float* dvr = p.ws + (DK == DV ? (p.n_splits + split) * nel
                                    : p.n_splits * nel + split * nelv) + offv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n < NK) store2(dkr + n * 8, dk[n][2 * h], dk[n][2 * h + 1]);
        if (n < NV) store2(dvr + n * 8, dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// dK = scale * sum of the dK partials, dV = sum of the dV partials, each
// summed in split order; 4 elements of dK a thread (n4 = B*L*KVH*dk / 4)
// and, while dV has any left (dv <= dk), the same 4 of dV
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_combine(const Params p, long long n4) {
  wait_for_prior_grid();  // the dK/dV kernel's partials
  const long long n4v = DK == DV ? n4 : n4 * DV / DK;  // B*L*KVH*dv / 4
  const float4* wk = reinterpret_cast<const float4*>(p.ws);
  const float4* wv = wk + p.n_splits * n4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    const bool hv = DK == DV || i < n4v;
    float4 a = wk[i], v = hv ? wv[i] : a;
    for (int s = 1; s < p.n_splits; ++s) {
      const float4 x = wk[s * n4 + i], y = hv ? wv[s * n4v + i] : x;
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      v.x += y.x; v.y += y.y; v.z += y.z; v.w += y.w;
    }
    a.x *= p.scale; a.y *= p.scale; a.z *= p.scale; a.w *= p.scale;
    store4(static_cast<T*>(p.dk) + 4 * i, a);
    if (hv) store4(static_cast<T*>(p.dv) + 4 * i, v);
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

// the forward takes the largest carveout, room for fwd_min_blocks blocks an SM
template <typename T, int DK, int DV>
cudaError_t fwd_attributes() {
  static bool configured[kMaxDevices] = {};
  return allow_smem(fwd_kernel<T, DK, DV>, fwd_smem<T, DK, DV>(), configured,
                    (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int DK, int DV>
cudaError_t fwd_occupancy(int* blocks, int* smem_bytes) {
  cudaError_t e = fwd_attributes<T, DK, DV>();
  if (e != cudaSuccess) return e;
  *smem_bytes = (int)fwd_smem<T, DK, DV>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fwd_kernel<T, DK, DV>, FWD_NT,
                                                       fwd_smem<T, DK, DV>());
}

template <typename T, int DK, int DV>
cudaError_t launch_fwd(const Params& p, cudaStream_t s) {
  cudaError_t e = fwd_attributes<T, DK, DV>();
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T * (p.H / p.KVH) + FBQ - 1) / FBQ, p.KVH, p.B);
  fwd_kernel<T, DK, DV><<<grid, FWD_NT, fwd_smem<T, DK, DV>(), s>>>(p);
  return cudaGetLastError();
}

// the backward kernels take the largest carveout too
template <typename T, int DK, int DV>
cudaError_t bwd_attributes() {
  static bool conf_q[kMaxDevices] = {}, conf_kv[kMaxDevices] = {};
  cudaError_t e = allow_smem(flash_bwd_dq<T, DK, DV>, dq_smem<T, DK, DV>(), conf_q,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return allow_smem(flash_bwd_dkv<T, DK, DV>, dkv_smem<T, DK, DV>(), conf_kv,
                    (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int DK, int DV>
cudaError_t bwd_occupancy(int which, int* blocks, int* smem_bytes) {
  cudaError_t e = bwd_attributes<T, DK, DV>();
  if (e != cudaSuccess) return e;
  if (which == 0) {
    *smem_bytes = (int)dq_smem<T, DK, DV>();
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_bwd_dq<T, DK, DV>,
                                                         BWD_NT, dq_smem<T, DK, DV>());
  }
  *smem_bytes = (int)dkv_smem<T, DK, DV>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_bwd_dkv<T, DK, DV>, BWD_NT,
                                                       dkv_smem<T, DK, DV>());
}

// kern<<<grid, block, smem, s>>>(args...) as a programmatic dependent launch
template <typename... Args>
cudaError_t launch_dependent(void (*kern)(Args...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename T, int DK, int DV>
cudaError_t launch_bwd(const Params& p, cudaStream_t s) {
  cudaError_t e = bwd_attributes<T, DK, DV>();
  if (e != cudaSuccess) return e;
  const dim3 gq((p.T * (p.H / p.KVH) + BWD_ROWS - 1) / BWD_ROWS, p.KVH, p.B);
  // writes dsum for flash_bwd_dkv
  flash_bwd_dq<T, DK, DV><<<gq, BWD_NT, dq_smem<T, DK, DV>(), s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gkv((p.L + BWD_ROWS - 1) / BWD_ROWS * p.n_splits, p.KVH, p.B);
  e = launch_dependent(flash_bwd_dkv<T, DK, DV>, gkv, dim3(BWD_NT), dkv_smem<T, DK, DV>(), s,
                       p);
  if (e != cudaSuccess || p.n_splits == 1) return e;
  const long long n4 = static_cast<long long>(p.B) * p.L * p.KVH * DK / 4;
  const long long blocks = (n4 + 255) / 256;
  return launch_dependent(flash_bwd_combine<T, DK, DV>,
                          dim3((unsigned)(blocks < 8192 ? blocks : 8192)), dim3(256), 0, s, p, n4);
}

// The instantiated (dk, dv) pairs: F(DK, DV) for each; the forward's
// (FWD_PAIRS) add (256, 256), which has no backward
#define FLASH_PAIRS(F) F(64, 64) F(128, 128) F(192, 128)
#define FWD_PAIRS(F) FLASH_PAIRS(F) F(256, 256)

template <typename T>
cudaError_t dispatch(const Params& p, int dk, int dv, bool backward, cudaStream_t s) {
#define FLASH_LAUNCH_FWD(DK, DV) \
  if (!backward && dk == DK && dv == DV) return launch_fwd<T, DK, DV>(p, s);
#define FLASH_LAUNCH_BWD(DK, DV) \
  if (backward && dk == DK && dv == DV) return launch_bwd<T, DK, DV>(p, s);
  FWD_PAIRS(FLASH_LAUNCH_FWD)
  FLASH_PAIRS(FLASH_LAUNCH_BWD)
#undef FLASH_LAUNCH_BWD
#undef FLASH_LAUNCH_FWD
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
  p.n_splits = 1;
  return p;
}

bool bad_shape(int B, int T, int H, int KVH, int L) {
  return B <= 0 || T <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q/k rows of dk elements, v rows
// of dv; out [B, T, H, dv] contiguous; lse [B, H, T] fp32, or null.
// Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for a (dk, dv)
// pair that has no instantiation).
extern "C" int flash_attn_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, void* lse, int B, int T, int H, int KVH, int L, int dk,
    int dv, long long q_sb, long long q_st, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, long long qp_sb, long long kp_sb, float scale, int has_window,
    int window, int prefix_len, void* stream) {
  if (bad_shape(B, T, H, KVH, L)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, q_pos, k_pos, B, T, H, KVH, L, q_sb, q_st, k_sb, k_sl,
                         v_sb, v_sl, qp_sb, kp_sb, scale, has_window, window, prefix_len);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, dk, dv, false, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, dk, dv, false, s);
  return cudaErrorInvalidValue;
}

// The forward's blocks per SM and dynamic shared memory per block at
// (dtype, dk, dv), into *blocks and *smem_bytes: the runtime's occupancy
// calculator, which also counts register granularity and the carveout.
extern "C" int flash_attn_fwd_occupancy(int dtype, int dk, int dv, int* blocks,
                                        int* smem_bytes) {
#define FLASH_FWD_OCC(DK, DV)                                   \
  if (dtype == 0 && dk == DK && dv == DV)                       \
    return fwd_occupancy<float, DK, DV>(blocks, smem_bytes);    \
  if (dtype == 1 && dk == DK && dv == DV)                       \
    return fwd_occupancy<__nv_bfloat16, DK, DV>(blocks, smem_bytes);
  FWD_PAIRS(FLASH_FWD_OCC)
#undef FLASH_FWD_OCC
  return cudaErrorInvalidValue;
}

// The backward kernels' blocks per SM and dynamic shared memory per block
// at (dtype, dk, dv): which = 0 the dQ kernel, 1 the dK/dV kernel.
extern "C" int flash_attn_bwd_occupancy(int dtype, int dk, int dv, int which, int* blocks,
                                        int* smem_bytes) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
#define FLASH_BWD_OCC(DK, DV)                                          \
  if (dtype == 0 && dk == DK && dv == DV)                              \
    return bwd_occupancy<float, DK, DV>(which, blocks, smem_bytes);    \
  if (dtype == 1 && dk == DK && dv == DV)                              \
    return bwd_occupancy<__nv_bfloat16, DK, DV>(which, blocks, smem_bytes);
  FLASH_PAIRS(FLASH_BWD_OCC)
#undef FLASH_BWD_OCC
  return cudaErrorInvalidValue;
}

// o, dout [B, T, H, dv], dq [B, T, H, dk], dk [B, L, KVH, dk] and dv [B, L,
// KVH, dv] contiguous in q's dtype; lse from the forward; dsum [B, H, T]
// fp32 scratch; with n_splits > 1, ws holds n_splits * B * L * KVH * (dk +
// dv) fp32 partials (else null).
// Two launches on one stream (dQ, then dK/dV), and the combine when
// n_splits > 1.
extern "C" int flash_attn_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, const void* k_pos, void* dsum,
    void* dq, void* dk, void* dv, void* ws, int n_splits, int B, int T, int H, int KVH, int L,
    int dk_dim, int dv_dim, long long q_sb, long long q_st, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long qp_sb, long long kp_sb, float scale,
    int has_window, int window, int prefix_len, void* stream) {
  if (bad_shape(B, T, H, KVH, L) || n_splits < 1 || (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, q_pos, k_pos, B, T, H, KVH, L, q_sb, q_st, k_sb, k_sl,
                         v_sb, v_sl, qp_sb, kp_sb, scale, has_window, window, prefix_len);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.o = o; p.dout = dout;
  p.dsum = static_cast<float*>(dsum);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.ws = static_cast<float*>(ws);
  p.n_splits = n_splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, dk_dim, dv_dim, true, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, dk_dim, dv_dim, true, s);
  return cudaErrorInvalidValue;
}
