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
// read through the slot's row of the block table bt [B, MAXB] (-1 unused,
// holes allowed), masked by absolute position as `_flash_tile` /
// `_tile_visible` do: key row j is visible to a query at position qp iff
//   0 <= pos[j] <= qp  and  pos[j] > qp - window    (window optional)
//   or 0 <= pos[j] < prefix_len.
// Softmax runs online in fp32; a row that sees nothing outputs zeros; int8
// k/v are dequantised in fp32 (k * scale, then the dot).
//
// What bounds it on an H100: bytes.  A verify step has G*T = 1..9 folded
// rows per kv-head on the main path, so each K/V byte feeds a handful of
// FLOPs, far below the ~20 a byte where the SIMT fp32 units would be the
// limit.  The design keeps bytes in flight and does no work the call does
// not need:
//   * split-KV: one block owns one (slot, kv-head, tile of RT folded rows,
//     split).  Split c takes live blocks [c*P, (c+1)*P) of the slot's
//     ordered list of live blocks (P = ceil(MAXB / n_splits)).  n_splits
//     comes from the shapes and the SM count alone (the wrapper), so the
//     launch never depends on the data.  With n_splits > 1 each split
//     writes its unnormalised (acc, m, l) to an fp32 workspace and
//     `paged_verify_kernel_combine` folds the splits in index order 0, 1,
//     2, ..., never in arrival order; no atomics touch the output or m/l.
//   * a ring of NS = 3 stages filled by 16-byte cp.async copies, K and V
//     kept in their storage type in shared memory (bf16, fp32, or int8
//     with the scales beside them as fp32), converted as the dot products
//     read them.  A pool block of one kv-head is bs rows of hd * elt
//     contiguous bytes: neighbouring lanes copy neighbouring 16-byte chunks.
//     A stage holds max(32, bs) keys; one barrier per stage.
//   * no wasted copies: before any K/V byte of the split is copied, its
//     blocks' positions are tested against the tile's rows (the TPU
//     kernel's `_tile_visible`); an invisible block costs no K/V bytes.
//   * no work on rows the call does not have: a block computes its nr <= RT
//     rows only, and a tile of padding rows only (every position -1, no
//     prefix: the mixed verify+chunk launch pads each slot to the widest
//     slot's columns) sees nothing, so it writes what the walk would write
//     for it (zero rows; with splits the empty partial acc 0, m -inf, l 0)
//     and returns before it loads Q or reads the table.  The 4 warps split each stage's keys, 8 at a time; a lane
//     is (key jj = lane & 7, dim quarter qd = lane >> 3) for the scores,
//     two shuffles finish a dot product, and (dims lane*hd/32 ..) for P.V.
//     Scores, running max and sum stay in registers (warp shuffles); each
//     warp keeps its own online-softmax state, and the warps are merged in
//     warp order at the end.
//
// K2 and K3 differ only in how a block finds its split's live blocks:
//   * K2 walks all MAXB entries of its table row (32 at a time, one warp
//     ballot each) and keeps the live entries whose rank falls in its split;
//   * K3 reads cu_blocks [B + 1] on the device (per-slot steps max(live, 1),
//     from kernels/tuning.py `host_cu_blocks`): a split past the slot's
//     steps reads no table entry, and the walk stops once the split's
//     blocks are found.
// Both hand the same ordered blocks to the same visibility test, stages,
// key-to-warp assignment and merges, so K3 is bit-identical to K2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int RT = 8;            // folded query rows per block (one row tile)
constexpr int NS = 3;            // ring stages
constexpr int STAGE_KEYS = 32;   // keys per stage: max(STAGE_KEYS, bs)
constexpr int GK = 8;            // keys a warp takes at a time
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
  float* ws_acc;           // [parts, hd] with n_splits > 1, else null
  float* ws_m;             // [parts]
  float* ws_l;             // [parts]
  int B, T, H, KVH, bs, lbs, MAXB;
  int tiles, n_splits, per_split, stage_keys;
  int stage_bytes, ring_bytes;
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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 32-bit words of a storage type, widened to fp32 (bf16: the high half of an fp32)
template <typename KT> struct Widen;
template <> struct Widen<float> {
  static constexpr int PER = 1;
  __device__ static __forceinline__ void word(uint32_t w, float* o) { o[0] = __uint_as_float(w); }
};
template <> struct Widen<__nv_bfloat16> {
  static constexpr int PER = 2;
  __device__ static __forceinline__ void word(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Widen<int8_t> {
  static constexpr int PER = 4;
  __device__ static __forceinline__ void word(uint32_t w, float* o) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
};

// N elements of KT from shared memory (aligned to their total size) as fp32
template <typename KT, int N>
__device__ __forceinline__ void load_f(const unsigned char* src, float* o) {
  using W = Widen<KT>;
  constexpr int BYTES = N * static_cast<int>(sizeof(KT));
  if constexpr (BYTES == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    W::word(x.x, o);
    W::word(x.y, o + W::PER);
    W::word(x.z, o + 2 * W::PER);
    W::word(x.w, o + 3 * W::PER);
  } else if constexpr (BYTES == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    W::word(x.x, o);
    W::word(x.y, o + W::PER);
  } else if constexpr (BYTES == 4) {
    W::word(*reinterpret_cast<const uint32_t*>(src), o);
  } else {
    static_assert(BYTES == 2 && sizeof(KT) == 1, "two int8 values");
    const uint32_t h = *reinterpret_cast<const unsigned short*>(src);
    o[0] = static_cast<float>(static_cast<int>(h << 24) >> 24);
    o[1] = static_cast<float>(static_cast<int>(h << 16) >> 24);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
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

// key at position kp visible to the query at position qp
__device__ __forceinline__ bool key_visible(const Params& p, int kp, int qp) {
  bool o = kp >= 0 && kp <= qp;
  if (p.has_window) o = o && kp > qp - p.window;
  if (p.prefix_len) o = o || (kp >= 0 && kp < p.prefix_len);
  return o;
}

// key visible to some row of a tile whose valid positions span [qlo, qhi]
__device__ __forceinline__ bool key_visible_tile(const Params& p, int kp, int qlo, int qhi) {
  bool o = kp >= 0 && kp <= qhi;
  if (p.has_window) o = o && kp > qlo - p.window;
  if (p.prefix_len) o = o || (kp >= 0 && kp < p.prefix_len);
  return o;
}

// Shared memory after the ring: Qs [RT][HD] fp32, Pw [NW][RT][GK] fp32,
// QP [RT], then the split's live blocks LB, visibility flags VF and visible
// blocks VL, per_split ints each.
template <int HD>
constexpr size_t tail_bytes() {
  return sizeof(float) * (RT * HD + NW * RT * GK) + sizeof(int) * RT;
}

// Blocks an SM the register budget is cut for: fp32 at hd 128 fits two by
// its shared memory, so it may take up to 255 registers; the others four.
template <typename KT, int HD>
constexpr int min_blocks() {
  return sizeof(KT) == 4 && HD == 128 ? 2 : 4;
}

// QT: query / output type; KT: pool type (QT, or int8_t with ST scales).
template <typename QT, typename KT, typename ST, int HD, bool RAGGED>
__global__ void __launch_bounds__(NT, min_blocks<KT, HD>()) paged_verify_kernel(const Params p) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int EB = sizeof(KT);
  constexpr int RS = HD * EB + 16;     // K row stride in smem: 16 (mod 128) bytes, conflict-free
  constexpr int RSV = HD * EB;         // V rows: a warp reads one whole row at a time
  constexpr int NCH = HD * EB / 16;    // 16-byte chunks per row
  constexpr int EPC = 16 / EB;         // elements per chunk
  constexpr int CPL = NCH / 4;         // score-phase chunks per lane
  constexpr int DPL = HD / 32;         // P.V dims per lane
  static_assert(NCH % 4 == 0 && EPC % 4 == 0, "row layout");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* Qs = reinterpret_cast<float*>(smem + p.ring_bytes);
  float* Pw = Qs + RT * HD;
  int* QP = reinterpret_cast<int*>(Pw + NW * RT * GK);
  int* LB = QP + RT;
  int* VF = LB + p.per_split;
  int* VL = VF + p.per_split;
  __shared__ int n_live_s, n_vis_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x % p.tiles, split = blockIdx.x / p.tiles;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = tile * RT;
  const int nr = min(RT, G * p.T - r0);
  const int bs = p.bs, lbs = p.lbs, P = p.per_split, KC = p.stage_keys;

  // a tile of padding rows only: the walk below would see no key and write
  // zeros (the empty partial with splits); write them and stop
  if (p.prefix_len == 0) {
    bool dead = true;
    for (int r = 0; r < nr; ++r) dead = dead && p.q_pos[b * p.qp_sb + (r0 + r) % p.T] < 0;
    if (dead) {
      const long long part0 =
          ((static_cast<long long>(b) * p.KVH + kvh) * p.n_splits + split) * (p.tiles * RT) + r0;
      QT* o = static_cast<QT*>(p.out);
      for (int e = tid; e < nr * HD; e += NT) {
        const int r = e / HD, d = e % HD;
        if (p.n_splits == 1) {
          const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
          o[((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * HD + d] = from_f<QT>(0.f);
        } else {
          p.ws_acc[(part0 + r) * HD + d] = 0.f;
          if (d == 0) {
            p.ws_m[part0 + r] = -INFINITY;
            p.ws_l[part0 + r] = 0.f;
          }
        }
      }
      return;
    }
  }

  // the row tile: folded row r0 + r = g*T + t holds head kvh*G + g at time t
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < RT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r < nr) {
      const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
      x = to_f(q[b * p.q_sb + t * p.q_st + static_cast<long long>(kvh * G + g) * HD + d]);
    }
    Qs[e] = x;
  }
  if (tid < RT) QP[tid] = tid < nr ? p.q_pos[b * p.qp_sb + (r0 + tid) % p.T] : -1;
  for (int i = tid; i < P; i += NT) VF[i] = 0;

  // the split's live blocks, in ascending logical order
  if (warp == 0) {
    const int* bt_row = p.bt + b * p.bt_sb;
    const int lo = split * P;
    int want = lo + P;                      // live entries the walk must reach
    if constexpr (RAGGED) want = min(want, p.cu[b + 1] - p.cu[b]);
    int n = 0;
    if (lo < want) {
      for (int j0 = 0; j0 < p.MAXB && (!RAGGED || n < want); j0 += 32) {
        const int j = j0 + lane;
        const int e = j < p.MAXB ? bt_row[j] : -1;
        const unsigned m = __ballot_sync(0xffffffffu, e >= 0);
        const int idx = n + __popc(m & ((1u << lane) - 1u));
        if (e >= 0 && idx >= lo && idx < lo + P) LB[idx - lo] = e;
        n += __popc(m);
      }
    }
    if (lane == 0) n_live_s = max(0, min(n, want) - lo);
  }
  __syncthreads();
  const int nl = n_live_s;

  // tile-level visibility bounds (the TPU kernel's q_hi / q_lo)
  int qhi = -1, qlo = INT_MAX;
  for (int r = 0; r < nr; ++r) {
    const int x = QP[r];
    qhi = max(qhi, x);
    if (x >= 0) qlo = min(qlo, x);
  }

  // which live blocks some row of the tile sees: every flag written is 1
  for (int idx = tid; idx < (nl << lbs); idx += NT) {
    const int i = idx >> lbs, off = idx & (bs - 1);
    if (key_visible_tile(p, p.pos[LB[i] * p.pos_sn + off], qlo, qhi)) VF[i] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nl; i0 += 32) {
      const int i = i0 + lane;
      const bool f = i < nl && VF[i] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) VL[n + __popc(m & ((1u << lane) - 1u))] = LB[i];
      n += __popc(m);
    }
    if (lane == 0) n_vis_s = n;
  }
  __syncthreads();
  const int nv = n_vis_s;
  const int SB = KC >> lbs;                 // pool blocks per stage
  const int nst = (nv + SB - 1) / SB;

  const unsigned char* kg = static_cast<const unsigned char*>(p.k);
  const unsigned char* vg = static_cast<const unsigned char*>(p.v);
  const ST* ksg = static_cast<const ST*>(p.k_scale);
  const ST* vsg = static_cast<const ST*>(p.v_scale);

  // stage i: visible blocks VL[i*SB ..) into ring slot i % NS
  auto issue = [&](int i) {
    if (i >= nst) return;
    unsigned char* slot = ring + (i % NS) * p.stage_bytes;
    int* KP = reinterpret_cast<int*>(slot + KC * (RS + RSV));
    const int nkeys = min(SB, nv - i * SB) << lbs;
    for (int e = tid; e < nkeys * NCH; e += NT) {
      const int j = e / NCH, c = e % NCH;
      const long long blk = VL[i * SB + (j >> lbs)];
      const int off = j & (bs - 1);
      cp_async16(slot + j * RS + c * 16,
                 kg + (blk * p.k_sn + off * p.k_sl + kvh * HD) * EB + c * 16);
      cp_async16(slot + KC * RS + j * RSV + c * 16,
                 vg + (blk * p.v_sn + off * p.v_sl + kvh * HD) * EB + c * 16);
    }
    if (tid < nkeys) {
      const long long blk = VL[i * SB + (tid >> lbs)];
      const int off = tid & (bs - 1);
      cp_async4(KP + tid, p.pos + blk * p.pos_sn + off);
      if constexpr (QUANT) {     // the scales, widened, beside their rows
        float* SK = reinterpret_cast<float*>(KP + KC);
        const long long so = blk * p.s_sn + off * p.s_sl + kvh;
        SK[tid] = to_f(ksg[so]);
        SK[KC + tid] = to_f(vsg[so]);
      }
    }
  };

  // per-warp online-softmax state over the warp's keys
  const int jj = lane & 7, qd = lane >> 3;
  float acc[RT][DPL], m_r[RT], l_r[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  float* Pme = Pw + warp * RT * GK;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();                        // stage i landed; slot (i-1) % NS is free
    issue(i + NS - 1);
    cp_async_commit();

    const unsigned char* slot = ring + (i % NS) * p.stage_bytes;
    const int* KP = reinterpret_cast<const int*>(slot + KC * (RS + RSV));
    const float* SK = reinterpret_cast<const float*>(KP + KC);
    const int nk = min(SB, nv - i * SB) << lbs;
    for (int g0 = warp * GK; g0 < nk; g0 += NW * GK) {
      // scores of key g0 + jj over the lane's quarter of the dims
      const int jk = g0 + jj;
      const bool kin = jk < nk;
      const int kp = kin ? KP[jk] : -1;
      float s[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] = 0.f;
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = qd + 4 * ci;
        float kf[EPC];
        load_f<KT, EPC>(slot + jk * RS + c * 16, kf);
        if constexpr (QUANT) {
          const float sc = SK[jk];
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[e] *= sc;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            const float4* q4 = reinterpret_cast<const float4*>(Qs + r * HD + c * EPC);
#pragma unroll
            for (int e4 = 0; e4 < EPC / 4; ++e4) {
              const float4 qv = q4[e4];
              s[r] = fmaf(qv.x, kf[4 * e4 + 0], s[r]);
              s[r] = fmaf(qv.y, kf[4 * e4 + 1], s[r]);
              s[r] = fmaf(qv.z, kf[4 * e4 + 2], s[r]);
              s[r] = fmaf(qv.w, kf[4 * e4 + 3], s[r]);
            }
          }
        }
      }
      // finish the dots, then the online softmax over these 8 keys, row by row
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < nr) {
          float x = s[r];
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          x *= p.scale;
          const bool ok = kin && key_visible(p, kp, QP[r]);
          float mt = ok ? x : -INFINITY;
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
          const float m_new = fmaxf(m_r[r], mt);
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          const float pv = ok ? expf(x - m_safe) : 0.f;
          float ps = pv;
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          ps += __shfl_xor_sync(0xffffffffu, ps, 4);
          const float corr = m_r[r] == -INFINITY ? 0.f : expf(m_r[r] - m_safe);
          m_r[r] = m_new;
          l_r[r] = l_r[r] * corr + ps;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
          if (qd == 0) Pme[r * GK + jj] = pv;
        }
      }
      __syncwarp();
      // acc += P @ V over the keys of this group that the stage holds
      const int nkg = min(GK, nk - g0);
#pragma unroll
      for (int t = 0; t < GK; ++t) {
        if (t < nkg) {
          float vf[DPL];
          load_f<KT, DPL>(slot + KC * RS + (g0 + t) * RSV + lane * DPL * EB, vf);
          if constexpr (QUANT) {
            const float sc = SK[KC + g0 + t];
#pragma unroll
            for (int e = 0; e < DPL; ++e) vf[e] *= sc;
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r < nr) {
              const float pr = Pme[r * GK + t];
#pragma unroll
              for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
            }
          }
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring becomes the merge's scratch

  // merge the warps' states in warp order
  float* Aw = reinterpret_cast<float*>(ring);   // [NW][RT][HD]
  float* Mw = Aw + NW * RT * HD;                // [NW][RT]
  float* Lw = Mw + NW * RT;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) Aw[(warp * RT + r) * HD + lane * DPL + e] = acc[r][e];
      if (lane == 0) {
        Mw[warp * RT + r] = m_r[r];
        Lw[warp * RT + r] = l_r[r];
      }
    }
  }
  __syncthreads();
  const long long part0 =
      ((static_cast<long long>(b) * p.KVH + kvh) * p.n_splits + split) * (p.tiles * RT) + r0;
  QT* o = static_cast<QT*>(p.out);  // [B, T, H, HD], contiguous
  for (int e = tid; e < nr * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * RT + r]);
    const float m_safe = M == -INFINITY ? 0.f : M;
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = Mw[w * RT + r];
      if (mw != -INFINITY) {
        const float f = expf(mw - m_safe);
        L += f * Lw[w * RT + r];
        A += f * Aw[(w * RT + r) * HD + d];
      }
    }
    if (p.n_splits == 1) {
      const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
      o[((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * HD + d] =
          from_f<QT>(A / fmaxf(L, 1e-30f));
    } else {
      p.ws_acc[(part0 + r) * HD + d] = A;
      if (d == 0) {
        p.ws_m[part0 + r] = M;
        p.ws_l[part0 + r] = L;
      }
    }
  }
}

// Fold the splits' (acc, m, l) of one (slot, kv-head, row tile) in split
// order 0, 1, 2, ... and normalise.  A row that no split saw gives zeros.
template <typename QT, int HD>
__global__ void __launch_bounds__(NT) paged_verify_kernel_combine(const Params p) {
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int r0 = tile * RT;
  const int nr = min(RT, G * p.T - r0);
  const long long rows = p.tiles * RT;
  const long long part0 = (static_cast<long long>(b) * p.KVH + kvh) * p.n_splits * rows + r0;
  QT* o = static_cast<QT*>(p.out);
  for (int e = threadIdx.x; e < nr * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    float M = -INFINITY;
    for (int c = 0; c < p.n_splits; ++c) M = fmaxf(M, p.ws_m[part0 + c * rows + r]);
    const float m_safe = M == -INFINITY ? 0.f : M;
    float A = 0.f, L = 0.f;
    for (int c = 0; c < p.n_splits; ++c) {
      const long long pi = part0 + c * rows + r;
      const float mc = p.ws_m[pi];
      if (mc != -INFINITY) {
        const float f = expf(mc - m_safe);
        L += f * p.ws_l[pi];
        A += f * p.ws_acc[pi * HD + d];
      }
    }
    const int fr = r0 + r, g = fr / p.T, t = fr % p.T;
    o[((static_cast<long long>(b) * p.T + t) * p.H + kvh * G + g) * HD + d] =
        from_f<QT>(A / fmaxf(L, 1e-30f));
  }
}

template <typename KT, int HD>
size_t stage_bytes(int keys) {
  const size_t rows = 2 * HD * sizeof(KT) + 16;   // a K row (padded) and a V row
  return keys * rows + sizeof(int) * keys + (sizeof(KT) == 1 ? 2 * sizeof(float) * keys : 0);
}

// fills the geometry the kernel reads from p; returns its dynamic shared memory
template <typename KT, int HD>
size_t geometry(Params& p) {
  p.stage_keys = p.bs > STAGE_KEYS ? p.bs : STAGE_KEYS;
  p.stage_bytes = static_cast<int>(stage_bytes<KT, HD>(p.stage_keys));
  const size_t merge = sizeof(float) * NW * RT * (HD + 2);
  const size_t ring = NS * static_cast<size_t>(p.stage_bytes);
  p.ring_bytes = static_cast<int>(ring > merge ? ring : merge);
  return p.ring_bytes + tail_bytes<HD>() + sizeof(int) * 3 * p.per_split;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t* configured) {
  // above 48 KB only as opted-in dynamic shared memory, raised per device
  // to the largest size asked for so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    // all of the SM's memory as shared that it can take: blocks, not L1, hold the ring
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured[dev] = bytes;
  }
  return cudaSuccess;
}

template <typename QT, typename KT, typename ST, int HD, bool RAGGED>
cudaError_t prepare(Params& p, size_t* smem) {
  static size_t configured[kMaxDevices] = {};
  *smem = geometry<KT, HD>(p);
  return allow_smem(paged_verify_kernel<QT, KT, ST, HD, RAGGED>, *smem, configured);
}

template <typename QT, typename KT, typename ST, int HD, bool RAGGED>
cudaError_t launch(Params p, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t e = prepare<QT, KT, ST, HD, RAGGED>(p, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.tiles * p.n_splits, p.KVH, p.B);
  paged_verify_kernel<QT, KT, ST, HD, RAGGED><<<grid, NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return e;
  paged_verify_kernel_combine<QT, HD><<<dim3(p.tiles, p.KVH, p.B), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, typename ST, int HD>
cudaError_t occupancy(Params p, int* blocks, int* smem_bytes) {
  size_t smem = 0;
  cudaError_t e = prepare<QT, KT, ST, HD, true>(p, &smem);
  if (e != cudaSuccess) return e;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, paged_verify_kernel<QT, KT, ST, HD, true>, NT, smem);
}

template <bool RAGGED>
int dispatch(int q_dtype, int kv_dtype, const Params& p, int hd, cudaStream_t s) {
#define PV_HD(QT, KT, ST)                                              \
  if (hd == 64) return launch<QT, KT, ST, 64, RAGGED>(p, s);           \
  if (hd == 128) return launch<QT, KT, ST, 128, RAGGED>(p, s);         \
  return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) { PV_HD(float, float, float) }
  if (q_dtype == 1 && kv_dtype == 1) { PV_HD(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16) }
  if (q_dtype == 0 && kv_dtype == 2) { PV_HD(float, int8_t, float) }
  if (q_dtype == 1 && kv_dtype == 2) { PV_HD(__nv_bfloat16, int8_t, __nv_bfloat16) }
#undef PV_HD
  return cudaErrorInvalidValue;
}

bool valid_shape(const Params& p) {
  return p.B > 0 && p.T > 0 && p.MAXB > 0 && p.KVH > 0 && p.H % p.KVH == 0 && p.bs > 0 &&
         p.bs <= 64 && 64 % p.bs == 0 && (1 << p.lbs) == p.bs && p.n_splits > 0 &&
         p.per_split > 0 && p.per_split * p.n_splits >= p.MAXB &&
         p.tiles * RT >= (p.H / p.KVH) * p.T;
}

int log2_exact(int x) {
  int n = 0;
  while ((1 << n) < x) ++n;
  return n;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  Scales take the query
// dtype.  `cu` is read only when `ragged` is set (K3); K2 passes null.
// With n_splits > 1, `ws` is an fp32 workspace of parts * (hd + 2) floats,
// parts = B * KVH * n_splits * tiles * 8 (8 folded rows per tile); the
// call then runs the partial kernel and the combine kernel.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_verify_attn(
    int ragged, int q_dtype, int kv_dtype, const void* q, const void* k,
    const void* v, const void* q_pos, const void* pos, const void* bt,
    const void* cu, const void* k_scale, const void* v_scale, void* out,
    int B, int T, int H, int KVH, int bs, int MAXB, int hd, int n_splits, void* ws,
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
  p.B = B; p.T = T; p.H = H; p.KVH = KVH; p.bs = bs; p.lbs = log2_exact(bs); p.MAXB = MAXB;
  p.n_splits = n_splits;
  p.per_split = n_splits > 0 ? (MAXB + n_splits - 1) / n_splits : 0;
  p.tiles = KVH > 0 ? ((H / KVH) * T + RT - 1) / RT : 0;
  const long long parts = static_cast<long long>(B) * KVH * n_splits * p.tiles * RT;
  float* w = static_cast<float*>(ws);
  p.ws_acc = w;
  p.ws_m = w ? w + parts * hd : nullptr;
  p.ws_l = w ? w + parts * (hd + 1) : nullptr;
  p.q_sb = q_sb; p.q_st = q_st; p.k_sn = k_sn; p.k_sl = k_sl;
  p.v_sn = v_sn; p.v_sl = v_sl; p.s_sn = s_sn; p.s_sl = s_sl;
  p.qp_sb = qp_sb; p.pos_sn = pos_sn; p.bt_sb = bt_sb;
  p.scale = scale; p.has_window = has_window; p.window = window;
  p.prefix_len = prefix_len;
  if (!valid_shape(p) || (n_splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ragged) {
    if (cu == nullptr) return cudaErrorInvalidValue;
    return dispatch<true>(q_dtype, kv_dtype, p, hd, s);
  }
  return dispatch<false>(q_dtype, kv_dtype, p, hd, s);
}

// Blocks per SM of the current card and dynamic shared memory per block of
// the partial kernel at (q dtype, kv dtype, hd, bs) with one split over
// MAXB table entries, into *blocks and *smem_bytes: the runtime's occupancy
// calculator, which also counts registers and their allocation granularity.
extern "C" int paged_verify_occupancy(int q_dtype, int kv_dtype, int hd, int bs, int MAXB,
                                      int* blocks, int* smem_bytes) {
  Params p = {};
  p.bs = bs; p.lbs = log2_exact(bs); p.MAXB = MAXB; p.n_splits = 1; p.per_split = MAXB;
  if (bs <= 0 || bs > 64 || 64 % bs != 0 || MAXB <= 0) return cudaErrorInvalidValue;
#define PV_OCC(QT, KT, ST)                                                     \
  if (hd == 64) return occupancy<QT, KT, ST, 64>(p, blocks, smem_bytes);       \
  if (hd == 128) return occupancy<QT, KT, ST, 128>(p, blocks, smem_bytes);     \
  return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) { PV_OCC(float, float, float) }
  if (q_dtype == 1 && kv_dtype == 1) { PV_OCC(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16) }
  if (q_dtype == 0 && kv_dtype == 2) { PV_OCC(float, int8_t, float) }
  if (q_dtype == 1 && kv_dtype == 2) { PV_OCC(__nv_bfloat16, int8_t, __nv_bfloat16) }
#undef PV_OCC
  return cudaErrorInvalidValue;
}
