// Speculative-verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `spec_verify_attn_pallas`
// (src/repro/kernels/spec_verify_attn.py, body `_verify_kernel`) and the
// head folding of its wrapper `ops.spec_verify_attn`
// (src/repro/kernels/ops.py).  It computes GQA attention of T query rows per
// request against a contiguous ring cache k/v [B, L, KVH, hd], masked by
// absolute position (attn_tile.cuh): causal, with an optional window and
// prefix, rows at position -1 never attended.  Softmax runs online in fp32;
// a fully masked query row outputs zeros.  int8 k/v come with per-(row,
// kv-head) scales [B, L, KVH].
//
// What bounds it on an H100.  The verify and decode calls (T = s+1 <= 9
// rows per request) are bound by bytes: every K/V byte feeds a handful of
// dot products.  The prefills (B = 1, T 64-256 into a 512-row ring) do
// 4 x T x visible keys x hd flop per head and, on the tensor cores, are
// bound by neither: a B = 1 call moves a few MB, so what is left is latency
// (the chain of tiles one block walks) and filling 132 SMs.  The design:
//   * the products run on the tensor cores (mma.sync, attn_tile.cuh):
//     bf16 m16n8k16 with P rounded to bf16 before P V; fp32 as three tf32
//     m16n8k8 products (big*big + big*small + small*big), since one tf32
//     product misses the fp32 tolerance.  A warp owns 16 folded rows
//     g*T + t (the G query heads of a kv-head share each K/V tile) and
//     keeps the online softmax on its accumulator fragments;
//   * a row tile sized to the call: calls of at most 16 folded rows (the
//     verify and decode steps of a G = 1 model) take blocks of one warp,
//     others blocks of four warps and 64 rows (the wrapper picks it from
//     the shapes);
//   * K/V tiles of 32 keys in their storage type move by 16-byte cp.async
//     into a ring (three stages for one-warp blocks, two for four-warp
//     ones), read in place through the (b, l) strides; row padding keeps
//     ldmatrix and the fragment reads free of bank conflicts;
//   * before any K/V byte moves, the block tests the key positions of the
//     whole ring against its rows, 32 tiles a round trip, into a bit mask
//     of the tiles some row may see (and those every row sees whole, which
//     need no mask); invisible tiles cost no bytes.  On a ring row order is
//     not position order, and the test uses positions only;
//   * split-KV: when the (b, kv-head, row tile) blocks alone would leave
//     SMs idle and the cache is long, each one's visible tiles are shared
//     by n_splits blocks (split c takes tiles [c*P, c*P + P) of the ordered
//     visible list, P = ceil(visible / n_splits)).  n_splits comes from the
//     shapes and the SM count (the wrapper), so the launch never depends on
//     the data.  The splits write fp32 (acc, m, l) to a workspace and
//     `verify_kernel_combine` folds them in split order 0, 1, 2, ..., never
//     in arrival order;
//   * int8 tiles are copied as int8 and dequantised in shared memory
//     (x * scale in fp32, then to the query's type) before the fragments
//     are read.
#include <climits>
#include <math.h>

#include "attn_tile.cuh"

namespace {

constexpr int BK = 32;          // keys per tile
constexpr int SCAN_TILES = 32;  // key tiles a warp tests per round trip (one mask word)
constexpr int NT_C = 128;       // threads of a combine block
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
  float* ws_acc;           // [parts, hd] with n_splits > 1, else null
  float* ws_m;             // [parts], natural-log units
  float* ws_l;             // [parts]
  int B, T, H, KVH, L;
  int rt, tiles, n_splits; // folded rows per row tile, row tiles, key splits
  long long q_sb, q_st;    // q strides over (b, t); heads and hd contiguous
  long long k_sb, k_sl;    // k strides over (b, l); kv-heads and hd contiguous
  long long v_sb, v_sl;
  long long s_sb, s_sl;    // scale strides over (b, l); kv-heads contiguous
  long long qp_sb, kp_sb;  // position strides over b; t / l contiguous
  float scale;
  int has_window, window, prefix_len;
};

// Blocks of NW warps (16 folded rows each) at head dim HD: ring stages,
// row padding (elements) of the Q/K and V tiles, and the blocks an SM the
// registers are sized for.  The padding puts fp32 Q/K rows at 8 mod 32
// words (float2 per lane), fp32 V rows at 4 mod 16 words, bf16 rows at 4
// mod 32 words (ldmatrix).  One-warp blocks take three stages to keep more
// bytes in flight for the byte-bound decode calls.  At hd 256 the output
// accumulator alone is 128 fp32 registers a thread: the four-warp bf16
// block, which three blocks an SM would cut to 168, takes 255 (shared
// memory allows two of its 101 KB blocks; the fp32 blocks, 197-213 KB, run
// one an SM).
template <typename QT, int NW, int HD> struct Cfg {
  static constexpr int NSTG = NW == 1 ? 3 : 2;
  static constexpr int PADK = 8, PADV = sizeof(QT) == 2 ? 8 : 4;
  static constexpr int MIN_BLOCKS =
      NW == 1 ? 4 : (sizeof(QT) == 2 && HD <= 128 ? 3 : 2);
};

// shared memory: Qs [16 NW][HD+PADK]; Ks [KSTG][BK][HD+PADK], Vs
// [KSTG][BK][HD+PADV] in the query's type (KSTG = NSTG, or 1 for int8,
// whose stages are the int8 staging K8/V8 [NSTG][BK][HD+16]); KP
// [NSTG][BK] positions; VIS/FULL [nwin] tile masks
template <typename QT, typename KT, int HD, int NW>
size_t smem_bytes(int L) {
  using C = Cfg<QT, NW, HD>;
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int KSTG = QUANT ? 1 : C::NSTG;
  const int nwin = ((L + BK - 1) / BK + SCAN_TILES - 1) / SCAN_TILES;
  return sizeof(QT) * (16 * NW * (HD + C::PADK) + KSTG * BK * (2 * HD + C::PADK + C::PADV)) +
         (QUANT ? 2 * C::NSTG * BK * (HD + 16) : 0) + sizeof(int) * C::NSTG * BK +
         sizeof(unsigned) * 2 * nwin;
}

// One block per (row tile, split, kv-head, b).  Rows fr = g*T + t of the
// tile fold the G query heads of kv-head kvh; warp w owns rows 16w ..
// 16w + 15 of the tile.
template <typename QT, typename KT, int HD, int NW>
__global__ void __launch_bounds__(32 * NW, Cfg<QT, NW, HD>::MIN_BLOCKS)
    verify_kernel(const Params p) {
  using C = Cfg<QT, NW, HD>;
  constexpr bool kBf16 = sizeof(QT) == 2;
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int NT = 32 * NW, FBQ = 16 * NW, NSTG = C::NSTG;
  constexpr int KSTG = QUANT ? 1 : NSTG;
  constexpr int RK = HD + C::PADK;        // Q and K row stride (elements)
  constexpr int RV = HD + C::PADV;        // V row stride
  constexpr int RS8 = HD + 16;            // int8 staging row stride (bytes)
  constexpr int EPC = 16 / sizeof(QT);    // query elements per 16-byte copy
  constexpr int CPR = HD / EPC;           // copies per query row
  constexpr int KCPR = HD * sizeof(KT) / 16;  // copies per K/V row
  // a K/V row's copies are taken by KCW threads, KREP each (one, except
  // where a row has more copies than the block threads: fp32 at hd 256 in
  // one warp), so a pass of the block covers KRPC rows
  constexpr int KCW = KCPR < NT ? KCPR : NT;
  constexpr int KREP = KCPR / KCW;
  constexpr int KRPC = NT / KCW;
  constexpr int NS = BK / 8;              // n8 tiles of a score row
  constexpr int NO = HD / 8;              // n8 tiles of an output row
  static_assert((FBQ * CPR) % NT == 0 && NT % KCW == 0 && KCPR % KCW == 0 &&
                    BK % KRPC == 0 && NT >= BK && (!QUANT || KREP == 1),
                "copy layout");

  extern __shared__ __align__(16) unsigned char verify_smem_raw[];
  QT* Qs = reinterpret_cast<QT*>(verify_smem_raw);
  QT* Ks = Qs + FBQ * RK;
  QT* Vs = Ks + KSTG * BK * RK;
  unsigned char* K8 = reinterpret_cast<unsigned char*>(Vs + KSTG * BK * RV);
  unsigned char* V8 = K8 + (QUANT ? NSTG * BK * RS8 : 0);
  int* KP = reinterpret_cast<int*>(V8 + (QUANT ? NSTG * BK * RS8 : 0));
  unsigned* VIS = reinterpret_cast<unsigned*>(KP + NSTG * BK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, lane in quad
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  // the last row tiles, which see the most keys under a causal mask, first
  const int tile = p.tiles - 1 - static_cast<int>(blockIdx.x) / p.n_splits;
  const int split = static_cast<int>(blockIdx.x) % p.n_splits;
  const int r0 = tile * FBQ;
  const int nr = min(FBQ, G * p.T - r0);
  const int ntiles = (p.L + BK - 1) / BK;
  const int nwin = (ntiles + SCAN_TILES - 1) / SCAN_TILES;
  unsigned* FULL = VIS + nwin;
  const QT* qg = static_cast<const QT*>(p.q);

  // Q, once, zeros past nr: copy tid + i * NT is chunk c of row r
  {
#pragma unroll
    for (int i = 0; i < FBQ * CPR / NT; ++i) {
      const int r = (tid + i * NT) / CPR, c = (tid + i * NT) % CPR;
      const bool ok = r < nr;
      const int fr = r0 + (ok ? r : 0);
      const long long off =
          b * p.q_sb + (fr % p.T) * p.q_st + static_cast<long long>(kvh * G + fr / p.T) * HD;
      cp_async16(Qs + r * RK + c * EPC, qg + (ok ? off : 0) + c * EPC, ok);
    }
    cp_async_commit();
  }

  // positions of this lane's two fragment rows, and the span of the block's
  // valid positions (every warp computes the same)
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    qp[h] = r < nr ? p.q_pos[b * p.qp_sb + (r0 + r) % p.T] : -1;
  }
  int qhi = -1, qlo = INT_MAX, qmin = INT_MAX;
  for (int r = lane; r < nr; r += 32) {
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

  // the tiles some row may see, and those every row sees whole: one mask
  // word per SCAN_TILES tiles, the warps taking the words in turn
  for (int w = warp; w < nwin; w += NW) {
    TileScan sc;
    scan_tiles<BK, SCAN_TILES>(p, b, w * SCAN_TILES, qmin, qlo, qhi, lane, sc);
    if (lane == 0) {
      VIS[w] = sc.vis;
      FULL[w] = sc.full;
    }
  }
  __syncthreads();

  // this split's share of the ordered visible tiles: [first, first + count)
  int nvis = 0;
  for (int w = 0; w < nwin; ++w) nvis += __popc(VIS[w]);
  const int per = (nvis + p.n_splits - 1) / p.n_splits;
  const int first = split * per;
  const int count = max(0, min(nvis, first + per) - first);
  int ww = 0;                 // the walk: mask word, its tiles not yet taken
  unsigned rem = VIS[0];
  if (count > 0) {
    int skip = first;
    for (int c = __popc(rem); skip >= c; c = __popc(rem)) {
      skip -= c;
      rem = VIS[++ww];
    }
    for (; skip > 0; --skip) rem &= rem - 1;
  }
  auto next_visible = [&]() {
    while (rem == 0) rem = VIS[++ww];
    const int t = ww * SCAN_TILES + __ffs(rem) - 1;
    rem &= rem - 1;
    return t;
  };

  // K/V rows [jt*BK, jt*BK + BK) and their positions into stage st; rows
  // past L are zeros (V must be finite where P is 0) at position -1.  This
  // thread takes chunks kc, kc + KCW, ... of rows kjr, kjr + KRPC, ...
  const int kc = tid % KCW, kjr = tid / KCW;
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k) +
                               (b * p.k_sb + static_cast<long long>(kvh) * HD) * sizeof(KT) +
                               kc * 16;
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v) +
                               (b * p.v_sb + static_cast<long long>(kvh) * HD) * sizeof(KT) +
                               kc * 16;
  const long long k_row = p.k_sl * static_cast<long long>(sizeof(KT));
  const long long v_row = p.v_sl * static_cast<long long>(sizeof(KT));
  constexpr int KROWB = QUANT ? RS8 : RK * static_cast<int>(sizeof(QT));  // stage row bytes
  constexpr int VROWB = QUANT ? RS8 : RV * static_cast<int>(sizeof(QT));
  unsigned char* kst0 = QUANT ? K8 : reinterpret_cast<unsigned char*>(Ks);
  unsigned char* vst0 = QUANT ? V8 : reinterpret_cast<unsigned char*>(Vs);
  auto load_tile = [&](int jt, int st) {
    const int j0 = jt * BK + kjr;
    const unsigned char* kr = kbase + j0 * k_row;
    const unsigned char* vr = vbase + j0 * v_row;
    unsigned char* ks = kst0 + (st * BK + kjr) * KROWB + kc * 16;
    unsigned char* vs = vst0 + (st * BK + kjr) * VROWB + kc * 16;
#pragma unroll
    for (int i = 0; i < BK / KRPC; ++i) {
      const bool ok = j0 + i * KRPC < p.L;
#pragma unroll
      for (int x = 0; x < KREP; ++x) {
        cp_async16(ks + i * KRPC * KROWB + x * KCW * 16, ok ? kr + x * KCW * 16 : kbase, ok);
        cp_async16(vs + i * KRPC * VROWB + x * KCW * 16, ok ? vr + x * KCW * 16 : vbase, ok);
      }
      kr += KRPC * k_row;
      vr += KRPC * v_row;
    }
    if (tid < BK) {
      const int jj = jt * BK + tid;
      if (jj < p.L)
        cp_async4(KP + st * BK + tid, p.k_pos + b * p.kp_sb + jj);
      else
        KP[st * BK + tid] = -1;
    }
  };

  // prologue: the first NSTG - 1 tiles in flight; pend[i] is the tile in
  // the stage computed i iterations from now (ntiles: none)
  int pend[NSTG - 1];
  int issued = 0;
#pragma unroll
  for (int s = 0; s < NSTG - 1; ++s) {
    const int t = issued < count ? next_visible() : ntiles;
    ++issued;
    if (t < ntiles) load_tile(t, s);
    cp_async_commit();
    pend[s] = t;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  const QT* qw = Qs + warp * 16 * RK;
  const bool active = warp * 16 < nr;  // a warp without rows copies but computes nothing

  for (int i = 0, st = 0; i < count; ++i) {
    const int jt = pend[0];
    const bool full = (FULL[jt / SCAN_TILES] >> (jt % SCAN_TILES)) & 1u;
    float ksc[QUANT ? BK / KRPC : 1], vsc[QUANT ? BK / KRPC : 1];
    if constexpr (QUANT) {  // this thread's rows' scales, in flight across the wait
      using ST = QT;
      const ST* ksg = static_cast<const ST*>(p.k_scale);
      const ST* vsg = static_cast<const ST*>(p.v_scale);
#pragma unroll
      for (int r = 0; r < BK / KRPC; ++r) {
        const int jj = jt * BK + kjr + r * KRPC;
        const long long so = b * p.s_sb + jj * p.s_sl + kvh;
        ksc[r] = jj < p.L ? to_f(ksg[so]) : 0.f;
        vsc[r] = jj < p.L ? to_f(vsg[so]) : 0.f;
      }
    }
    cp_async_wait<NSTG - 2>();
    __syncthreads();  // tile jt landed; every warp is done with the stage refilled next
    {
      const int t = issued < count ? next_visible() : ntiles;
      ++issued;
      if (t < ntiles) load_tile(t, st == 0 ? NSTG - 1 : st - 1);
      cp_async_commit();
#pragma unroll
      for (int s = 0; s + 1 < NSTG - 1; ++s) pend[s] = pend[s + 1];
      pend[NSTG - 2] = t;
    }
    if constexpr (QUANT) {  // dequantise stage st into the compute tile
#pragma unroll
      for (int r = 0; r < BK / KRPC; ++r) {
        const int j = kjr + r * KRPC;
        const uint4 kx = *reinterpret_cast<const uint4*>(K8 + (st * BK + j) * RS8 + kc * 16);
        const uint4 vx = *reinterpret_cast<const uint4*>(V8 + (st * BK + j) * RS8 + kc * 16);
        const uint32_t kw[4] = {kx.x, kx.y, kx.z, kx.w}, vw[4] = {vx.x, vx.y, vx.z, vx.w};
        QT* kd = Ks + j * RK + kc * 16;
        QT* vd = Vs + j * RV + kc * 16;
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          const int sh0 = 8 * (e % 4), sh1 = 8 * ((e + 1) % 4);
          const float k0 = static_cast<float>(static_cast<int>(kw[e / 4] << (24 - sh0)) >> 24);
          const float k1 = static_cast<float>(static_cast<int>(kw[e / 4] << (24 - sh1)) >> 24);
          const float v0 = static_cast<float>(static_cast<int>(vw[e / 4] << (24 - sh0)) >> 24);
          const float v1 = static_cast<float>(static_cast<int>(vw[e / 4] << (24 - sh1)) >> 24);
          store2(kd + e, k0 * ksc[r], k1 * ksc[r]);
          store2(vd + e, v0 * vsc[r], v1 * vsc[r]);
        }
      }
      __syncthreads();
    }
    const int cs = QUANT ? 0 : st;  // the compute tile's stage
    const QT* ks = Ks + cs * BK * RK;
    const QT* vs = Vs + cs * BK * RV;
    const int* kp = KP + st * BK;
    st = st + 1 == NSTG ? 0 : st + 1;
    if (!active) continue;

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
        // the k index is permuted within each step of 8 (slot t <-> d 2t,
        // slot t+4 <-> d 2t+1) so that a lane reads its pairs as float2
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
        // A slot tig <-> key 8kk + 2tig, slot tig+4 <-> key 8kk + 2tig + 1:
        // the S accumulator's layout, so P never leaves the registers
        uint32_t pb[4], ps[4];
        split_tf32(s[kk][0], pb[0], ps[0]);
        split_tf32(s[kk][2], pb[1], ps[1]);
        split_tf32(s[kk][1], pb[2], ps[2]);
        split_tf32(s[kk][3], pb[3], ps[3]);
        const QT* v0 = vs + (kk * 8 + 2 * tig) * RV + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) mma_3xtf32(o[n], pb, ps, v0[n * 8], v0[RV + n * 8]);
      }
    }
  }
  cp_async_wait<0>();

  // one split: the normalised rows; several: this split's (acc, m, l)
  const long long part0 =
      ((static_cast<long long>(b) * p.KVH + kvh) * p.n_splits + split) * (p.tiles * FBQ) + r0;
  QT* og = static_cast<QT*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int r = warp * 16 + g + 8 * h;
    if (r >= nr) continue;
    if (p.n_splits == 1) {
      const float den = fmaxf(lh, 1e-30f);
      const int fr = r0 + r;
      QT* orow = og + ((static_cast<long long>(b) * p.T + fr % p.T) * p.H + kvh * G + fr / p.T) *
                          HD + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n) store2(orow + n * 8, o[n][2 * h] / den, o[n][2 * h + 1] / den);
    } else {
      const long long part = part0 + r;
      if (tig == 0) {
        p.ws_m[part] = m[h] == -INFINITY ? -INFINITY : (kBf16 ? m[h] * p.scale : m[h]);
        p.ws_l[part] = lh;
      }
      if (m[h] != -INFINITY) {  // the combine reads acc only where m is finite
        float* arow = p.ws_acc + part * HD + 2 * tig;
#pragma unroll
        for (int n = 0; n < NO; ++n) store2(arow + n * 8, o[n][2 * h], o[n][2 * h + 1]);
      }
    }
  }
}

// Fold the splits' (acc, m, l) of each folded row of one (b, kv-head) in
// split order 0, 1, 2, ... and normalise.  A thread takes four columns of
// one row, so a block covers NT_C / (HD / 4) rows and every thread makes
// one pass.  A row that no split saw gives zeros.
template <typename QT, int HD>
__global__ void __launch_bounds__(NT_C) verify_kernel_combine(const Params p) {
  constexpr int CPT = HD / 4;        // threads of a row
  constexpr int RPB = NT_C / CPT;    // rows of a block
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KVH;
  const int fr = blockIdx.x * RPB + threadIdx.x / CPT;
  const int d = 4 * (threadIdx.x % CPT);
  if (fr >= G * p.T) return;
  const long long rows = static_cast<long long>(p.tiles) * p.rt;
  const long long part0 = (static_cast<long long>(b) * p.KVH + kvh) * p.n_splits * rows + fr;
  float M = -INFINITY;
#pragma unroll 4
  for (int c = 0; c < p.n_splits; ++c) M = fmaxf(M, p.ws_m[part0 + c * rows]);
  const float m_safe = M == -INFINITY ? 0.f : M;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  float L = 0.f;
#pragma unroll 4
  for (int c = 0; c < p.n_splits; ++c) {
    const long long pi = part0 + c * rows;
    const float mc = p.ws_m[pi];
    if (mc != -INFINITY) {
      const float f = expf(mc - m_safe);
      const float4 a = *reinterpret_cast<const float4*>(p.ws_acc + pi * HD + d);
      L += f * p.ws_l[pi];
      A.x += f * a.x;
      A.y += f * a.y;
      A.z += f * a.z;
      A.w += f * a.w;
    }
  }
  const float den = fmaxf(L, 1e-30f);
  QT* orow = static_cast<QT*>(p.out) +
             ((static_cast<long long>(b) * p.T + fr % p.T) * p.H + kvh * G + fr / p.T) * HD + d;
  store2(orow, A.x / den, A.y / den);
  store2(orow + 2, A.z / den, A.w / den);
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t* configured) {
  // above 48 KB only as opted-in dynamic shared memory, raised per device
  // to the largest size asked for so far, with all of the SM's memory as
  // shared that it can take
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured[dev] = bytes;
  }
  return cudaSuccess;
}

template <typename QT, typename KT, int HD, int NW>
cudaError_t prepare(const Params& p, size_t* smem) {
  static size_t configured[kMaxDevices] = {};
  *smem = smem_bytes<QT, KT, HD, NW>(p.L);
  return allow_smem(verify_kernel<QT, KT, HD, NW>, *smem, configured);
}

template <typename QT, typename KT, int HD, int NW>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t e = prepare<QT, KT, HD, NW>(p, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.tiles * p.n_splits, p.KVH, p.B);
  verify_kernel<QT, KT, HD, NW><<<grid, 32 * NW, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_splits == 1) return e;
  constexpr int RPB = NT_C / (HD / 4);
  const int nrows = (p.H / p.KVH) * p.T;
  verify_kernel_combine<QT, HD><<<dim3((nrows + RPB - 1) / RPB, p.KVH, p.B), NT_C, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, int HD, int NW>
cudaError_t occupancy(const Params& p, int* blocks, int* smem_bytes_out) {
  size_t smem = 0;
  cudaError_t e = prepare<QT, KT, HD, NW>(p, &smem);
  if (e != cudaSuccess) return e;
  *smem_bytes_out = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, verify_kernel<QT, KT, HD, NW>,
                                                       32 * NW, smem);
}

// the instantiation for (q dtype, kv dtype, hd, row tile): F(QT, KT, HD, NW)
#define SV_DISPATCH(F)                                                      \
  if (hd == 64 && p.rt == 16) return F(QT, KT, 64, 1);                      \
  if (hd == 64 && p.rt == 64) return F(QT, KT, 64, 4);                      \
  if (hd == 128 && p.rt == 16) return F(QT, KT, 128, 1);                    \
  if (hd == 128 && p.rt == 64) return F(QT, KT, 128, 4);                    \
  if (hd == 256 && p.rt == 16) return F(QT, KT, 256, 1);                    \
  if (hd == 256 && p.rt == 64) return F(QT, KT, 256, 4);                    \
  return cudaErrorInvalidValue;

#define SV_LAUNCH(QT, KT, HD, NW) launch<QT, KT, HD, NW>(p, s)
#define SV_OCC(QT, KT, HD, NW) occupancy<QT, KT, HD, NW>(p, blocks, smem_bytes_out)

template <typename QT, typename KT>
cudaError_t dispatch(const Params& p, int hd, cudaStream_t s) {
  SV_DISPATCH(SV_LAUNCH)
}

template <typename QT, typename KT>
cudaError_t dispatch_occupancy(const Params& p, int hd, int* blocks, int* smem_bytes_out) {
  SV_DISPATCH(SV_OCC)
}

#undef SV_OCC
#undef SV_LAUNCH
#undef SV_DISPATCH

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.  Scales take the query
// dtype.  row_tile is 16 (blocks of one warp) or 64 (four warps).  With
// n_splits > 1, `ws` is an fp32 workspace of parts * (hd + 2) floats,
// parts = B * KVH * n_splits * ceil(G*T / row_tile) * row_tile; the call
// then runs the split kernel and the combine kernel.  q, k and v are
// copied 16 bytes at a time: their bases and (b, t) / (b, l) strides must
// be multiples of 16 bytes (the scales are read element by element).
// Returns a cudaError_t (0 = launched).
extern "C" int spec_verify_attn(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* q_pos, const void* k_pos, const void* k_scale, const void* v_scale,
    void* out, int B, int T, int H, int KVH, int L, int hd, int row_tile, int n_splits,
    void* ws, long long q_sb, long long q_st, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long s_sb, long long s_sl,
    long long qp_sb, long long kp_sb, float scale, int has_window, int window,
    int prefix_len, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || n_splits <= 0 ||
      (row_tile != 16 && row_tile != 64) || (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.k_scale = k_scale; p.v_scale = v_scale; p.out = out;
  p.B = B; p.T = T; p.H = H; p.KVH = KVH; p.L = L;
  p.rt = row_tile;
  p.tiles = ((H / KVH) * T + row_tile - 1) / row_tile;
  p.n_splits = n_splits;
  const long long parts = static_cast<long long>(B) * KVH * n_splits * p.tiles * row_tile;
  float* w = static_cast<float*>(ws);
  p.ws_acc = w;
  p.ws_m = w ? w + parts * hd : nullptr;
  p.ws_l = w ? w + parts * (hd + 1) : nullptr;
  p.q_sb = q_sb; p.q_st = q_st; p.k_sb = k_sb; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sl = v_sl; p.s_sb = s_sb; p.s_sl = s_sl;
  p.qp_sb = qp_sb; p.kp_sb = kp_sb;
  p.scale = scale; p.has_window = has_window; p.window = window;
  p.prefix_len = prefix_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, hd, s);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch<float, int8_t>(p, hd, s);
  if (q_dtype == 1 && kv_dtype == 2) return dispatch<__nv_bfloat16, int8_t>(p, hd, s);
  return cudaErrorInvalidValue;
}

// Blocks per SM of the current card and dynamic shared memory per block of
// the split kernel at (q dtype, kv dtype, hd, row tile) over a cache of L
// rows, into *blocks and *smem_bytes: the runtime's occupancy calculator,
// which also counts registers and their allocation granularity.
extern "C" int spec_verify_occupancy(int q_dtype, int kv_dtype, int hd, int row_tile, int L,
                                     int* blocks, int* smem_bytes_out) {
  if (L <= 0 || (row_tile != 16 && row_tile != 64)) return cudaErrorInvalidValue;
  Params p = {};
  p.L = L;
  p.rt = row_tile;
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_occupancy<float, float>(p, hd, blocks, smem_bytes_out);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_occupancy<__nv_bfloat16, __nv_bfloat16>(p, hd, blocks, smem_bytes_out);
  if (q_dtype == 0 && kv_dtype == 2)
    return dispatch_occupancy<float, int8_t>(p, hd, blocks, smem_bytes_out);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_occupancy<__nv_bfloat16, int8_t>(p, hd, blocks, smem_bytes_out);
  return cudaErrorInvalidValue;
}
