// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface: K6.
//
// Replaces the TPU kernel `ssd_chunk_pallas` (src/repro/kernels/ssd_chunk.py,
// body `_ssd_chunk_kernel`) together with the chunk loop around it that the
// JAX model runs as a `lax.scan` (`Mamba2LM._ssd_chunked`,
// src/repro/models/mamba2.py).  For one (batch, head) slice and one chunk of
// Q rows, with x [Q, P], b/c [Q, N] (the head's group), dt [Q], the
// log-decay l [Q] (l = -dt * A[head] on the model's path) and the carried
// state h0 [P, N]:
//   cs    = cumsum(l)
//   S     = c b^T,  M = tril(S * exp(cs_i - cs_j) * dt_j)
//   y     = M x + exp(cs) * (c h0^T)
//   h_new = exp(cs_Q) h0 + (x * w)^T b,   w_j = dt_j exp(cs_Q - cs_j)
// and h_new is carried into the next chunk.
//
// What bounds it on an H100: at the serving prefills (one chunk of T <= 256
// rows, bf16, a zero state) bytes and latency: about 9 MB and 0.55 GFLOP at
// B 1, T 256, 64 heads.  At long fp32 prefills the tensor cores: about 21
// MFLOP per (head, 256-row chunk), each product as three tf32 products.
// What the design does:
//   * all four products run on the tensor cores (mma.sync m16n8k16 bf16 or
//     m16n8k8 tf32, fp32 accumulators).  bf16 inputs are exact bf16
//     operands; an fp32 intermediate (the decayed scores M, x * w, the
//     carried state) enters as a bf16 pair hi + lo (two products, about 16
//     bits of it).  fp32 inputs run every product as three tf32 products
//     with the bit-mask split of K4's backward;
//   * roles of 4-warp blocks.  An output block takes WR row tiles of 16 rows
//     of one chunk and 4 / WR heads of one group, a warp per (row tile,
//     head); the block's warps share each b tile and each head's x tile.  A
//     state block takes one head's chunk state, 64 (or 128) rows of P by a
//     column split of N.  (A warp computing c b^T once for two heads of a
//     group was slower at every shape tools/ssd_variants.py timed: the
//     products are not what limits the kernel.)  With several chunks a
//     c b^T block computes each chunk's c b^T once for its group, and the
//     output blocks of every head read it;
//   * b, c and x tiles arrive by 16-byte cp.async: the output blocks' keys
//     in stages of two 16-key tiles through a ring (3 stages in bf16, 2 in
//     fp32), one barrier a stage; key tiles past a row tile's diagonal are
//     skipped, and rows past Q are zero operands whose results are
//     dropped.  A carried-in state reaches the output blocks through
//     shared memory, one head at a time;
//   * the decay is masked above the diagonal before its exp: exp(cs_i)
//     exp(-cs_j) would overflow (cs falls to about -410 over 256 rows under
//     strong decay);
//   * one chunk (every serving prefill) is one launch: the output blocks
//     use h0 directly and the state blocks write exp(cs_Q) h0 + (x w)^T b.
//     Several chunks take the chunk-parallel form (arXiv:2405.21060 §6):
//     each chunk's state from zero and its c b^T, in parallel; an ordered
//     pass that carries the states over the chunks (P x N element-wise work
//     a chunk); then every chunk's outputs from its carried-in state: three
//     launches whatever the number of chunks.  No atomics; two calls agree
//     bit for bit;
//   * h0 may be null: a zero state, whose reads and products are skipped.
// The grid (WR, the state split) is the wrapper's, a function of the shapes
// (kernels/ssd_chunk.py, ssd_plan).
//
// The scan's backward (ssd_chunk_scan_bwd: the gradients of x, b, c, dt, A
// and h0) follows the forward in this file, with its own design notes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

constexpr int NW = 4;            // warps per block
constexpr int NT = 32 * NW;      // threads per block
constexpr int TR = 16;           // output role: rows per row tile, keys per key tile
// output role: stages of 32 keys in its ring (bf16 stages are half the size)
template <typename T>
__host__ __device__ constexpr int out_stages() { return sizeof(T) == 2 ? 3 : 2; }
constexpr int OSTAGES = 2;       // c b^T role: stages of 32 keys in its ring
constexpr int SK = 32;           // state role: keys per stage of its ring
constexpr int MAXQ = 256;        // chunk rows at most
constexpr int PAD = 8;           // row padding (elements) of every staged tile
constexpr int kMaxDevices = 64;
constexpr float LOG2E = 1.4426950408889634f;
// bf16: fp32 intermediates as a hi + lo pair of bf16 operands (two products)
// (tools/ssd_variants.py's `rounded` variant times the kernel with it false)
constexpr bool kSplitBf16 = true;

struct Params {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* l;   // log-decay, or null: then l = -dt * A[head]
  const float* A;
  const float* h0;  // [B, H, P, N] contiguous, or null: a zero state
  float* y;         // [B, T, H, P] contiguous
  float* h_out;     // [B, H, P, N] contiguous
  float* ws;        // several chunks: [B, nc, H, P, N], the chunk states, then carried-in
  float* dec;       // several chunks: [B, nc, H], cs_Q * log2(e) of each chunk
  float* sws;       // several chunks: [B, nc, G, QP, QP], c b^T of each chunk and group
  int B, T, H, G, P, N, Q, nc;
  long long x_sb, x_st, x_sh;     // x strides over (b, t, head); p contiguous
  long long b_sb, b_st, b_sg;     // b strides over (b, t, group); n contiguous
  long long c_sb, c_st, c_sg;
  long long dt_sb, dt_st, dt_sh;  // dt (and l) strides over (b, t, head)
  int pp, np;       // P and N rounded up to 16
  int qp;           // Q rounded up to 16
  int wr, hb;       // output role: row tiles and heads a block (a warp each)
  int has_hin;      // output role: a carried-in state (h0, or several chunks)
  int nspl;         // state role: column splits of the state
  int n_first;      // blocks of a launch's first role: output blocks in ssd_scan,
                    // c b^T blocks in ssd_states
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// state role: n8 tiles of N a block takes
__host__ __device__ inline int state_n8(const Params& p) { return (p.np / 8 + p.nspl - 1) / p.nspl; }

// output role: a stage of its ring holds 32 keys' b rows, or with several
// chunks the block's rows of c b^T at those keys from the workspace; and
// each head's x rows at those keys
template <typename T>
__host__ __device__ inline int out_stage_elems(const Params& p) {
  return p.sws != nullptr ? p.wr * TR * (2 * TR + PAD) * 4 / static_cast<int>(sizeof(T))
                          : 2 * TR * (p.np + PAD);
}

template <typename T>
__host__ __device__ inline size_t out_smem(const Params& p) {
  const int RC = p.np + PAD, RX = p.pp + PAD;
  constexpr int NS = out_stages<T>();
  return sizeof(T) * (static_cast<size_t>(p.wr) * TR * RC + NS * out_stage_elems<T>(p) +
                      NS * p.hb * 2 * TR * RX) +
         sizeof(float) * (2 * p.hb * MAXQ + (p.has_hin ? p.P * (p.np + PAD) : 0));
}

// c b^T role: the block's rows of c and a ring of b tiles
template <typename T>
__host__ __device__ inline size_t cb_smem(const Params& p) {
  return sizeof(T) * static_cast<size_t>(NW + 2 * OSTAGES) * TR * (p.np + PAD);
}

template <typename T>
__host__ __device__ inline size_t state_smem(const Params& p) {
  const int RS = round16(8 * state_n8(p)) + PAD, RX = p.pp + PAD;
  return sizeof(T) * (2 * SK * RX + 2 * SK * RS) + sizeof(float) * 2 * MAXQ;
}

// K4's backward's fp32 operand split (flash_attn.cu, bwd_split): big = x
// with its low 13 bits cleared, small = x - big; the tensor cores read a tf32
// operand's top 19 bits
__device__ __forceinline__ void split_mask(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b in three tf32 products (the small*small term is dropped)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_mask(b0, bb0, bs0);
  split_mask(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// (v0, v1) as bf16 pairs hi + lo: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - f.x, v1 - f.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// Rows [r0, r0 + nrows) of a tile (row stride rs elements) into dst (row
// stride R), ccols columns (a multiple of 16); rows at or past rvalid and
// columns at or past cvalid (a multiple of 8) are zeros.  Every thread of
// the block takes part; the caller commits.  Where a row's 16-byte chunks
// divide the block (every width of the repo's models), each thread keeps
// one column and walks the rows with pointer steps: no division per chunk,
// whose cost the copies otherwise pay at every stage.
template <typename T, int NTH = NT>
__device__ __forceinline__ void load_rows(T* dst, int R, const T* src, long long rs, int r0,
                                          int nrows, int rvalid, int cvalid, int ccols) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = ccols / EPC;
  if (NTH % cpr == 0) {
    const int rpp = NTH / cpr, cc = (threadIdx.x % cpr) * EPC;
    int rr = threadIdx.x / cpr;
    const T* s = src + (r0 + rr) * rs + cc;
    T* d = dst + rr * R + cc;
    const long long s_step = rpp * rs;
    const int d_step = rpp * R;
    for (; rr < nrows; rr += rpp, s += s_step, d += d_step) {
      const bool ok = r0 + rr < rvalid && cc < cvalid;
      cp_async16(d, ok ? s : src, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < nrows * cpr; e += NTH) {
    const int rr = e / cpr, cc = (e % cpr) * EPC, row = r0 + rr;
    const bool ok = row < rvalid && cc < cvalid;
    cp_async16(dst + rr * R + cc, ok ? src + row * rs + cc : src, ok);
  }
}

// One warp: the inclusive prefix sum of a chunk's log-decay over rows [0, n)
// in runs of 8 rows a lane (the same runs whatever n, so every block of a
// chunk computes the same cs), then a shuffle scan of the run totals.
// Writes cs2[i] = cs_i * log2(e) and dts[i] = dt_i for i < MAXQ (dt 0 and
// the log-decay 0 at and past n).
__device__ void chunk_cumsum(const Params& p, int bb, int h, int t0, int n, float* cs2,
                             float* dts, int lane) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh;
  const float* L = p.l != nullptr ? p.l + bb * p.dt_sb + h * p.dt_sh : nullptr;
  const float rate = p.l != nullptr ? 0.f : p.A[h];
  float v[8], d[8], run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * lane + i;
    float li = 0.f;
    d[i] = 0.f;
    if (row < n) {
      const long long o = static_cast<long long>(t0 + row) * p.dt_st;
      d[i] = DT[o];
      li = L != nullptr ? L[o] : -d[i] * rate;
    }
    run += li;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float base = incl - run;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs2[8 * lane + i] = (base + v[i]) * LOG2E;
    dts[8 * lane + i] = d[i];
  }
}

// s[u][2][4] = the 16 x 16 tiles A B_u^T of a warp for the two 16-key
// sub-tiles u of a stage: A [16][R] (rows), B [32][R] (keys), depth np (a
// multiple of 16).  Element e of n8 tile n of sub-tile u is row g + 8 (e /
// 2), key 16 u + 8 n + 2 tig + e % 2.  One A fragment feeds both sub-tiles.
template <typename T>
__device__ __forceinline__ void scores(float (&s)[2][2][4], const T* a, const T* b, int R,
                                       int np, int lane) {
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][n][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    const int ao = ((lane & 7) + ((lane >> 3) & 1) * 8) * R + (lane >> 4) * 8;
    const int bo = ((lane & 7) + (lane >> 4) * 8) * R + ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int kk = 0; kk < np / 16; ++kk) {
      uint32_t fa[4];
      ldsm_x4(fa, a + ao + kk * 16);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t fb[4];
        ldsm_x4(fb, b + 16 * u * R + bo + kk * 16);
        mma_bf16(s[u][0], fa, fb[0], fb[1]);
        mma_bf16(s[u][1], fa, fb[2], fb[3]);
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < np / 8; ++kk) {
      // k slot t <-> column 2t, slot t+4 <-> 2t+1 (float2 per lane), in both operands
      const int d = kk * 8 + 2 * tig;
      const float2 x0 = *reinterpret_cast<const float2*>(a + g * R + d);
      const float2 x1 = *reinterpret_cast<const float2*>(a + (g + 8) * R + d);
      uint32_t ab[4], as[4];
      split_mask(x0.x, ab[0], as[0]);
      split_mask(x1.x, ab[1], as[1]);
      split_mask(x0.y, ab[2], as[2]);
      split_mask(x1.y, ab[3], as[3]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 v = *reinterpret_cast<const float2*>(b + (16 * u + n * 8 + g) * R + d);
          mma3(s[u][n], ab, as, v.x, v.y);
        }
    }
  }
}

// acc[16][PMAX] += M X: M the warp's 16 x 16 decayed scores in the layout of
// `scores`, X [16 keys][R] in shared memory, pp columns (a multiple of 16).
template <typename T, int PMAX>
__device__ __forceinline__ void mx_product(float (&acc)[PMAX / 8][4], const float (&m)[2][4],
                                           const T* x, int R, int pp, int lane) {
  const int g = lane / 4, tig = lane % 4;
  if constexpr (sizeof(T) == 2) {
    uint32_t ah[4], al[4];
    split_bf16(m[0][0], m[0][1], ah[0], al[0]);
    split_bf16(m[0][2], m[0][3], ah[1], al[1]);
    split_bf16(m[1][0], m[1][1], ah[2], al[2]);
    split_bf16(m[1][2], m[1][3], ah[3], al[3]);
    const T* x0 = x + ((lane & 7) + ((lane >> 3) & 1) * 8) * R + (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < PMAX / 16; ++np) {
      if (np * 16 < pp) {
        uint32_t yb[4];
        ldsm_x4_t(yb, x0 + np * 16);
        mma_bf16(acc[2 * np], ah, yb[0], yb[1]);
        mma_bf16(acc[2 * np + 1], ah, yb[2], yb[3]);
        if (kSplitBf16) {
          mma_bf16(acc[2 * np], al, yb[0], yb[1]);
          mma_bf16(acc[2 * np + 1], al, yb[2], yb[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // the k index permuted within each step of 8 (slot t <-> key 2t, slot
      // t+4 <-> key 2t+1), the layout m already has
      uint32_t xb[4], xs[4];
      split_mask(m[kk][0], xb[0], xs[0]);
      split_mask(m[kk][2], xb[1], xs[1]);
      split_mask(m[kk][1], xb[2], xs[2]);
      split_mask(m[kk][3], xb[3], xs[3]);
      const T* y0 = x + (kk * 8 + 2 * tig) * R + g;
#pragma unroll
      for (int n = 0; n < PMAX / 8; ++n)
        if (n * 8 < pp) mma3(acc[n], xb, xs, y0[n * 8], y0[R + n * 8]);
    }
  }
}

// acc[16][PMAX] += C H^T: C the warp's 16 rows [16][R] in shared memory
// (columns past N are zeros), H [P][RH] fp32 in shared memory (a carried-in
// state), depth N (a multiple of 8).
template <typename T, int PMAX>
__device__ __forceinline__ void off_product(float (&acc)[PMAX / 8][4], const T* c, int R,
                                            const float* hm, int RH, int P, int N, int lane) {
  const int g = lane / 4, tig = lane % 4;
  if constexpr (sizeof(T) == 2) {
    const int ao = ((lane & 7) + ((lane >> 3) & 1) * 8) * R + (lane >> 4) * 8;
    for (int kk = 0; kk < (N + 15) / 16; ++kk) {
      uint32_t fa[4];
      ldsm_x4(fa, c + ao + kk * 16);
      const bool second = kk * 16 + 8 < N;
#pragma unroll
      for (int n = 0; n < PMAX / 8; ++n) {
        if (n * 8 < P) {
          const float* hr = hm + (n * 8 + g) * RH + kk * 16 + 2 * tig;
          const float2 v0 = *reinterpret_cast<const float2*>(hr);
          const float2 v1 = second ? *reinterpret_cast<const float2*>(hr + 8)
                                   : make_float2(0.f, 0.f);
          uint32_t h0, l0, h1, l1;
          split_bf16(v0.x, v0.y, h0, l0);
          split_bf16(v1.x, v1.y, h1, l1);
          mma_bf16(acc[n], fa, h0, h1);
          if (kSplitBf16) mma_bf16(acc[n], fa, l0, l1);
        }
      }
    }
  } else {
    for (int kk = 0; kk < N / 8; ++kk) {
      const int d = kk * 8 + 2 * tig;
      const float2 x0 = *reinterpret_cast<const float2*>(c + g * R + d);
      const float2 x1 = *reinterpret_cast<const float2*>(c + (g + 8) * R + d);
      uint32_t ab[4], as[4];
      split_mask(x0.x, ab[0], as[0]);
      split_mask(x1.x, ab[1], as[1]);
      split_mask(x0.y, ab[2], as[2]);
      split_mask(x1.y, ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < PMAX / 8; ++n) {
        if (n * 8 < P) {
          const float2 u = *reinterpret_cast<const float2*>(hm + (n * 8 + g) * RH + d);
          mma3(acc[n], ab, as, u.x, u.y);
        }
      }
    }
  }
}

// The output role: y of WR row tiles x HB = 4 / WR heads of one (batch,
// chunk), a warp per (row tile, head).
template <typename T, int PMAX>
__device__ __forceinline__ void out_role(const Params& p, unsigned char* smem, int bx) {
  constexpr int PT8 = PMAX / 8;
  constexpr int OSTAGES = out_stages<T>();
  constexpr int KT = 2 * TR;             // keys a stage: two 16-key sub-tiles
  constexpr int RS = KT + PAD;           // row stride of staged c b^T rows
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, tig = lane % 4;
  const int bb = blockIdx.z, k = blockIdx.y, t0 = k * p.Q;
  const int wr = p.wr, hb = p.hb;
  const int nq = (p.Q + TR - 1) / TR, nqb = (nq + wr - 1) / wr, nhg = p.H / hb;
  const int qb = nqb - 1 - bx / nhg;     // the last row tiles, which see the most keys, first
  const int hb0 = (bx % nhg) * hb;       // the block's first head
  const int r0 = qb * wr;
  const int nk = min(nq, r0 + wr);       // key tiles the block needs
  const int nst = (nk + 1) / 2;          // stages
  const int wrow = w % wr, wh = w / wr;  // this warp's row tile and head in the block
  const int r = r0 + wrow;
  const bool active = r < nq;
  const int RC = p.np + PAD, RX = p.pp + PAD, RH = p.np + PAD;
  const bool cb_ws = p.sws != nullptr;   // c b^T from the workspace
  const int SE = out_stage_elems<T>(p);
  T* Cs = reinterpret_cast<T*>(smem);    // [wr][TR][RC]
  T* Bs = Cs + wr * TR * RC;             // [OSTAGES][SE]: b rows [KT][RC] or c b^T rows [wr*TR][RS]
  T* Xs = Bs + OSTAGES * SE;             // [OSTAGES][hb][KT][RX]
  float* cs2 = reinterpret_cast<float*>(Xs + OSTAGES * hb * KT * RX);  // [hb][MAXQ]
  float* dts = cs2 + hb * MAXQ;                                        // [hb][MAXQ]
  float* Hs = dts + hb * MAXQ;           // [P][RH] a carried-in state, when there is one

  const int grp = hb0 / (p.H / p.G);
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;
  const T* Xg = static_cast<const T*>(p.x) + bb * p.x_sb + t0 * p.x_st;
  const float* Sg = cb_ws ? p.sws + ((static_cast<long long>(bb) * p.nc + k) * p.G + grp) *
                                       p.qp * p.qp : nullptr;
  auto load_stage = [&](int sg) {
    const int st = sg % OSTAGES;
    if (cb_ws)
      load_rows<float>(reinterpret_cast<float*>(Bs + st * SE), RS, Sg + sg * KT, p.qp, r0 * TR,
                       wr * TR, p.qp, min(KT, p.qp - sg * KT), KT);
    else
      load_rows<T>(Bs + st * SE, RC, Bg, p.b_st, sg * KT, KT, p.Q, p.N, p.np);
    for (int j = 0; j < hb; ++j)
      load_rows<T>(Xs + (st * hb + j) * KT * RX, RX, Xg + (hb0 + j) * p.x_sh, p.x_st, sg * KT,
                   KT, p.Q, p.P, p.pp);
  };

  load_rows<T>(Cs, RC, Cg, p.c_st, r0 * TR, wr * TR, p.Q, p.N, p.np);
  cp_async_commit();
  for (int sg = 0; sg < OSTAGES - 1; ++sg) {   // the first stages, ahead
    if (sg < nst) load_stage(sg);
    cp_async_commit();
  }
  for (int j = w; j < hb; j += NW)
    chunk_cumsum(p, bb, hb0 + j, t0, min(p.Q, nk * TR), cs2 + j * MAXQ, dts + j * MAXQ, lane);
  cp_async_wait<OSTAGES - 1>();
  __syncthreads();  // c rows and cs in place

  float acc[PT8][4];
#pragma unroll
  for (int n = 0; n < PT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* c2 = cs2 + wh * MAXQ;
  const float* d = dts + wh * MAXQ;

  // the carried-in state's term first: exp(cs_i) (c_i . h_p), one head's
  // state at a time through shared memory
  const float* hbase = p.nc == 1 ? p.h0 : (k == 0 && p.h0 == nullptr ? nullptr : p.ws);
  if (hbase != nullptr) {
    for (int j = 0; j < hb; ++j) {
      const float* hm =
          hbase + ((static_cast<long long>(bb) * p.nc + k) * p.H + hb0 + j) * p.P * p.N;
      load_rows<float>(Hs, RH, hm, p.N, 0, p.P, p.P, p.N, p.np);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // the state in place
      if (active && wh == j) {
        off_product<T, PMAX>(acc, Cs + wrow * TR * RC, RC, Hs, RH, p.P, p.N, lane);
        const float f0 = ex2(c2[r * TR + g]), f1 = ex2(c2[r * TR + g + 8]);
#pragma unroll
        for (int n = 0; n < PT8; ++n) {
          acc[n][0] *= f0;
          acc[n][1] *= f0;
          acc[n][2] *= f1;
          acc[n][3] *= f1;
        }
      }
      __syncthreads();  // the state consumed
    }
  }

  // the chunk's own term, key tiles at or below the diagonal, two a stage
  for (int sg = 0; sg < nst; ++sg) {
    cp_async_wait<OSTAGES - 2>();
    __syncthreads();  // stage sg in place; stage sg - 1 consumed by every warp
    if (sg + OSTAGES - 1 < nst) load_stage(sg + OSTAGES - 1);
    cp_async_commit();
    const int st = sg % OSTAGES;
    if (active && 2 * sg <= r) {
      float s[2][2][4];
      if (cb_ws) {
        const float* sr = reinterpret_cast<const float*>(Bs + st * SE) + (wrow * TR + g) * RS;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float2 v0 = *reinterpret_cast<const float2*>(sr + 16 * u + 8 * n + 2 * tig);
            const float2 v1 =
                *reinterpret_cast<const float2*>(sr + 8 * RS + 16 * u + 8 * n + 2 * tig);
            s[u][n][0] = v0.x;
            s[u][n][1] = v0.y;
            s[u][n][2] = v1.x;
            s[u][n][3] = v1.y;
          }
      } else {
        scores<T>(s, Cs + wrow * TR * RC, Bs + st * SE, RC, p.np, lane);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kt = 2 * sg + u;
        if (kt > r) continue;
        float m[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r * TR + g + 8 * (e >> 1), jj = kt * TR + 8 * n + 2 * tig + (e & 1);
            // mask before the exp: above the diagonal the decay would overflow
            m[n][e] = jj <= i ? s[u][n][e] * ex2(c2[i] - c2[jj]) * d[jj] : 0.f;
          }
        mx_product<T, PMAX>(acc, m, Xs + ((st * hb + wh) * KT + u * TR) * RX, RX, p.pp, lane);
      }
    }
  }

  if (!active) return;
  const long long y_st = static_cast<long long>(p.H) * p.P;
  float* Y = p.y + (static_cast<long long>(bb) * p.T + t0) * y_st + (hb0 + wh) * p.P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r * TR + g + 8 * half;
    if (i < p.Q) {
#pragma unroll
      for (int n = 0; n < PT8; ++n)
        if (n * 8 < p.P)
          store2(Y + i * y_st + n * 8 + 2 * tig, acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// The c b^T role (several chunks): S = c b^T of one (batch, chunk, group)
// for 4 row tiles, a warp each, over the key tiles at or below its
// diagonal, into the workspace (fp32, row stride QP); the output blocks of
// every head of the group read it instead of computing it.
template <typename T>
__device__ __forceinline__ void cb_role(const Params& p, unsigned char* smem, int sb) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, tig = lane % 4;
  const int bb = blockIdx.z, k = blockIdx.y, t0 = k * p.Q;
  const int nq = (p.Q + TR - 1) / TR, nband = (nq + NW - 1) / NW;
  const int grp = sb / nband, r0 = (nband - 1 - sb % nband) * NW;
  const int r = r0 + w, nk = (min(nq, r0 + NW) + 1) / 2;   // stages of 32 keys
  const int RC = p.np + PAD;
  T* Cs = reinterpret_cast<T*>(smem);     // [NW][TR][RC]
  T* Bs = Cs + NW * TR * RC;              // [OSTAGES][2 * TR][RC]
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;
  float* S = p.sws + ((static_cast<long long>(bb) * p.nc + k) * p.G + grp) * p.qp * p.qp;
  load_rows<T>(Cs, RC, Cg, p.c_st, r0 * TR, NW * TR, p.Q, p.N, p.np);
  cp_async_commit();
  for (int kt = 0; kt < OSTAGES - 1; ++kt) {
    if (kt < nk)
      load_rows<T>(Bs + kt * 2 * TR * RC, RC, Bg, p.b_st, kt * 2 * TR, 2 * TR, p.Q, p.N, p.np);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<OSTAGES - 2>();
    __syncthreads();  // stage kt (and the c rows) in place; stage kt - 1 consumed
    const int kn = kt + OSTAGES - 1;
    if (kn < nk)
      load_rows<T>(Bs + (kn % OSTAGES) * 2 * TR * RC, RC, Bg, p.b_st, kn * 2 * TR, 2 * TR, p.Q,
                   p.N, p.np);
    cp_async_commit();
    if (r < nq && 2 * kt <= r) {
      float sc[2][2][4];
      scores<T>(sc, Cs + w * TR * RC, Bs + (kt % OSTAGES) * 2 * TR * RC, RC, p.np, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (2 * kt + u > r) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* row = S + static_cast<long long>(r * TR + g + 8 * half) * p.qp +
                       (2 * kt + u) * TR + 2 * tig;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            store2(row + 8 * n, sc[u][n][2 * half], sc[u][n][2 * half + 1]);
        }
      }
    }
  }
}

// The state role: (x * w)^T b of one (batch, head, chunk) over a column
// split of N; with one chunk, exp(cs_Q) h0 + that into h_out, else that into
// the workspace and cs_Q into dec.
template <typename T, int PMAX>
__device__ __forceinline__ void state_role(const Params& p, unsigned char* smem, int sb) {
  constexpr int SMT = PMAX / 64;   // m16 tiles of P a warp
  constexpr int SN8 = 16 / SMT;    // n8 tiles of N a warp, at most
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / 4, tig = lane % 4;
  const int bb = blockIdx.z, k = blockIdx.y, t0 = k * p.Q;
  const int h = sb / p.nspl, split = sb % p.nspl;
  const int ns8 = state_n8(p), n0 = split * ns8 * 8;
  const int ncols = round16(8 * ns8), RS = ncols + PAD, RX = p.pp + PAD;
  T* Xs = reinterpret_cast<T*>(smem);   // [2][SK][RX]
  T* Bs = Xs + 2 * SK * RX;              // [2][SK][RS]
  float* wts = reinterpret_cast<float*>(Bs + 2 * SK * RS);  // [MAXQ] dt, then w
  float* cs2 = wts + MAXQ;                                   // [MAXQ]

  const int grp = h / (p.H / p.G);
  const T* Xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh + t0 * p.x_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st + n0;
  auto load_stage = [&](int ks, int st) {
    load_rows<T>(Xs + st * SK * RX, RX, Xg, p.x_st, ks * SK, SK, p.Q, p.P, p.pp);
    load_rows<T>(Bs + st * SK * RS, RS, Bg, p.b_st, ks * SK, SK, p.Q, p.N - n0, ncols);
  };
  load_stage(0, 0);
  cp_async_commit();
  if (w == 0) {
    chunk_cumsum(p, bb, h, t0, p.Q, cs2, wts, lane);
    __syncwarp();
    const float cl = cs2[p.Q - 1];
    for (int j = lane; j < MAXQ; j += 32) wts[j] *= ex2(cl - cs2[j]);
  }

  float acc[SMT][SN8][4];
#pragma unroll
  for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
    for (int n = 0; n < SN8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  const int nks = (p.Q + SK - 1) / SK;
  for (int ks = 0; ks < nks; ++ks) {
    const int st = ks & 1;
    if (ks + 1 < nks) {
      load_stage(ks + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and w) in place
    const T* xs = Xs + st * SK * RX;
    const T* bs = Bs + st * SK * RS;
    const float* wk = wts + ks * SK;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
        const int j0 = kk * 16 + 2 * tig;
        const float w00 = wk[j0], w01 = wk[j0 + 1], w10 = wk[j0 + 8], w11 = wk[j0 + 9];
#pragma unroll
        for (int mt = 0; mt < SMT; ++mt) {
          const int p0 = (w * SMT + mt) * 16;
          if (p0 < p.pp) {
            // A = (x * w)^T: x [keys][p] read transposed, then scaled by each key's w
            uint32_t fa[4], ah[4], al[4];
            ldsm_x4_t(fa, xs + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * RX + p0 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 v = unpack_bf16(fa[q]);
              const float a0 = q < 2 ? w00 : w10, a1 = q < 2 ? w01 : w11;
              split_bf16(v.x * a0, v.y * a1, ah[q], al[q]);
            }
            const T* b0 = bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                          (lane >> 4) * 8;
#pragma unroll
            for (int np = 0; np < SN8 / 2; ++np) {
              if (2 * np < ns8) {
                uint32_t yb[4];
                ldsm_x4_t(yb, b0 + np * 16);
                mma_bf16(acc[mt][2 * np], ah, yb[0], yb[1]);
                mma_bf16(acc[mt][2 * np + 1], ah, yb[2], yb[3]);
                if (kSplitBf16) {
                  mma_bf16(acc[mt][2 * np], al, yb[0], yb[1]);
                  mma_bf16(acc[mt][2 * np + 1], al, yb[2], yb[3]);
                }
              }
            }
          }
        }
      }
    } else {
#pragma unroll 1
      for (int kk = 0; kk < SK / 8; ++kk) {
        const int j0 = kk * 8 + tig;
        const float wa = wk[j0], wb = wk[j0 + 4];
#pragma unroll
        for (int mt = 0; mt < SMT; ++mt) {
          const int p0 = (w * SMT + mt) * 16;
          if (p0 < p.pp) {
            uint32_t ab[4], as[4];
            split_mask(xs[j0 * RX + p0 + g] * wa, ab[0], as[0]);
            split_mask(xs[j0 * RX + p0 + 8 + g] * wa, ab[1], as[1]);
            split_mask(xs[(j0 + 4) * RX + p0 + g] * wb, ab[2], as[2]);
            split_mask(xs[(j0 + 4) * RX + p0 + 8 + g] * wb, ab[3], as[3]);
#pragma unroll
            for (int n = 0; n < SN8; ++n)
              if (n < ns8)
                mma3(acc[mt][n], ab, as, bs[j0 * RS + n * 8 + g], bs[(j0 + 4) * RS + n * 8 + g]);
          }
        }
      }
    }
    __syncthreads();  // stage st consumed
  }

  const float csl = cs2[p.Q - 1];
  const long long pn = static_cast<long long>(p.P) * p.N;
  const long long slot = (static_cast<long long>(bb) * p.nc + k) * p.H + h;
  float* dst = p.nc == 1 ? p.h_out + slot * pn : p.ws + slot * pn;
  const float* h0 = p.nc == 1 && p.h0 != nullptr ? p.h0 + slot * pn : nullptr;
  const float dl = ex2(csl);
  if (p.nc > 1 && split == 0 && tid == 0) p.dec[slot] = csl;
#pragma unroll
  for (int mt = 0; mt < SMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (w * SMT + mt) * 16 + g + 8 * half;
      if (row < p.P) {
#pragma unroll
        for (int n = 0; n < SN8; ++n) {
          const int col = n0 + n * 8 + 2 * tig;
          if (n < ns8 && col < p.N) {
            float v0 = acc[mt][n][2 * half], v1 = acc[mt][n][2 * half + 1];
            if (h0 != nullptr) {
              const float2 o = __ldg(reinterpret_cast<const float2*>(h0 + row * p.N + col));
              v0 = fmaf(dl, o.x, v0);
              v1 = fmaf(dl, o.y, v1);
            }
            store2(dst + row * p.N + col, v0, v1);
          }
        }
      }
    }
  }
}

// One chunk: blockIdx.x below n_first an output block, at or past it a
// state block, side by side in one grid.
template <typename T, int PMAX>
__global__ void __launch_bounds__(NT) ssd_scan(const Params p) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int bx = blockIdx.x;
  if (bx < p.n_first)
    out_role<T, PMAX>(p, ssd_smem, bx);
  else
    state_role<T, PMAX>(p, ssd_smem, bx - p.n_first);
}

// Several chunks: every chunk's c b^T (blockIdx.x below n_first: first,
// since each of these blocks runs longer) and every chunk's state from zero
// (at or past it) ...
template <typename T, int PMAX>
__global__ void __launch_bounds__(NT) ssd_states(const Params p) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  if (static_cast<int>(blockIdx.x) < p.n_first)
    cb_role<T>(p, ssd_smem, blockIdx.x);
  else
    state_role<T, PMAX>(p, ssd_smem, blockIdx.x - p.n_first);
}

// ... and, after the carry, every chunk's outputs
template <typename T, int PMAX>
__global__ void __launch_bounds__(NT) ssd_outputs(const Params p) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  out_role<T, PMAX>(p, ssd_smem, blockIdx.x);
}

// The ordered pass over the chunks (several chunks only): h = h0 (or 0);
// for each chunk k in order: ws[k] = h (its carried-in state), h =
// exp(cs_Q) h + s_k; then h_out = h.  Four state entries a thread.
__global__ void __launch_bounds__(256) ssd_carry(const Params p) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const long long pn = static_cast<long long>(p.P) * p.N;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= pn / 4) return;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.h0 != nullptr)
    hv = reinterpret_cast<const float4*>(p.h0 + (static_cast<long long>(bb) * p.H + h) * pn)[e];
  constexpr int AHEAD = 4;   // chunk states read together, before any of them is written
  for (int k0 = 0; k0 < p.nc; k0 += AHEAD) {
    float4 sv[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const long long slot = (static_cast<long long>(bb) * p.nc + k0 + i) * p.H + h;
      if (k0 + i < p.nc) {
        sv[i] = reinterpret_cast<const float4*>(p.ws + slot * pn)[e];
        d[i] = exp2f(p.dec[slot]);
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (k0 + i < p.nc) {
        const long long slot = (static_cast<long long>(bb) * p.nc + k0 + i) * p.H + h;
        reinterpret_cast<float4*>(p.ws + slot * pn)[e] = hv;
        hv = make_float4(fmaf(d[i], hv.x, sv[i].x), fmaf(d[i], hv.y, sv[i].y),
                         fmaf(d[i], hv.z, sv[i].z), fmaf(d[i], hv.w, sv[i].w));
      }
    }
  }
  reinterpret_cast<float4*>(p.h_out + (static_cast<long long>(bb) * p.H + h) * pn)[e] = hv;
}

constexpr int kSmemMax = 232448;   // an H100 block's dynamic shared memory at most

// above 48 KB only as opted-in dynamic shared memory, set once per device
template <typename K>
cudaError_t allow_smem(K kern, bool* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int PMAX>
cudaError_t kernel_attributes() {
  static bool c_scan[kMaxDevices] = {}, c_states[kMaxDevices] = {}, c_out[kMaxDevices] = {};
  cudaError_t e = allow_smem(ssd_scan<T, PMAX>, c_scan);
  if (e != cudaSuccess) return e;
  e = allow_smem(ssd_states<T, PMAX>, c_states);
  if (e != cudaSuccess) return e;
  return allow_smem(ssd_outputs<T, PMAX>, c_out);
}

template <typename T, int PMAX>
cudaError_t launch(Params p, cudaStream_t s) {
  cudaError_t e = kernel_attributes<T, PMAX>();
  if (e != cudaSuccess) return e;
  const int nq = (p.Q + TR - 1) / TR;
  const int n_out = (nq + p.wr - 1) / p.wr * (p.H / p.hb), n_state = p.H * p.nspl;
  const size_t so = out_smem<T>(p), ss = state_smem<T>(p);
  if (so > kSmemMax || ss > kSmemMax || cb_smem<T>(p) > kSmemMax) return cudaErrorInvalidValue;
  if (p.nc == 1) {   // one launch: output and state blocks side by side
    p.n_first = n_out;
    ssd_scan<T, PMAX><<<dim3(n_out + n_state, 1, p.B), NT, so > ss ? so : ss, s>>>(p);
    return cudaGetLastError();
  }
  const int n_cb = p.G * ((nq + NW - 1) / NW);
  const size_t sc = cb_smem<T>(p);
  p.n_first = n_cb;
  ssd_states<T, PMAX><<<dim3(n_state + n_cb, p.nc, p.B), NT, ss > sc ? ss : sc, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n4 = static_cast<long long>(p.P) * p.N / 4;
  ssd_carry<<<dim3(static_cast<unsigned>((n4 + 255) / 256), p.H, p.B), 256, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_outputs<T, PMAX><<<dim3(n_out, p.nc, p.B), NT, so, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  return p.P <= 64 ? launch<T, 64>(p, s) : launch<T, 128>(p, s);
}

// blocks per SM of the kernels a plan runs: the one-chunk kernel for both
// roles, or the outputs and the states kernel of several chunks
template <typename T, int PMAX>
cudaError_t occupancy(const Params& p, int* out_blocks, int* state_blocks) {
  cudaError_t e = kernel_attributes<T, PMAX>();
  if (e != cudaSuccess) return e;
  if (p.nc == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out_blocks, ssd_scan<T, PMAX>, NT,
                                                      out_smem<T>(p));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(state_blocks, ssd_scan<T, PMAX>, NT,
                                                         state_smem<T>(p));
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out_blocks, ssd_outputs<T, PMAX>, NT,
                                                    out_smem<T>(p));
  if (e != cudaSuccess) return e;
  const size_t ss = state_smem<T>(p), sc = cb_smem<T>(p);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(state_blocks, ssd_states<T, PMAX>, NT,
                                                       ss > sc ? ss : sc);
}

bool make_params(Params& p, int B, int T, int H, int G, int P, int N, int Q, int wr, int nspl,
                 bool has_h0) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || G <= 0 || H % G != 0) return false;
  if (P <= 0 || P > 128 || P % 8 != 0 || N <= 0 || N > 128 || N % 8 != 0) return false;
  if (Q <= 0 || Q > MAXQ || T % Q != 0 || T / Q > 65535) return false;
  if (wr != 1 && wr != 2 && wr != 4) return false;
  if (nspl < 1 || nspl > (N + 15) / 16 * 2) return false;
  const int hb = NW / wr;
  if ((H / G) % hb != 0) return false;
  p.B = B; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q; p.nc = T / Q;
  p.pp = round16(P); p.np = round16(N); p.qp = round16(Q);
  p.wr = wr; p.hb = hb; p.nspl = nspl;
  p.has_hin = has_h0 || p.nc > 1;
  return state_n8(p) <= (P <= 64 ? 16 : 8);
}

}  // namespace

// dtype code of x, b, c: 0 = float32, 1 = bfloat16.  h0 may be null (a zero
// state).  With T / Q > 1 chunks, ws holds B * (T/Q) * H * P * N floats, dec
// B * (T/Q) * H and sws B * (T/Q) * G * QP * QP (QP = Q rounded up to 16);
// the call issues three device kernels (the chunk states and c b^T, the
// ordered carry, the outputs: ssd_states, ssd_carry, ssd_outputs), else one
// (ssd_scan).  wr, nspl: the grid (ssd_plan in kernels/ssd_chunk.py).
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan(
    int dtype, const void* x, const void* b, const void* c, const void* dt,
    const void* l, const void* A, const void* h0, void* y, void* h_out, void* ws, void* dec,
    void* sws, int B, int T, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_st, long long x_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dt_sb, long long dt_st, long long dt_sh,
    int wr, int nspl, void* stream) {
  Params p = {};
  if (!make_params(p, B, T, H, G, P, N, Q, wr, nspl, h0 != nullptr)) return cudaErrorInvalidValue;
  if (l == nullptr && A == nullptr) return cudaErrorInvalidValue;
  if (p.nc > 1 && (ws == nullptr || dec == nullptr || sws == nullptr)) return cudaErrorInvalidValue;
  p.x = x; p.b = b; p.c = c;
  p.dt = static_cast<const float*>(dt);
  p.l = static_cast<const float*>(l);
  p.A = static_cast<const float*>(A);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  p.ws = static_cast<float*>(ws);
  p.dec = static_cast<float*>(dec);
  p.sws = p.nc > 1 ? static_cast<float*>(sws) : nullptr;
  p.x_sb = x_sb; p.x_st = x_st; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_st = b_st; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_st = c_st; p.c_sg = c_sg;
  p.dt_sb = dt_sb; p.dt_st = dt_st; p.dt_sh = dt_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// Blocks per SM of the output and the state role at a plan with a zero
// state (the runtime's occupancy calculator), and each role's dynamic
// shared memory: of the one-chunk kernel when T == Q, else of the outputs
// and the states kernel of several chunks.
extern "C" int ssd_chunk_occupancy(int dtype, int P, int N, int T, int Q, int H, int G, int wr,
                                   int nspl, int* out_blocks, int* state_blocks,
                                   int* out_smem_bytes, int* state_smem_bytes) {
  Params p = {};
  if (!make_params(p, 1, T, H, G, P, N, Q, wr, nspl, false)) return cudaErrorInvalidValue;
  float marker = 0.f;
  if (p.nc > 1) p.sws = &marker;   // sized as the outputs kernel reads c b^T
  if (dtype == 0) {
    *out_smem_bytes = static_cast<int>(out_smem<float>(p));
    *state_smem_bytes = static_cast<int>(state_smem<float>(p));
    return P <= 64 ? occupancy<float, 64>(p, out_blocks, state_blocks)
                   : occupancy<float, 128>(p, out_blocks, state_blocks);
  }
  if (dtype == 1) {
    *out_smem_bytes = static_cast<int>(out_smem<__nv_bfloat16>(p));
    *state_smem_bytes = static_cast<int>(state_smem<__nv_bfloat16>(p));
    return P <= 64 ? occupancy<__nv_bfloat16, 64>(p, out_blocks, state_blocks)
                   : occupancy<__nv_bfloat16, 128>(p, out_blocks, state_blocks);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The backward of the chunked scan (what JAX's autodiff of
// `Mamba2LM._ssd_chunked` computes; the TPU kernel has no backward).  For
// one (batch, head) slice and one chunk, with dy [Q, P] the gradient of y,
// dh_out [P, N] that of the chunk's final state (the next chunk's dh_in, or
// dh_final, or zero, for the last), L_ij = exp(cs_i - cs_j) for i >= j
// (else 0), S = c b^T, D = dy x^T and e_j = exp(cs_Q - cs_j):
//   dx_j  = dt_j (sum_i S_ij L_ij dy_i + e_j dh_out b_j)
//   db_j  = dt_j (sum_i L_ij D_ij c_i + e_j dh_out^T x_j)
//   dc_i  = sum_j L_ij D_ij dt_j b_j + exp(cs_i) h_in^T dy_i
//   ddt_j = sum_i S_ij L_ij D_ij + e_j x_j^T dh_out b_j    (its direct part)
//   dh_in = exp(cs_Q) dh_out + sum_i exp(cs_i) dy_i c_i^T
// and the log-decay's gradient dcs_k = c_k . dc_k - dt_k ddt_k, plus, at the
// last row, E + sum_j W_j (E = exp(cs_Q) <dh_out, h_in>, W_j = dt_j e_j
// x_j^T dh_out b_j); dl is its reverse cumsum and ddt -= A dl.  dA is taken
// in its direct form, each decay's derivative in A (-sum dt dl sums row
// minus column sums and loses 1e-5 to 1e-4 of its largest entry in fp32):
//   dA = -(sum_{i>=j} T_ij (cd_i - cd_j) + sum_i U_i cd_i
//          + sum_j W_j (cd_Q - cd_j) + E cd_Q)
// with cd the running sum of dt in the chunk, T_ij = S_ij L_ij D_ij dt_j and
// U_i = exp(cs_i) c_i^T h_in^T dy_i.  db and dc sum over the heads of a
// group, dA over the batch and the chunks.
//
// What bounds it on an H100: at the trainer's shape (B 4, T 512, 64 heads
// of 64, N 128, chunks of 256, fp32) the products, 17.3 GFLOP a call, each
// as three tf32 products (0.105 ms at the tf32 peak; the bytes about 0.03
// ms).  Issued as mma.sync, which is all the card offers short of wgmma,
// the products run latency-bound: a warp's chain of dependent products and
// shared-memory reads, with 8 to 16 warps an SM.  What the design does:
//   * every product on the tensor cores, mma.sync m16n8k8 tf32 with fp32
//     accumulators, an fp32 operand as big + small (the bit-mask split of
//     K4's backward and the forward: three products, small * small
//     dropped).  bf16 inputs take the same route with x, b and c as exact
//     tf32 operands (their small part is zero: two products); only S = c
//     b^T has two bf16 operands, and runs on m16n8k16.  The tf32 route and
//     not bf16 hi + lo pairs for the rest: each of those products has an
//     fp32 operand (dy is always fp32; S o L, L o D o dt and the states of
//     dh are fp32 intermediates), a pair costs two products as the tf32
//     route does, and one code path serves both types;
//   * a product's three passes run over 4 n8 tiles at a time (each tile's
//     first pass, then the second, then the third), so no product waits on
//     the one before it on the same accumulator;
//   * no product twice: S once per (batch, chunk, group), by the forward's
//     c b^T role into a workspace that every head of the group reads; D once
//     per tile pair: the key blocks write L o D o dt of each causal pair of
//     64-row tiles into a workspace, and the query blocks read it;
//     n8 tiles wholly above the diagonal or past Q are skipped by the warp
//     that would compute them;
//   * blocks of 64 rows, a warp per 16 (4 warps a key block, up to 255 registers
//     and 89 KB, two an SM; 8 warps a query block, each of a pair of warps
//     with half of N's columns, 128 registers, two an SM): a key block walks
//     the query rows at or after its keys, a query block the key rows at or
//     before its queries, in stages of 32 rows through a two-stage ring of
//     16-byte cp.async copies (the next stage's copies overlap this one's
//     products).  Rows are padded so that fragment reads hit each
//     shared-memory bank once (fp32 rows 4 floats past a multiple of 8 where
//     read down a column, 8 where read as float2 along a row).  The heaviest
//     tiles (the first key tile, the last query tile) are launched first;
//   * a block takes hb heads of one group in order and sums their db (key
//     blocks) or dc (query blocks) in its registers, so the partials are
//     [B, T, H / hb, N], summed over a group's slabs in order by
//     ssd_bwd_reduce;
//   * the device kernels: ssd_bwd_states (S; with several chunks or an h0
//     also each chunk's sum_i exp(cs_i) dy_i c_i^T and its cs_Q), then
//     ssd_bwd_carry (with several chunks or an h0: the ordered reverse pass,
//     each chunk's dh_out and dh0), ssd_bwd_keys (dx, db's slab partial,
//     ddt's direct part, W, dA's T sum of each key tile), ssd_bwd_queries
//     (dc's slab partial, c_i . dc_i, U), ssd_bwd_finish (dcs, its reverse
//     cumsum, ddt, each chunk's dA) and ssd_bwd_reduce (the slabs, dA);
//   * dA in its direct form, T_ij (cd_i - cd_j) from the fp32 accumulators
//     of S and D; the decay masked before its exp.
// No atomics: every sum has a fixed order, so two calls agree bit for bit.
// The carried-in states are the forward's (kept from its workspace).  The
// plan (hb) is the wrapper's, from the shapes alone (kernels/ssd_chunk.py,
// ssd_bwd_plan).  tools/ssd_variants.py --bwd times the ablations (S once a
// head, D twice, one tf32 product, ...) as edits of this source.

namespace {

constexpr int BT = 256;         // threads of ssd_bwd_finish: a chunk row each
constexpr int TB = 64;          // rows of a key or a query tile
constexpr int BW = 4;           // warps of a key or state block; slices of 16 rows of a tile
constexpr int BNT = 32 * BW;
constexpr int KW = 2 * BW;      // warps of a query block: two a slice of 16 rows
constexpr int KNT = 32 * KW;
constexpr int KS = 32;          // rows of a ring stage
constexpr int NMAX = 128;       // N at most
constexpr int RSK = TB + 4;     // key blocks: row stride of the staged S rows (read down a column)
constexpr int RQ = KS + 8;      // query blocks: row stride of the staged S and L o D o dt
                                // rows (read as float2 along a row)
// fp32 products as three tf32 products (tools/ssd_variants.py's `tf32x1`
// times the kernel with one, whose results are wrong)
constexpr bool kBwd3 = true;

struct BwdParams {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* A;
  const float* dy;        // [B, T, H, P] contiguous
  const float* hin;       // [B, nc, H, P, N] each chunk's carried-in state (chunk 0: h0)
  const float* dh_final;  // [B, H, P, N] or null (zero)
  void* dx;               // [B, T, H, P], x's dtype
  void* dB;               // [B, T, G, N], b's dtype
  void* dC;
  float* ddt;             // [B, T, H]
  float* dA;              // [H]
  float* dh0;             // [B, H, P, N] (with h0)
  float* dhs;             // [B, nc, H, P, N]: sum_i exp(cs_i) dy_i c_i^T, then each dh_out
  float* dec;             // [B, nc, H]: cs_Q * log2(e)
  float* sws;             // [B, nc, G, QP, QP]: S = c b^T (QP = Q rounded up to 16)
  float* lds;             // [B, nc, H, nt (nt + 1) / 2, TB, TB]: L o D o dt of each causal
                          // tile pair (it, jt) at it (it + 1) / 2 + jt
  float* dbp;             // [B, T, H / hb, N]: db of each slab of hb heads
  float* dcp;             // [B, T, H / hb, N]: dc of each slab
  float* rrow;            // [B, T, H]: c_i . dc_i
  float* ddir;            // [B, T, H]: ddt's direct part
  float* wst;             // [B, T, H]: dt_j e_j x_j^T dh_out b_j
  float* urow;            // [B, T, H]: exp(cs_i) c_i^T h_in^T dy_i
  float* dAt;             // [B, nc, H, nt]: each key tile's sum of T_ij (cd_i - cd_j)
  float* dAp;             // [B, nc, H]: each chunk's part of dA
  int B, T, H, G, P, N, Q, nc, nt;
  int hb;                 // heads a key or query block takes, in order
  int has_h0;             // chunk 0 carries h0 in, and dh0 is wanted
  int run_states;         // the states of dh and ssd_bwd_carry run
  int dspl;               // states of dh: column splits of a state
  int n_cb;               // blocks of ssd_bwd_states' S role
  long long x_sb, x_st, x_sh;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
  long long dt_sb, dt_st, dt_sh;
  Params cb;              // the forward's c b^T role over the groups
};

__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int al16(int bytes) { return (bytes + 15) / 16 * 16; }
// row strides (elements) of a staged tile w wide: fp32 rows 4 floats past a
// multiple of 8 (fragment reads down a column or along a row hit each bank
// once), bf16 rows 8 past one (the same in 32-bit words)
template <typename T>
__host__ __device__ constexpr int rowT(int w) { return round8(w) + (sizeof(T) == 4 ? 4 : 8); }
__host__ __device__ constexpr int rowF(int w) { return round8(w) + 4; }
template <typename T>
__host__ __device__ constexpr int tile_bytes(int rows, int w) {
  return al16(rows * rowT<T>(w) * static_cast<int>(sizeof(T)));
}

// key blocks: x_j [TB][P]; a ring of two stages (dy [KS][P] fp32, c [KS][N],
// S [KS][TB] fp32), after the loop dh_out [P][N] fp32 and b_j [TB][N] in
// its place; cs, dt, cd; the block sum's 4 floats
template <typename T>
__host__ __device__ inline int key_stage_bytes(int P, int N) {
  return tile_bytes<float>(KS, P) + tile_bytes<T>(KS, N) + al16(KS * RSK * 4);
}
template <typename T>
__host__ __device__ inline int key_ring_bytes(int P, int N) {
  const int ring = 2 * key_stage_bytes<T>(P, N);
  const int after = tile_bytes<float>(P, N) + tile_bytes<T>(TB, N);
  return ring > after ? ring : after;
}
template <typename T>
__host__ __device__ inline int key_smem(int P, int N) {
  return tile_bytes<T>(TB, P) + key_ring_bytes<T>(P, N) + (3 * MAXQ + BW) * 4;
}

// query blocks: dy_i [TB][P] fp32; a ring of two stages (b [KS][N], S [TB][KS]
// fp32 and L o D o dt [TB][KS] fp32), after the loop h_in [P][N] fp32 (rows
// 8 past a multiple of 8: read down a column) and c_i [TB][N] in its place;
// cs, dt; the second column half's U
template <typename T>
__host__ __device__ inline int query_stage_bytes(int P, int N) {
  return tile_bytes<T>(KS, N) + al16(TB * RQ * 4) + al16(TB * RQ * 4);
}
template <typename T>
__host__ __device__ inline int query_ring_bytes(int P, int N) {
  const int ring = 2 * query_stage_bytes<T>(P, N);
  const int after = al16(P * (round8(N) + 8) * 4) + tile_bytes<T>(TB, N);
  return ring > after ? ring : after;
}
template <typename T>
__host__ __device__ inline int query_smem(int P, int N) {
  return tile_bytes<float>(TB, P) + query_ring_bytes<T>(P, N) + (2 * MAXQ + TB) * 4;
}

// the states of dh: a ring of two stages (dy [KS][P] fp32, c [KS][N]); cs, exp(cs)
template <typename T>
__host__ __device__ inline int dhstate_smem(int P, int N) {
  return 2 * (tile_bytes<float>(KS, P) + tile_bytes<T>(KS, N)) + 2 * MAXQ * 4;
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_mask(v[q], ab[q], as[q]);
}

// c[q] += a b_q on the tensor cores for the n8 tiles lo <= q < hi of a
// group of NB: a 16 x 8 A fragment as big + small, b_q's two values at bq[q
// sq] and bq[q sq + s1], read and split here.  A_EXACT / B_EXACT: that
// operand is a bf16 input, an exact tf32 value whose small part is zero,
// so its product is skipped (two products where both are fp32 take three).  The products
// of the tiles run a pass apart (every tile's first, then every tile's
// second and third), so that none waits on its own tile's last one.
template <bool A_EXACT, bool B_EXACT, int NB, typename TV>
__device__ __forceinline__ void mma_tiles(float (*c)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const TV* bq, int sq, int s1,
                                          int lo, int hi) {
  uint32_t bb[NB][2], bs[NB][2];
#pragma unroll
  for (int q = 0; q < NB; ++q)
    if (q >= lo && q < hi) {
      split_mask(to_f(bq[q * sq]), bb[q][0], bs[q][0]);
      split_mask(to_f(bq[q * sq + s1]), bb[q][1], bs[q][1]);
    }
  if (kBwd3 && !A_EXACT)
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (q >= lo && q < hi) mma_tf32(c[q], as, bb[q][0], bb[q][1]);
  if (kBwd3 && !B_EXACT)
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (q >= lo && q < hi) mma_tf32(c[q], ab, bs[q][0], bs[q][1]);
#pragma unroll
  for (int q = 0; q < NB; ++q)
    if (q >= lo && q < hi) mma_tf32(c[q], ab, bb[q][0], bb[q][1]);
}

// the same over an accumulator of NT tiles (tiles at or past n of them
// skipped), in groups of 4
template <bool A_EXACT, bool B_EXACT, int NT, typename TV>
__device__ __forceinline__ void mma_row(float (&c)[NT][4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4], const TV* bq, int sq, int s1,
                                        int n) {
#pragma unroll
  for (int q0 = 0; q0 < NT; q0 += 4)
    if (q0 < n) mma_tiles<A_EXACT, B_EXACT, 4>(c + q0, ab, as, bq + q0 * sq, sq, s1, 0, n - q0);
}

// An A fragment from rows g and g + 8 of a staged tile (row stride R), each
// row times its scale: natural k order (slot t <-> column k0 + t, slot t + 4
// <-> k0 + t + 4), whose B fragment reads rows t and t + 4 ...
template <typename T>
__device__ __forceinline__ void frag_rows(float (&v)[4], const T* a, int R, int k0, int lane,
                                          float s0 = 1.f, float s1 = 1.f) {
  const T* r = a + (lane >> 2) * R + k0 + (lane & 3);
  v[0] = to_f(r[0]) * s0;
  v[1] = to_f(r[8 * R]) * s1;
  v[2] = to_f(r[4]) * s0;
  v[3] = to_f(r[8 * R + 4]) * s1;
}

// ... or permuted (slot t <-> column k0 + 2t, slot t + 4 <-> k0 + 2t + 1: an
// accumulator's column order), whose B fragment reads rows 2t and 2t + 1
template <typename T>
__device__ __forceinline__ void frag_rows_perm(float (&v)[4], const T* a, int R, int k0, int lane,
                                               float s0, float s1) {
  const T* r = a + (lane >> 2) * R + k0 + 2 * (lane & 3);
  v[0] = to_f(r[0]) * s0;
  v[1] = to_f(r[8 * R]) * s1;
  v[2] = to_f(r[1]) * s0;
  v[3] = to_f(r[8 * R + 1]) * s1;
}

// an accumulator's 16 x 8 tile as an A fragment of depth 8 (permuted order)
__device__ __forceinline__ void frag_acc(uint32_t (&ab)[4], uint32_t (&as)[4],
                                         const float (&c)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  split4(v, ab, as);
}

template <int MR, int NS>
__device__ __forceinline__ void zero(float (&acc)[MR][NS]) {
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s] = 0.f;
}

// the sum over a quad (the 4 lanes of one accumulator row), the same in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Inclusive prefix sum over a warp of v[0..8) per lane (runs of 8 rows a
// lane, then a shuffle scan of the run totals), in place.
__device__ __forceinline__ void warp_scan8(float (&v)[8], int lane) {
#pragma unroll
  for (int i = 1; i < 8; ++i) v[i] += v[i - 1];
  float incl = v[7];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float base = incl - v[7];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] += base;
}

// The chunk's inclusive prefix sum of l = -dt A[h] over rows [0, Q), as
// chunk_cumsum takes it, by one warp: cs2[i] = cs_i * log2(e), dts[i] =
// dt_i and, where cds is given, cds[i] = the running sum of dt (zeros at
// and past Q for dt; the last sums after).
__device__ void bwd_cumsum(const BwdParams& p, int bb, int h, int t0, float* cs2, float* dts,
                           float* cds, int lane) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh;
  const float rate = p.A[h];
  float v[8], d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * lane + i;
    d[i] = row < p.Q ? DT[static_cast<long long>(t0 + row) * p.dt_st] : 0.f;
    v[i] = -d[i] * rate;
  }
  warp_scan8(v, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs2[8 * lane + i] = v[i] * LOG2E;
    dts[8 * lane + i] = d[i];
  }
  if (cds != nullptr) {
    warp_scan8(d, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) cds[8 * lane + i] = d[i];
  }
}

// Sum of v over the block of NWARPS warps in a fixed order (shuffles, then
// the warps in order); every thread gets it.  `red` holds NWARPS floats.
template <int NWARPS>
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red free
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) s += red[i];
  return s;
}

__device__ __forceinline__ long long slot_of(const BwdParams& p, int bb, int k, int h) {
  return (static_cast<long long>(bb) * p.nc + k) * p.H + h;
}

// dh_out of chunk k: dh_final (or zero: null) for the last, else what
// ssd_bwd_carry left in dhs
__device__ __forceinline__ const float* bwd_dh_out(const BwdParams& p, int bb, int k, int h) {
  const long long pn = static_cast<long long>(p.P) * p.N;
  if (k == p.nc - 1)
    return p.dh_final != nullptr ? p.dh_final + (static_cast<long long>(bb) * p.H + h) * pn
                                 : nullptr;
  return p.dhs + slot_of(p, bb, k, h) * pn;
}

// h_in of chunk k (null: zero)
__device__ __forceinline__ const float* bwd_h_in(const BwdParams& p, int bb, int k, int h) {
  if (k == 0 && !p.has_h0) return nullptr;
  return p.hin + slot_of(p, bb, k, h) * static_cast<long long>(p.P) * p.N;
}

// S = c b^T of the (batch, chunk) slot read by head h
__device__ __forceinline__ const float* bwd_scores(const BwdParams& p, int bb, int k, int h) {
  const int qp = round16(p.Q);
  return p.sws + ((static_cast<long long>(bb) * p.nc + k) * p.G + h / (p.H / p.G)) * qp * qp;
}

// Key blocks: a block per (batch, chunk, slab of hb heads, key tile jt of
// 64 rows), tile 0 (the most query rows) first.  For each head of the slab
// in order: for the query rows i >= j in stages of 32, D^T = x_j dy_i^T (the
// warp's 16 keys by 32 queries), the decay, then dx_j += (dt S o L)^T dy_i
// and db_j += (dt L o D)^T c_i, L o D o dt into the pair's workspace; after
// the loop dh_out's terms; writes dx, ddt's direct part, W and the tile's
// part of dA.  db sums over the slab's heads in the registers.
template <typename T, int PMAX>
__global__ void __launch_bounds__(BNT, 2) ssd_bwd_keys(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char bsm[];
  constexpr bool EX = sizeof(T) == 2;   // x, b and c are exact tf32 operands
  constexpr int PT = PMAX / 8, NT8 = NMAX / 8, KT = KS / 8;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int nslab = p.H / p.hb, per = nslab * p.nc * p.B;
  const int jt = blockIdx.x / per, slab = blockIdx.x % nslab;
  const int k = blockIdx.x / nslab % p.nc, bb = blockIdx.x % per / (nslab * p.nc);
  const int t0 = k * p.Q, j0 = jt * TB;
  const int RX = rowT<T>(p.P), RY = rowF(p.P), RC = rowT<T>(p.N), RD = rowF(p.N);
  const int SB = key_stage_bytes<T>(p.P, p.N);
  const int oc = tile_bytes<float>(KS, p.P), os = oc + tile_bytes<T>(KS, p.N);
  T* Xs = reinterpret_cast<T*>(bsm);                                   // [TB][RX]
  unsigned char* ring = bsm + tile_bytes<T>(TB, p.P);
  float* DH = reinterpret_cast<float*>(ring);                          // after the loop
  T* Bs = reinterpret_cast<T*>(ring + tile_bytes<float>(p.P, p.N));
  float* cs2 = reinterpret_cast<float*>(ring + key_ring_bytes<T>(p.P, p.N));
  float* dts = cs2 + MAXQ;
  float* cds = dts + MAXQ;
  float* red = cds + MAXQ;
  const int grp = slab * p.hb / (p.H / p.G), qp = round16(p.Q);
  const int nst = (p.Q - j0 + KS - 1) / KS;   // query stages from j0
  const int jr = 16 * w + g, ja = j0 + jr, jb = ja + 8;
  const int pairs = p.nt * (p.nt + 1) / 2;
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;

  float db[NT8][4];
  zero(db);
  for (int hi = 0; hi < p.hb; ++hi) {
    const int h = slab * p.hb + hi;
    const long long slot = slot_of(p, bb, k, h);
    const T* Xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh + t0 * p.x_st;
    const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
    const float* Sg = bwd_scores(p, bb, k, h);
    auto load_stage = [&](int s) {
      unsigned char* st = ring + (s & 1) * SB;
      const int i0 = j0 + s * KS;
      load_rows<float>(reinterpret_cast<float*>(st), RY, DYg, dy_st, i0, KS, p.Q, p.P,
                       round8(p.P));
      load_rows<T>(reinterpret_cast<T*>(st + oc), RC, Cg, p.c_st, i0, KS, p.Q, p.N, round8(p.N));
      load_rows<float>(reinterpret_cast<float*>(st + os), RSK, Sg + j0, qp, i0, KS, qp, qp - j0,
                       TB);
    };
    if (hi > 0) __syncthreads();   // the previous head's reads of every tile and of cs done
    load_rows<T>(Xs, RX, Xg, p.x_st, j0, TB, p.Q, p.P, round8(p.P));
    load_stage(0);
    cp_async_commit();
    if (w == 0) bwd_cumsum(p, bb, h, t0, cs2, dts, cds, lane);

    float dx[PT][4];
    zero(dx);
    float rs0 = 0.f, rs1 = 0.f, tda = 0.f;   // rows ja, jb of ddt's direct part; dA's T sum
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // stage s (and x_j, cs) in place; stage s - 1 consumed by every warp
      if (s + 1 < nst) load_stage(s + 1);
      cp_async_commit();
      const unsigned char* st = ring + (s & 1) * SB;
      const float* dys = reinterpret_cast<const float*>(st);
      const T* css = reinterpret_cast<const T*>(st + oc);
      const float* sss = reinterpret_cast<const float*>(st + os);
      const int i0 = j0 + s * KS;
      // the stage's n8 tiles of queries the warp's keys see: a tile before
      // its first key, or past Q, is all masked and skipped
      const int nlo = max(0, (16 * w + j0 - i0) / 8), nhi = min(KT, (p.Q - i0 + 7) / 8);
      // D^T = x_j dy_i^T
      float d[KT][4];
      zero(d);
      if (nlo < nhi) {
        for (int kk = 0; kk < p.P / 8; ++kk) {
          float v[4];
          uint32_t ab[4], as[4];
          frag_rows(v, Xs + 16 * w * RX, RX, kk * 8, lane);
          split4(v, ab, as);
          mma_tiles<EX, false, KT>(d, ab, as, dys + g * RY + kk * 8 + t4, 8 * RY, 4, nlo, nhi);
        }
      }
      // per query tile: the decay, masked before its exp (above the diagonal
      // it would overflow); S o L and L o D scaled by dt_j (the warp's rows)
      // are the A operands of dx_j += (dt S o L)^T dy_i, db_j += (dt L o D)^T c_i
      const float dta = dts[ja], dtb = dts[jb], csa = cs2[ja], csb = cs2[jb];
      const float cda = cds[ja], cdb = cds[jb];
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        if (n < nlo || n >= nhi) continue;
        float sl[4], ld[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = n * 8 + 2 * t4 + (e & 1), i = i0 + il;
          const bool up = e >> 1;
          const bool ok = i >= (up ? jb : ja) && i < p.Q;
          const float L = ok ? ex2(cs2[i] - (up ? csb : csa)) : 0.f;
          const float sv = ok ? sss[il * RSK + jr + (up ? 8 : 0)] : 0.f;
          const float a = sv * L, tv = a * d[n][e], dtj = up ? dtb : dta;
          if (up) rs1 += tv; else rs0 += tv;
          tda = fmaf(tv * dtj, cds[i] - (up ? cdb : cda), tda);
          sl[e] = a * dtj;
          ld[e] = L * d[n][e] * dtj;
        }
        {   // L o D o dt of the pair, read by the query blocks
          const int it = i0 / TB, pr = it * (it + 1) / 2 + jt;
          const int il = i0 - it * TB + n * 8 + 2 * t4;
          float* dst = p.lds + ((slot * pairs + pr) * TB + il) * TB + jr;
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(e & 1) * TB + (e >> 1) * 8] = ld[e];
        }
        uint32_t ab[4], as[4];
        frag_acc(ab, as, sl);
        mma_row<false, false>(dx, ab, as, dys + (n * 8 + 2 * t4) * RY + g, 8, RY, p.P / 8);
        frag_acc(ab, as, ld);
        mma_row<false, EX>(db, ab, as, css + (n * 8 + 2 * t4) * RC + g, 8, RC, p.N / 8);
      }
    }
    __syncthreads();   // every stage consumed: dh_out and b_j go where the ring was

    const float* dho = bwd_dh_out(p, bb, k, h);
    if (dho != nullptr) {
      load_rows<float>(DH, RD, dho, p.N, 0, p.P, p.P, p.N, round8(p.N));
      load_rows<T>(Bs, RC, Bg, p.b_st, j0, TB, p.Q, p.N, round8(p.N));
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float cl = cs2[p.Q - 1];
    const float dta = dts[ja], dtb = dts[jb];
    const float ea = ex2(cl - cs2[ja]), eb = ex2(cl - cs2[jb]);
    const float sa = dta * ea, sb = dtb * eb;
    float xb0 = 0.f, xb1 = 0.f;   // x_j^T dh_out b_j
    if (dho != nullptr) {   // dx_j += dt_j e_j dh_out b_j
      float bdh[PT][4];
      zero(bdh);
      for (int kk = 0; kk < p.N / 8; ++kk) {
        float v[4];
        uint32_t ab[4], as[4];
        frag_rows(v, Bs + 16 * w * RC, RC, kk * 8, lane);
        split4(v, ab, as);
        mma_row<EX, false>(bdh, ab, as, DH + g * RD + kk * 8 + t4, 8 * RD, 4, p.P / 8);
      }
#pragma unroll
      for (int np = 0; np < PT; ++np)
        if (np * 8 < p.P)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xv = to_f(Xs[(jr + (e >> 1) * 8) * RX + np * 8 + 2 * t4 + (e & 1)]);
            if (e >> 1) xb1 = fmaf(xv, bdh[np][e], xb1); else xb0 = fmaf(xv, bdh[np][e], xb0);
            dx[np][e] = fmaf(e >> 1 ? sb : sa, bdh[np][e], dx[np][e]);
          }
    }
    T* DX = static_cast<T*>(p.dx) + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? jb : ja;
      if (row < p.Q) {
#pragma unroll
        for (int np = 0; np < PT; ++np)
          if (np * 8 < p.P)
            store2(DX + row * dy_st + np * 8 + 2 * t4, dx[np][2 * half], dx[np][2 * half + 1]);
      }
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    xb0 = quad_sum(xb0);
    xb1 = quad_sum(xb1);
    if (t4 == 0) {
      const long long o = (static_cast<long long>(bb) * p.T + t0) * p.H + h;
      if (ja < p.Q) {
        p.ddir[o + static_cast<long long>(ja) * p.H] = rs0 + ea * xb0;
        p.wst[o + static_cast<long long>(ja) * p.H] = sa * xb0;
      }
      if (jb < p.Q) {
        p.ddir[o + static_cast<long long>(jb) * p.H] = rs1 + eb * xb1;
        p.wst[o + static_cast<long long>(jb) * p.H] = sb * xb1;
      }
    }
    if (dho != nullptr) {   // db_j += dt_j e_j dh_out^T x_j
      for (int kk = 0; kk < p.P / 8; ++kk) {
        float v[4];
        uint32_t ab[4], as[4];
        frag_rows_perm(v, Xs + 16 * w * RX, RX, kk * 8, lane, sa, sb);
        split4(v, ab, as);
        mma_row<false, false>(db, ab, as, DH + (kk * 8 + 2 * t4) * RD + g, 8, RD, p.N / 8);
      }
    }
    tda = block_sum<BW>(tda, red);   // (its first barrier: every read of the tiles above is done)
    if (threadIdx.x == 0) p.dAt[slot * p.nt + jt] = tda;
  }

  const int nsl = p.H / p.hb;
  const long long prow = static_cast<long long>(nsl) * p.N;
  float* DBP = p.dbp + (static_cast<long long>(bb) * p.T + t0) * prow + slab * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? jb : ja;
    if (row < p.Q) {
#pragma unroll
      for (int nn = 0; nn < NT8; ++nn)
        if (nn * 8 < p.N)
          store2(DBP + row * prow + nn * 8 + 2 * t4, db[nn][2 * half], db[nn][2 * half + 1]);
    }
  }
}

// Query blocks: a block per (batch, chunk, slab of hb heads, query tile it
// of 64 rows), the last tile (the most key rows) first; 8 warps, two a
// slice of 16 queries, each of the two with half of N's columns.  For each
// head of the slab in order, over the key rows j <= i in stages of 32: dc_i
// += (L o D o dt)_ij b_j (L o D o dt read from the key blocks' workspace)
// and, in the first half's warps, the row sums of (L o D o dt) o S; after
// the loop h_in's term; writes c_i . dc_i and U.  dc sums over the slab's
// heads in the registers.
template <typename T, int PMAX>
__global__ void __launch_bounds__(KNT, 2) ssd_bwd_queries(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char bsm[];
  constexpr bool EX = sizeof(T) == 2;
  constexpr int NH8 = NMAX / 16, KT = KS / 8;   // n8 tiles of a column half, at most
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int ws = w % BW, second = w >= BW;   // the warp's 16 queries, its column half
  const int nslab = p.H / p.hb, per = nslab * p.nc * p.B;
  const int it = p.nt - 1 - static_cast<int>(blockIdx.x) / per, slab = blockIdx.x % nslab;
  const int k = blockIdx.x / nslab % p.nc, bb = blockIdx.x % per / (nslab * p.nc);
  const int t0 = k * p.Q, i0 = it * TB;
  const int RY = rowF(p.P), RB = rowT<T>(p.N), RH = round8(p.N) + 8;
  const int n8 = p.N / 8, c0 = second ? (n8 + 1) / 2 : 0, nc8 = second ? n8 / 2 : (n8 + 1) / 2;
  const int SB = query_stage_bytes<T>(p.P, p.N);
  const int osq = tile_bytes<T>(KS, p.N), o3 = osq + al16(TB * RQ * 4);
  float* DYs = reinterpret_cast<float*>(bsm);                          // [TB][RY]
  unsigned char* ring = bsm + tile_bytes<float>(TB, p.P);
  float* HIN = reinterpret_cast<float*>(ring);                         // after the loop
  T* Cs = reinterpret_cast<T*>(ring + al16(p.P * RH * 4));
  float* cs2 = reinterpret_cast<float*>(ring + query_ring_bytes<T>(p.P, p.N));
  float* dts = cs2 + MAXQ;
  float* ux = dts + MAXQ;   // [TB]: the second half's part of U
  const int grp = slab * p.hb / (p.H / p.G), qp = round16(p.Q);
  const int nst = (min(p.Q, i0 + TB) + KS - 1) / KS;   // key stages up to the tile's last row
  const int ir = 16 * ws + g, ia = i0 + ir, ib = ia + 8;
  const int pairs = p.nt * (p.nt + 1) / 2;
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;

  float dc[NH8][4];   // the warp's columns c0 * 8 ..
  zero(dc);
  for (int hi = 0; hi < p.hb; ++hi) {
    const int h = slab * p.hb + hi;
    const long long slot = slot_of(p, bb, k, h);
    const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
    const float* Sg = bwd_scores(p, bb, k, h);
    const float* LDg = p.lds + slot * pairs * TB * TB;
    auto load_stage = [&](int s) {
      unsigned char* st = ring + (s & 1) * SB;
      const int j0 = s * KS;
      load_rows<T, KNT>(reinterpret_cast<T*>(st), RB, Bg, p.b_st, j0, KS, p.Q, p.N, round8(p.N));
      load_rows<float, KNT>(reinterpret_cast<float*>(st + osq), RQ, Sg + j0, qp, i0, TB, qp,
                            qp - j0, KS);
      const int jt = j0 / TB, pr = it * (it + 1) / 2 + jt;
      load_rows<float, KNT>(reinterpret_cast<float*>(st + o3), RQ,
                            LDg + static_cast<long long>(pr) * TB * TB + (j0 - jt * TB), TB, 0,
                            TB, TB, TB, KS);
    };
    if (hi > 0) __syncthreads();   // the previous head's reads of every tile and of cs done
    load_rows<float, KNT>(DYs, RY, DYg, dy_st, i0, TB, p.Q, p.P, round8(p.P));
    load_stage(0);
    cp_async_commit();
    if (w == 0) bwd_cumsum(p, bb, h, t0, cs2, dts, nullptr, lane);

    float rr0 = 0.f, rr1 = 0.f;   // rows ia, ib of sum_j (L o D o dt)_ij S_ij
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // stage s (and dy_i, cs) in place; stage s - 1 consumed by every warp
      if (s + 1 < nst) load_stage(s + 1);
      cp_async_commit();
      const unsigned char* st = ring + (s & 1) * SB;
      const T* bs = reinterpret_cast<const T*>(st);
      const float* sq = reinterpret_cast<const float*>(st + osq);
      const int j0 = s * KS;
      // the stage's n8 tiles of keys the slice's queries see: a tile after
      // its last query is all masked and skipped, and so is a slice past Q
      const int iw = i0 + 16 * ws;
      const int khi = iw >= p.Q ? 0 : max(0, min(KT, (iw - j0 + 16) / 8));
      if (khi == 0) continue;
      float a[KT][4];   // (L o D o dt)_ij, an accumulator's layout: rows ia, ib
      zero(a);
      {   // read from the key blocks' workspace
        const float* lq = reinterpret_cast<const float*>(st + o3) + ir * RQ + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          if (kk < khi) {
            const float2 u = *reinterpret_cast<const float2*>(lq + kk * 8);
            const float2 v = *reinterpret_cast<const float2*>(lq + 8 * RQ + kk * 8);
            a[kk][0] = u.x;
            a[kk][1] = u.y;
            a[kk][2] = v.x;
            a[kk][3] = v.y;
          }
      }
      // the causal mask (the workspace's rows past Q were never written), the
      // row sums with S (the first half), and dc_i += (L o D o dt) b_j
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk >= khi) continue;
        float sval[4] = {0.f, 0.f, 0.f, 0.f};
        if (!second) {
          const float2 su = *reinterpret_cast<const float2*>(sq + ir * RQ + kk * 8 + 2 * t4);
          const float2 sw = *reinterpret_cast<const float2*>(sq + (ir + 8) * RQ + kk * 8 + 2 * t4);
          sval[0] = su.x;
          sval[1] = su.y;
          sval[2] = sw.x;
          sval[3] = sw.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1 ? ib : ia, j = j0 + kk * 8 + 2 * t4 + (e & 1);
          const bool ok = j <= i && i < p.Q;
          a[kk][e] = ok ? a[kk][e] : 0.f;
          const float r = ok ? a[kk][e] * sval[e] : 0.f;
          if (e >> 1) rr1 += r; else rr0 += r;
        }
        uint32_t ab[4], as[4];
        frag_acc(ab, as, a[kk]);
        mma_row<false, EX>(dc, ab, as, bs + (kk * 8 + 2 * t4) * RB + g + c0 * 8, 8, RB, nc8);
      }
    }
    __syncthreads();   // every stage consumed: h_in and c_i go where the ring was

    const float* hin = bwd_h_in(p, bb, k, h);
    if (hin != nullptr) {
      load_rows<float, KNT>(HIN, RH, hin, p.N, 0, p.P, p.P, p.N, round8(p.N));
      load_rows<T, KNT>(Cs, RB, Cg, p.c_st, i0, TB, p.Q, p.N, round8(p.N));
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float ua = 0.f, ub = 0.f;   // U of rows ia, ib over the warp's columns
    if (hin != nullptr) {   // dc_i += exp(cs_i) h_in^T dy_i
      const float fa = ex2(cs2[ia]), fb = ex2(cs2[ib]);
      float hv[NH8][4];
      zero(hv);
      for (int kk = 0; kk < p.P / 8; ++kk) {
        float v[4];
        uint32_t ab[4], as[4];
        frag_rows(v, DYs + 16 * ws * RY, RY, kk * 8, lane, fa, fb);
        split4(v, ab, as);
        mma_row<false, false>(hv, ab, as, HIN + (kk * 8 + t4) * RH + g + c0 * 8, 8, 4 * RH, nc8);
      }
#pragma unroll
      for (int nn = 0; nn < NH8; ++nn)
        if (nn < nc8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float cv =
                to_f(Cs[(ir + (e >> 1) * 8) * RB + (c0 + nn) * 8 + 2 * t4 + (e & 1)]);
            if (e >> 1) ub = fmaf(cv, hv[nn][e], ub); else ua = fmaf(cv, hv[nn][e], ua);
            dc[nn][e] += hv[nn][e];
          }
    }
    ua = quad_sum(ua);
    ub = quad_sum(ub);
    if (second && t4 == 0) {
      ux[ir] = ua;
      ux[ir + 8] = ub;
    }
    __syncthreads();   // the second half's U in place
    if (!second) {
      ua += ux[ir];
      ub += ux[ir + 8];
      rr0 = quad_sum(rr0);
      rr1 = quad_sum(rr1);
      if (t4 == 0) {
        const long long o = (static_cast<long long>(bb) * p.T + t0) * p.H + h;
        if (ia < p.Q) {
          p.rrow[o + static_cast<long long>(ia) * p.H] = rr0 + ua;
          p.urow[o + static_cast<long long>(ia) * p.H] = ua;
        }
        if (ib < p.Q) {
          p.rrow[o + static_cast<long long>(ib) * p.H] = rr1 + ub;
          p.urow[o + static_cast<long long>(ib) * p.H] = ub;
        }
      }
    }
  }

  const int nsl = p.H / p.hb;
  const long long prow = static_cast<long long>(nsl) * p.N;
  float* DCP = p.dcp + (static_cast<long long>(bb) * p.T + t0) * prow + slab * p.N + c0 * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? ib : ia;
    if (row < p.Q) {
#pragma unroll
      for (int nn = 0; nn < NH8; ++nn)
        if (nn < nc8)
          store2(DCP + row * prow + nn * 8 + 2 * t4, dc[nn][2 * half], dc[nn][2 * half + 1]);
    }
  }
}

// The states of dh: sum_i exp(cs_i) dy_i c_i^T of one (batch, chunk, head)
// over a column split of N into dhs, and cs_Q into dec; chunk 0's only
// when there is an h0 (it feeds dh0 alone).  A warp per 16 (or 32) rows of
// P, the chunk's rows in stages of 32 through a two-stage ring.
template <typename T, int PMAX>
__device__ __forceinline__ void dh_state_role(const BwdParams& p, unsigned char* smem, int sb) {
  constexpr bool EX = sizeof(T) == 2;
  constexpr int SMT = PMAX / 64;   // m16 tiles of P a warp
  constexpr int SN8 = 16 / SMT;    // n8 tiles of N a block, at most
  constexpr int KT = KS / 8;
  const int h = sb / p.dspl, split = sb % p.dspl, k = blockIdx.y, bb = blockIdx.z;
  if (k == 0 && !p.has_h0) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int n8 = round8(p.N) / 8, ns8 = (n8 + p.dspl - 1) / p.dspl, nb = split * ns8;
  const int RY = rowF(p.P), RC = rowT<T>(p.N);
  const int oc = tile_bytes<float>(KS, p.P), SB = oc + tile_bytes<T>(KS, p.N);
  float* cs2 = reinterpret_cast<float*>(smem + 2 * SB);
  float* fac = cs2 + MAXQ;   // dt, then exp(cs_i)
  const int t0 = k * p.Q, grp = h / (p.H / p.G);
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
  auto load_stage = [&](int s) {
    unsigned char* st = smem + (s & 1) * SB;
    load_rows<float>(reinterpret_cast<float*>(st), RY, DYg, dy_st, s * KS, KS, p.Q, p.P,
                     round8(p.P));
    load_rows<T>(reinterpret_cast<T*>(st + oc), RC, Cg, p.c_st, s * KS, KS, p.Q, p.N,
                 round8(p.N));
  };
  const int nst = (p.Q + KS - 1) / KS;
  load_stage(0);
  cp_async_commit();
  if (w == 0) bwd_cumsum(p, bb, h, t0, cs2, fac, nullptr, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < MAXQ; i += BNT) fac[i] = ex2(cs2[i]);

  float acc[SMT][SN8][4];
#pragma unroll
  for (int mt = 0; mt < SMT; ++mt) zero(acc[mt]);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // stage s (and exp(cs)) in place; stage s - 1 consumed
    if (s + 1 < nst) load_stage(s + 1);
    cp_async_commit();
    const float* dys = reinterpret_cast<const float*>(smem + (s & 1) * SB);
    const T* cq = reinterpret_cast<const T*>(smem + (s & 1) * SB + oc);
    const float* f = fac + s * KS;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int r0 = kk * 8 + 2 * t4;
      const float f0 = f[r0], f1 = f[r0 + 1];
      const T* cr = cq + r0 * RC + g;
#pragma unroll
      for (int mt = 0; mt < SMT; ++mt) {
        const int p0 = (w * SMT + mt) * 16;
        if (p0 < p.P) {
          // A = (exp(cs) dy)^T: rows of P, the chunk rows as its depth (permuted)
          const float* y0 = dys + r0 * RY + p0 + g;
          const float v[4] = {y0[0] * f0, y0[8] * f0, y0[RY] * f1, y0[RY + 8] * f1};
          uint32_t ab[4], as[4];
          split4(v, ab, as);
          mma_row<false, EX>(acc[mt], ab, as, cr + nb * 8, 8, RC, min(ns8, n8 - nb));
        }
      }
    }
  }
  const long long slot = slot_of(p, bb, k, h);
  float* dst = p.dhs + slot * static_cast<long long>(p.P) * p.N;
#pragma unroll
  for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (w * SMT + mt) * 16 + g + 8 * half;
      if (row < p.P) {
#pragma unroll
        for (int n = 0; n < SN8; ++n) {
          const int col = (nb + n) * 8 + 2 * t4;
          if (n < ns8 && col < p.N)
            store2(dst + row * p.N + col, acc[mt][n][2 * half], acc[mt][n][2 * half + 1]);
        }
      }
    }
  if (split == 0 && threadIdx.x == 0) p.dec[slot] = cs2[p.Q - 1];
}

// S of every (batch, chunk, group) (blockIdx.x below n_cb: the forward's c
// b^T role) and, past them, the states of dh
template <typename T, int PMAX>
__global__ void __launch_bounds__(BNT) ssd_bwd_states(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char bsm[];
  if (static_cast<int>(blockIdx.x) < p.n_cb)
    cb_role<T>(p.cb, bsm, blockIdx.x);
  else
    dh_state_role<T, PMAX>(p, bsm, blockIdx.x - p.n_cb);
}

// The ordered pass from the last chunk to the first: dh = dh_final (or 0);
// for each chunk k from the last: dhs[k] = dh (its dh_out; the last chunk's
// is dh_final itself), dh = exp(cs_Q) dh + dhs[k] as it was; dh0 = dh.
// One state entry a thread.
__global__ void __launch_bounds__(256) ssd_bwd_carry(const BwdParams p) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const long long pn = static_cast<long long>(p.P) * p.N;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= pn) return;
  float dh = p.dh_final != nullptr ? p.dh_final[(static_cast<long long>(bb) * p.H + h) * pn + e]
                                   : 0.f;
  const int k_end = p.has_h0 ? 0 : 1;   // without h0, chunk 0's dh_in is not wanted
  constexpr int AHEAD = 4;   // chunk states read together, before any of them is written
  for (int k0 = p.nc - 1; k0 >= k_end; k0 -= AHEAD) {
    float sv[AHEAD], d[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int k = k0 - i;
      if (k >= k_end) {
        const long long slot = slot_of(p, bb, k, h);
        sv[i] = p.dhs[slot * pn + e];
        d[i] = ex2(p.dec[slot]);
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int k = k0 - i;
      if (k >= k_end) {
        if (k < p.nc - 1) p.dhs[slot_of(p, bb, k, h) * pn + e] = dh;
        dh = fmaf(d[i], dh, sv[i]);
      }
    }
  }
  if (!p.has_h0) {   // dh_out of chunk 0 (its dh_in is not wanted)
    if (p.nc > 1) p.dhs[slot_of(p, bb, 0, h) * pn + e] = dh;
  } else {
    p.dh0[(static_cast<long long>(bb) * p.H + h) * pn + e] = dh;
  }
}

// Per (batch, chunk, head): dcs, dl (its reverse cumsum), ddt and the
// chunk's part of dA
__global__ void __launch_bounds__(BT) ssd_bwd_finish(const BwdParams p) {
  __shared__ float cs2[MAXQ], dts[MAXQ], cds[MAXQ], dcs[MAXQ], red[BT / 32];
  const int h = blockIdx.x, k = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int t0 = k * p.Q;
  if (tid < 32) bwd_cumsum(p, bb, h, t0, cs2, dts, cds, tid);
  const float* dho = bwd_dh_out(p, bb, k, h);
  const float* hi = bwd_h_in(p, bb, k, h);
  float dot = 0.f;
  if (dho != nullptr && hi != nullptr) {
    const long long pn = static_cast<long long>(p.P) * p.N;
    for (long long e = tid; e < pn; e += BT) dot = fmaf(dho[e], hi[e], dot);
  }
  dot = block_sum<BT / 32>(dot, red);   // (its barriers also publish cs2, dts and cds)
  const float eterm = ex2(cs2[p.Q - 1]) * dot, cl = cds[p.Q - 1];
  const long long o = (static_cast<long long>(bb) * p.T + t0 + tid) * p.H + h;
  float dd = 0.f, wv = 0.f, dc = 0.f, da = 0.f;
  if (tid < p.Q) {
    dd = p.ddir[o];
    wv = p.wst[o];
    dc = p.rrow[o] - dts[tid] * dd;
    da = wv * (cl - cds[tid]);                              // W_j (cd_Q - cd_j)
    if (hi != nullptr) da = fmaf(p.urow[o], cds[tid], da);  // U_i cd_i
  }
  const float wsum = block_sum<BT / 32>(wv, red);
  if (tid == p.Q - 1) dc += eterm + wsum;
  dcs[tid] = dc;
  __syncthreads();
  if (tid < 32) {   // dl_i = sum_{j >= i} dcs_j: runs of 8 rows a lane, from the top
    float v[8], run = 0.f;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      run += dcs[8 * lane + i];
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, incl, s);
      if (lane + s < 32) incl += u;
    }
    const float base = incl - run;
#pragma unroll
    for (int i = 0; i < 8; ++i) dcs[8 * lane + i] = base + v[i];
  }
  __syncthreads();
  if (tid < p.Q) p.ddt[o] = dd - p.A[h] * dcs[tid];
  da = block_sum<BT / 32>(da, red);
  if (tid == 0) {
    float tsum = 0.f;   // the key tiles' sums of T_ij (cd_i - cd_j), in order
    for (int t = 0; t < p.nt; ++t) tsum += p.dAt[slot_of(p, bb, k, h) * p.nt + t];
    p.dAp[slot_of(p, bb, k, h)] = -(tsum + da + eterm * cl);
  }
}

// dB, dC: each group's slabs summed in order; the last block: dA, the
// (batch, chunk) parts summed in order
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_reduce(const BwdParams p) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < p.H; h += 256) {
      float s = 0.f;
      for (int bb = 0; bb < p.B; ++bb)
        for (int k = 0; k < p.nc; ++k) s += p.dAp[slot_of(p, bb, k, h)];
      p.dA[h] = s;
    }
    return;
  }
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long total = static_cast<long long>(p.B) * p.T * p.G * p.N;
  if (e >= total) return;
  const int n = static_cast<int>(e % p.N);
  const long long rg = e / p.N;                  // (b, t, g)
  const int g = static_cast<int>(rg % p.G);
  const long long bt = rg / p.G;
  const int nsl = p.H / p.hb, per = nsl / p.G;   // slabs a group
  const long long base = (bt * nsl + static_cast<long long>(g) * per) * p.N + n;
  float sb = 0.f, sc = 0.f;
  for (int i = 0; i < per; ++i) {
    sb += p.dbp[base + static_cast<long long>(i) * p.N];
    sc += p.dcp[base + static_cast<long long>(i) * p.N];
  }
  from_f(static_cast<T*>(p.dB) + e, sb);
  from_f(static_cast<T*>(p.dC) + e, sc);
}

template <typename T>
size_t states_smem(const BwdParams& p) {
  const size_t a = cb_smem<T>(p.cb), b = dhstate_smem<T>(p.P, p.N);
  return a > b ? a : b;
}

template <typename T, int PMAX>
cudaError_t bwd_attributes() {
  static bool c_st[kMaxDevices] = {}, c_k[kMaxDevices] = {}, c_q[kMaxDevices] = {};
  cudaError_t e = allow_smem(ssd_bwd_states<T, PMAX>, c_st);
  if (e != cudaSuccess) return e;
  e = allow_smem(ssd_bwd_keys<T, PMAX>, c_k);
  if (e != cudaSuccess) return e;
  return allow_smem(ssd_bwd_queries<T, PMAX>, c_q);
}

template <typename T, int PMAX>
cudaError_t bwd_launch(const BwdParams& p, cudaStream_t s) {
  cudaError_t e = bwd_attributes<T, PMAX>();
  if (e != cudaSuccess) return e;
  const size_t ss = states_smem<T>(p), sk = key_smem<T>(p.P, p.N), sq = query_smem<T>(p.P, p.N);
  if (ss > kSmemMax || sk > kSmemMax || sq > kSmemMax) return cudaErrorInvalidValue;
  const long long pn = static_cast<long long>(p.P) * p.N;
  const int n_dh = p.run_states ? p.H * p.dspl : 0, nslab = p.H / p.hb;
  ssd_bwd_states<T, PMAX><<<dim3(p.n_cb + n_dh, p.nc, p.B), BNT, ss, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (p.run_states) {
    ssd_bwd_carry<<<dim3(static_cast<unsigned>((pn + 255) / 256), p.H, p.B), 256, 0, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const unsigned nblk = static_cast<unsigned>(p.nt * nslab * p.nc * p.B);
  ssd_bwd_keys<T, PMAX><<<nblk, BNT, sk, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_queries<T, PMAX><<<nblk, KNT, sq, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_finish<<<dim3(p.H, p.nc, p.B), BT, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(p.B) * p.T * p.G * p.N;
  ssd_bwd_reduce<T><<<static_cast<unsigned>((total + 255) / 256 + 1), 256, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch(const BwdParams& p, cudaStream_t s) {
  return p.P <= 64 ? bwd_launch<T, 64>(p, s) : bwd_launch<T, 128>(p, s);
}

// the shapes and the plan; false if the kernels do not take them
bool make_bwd_params(BwdParams& p, int B, int T, int H, int G, int P, int N, int Q, int hb,
                     bool has_h0) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || G <= 0 || H % G != 0) return false;
  if (P <= 0 || P > 128 || P % 8 != 0 || N <= 0 || N > NMAX || N % 8 != 0) return false;
  if (Q <= 0 || Q > MAXQ || T % Q != 0 || T / Q > 65535) return false;
  if (hb <= 0 || (H / G) % hb != 0) return false;
  p.B = B; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q; p.nc = T / Q;
  p.nt = (Q + TB - 1) / TB;
  p.hb = hb;
  p.has_h0 = has_h0;
  p.run_states = p.nc > 1 || has_h0;
  p.dspl = P <= 64 ? 1 : 2;
  p.n_cb = G * (((Q + TR - 1) / TR + NW - 1) / NW);   // cb_role's bands of 4 row tiles
  Params& c = p.cb;
  c.B = B; c.T = T; c.H = H; c.G = G; c.P = P; c.N = N; c.Q = Q; c.nc = p.nc;
  c.pp = round16(P); c.np = round16(N); c.qp = round16(Q);
  return static_cast<long long>(p.nt) * (H / hb) * p.nc * B <= 2147483647LL;
}

template <typename T, int PMAX>
cudaError_t bwd_occupancy_of(const BwdParams& p, int* kb, int* qb, int* sb) {
  cudaError_t e = bwd_attributes<T, PMAX>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(kb, ssd_bwd_keys<T, PMAX>, BNT,
                                                    key_smem<T>(p.P, p.N));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(qb, ssd_bwd_queries<T, PMAX>, KNT,
                                                    query_smem<T>(p.P, p.N));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(sb, ssd_bwd_states<T, PMAX>, BNT,
                                                       states_smem<T>(p));
}

template <typename T>
cudaError_t bwd_occupancy_at(const BwdParams& p, int* kb, int* qb, int* sb) {
  return p.P <= 64 ? bwd_occupancy_of<T, 64>(p, kb, qb, sb)
                   : bwd_occupancy_of<T, 128>(p, kb, qb, sb);
}

}  // namespace

// The backward of ssd_chunk_scan with the log-decay -dt * A.  dtype code of
// x, b, c (and of dx, dB, dC): 0 = float32, 1 = bfloat16.  dy [B, T, H, P]
// float32 contiguous; hin: each chunk's carried-in state [B, T/Q, H, P, N]
// as the forward's workspace leaves it, or with one chunk h0 (null: zero);
// dh_final [B, H, P, N] or null (zero); has_h0: chunk 0 carries an h0 in
// and dh0 [B, H, P, N] is written.  The plan: hb heads a key or query block
// (dividing H / G).  Workspace (float32, each part at a 16-byte boundary):
// with several chunks or an h0, dhs B * (T/Q) * H * P * N and dec B * (T/Q)
// * H; always sws B * (T/Q) * G * QP * QP (QP = Q rounded up to 16), lds B *
// (T/Q) * H * nt (nt + 1) / 2 * 64 * 64 (nt = ceil(Q / 64)), dbp and dcp B *
// T * (H / hb) * N each; rrow, ddir, wst, urow
// B * T * H each; dAt B * (T/Q) * H * nt and dAp B * (T/Q) * H.  Issues
// ssd_bwd_states, ssd_bwd_carry (several chunks or an h0), ssd_bwd_keys,
// ssd_bwd_queries, ssd_bwd_finish and ssd_bwd_reduce.  Returns a
// cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_bwd(
    int dtype, const void* x, const void* b, const void* c, const void* dt, const void* A,
    const void* hin, const void* dh_final, const void* dy, void* dx, void* dB, void* dC,
    void* ddt, void* dA, void* dh0, void* dhs, void* dec, void* sws, void* lds, void* dbp,
    void* dcp, void* rrow, void* ddir, void* wst, void* urow, void* dAt, void* dAp, int B,
    int T, int H, int G, int P, int N, int Q, int has_h0, int hb,
    long long x_sb, long long x_st, long long x_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dt_sb, long long dt_st, long long dt_sh, void* stream) {
  BwdParams p = {};
  if (!make_bwd_params(p, B, T, H, G, P, N, Q, hb, has_h0 != 0)) return cudaErrorInvalidValue;
  if (dt == nullptr || A == nullptr || dy == nullptr || dx == nullptr || dB == nullptr ||
      dC == nullptr || ddt == nullptr || dA == nullptr || sws == nullptr || lds == nullptr ||
      dbp == nullptr || dcp == nullptr || rrow == nullptr || ddir == nullptr ||
      wst == nullptr || urow == nullptr || dAt == nullptr || dAp == nullptr)
    return cudaErrorInvalidValue;
  if ((p.nc > 1 || p.has_h0) && hin == nullptr) return cudaErrorInvalidValue;
  if (p.run_states && (dhs == nullptr || dec == nullptr)) return cudaErrorInvalidValue;
  if (p.has_h0 && dh0 == nullptr) return cudaErrorInvalidValue;
  p.x = x; p.b = b; p.c = c;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.dy = static_cast<const float*>(dy);
  p.hin = static_cast<const float*>(hin);
  p.dh_final = static_cast<const float*>(dh_final);
  p.dx = dx; p.dB = dB; p.dC = dC;
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dh0 = static_cast<float*>(dh0);
  p.dhs = static_cast<float*>(dhs);
  p.dec = static_cast<float*>(dec);
  p.sws = static_cast<float*>(sws);
  p.lds = static_cast<float*>(lds);
  p.dbp = static_cast<float*>(dbp);
  p.dcp = static_cast<float*>(dcp);
  p.rrow = static_cast<float*>(rrow);
  p.ddir = static_cast<float*>(ddir);
  p.wst = static_cast<float*>(wst);
  p.urow = static_cast<float*>(urow);
  p.dAt = static_cast<float*>(dAt);
  p.dAp = static_cast<float*>(dAp);
  p.x_sb = x_sb; p.x_st = x_st; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_st = b_st; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_st = c_st; p.c_sg = c_sg;
  p.dt_sb = dt_sb; p.dt_st = dt_st; p.dt_sh = dt_sh;
  Params& cb = p.cb;
  cb.b = b; cb.c = c; cb.sws = p.sws;
  cb.b_sb = b_sb; cb.b_st = b_st; cb.b_sg = b_sg;
  cb.c_sb = c_sb; cb.c_st = c_st; cb.c_sg = c_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dispatch<float>(p, s);
  if (dtype == 1) return bwd_dispatch<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// Blocks per SM of ssd_bwd_keys, ssd_bwd_queries and ssd_bwd_states at
// head width P and state width N, and their dynamic shared memory (the
// states kernel's at chunks of Q rows)
extern "C" int ssd_chunk_bwd_occupancy(int dtype, int P, int N, int Q, int* key_blocks,
                                       int* query_blocks, int* state_blocks,
                                       int* key_smem_bytes, int* query_smem_bytes,
                                       int* state_smem_bytes) {
  BwdParams p = {};
  if (!make_bwd_params(p, 1, Q, 1, 1, P, N, Q, 1, false)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    *key_smem_bytes = key_smem<float>(P, N);
    *query_smem_bytes = query_smem<float>(P, N);
    *state_smem_bytes = static_cast<int>(states_smem<float>(p));
    return bwd_occupancy_at<float>(p, key_blocks, query_blocks, state_blocks);
  }
  if (dtype == 1) {
    *key_smem_bytes = key_smem<__nv_bfloat16>(P, N);
    *query_smem_bytes = query_smem<__nv_bfloat16>(P, N);
    *state_smem_bytes = static_cast<int>(states_smem<__nv_bfloat16>(p));
    return bwd_occupancy_at<__nv_bfloat16>(p, key_blocks, query_blocks, state_blocks);
  }
  return cudaErrorInvalidValue;
}
