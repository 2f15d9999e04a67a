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
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int R, const T* src, long long rs, int r0,
                                          int nrows, int rvalid, int cvalid, int ccols) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = ccols / EPC;
  if (NT % cpr == 0) {
    const int rpp = NT / cpr, cc = (threadIdx.x % cpr) * EPC;
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
  for (int e = threadIdx.x; e < nrows * cpr; e += NT) {
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
// of 64, N 128, chunks of 256, fp32) the products, about 26 GFLOP a call.
// The design is the simple one, fp32 SIMT products from shared memory:
//   * ssd_bwd_states: each chunk's sum_i exp(cs_i) dy_i c_i^T, in parallel
//     (the forward's state role with dy and c), and its cs_Q;
//   * ssd_bwd_carry: the ordered pass from the last chunk to the first,
//     dh_out of each chunk in place of its state, and dh0 (the mirror of
//     ssd_carry; run only with several chunks or an h0);
//   * ssd_bwd_chunk: a block per (batch, chunk, head, tile of 64 rows);
//     for its tile as keys j it walks the query tiles i >= j (dx, db, ddt's
//     direct part, the state terms with dh_out, its part of dA's T sum),
//     then for its tile as queries i the key tiles j <= i (dc with the h_in
//     term, c_i . dc_i and U_i):
//     every block walks nt + 1 tile pairs.  4 x 4 (or 4 x 8) outputs a
//     thread, rows of odd stride, so no shared-memory bank is hit twice;
//   * ssd_bwd_finish: per (batch, chunk, head) dcs, its reverse cumsum, ddt
//     and the chunk's part of dA (the tiles' parts in order, then U, W, E);
//   * ssd_bwd_reduce: db and dc summed over each group's heads in order,
//     and dA over (batch, chunk) in order.
// No atomics: every sum has a fixed order, so two calls agree bit for bit.
// The carried-in states are the forward's (kept from its workspace).

namespace {

constexpr int BT = 256;         // backward threads a block: 16 x 16 (tx along columns)
constexpr int TQ = 64;          // backward rows a tile
constexpr int NMAX = 128;       // N at most (tiles are this wide)
constexpr int SKB = 32;         // ssd_bwd_states: rows a stage

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
  float* dbp;             // [B, T, H, N]: each head's db, before the group's sum
  float* dcp;             // [B, T, H, N]: each head's dc
  float* rrow;            // [B, T, H]: c_i . dc_i
  float* ddir;            // [B, T, H]: ddt's direct part
  float* wst;             // [B, T, H]: dt_j e_j x_j^T dh_out b_j
  float* urow;            // [B, T, H]: exp(cs_i) c_i^T h_in^T dy_i
  float* dAt;             // [B, nc, H, nt]: each key tile's sum of T_ij (cd_i - cd_j)
  float* dAp;             // [B, nc, H]: each chunk's part of dA
  int B, T, H, G, P, N, Q, nc, nt;
  int has_h0;             // chunk 0 carries h0 in, and dh0 is wanted
  int run_states;         // ssd_bwd_states and ssd_bwd_carry run
  long long x_sb, x_st, x_sh;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
  long long dt_sb, dt_st, dt_sh;
};

__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16(v); }

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

// Sum of v over the block in a fixed order (shuffles, then the warps in
// order); every thread gets it.  `red` holds BT / 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red free
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < BT / 32; ++i) s += red[i];
  return s;
}

// rows [0, rows) x cols of dst (row stride R) = src rows [0, nrows) x
// columns [0, ncols) (row stride rs, unit column stride) as fp32, times
// scale[row] when given; zeros elsewhere.
template <typename T, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int R, const T* src, long long rs,
                                          int nrows, int ncols, int rows,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < rows * COLS; e += BT) {
    const int r = e / COLS, cc = e % COLS;
    float v = 0.f;
    if (r < nrows && cc < ncols) {
      v = to_f(src[r * rs + cc]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * R + cc] = v;
  }
}

// acc[r][s] += sum_{k < K} A[(ty + 16 r) am + k ak] * Bm[(tx + 16 s) bn + k bk]:
// a thread's MR x NS outputs of a product from shared memory.  The block's
// threads are a 16 x 16 grid; a warp holds two ty and 16 tx, so its A
// reads are two addresses and its B reads 16 consecutive ones or 16 rows of
// odd stride: one shared-memory wavefront each.
template <int MR, int NS>
__device__ __forceinline__ void mm_acc(float (&acc)[MR][NS], const float* A, int am, int ak,
                                       const float* Bm, int bn, int bk, int K, int ty, int tx) {
  const float* a0 = A + ty * am;
  const float* b0 = Bm + tx * bn;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[MR], bv[NS];
#pragma unroll
    for (int r = 0; r < MR; ++r) a[r] = a0[16 * r * am + k * ak];
#pragma unroll
    for (int s = 0; s < NS; ++s) bv[s] = b0[16 * s * bn + k * bk];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[r][s] = fmaf(a[r], bv[s], acc[r][s]);
  }
}

template <int MR, int NS>
__device__ __forceinline__ void zero(float (&acc)[MR][NS]) {
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s] = 0.f;
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

// shared memory of ssd_bwd_chunk (floats): x, b, c, dy tiles, two score
// tiles, cs, dt and the reductions
template <int PMAX>
__host__ __device__ constexpr int chunk_smem_floats() {
  return TQ * (2 * (PMAX + 1) + 2 * (NMAX + 1)) + 2 * TQ * (TQ + 1) + 3 * MAXQ + 9 * TQ;
}

template <int PMAX>
__host__ __device__ constexpr int states_smem_floats() {
  return SKB * (PMAX + 1 + NMAX + 1) + 2 * MAXQ;
}

// The chunk's tile t as keys j: for every query tile i >= t, S = c_i b_j^T
// and D = dy_i x_j^T, then dx_j += (S L)^T dy_i and db_j += (L D)^T c_i; then
// the dh_out terms; writes dx, db (this head's), ddt's direct part and W.
template <typename T, int PMAX>
__device__ __forceinline__ void bwd_keys(const BwdParams& p, float* sm, int bb, int k, int h,
                                         int t) {
  constexpr int RP = PMAX + 1, RN = NMAX + 1, RS = TQ + 1;
  constexpr int PS = PMAX / 16, NS = NMAX / 16, MR = TQ / 16;
  float* X = sm;
  float* Bt = X + TQ * RP;
  float* Cs = Bt + TQ * RN;
  float* DY = Cs + TQ * RN;
  float* SL = DY + TQ * RP;
  float* LD = SL + TQ * RS;
  float* cs2 = LD + TQ * RS;
  float* dts = cs2 + MAXQ;
  float* cds = dts + MAXQ;
  float* red = cds + MAXQ;   // [8][TQ] column sums of each warp, then [TQ] the row sums
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, w = tid >> 5;
  const int t0 = k * p.Q, grp = h / (p.H / p.G);
  const int j0 = t * TQ, nj = min(TQ, p.Q - j0);
  const T* Xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh + t0 * p.x_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;

  load_tile<T, PMAX>(X, RP, Xg + j0 * p.x_st, p.x_st, nj, p.P, TQ);
  load_tile<T, NMAX>(Bt, RN, Bg + j0 * p.b_st, p.b_st, nj, p.N, TQ);
  float dx[MR][PS], db[MR][NS], part[MR], tda = 0.f;   // tda: sum of T_ij (cd_i - cd_j)
  zero(dx);
  zero(db);
#pragma unroll
  for (int s = 0; s < MR; ++s) part[s] = 0.f;
  for (int it = t; it < p.nt; ++it) {
    const int i0 = it * TQ, ni = min(TQ, p.Q - i0);
    __syncthreads();  // the previous query tile consumed (and cs in place)
    load_tile<T, NMAX>(Cs, RN, Cg + i0 * p.c_st, p.c_st, ni, p.N, TQ);
    load_tile<float, PMAX>(DY, RP, DYg + i0 * dy_st, dy_st, ni, p.P, TQ);
    __syncthreads();
    float sc[MR][MR], dd[MR][MR];
    zero(sc);
    zero(dd);
    mm_acc(sc, Cs, RN, 1, Bt, RN, 1, p.N, ty, tx);   // S_ij = c_i . b_j
    mm_acc(dd, DY, RP, 1, X, RP, 1, p.P, ty, tx);    // D_ij = dy_i . x_j
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
      for (int s = 0; s < MR; ++s) {
        const int jl = tx + 16 * s, j = j0 + jl;
        // mask before the exp: above the diagonal the decay would overflow
        const bool ok = i >= j && il < ni && jl < nj;
        const float L = ok ? ex2(cs2[i] - cs2[j]) : 0.f;
        const float sl = ok ? sc[r][s] * L : 0.f;
        const float sd = sl * (ok ? dd[r][s] : 0.f);
        SL[il * RS + jl] = sl;
        LD[il * RS + jl] = ok ? L * dd[r][s] : 0.f;
        part[s] += sd;
        if (ok) tda = fmaf(sd * dts[j], cds[i] - cds[j], tda);
      }
    }
    __syncthreads();  // the score tiles in place
    mm_acc(dx, SL, 1, RS, DY, 1, RP, ni, ty, tx);   // sum_i (S L)_ij dy_i
    mm_acc(db, LD, 1, RS, Cs, 1, RN, ni, ty, tx);   // sum_i (L D)_ij c_i
  }
  __syncthreads();  // c, dy and the score tiles consumed: dh_out goes there

  const float* dho = bwd_dh_out(p, bb, k, h);
  float* DH = Cs;   // [PMAX][RN]
  if (dho != nullptr) {
    load_tile<float, NMAX>(DH, RN, dho, p.N, p.P, p.N, PMAX);
    __syncthreads();
  }
  const float cl = cs2[p.Q - 1];
  const long long out_row = static_cast<long long>(p.H) * p.P;
  T* DX = static_cast<T*>(p.dx) + (static_cast<long long>(bb) * p.T + t0 + j0) * out_row +
          h * p.P;
  {  // dx_j = dt_j (sum_i (S L)_ij dy_i + e_j dh_out b_j)
    float bdh[MR][PS];
    zero(bdh);
    if (dho != nullptr) mm_acc(bdh, Bt, RN, 1, DH, RN, 1, p.N, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int jl = ty + 16 * r, j = j0 + jl;
      if (jl >= nj) continue;
      const float dtj = dts[j], ej = ex2(cl - cs2[j]);
#pragma unroll
      for (int s = 0; s < PS; ++s) {
        const int pc = tx + 16 * s;
        if (pc < p.P) from_f(DX + jl * out_row + pc, dtj * fmaf(ej, bdh[r][s], dx[r][s]));
      }
    }
  }
  {  // db_j = dt_j (sum_i (L D)_ij c_i + e_j dh_out^T x_j); e_j x_j^T dh_out b_j
    float xdh[MR][NS];
    zero(xdh);
    if (dho != nullptr) mm_acc(xdh, X, RP, 1, DH, 1, RN, p.P, ty, tx);
    const long long nrow = static_cast<long long>(p.H) * p.N;
    float* DBP = p.dbp + (static_cast<long long>(bb) * p.T + t0 + j0) * nrow + h * p.N;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int jl = ty + 16 * r, j = j0 + jl;
      float xb = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) xb = fmaf(xdh[r][s], Bt[jl * RN + tx + 16 * s], xb);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) xb += __shfl_xor_sync(0xffffffffu, xb, o);  // over tx
      if (jl >= nj) continue;
      const float dtj = dts[j], ej = ex2(cl - cs2[j]);
      if (tx == 0) red[8 * TQ + jl] = ej * xb;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int n = tx + 16 * s;
        if (n < p.N) DBP[jl * nrow + n] = dtj * fmaf(ej, xdh[r][s], db[r][s]);
      }
    }
  }
  // ddt's intra-chunk part: the column sums of (S L) D, over ty in order
#pragma unroll
  for (int s = 0; s < MR; ++s) {
    const float v = part[s] + __shfl_xor_sync(0xffffffffu, part[s], 16);
    if (lane < 16) red[w * TQ + tx + 16 * s] = v;
  }
  __syncthreads();
  if (tid < nj) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < BT / 32; ++i) v += red[i * TQ + tid];
    const float st = red[8 * TQ + tid];
    const long long o = (static_cast<long long>(bb) * p.T + t0 + j0 + tid) * p.H + h;
    p.ddir[o] = v + st;
    p.wst[o] = dts[j0 + tid] * st;
  }
  tda = block_sum(tda, red);   // (its first barrier: every read of red above is done)
  if (tid == 0) p.dAt[slot_of(p, bb, k, h) * p.nt + t] = tda;
}

// The chunk's tile t as queries i: for every key tile j <= t, D = dy_i x_j^T
// and dc_i += (L D dt) b_j; then the h_in term; writes dc (this head's) and
// c_i . dc_i.
template <typename T, int PMAX>
__device__ __forceinline__ void bwd_queries(const BwdParams& p, float* sm, int bb, int k, int h,
                                            int t) {
  constexpr int RP = PMAX + 1, RN = NMAX + 1, RS = TQ + 1;
  constexpr int NS = NMAX / 16, MR = TQ / 16;
  float* X = sm;
  float* Bt = X + TQ * RP;
  float* Cs = Bt + TQ * RN;
  float* DY = Cs + TQ * RN;
  float* SL = DY + TQ * RP;
  float* LD = SL + TQ * RS;
  float* cs2 = LD + TQ * RS;
  float* dts = cs2 + MAXQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = k * p.Q, grp = h / (p.H / p.G);
  const int i0 = t * TQ, ni = min(TQ, p.Q - i0);
  float u[MR] = {};   // c_i . (h_in^T dy_i), then times exp(cs_i): U_i
  const T* Xg = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh + t0 * p.x_st;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + grp * p.b_sg + t0 * p.b_st;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
  (void)SL;

  __syncthreads();  // the key role's tiles consumed
  load_tile<T, NMAX>(Cs, RN, Cg + i0 * p.c_st, p.c_st, ni, p.N, TQ);
  load_tile<float, PMAX>(DY, RP, DYg + i0 * dy_st, dy_st, ni, p.P, TQ);
  float dc[MR][NS];
  zero(dc);
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * TQ, nj = min(TQ, p.Q - j0);
    if (jt > 0) __syncthreads();  // the previous key tile consumed
    load_tile<T, PMAX>(X, RP, Xg + j0 * p.x_st, p.x_st, nj, p.P, TQ);
    load_tile<T, NMAX>(Bt, RN, Bg + j0 * p.b_st, p.b_st, nj, p.N, TQ);
    __syncthreads();
    float dd[MR][MR];
    zero(dd);
    mm_acc(dd, DY, RP, 1, X, RP, 1, p.P, ty, tx);    // D_ij = dy_i . x_j
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
      for (int s = 0; s < MR; ++s) {
        const int jl = tx + 16 * s, j = j0 + jl;
        const bool ok = i >= j && il < ni && jl < nj;
        LD[il * RS + jl] = ok ? ex2(cs2[i] - cs2[j]) * dd[r][s] * dts[j] : 0.f;
      }
    }
    __syncthreads();  // the score tile in place
    mm_acc(dc, LD, RS, 1, Bt, 1, RN, nj, ty, tx);   // sum_j (L D dt)_ij b_j
  }
  __syncthreads();  // x, b and the score tile consumed: h_in goes where x and b were

  const float* hi = bwd_h_in(p, bb, k, h);
  if (hi != nullptr) {
    float* HIN = X;   // [PMAX][RN]
    load_tile<float, NMAX>(HIN, RN, hi, p.N, p.P, p.N, PMAX);
    __syncthreads();
    float dyh[MR][NS];
    zero(dyh);
    mm_acc(dyh, DY, RP, 1, HIN, 1, RN, p.P, ty, tx);   // h_in^T dy_i
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int il = ty + 16 * r;
      const float f = ex2(cs2[i0 + il]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        u[r] = fmaf(Cs[il * RN + tx + 16 * s], dyh[r][s], u[r]);
        dc[r][s] = fmaf(f, dyh[r][s], dc[r][s]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) u[r] += __shfl_xor_sync(0xffffffffu, u[r], o);  // over tx
      u[r] *= f;
    }
  }
  const long long nrow = static_cast<long long>(p.H) * p.N;
  float* DCP = p.dcp + (static_cast<long long>(bb) * p.T + t0 + i0) * nrow + h * p.N;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int il = ty + 16 * r;
    float cd = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) cd = fmaf(Cs[il * RN + tx + 16 * s], dc[r][s], cd);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) cd += __shfl_xor_sync(0xffffffffu, cd, o);  // over tx
    if (il >= ni) continue;
    if (tx == 0) {
      const long long o = (static_cast<long long>(bb) * p.T + t0 + i0 + il) * p.H + h;
      p.rrow[o] = cd;
      p.urow[o] = u[r];
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int n = tx + 16 * s;
      if (n < p.N) DCP[il * nrow + n] = dc[r][s];
    }
  }
}

// A block per (batch, chunk, head, tile): the tile as keys, then as queries
template <typename T, int PMAX>
__global__ void __launch_bounds__(BT) ssd_bwd_chunk(const BwdParams p) {
  extern __shared__ __align__(16) float bwd_smem[];
  const int t = blockIdx.x % p.nt, h = blockIdx.x / p.nt, k = blockIdx.y, bb = blockIdx.z;
  constexpr int RP = PMAX + 1, RN = NMAX + 1, RS = TQ + 1;
  float* cs2 = bwd_smem + TQ * (2 * RP + 2 * RN) + 2 * TQ * RS;
  if (threadIdx.x < 32) bwd_cumsum(p, bb, h, k * p.Q, cs2, cs2 + MAXQ, cs2 + 2 * MAXQ,
                                   threadIdx.x);
  bwd_keys<T, PMAX>(p, bwd_smem, bb, k, h, t);
  bwd_queries<T, PMAX>(p, bwd_smem, bb, k, h, t);
}

// Each chunk's sum_i exp(cs_i) dy_i c_i^T into dhs, and cs_Q into dec;
// chunk 0's only when there is an h0 (it feeds dh0 alone)
template <typename T, int PMAX>
__global__ void __launch_bounds__(BT) ssd_bwd_states(const BwdParams p) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int RP = PMAX + 1, RN = NMAX + 1, PS = PMAX / 16, NS = NMAX / 16;
  const int h = blockIdx.x, k = blockIdx.y, bb = blockIdx.z;
  if (k == 0 && !p.has_h0) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* DYs = bwd_smem;              // [SKB][RP]: dy rows times exp(cs_i)
  float* Cs = DYs + SKB * RP;         // [SKB][RN]
  float* cs2 = Cs + SKB * RN;
  float* fac = cs2 + MAXQ;            // dt, then exp(cs_i)
  const int t0 = k * p.Q, grp = h / (p.H / p.G);
  if (tid < 32) bwd_cumsum(p, bb, h, t0, cs2, fac, nullptr, tid);
  __syncthreads();
  fac[tid] = ex2(cs2[tid]);   // MAXQ == BT
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + grp * p.c_sg + t0 * p.c_st;
  const long long dy_st = static_cast<long long>(p.H) * p.P;
  const float* DYg = p.dy + (static_cast<long long>(bb) * p.T + t0) * dy_st + h * p.P;
  float acc[PS][NS];
  zero(acc);
  for (int r0 = 0; r0 < p.Q; r0 += SKB) {
    const int nr = min(SKB, p.Q - r0);
    __syncthreads();  // the previous stage consumed (and fac in place)
    load_tile<float, PMAX>(DYs, RP, DYg + r0 * dy_st, dy_st, nr, p.P, SKB, fac + r0);
    load_tile<T, NMAX>(Cs, RN, Cg + r0 * p.c_st, p.c_st, nr, p.N, SKB);
    __syncthreads();
    mm_acc(acc, DYs, 1, RP, Cs, 1, RN, nr, ty, tx);
  }
  const long long slot = slot_of(p, bb, k, h);
  float* dst = p.dhs + slot * static_cast<long long>(p.P) * p.N;
#pragma unroll
  for (int r = 0; r < PS; ++r) {
    const int pr = ty + 16 * r;
    if (pr >= p.P) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int n = tx + 16 * s;
      if (n < p.N) dst[pr * p.N + n] = acc[r][s];
    }
  }
  if (tid == 0) p.dec[slot] = cs2[p.Q - 1];
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
  dot = block_sum(dot, red);   // (its barriers also publish cs2, dts and cds)
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
  const float wsum = block_sum(wv, red);
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
  da = block_sum(da, red);
  if (tid == 0) {
    float tsum = 0.f;   // the key tiles' sums of T_ij (cd_i - cd_j), in order
    for (int t = 0; t < p.nt; ++t) tsum += p.dAt[slot_of(p, bb, k, h) * p.nt + t];
    p.dAp[slot_of(p, bb, k, h)] = -(tsum + da + eterm * cl);
  }
}

// dB, dC: each group's heads summed in order; the last block: dA, the
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
  const int rep = p.H / p.G;
  const long long base = (bt * p.H + static_cast<long long>(g) * rep) * p.N + n;
  float sb = 0.f, sc = 0.f;
  for (int i = 0; i < rep; ++i) {
    sb += p.dbp[base + static_cast<long long>(i) * p.N];
    sc += p.dcp[base + static_cast<long long>(i) * p.N];
  }
  from_f(static_cast<T*>(p.dB) + e, sb);
  from_f(static_cast<T*>(p.dC) + e, sc);
}

template <typename T, int PMAX>
cudaError_t bwd_attributes() {
  static bool c_chunk[kMaxDevices] = {}, c_states[kMaxDevices] = {};
  cudaError_t e = allow_smem(ssd_bwd_chunk<T, PMAX>, c_chunk);
  if (e != cudaSuccess) return e;
  return allow_smem(ssd_bwd_states<T, PMAX>, c_states);
}

template <typename T, int PMAX>
cudaError_t bwd_launch(const BwdParams& p, cudaStream_t s) {
  cudaError_t e = bwd_attributes<T, PMAX>();
  if (e != cudaSuccess) return e;
  const long long pn = static_cast<long long>(p.P) * p.N;
  if (p.run_states) {
    ssd_bwd_states<T, PMAX><<<dim3(p.H, p.nc, p.B), BT,
                              sizeof(float) * states_smem_floats<PMAX>(), s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ssd_bwd_carry<<<dim3(static_cast<unsigned>((pn + 255) / 256), p.H, p.B), 256, 0, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_bwd_chunk<T, PMAX><<<dim3(p.nt * p.H, p.nc, p.B), BT,
                           sizeof(float) * chunk_smem_floats<PMAX>(), s>>>(p);
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

}  // namespace

// The backward of ssd_chunk_scan with the log-decay -dt * A.  dtype code of
// x, b, c (and of dx, dB, dC): 0 = float32, 1 = bfloat16.  dy [B, T, H, P]
// float32 contiguous; hin: each chunk's carried-in state [B, T/Q, H, P, N]
// as the forward's workspace leaves it, or with one chunk h0 (null: zero);
// dh_final [B, H, P, N] or null (zero); has_h0: chunk 0 carries an h0 in
// and dh0 [B, H, P, N] is written.  Workspace (float32): with several
// chunks or an h0, dhs B * (T/Q) * H * P * N and dec B * (T/Q) * H; always
// dbp and dcp B * T * H * N each, rrow, ddir, wst, urow B * T * H each, dAt
// B * (T/Q) * H * ceil(Q / 64) and dAp B * (T/Q) * H.  Issues ssd_bwd_states and ssd_bwd_carry (several chunks
// or an h0), then ssd_bwd_chunk, ssd_bwd_finish and ssd_bwd_reduce.
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_chunk_scan_bwd(
    int dtype, const void* x, const void* b, const void* c, const void* dt, const void* A,
    const void* hin, const void* dh_final, const void* dy, void* dx, void* dB, void* dC,
    void* ddt, void* dA, void* dh0, void* dhs, void* dec, void* dbp, void* dcp, void* rrow,
    void* ddir, void* wst, void* urow, void* dAt, void* dAp, int B, int T, int H, int G, int P,
    int N, int Q,
    int has_h0, long long x_sb, long long x_st, long long x_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dt_sb, long long dt_st, long long dt_sh, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || G <= 0 || H % G != 0) return cudaErrorInvalidValue;
  if (P <= 0 || P > 128 || P % 8 != 0 || N <= 0 || N > NMAX || N % 8 != 0)
    return cudaErrorInvalidValue;
  if (Q <= 0 || Q > MAXQ || T % Q != 0 || T / Q > 65535) return cudaErrorInvalidValue;
  BwdParams p = {};
  p.B = B; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q; p.nc = T / Q;
  p.nt = (Q + TQ - 1) / TQ;
  p.has_h0 = has_h0 != 0;
  p.run_states = p.nc > 1 || p.has_h0;
  if (static_cast<long long>(p.nt) * H > 2147483647LL) return cudaErrorInvalidValue;
  if (dt == nullptr || A == nullptr || dy == nullptr || dx == nullptr || dB == nullptr ||
      dC == nullptr || ddt == nullptr || dA == nullptr || dbp == nullptr || dcp == nullptr ||
      rrow == nullptr || ddir == nullptr || wst == nullptr || urow == nullptr ||
      dAt == nullptr || dAp == nullptr)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dispatch<float>(p, s);
  if (dtype == 1) return bwd_dispatch<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

// Blocks per SM of ssd_bwd_chunk and ssd_bwd_states (P <= 64 or <= 128) and
// their dynamic shared memory
extern "C" int ssd_chunk_bwd_occupancy(int dtype, int P, int* chunk_blocks, int* state_blocks,
                                       int* chunk_smem_bytes, int* state_smem_bytes) {
  const bool wide = P > 64;
  *chunk_smem_bytes = static_cast<int>(sizeof(float) * (wide ? chunk_smem_floats<128>()
                                                             : chunk_smem_floats<64>()));
  *state_smem_bytes = static_cast<int>(sizeof(float) * (wide ? states_smem_floats<128>()
                                                             : states_smem_floats<64>()));
  cudaError_t e;
  if (dtype == 0) {
    e = wide ? bwd_attributes<float, 128>() : bwd_attributes<float, 64>();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        chunk_blocks, wide ? ssd_bwd_chunk<float, 128> : ssd_bwd_chunk<float, 64>, BT,
        *chunk_smem_bytes);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        state_blocks, wide ? ssd_bwd_states<float, 128> : ssd_bwd_states<float, 64>, BT,
        *state_smem_bytes);
  }
  if (dtype == 1) {
    e = wide ? bwd_attributes<__nv_bfloat16, 128>() : bwd_attributes<__nv_bfloat16, 64>();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        chunk_blocks, wide ? ssd_bwd_chunk<__nv_bfloat16, 128> : ssd_bwd_chunk<__nv_bfloat16, 64>,
        BT, *chunk_smem_bytes);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        state_blocks,
        wide ? ssd_bwd_states<__nv_bfloat16, 128> : ssd_bwd_states<__nv_bfloat16, 64>, BT,
        *state_smem_bytes);
  }
  return cudaErrorInvalidValue;
}
