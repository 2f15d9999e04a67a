// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_chunk_pallas` (src/repro/kernels/ssd_chunk.py,
// body `_ssd_chunk_kernel`) together with the chunk loop around it that the
// JAX model runs as a `lax.scan` (`Mamba2LM._ssd_chunked`,
// src/repro/models/mamba2.py).  For one (batch, head) slice and one chunk of
// Q rows, with x [Q, P], b/c [Q, N] (the head's group), dt [Q], the
// log-decay l [Q] (l = -dt * A[head] on the model's path) and the carried
// state h0 [P, N], all in fp32:
//   cs    = cumsum(l)
//   M     = tril(c b^T * exp(cs_i - cs_j))
//   y     = (M * dt_j) x + (c * exp(cs)) h0^T
//   h_new = exp(cs_Q) h0 + (x * dt exp(cs_Q - cs))^T b
// and h_new is carried into the next chunk.
//
// What bounds it on an H100: operations.  Per (slice, chunk) the causal
// half of c b^T and of M x, the carried-state term and the state update
// take 2 Q(Q+1)/2 (N+P) + 4 Q P N operations (21 MFLOP at Q 256, P 64,
// N 128) against a few hundred KB of inputs.  This first version runs them
// as fp32 FMA tile loops from shared memory (no tensor cores), which is
// what its time will show.  What the design does:
//   * one block per (batch, head) loops over the chunks in order and keeps
//     h (P x N fp32, 32 KB at full width) in shared memory from one chunk to
//     the next: no host loop and no launch per chunk, so a prime T (Q = 1)
//     is one launch too;
//   * x [B,T,H,P], b/c [B,T,G,N] and dt [B,T,H] are read in place through
//     strides, b/c by group (g = head / (H/G)): no per-head copy of b/c and
//     no transposed copy of anything;
//   * the Q x Q matrix M is never held whole (256 KB at Q 256): query tiles
//     of 64 rows meet key tiles of 32 rows at or below the diagonal only,
//     and each element's decay exp(cs_i - cs_j) is computed in the tile and
//     only where j <= i, so it never overflows (cs falls to about -400 over
//     256 rows under strong decay, where exp(-cs_j) alone would be inf);
//   * cs is an inclusive prefix sum over the chunk by one warp (runs per
//     lane, then a shuffle scan of the run totals);
//   * each thread holds a 4-row register tile of the scores, of y and of
//     the state update, so that every value read from shared memory feeds
//     several FMAs; rows of b, c and h are padded to an odd stride, so the
//     16 rows a half-warp reads at once sit in 16 banks.
// Inputs x, b, c are fp32 or bf16; dt, l, A and h0 fp32; y and the final
// state are written in fp32, as the Pallas kernel writes them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 256;     // threads per block, seen as 16 x 16 (ty, tx)
constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 32;      // key rows per tile
constexpr int RA = BQ / 16; // query rows per thread (ty + 16 a)
constexpr int CB = BK / 16; // key columns per thread in a score tile (tx + 16 c)
constexpr int MAXQ = 256;   // chunk rows at most
constexpr int kMaxDevices = 64;

struct Params {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* l;   // log-decay, or null: then l = -dt * A[head]
  const float* A;
  const float* h0;  // [B, H, P, N], contiguous
  float* y;         // [B, T, H, P], contiguous
  float* h_out;     // [B, H, P, N], contiguous
  int B, T, H, G, P, N, Q;
  long long x_sb, x_st, x_sh;     // x strides over (b, t, head); p contiguous
  long long b_sb, b_st, b_sg;     // b strides over (b, t, group); n contiguous
  long long c_sb, c_st, c_sg;
  long long dt_sb, dt_st, dt_sh;  // dt (and l) strides over (b, t, head)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr int odd_stride(int n) { return n | 1; }

__host__ __device__ constexpr long long smem_floats(int P, int N) {
  return static_cast<long long>(P) * odd_stride(N)   // h
         + static_cast<long long>(BQ) * odd_stride(N)  // c tile
         + static_cast<long long>(BK) * odd_stride(N)  // b tile
         + static_cast<long long>(BK) * P              // x tile
         + BQ * (BK + 1)                               // scores
         + 3 * MAXQ;                                   // cs, dt, state weights
}

// one block per (head, batch row); PB = ceil(P / 16) and NB = ceil(N / 16)
// bound the register tiles (columns tx + 16 k beyond P or N are skipped)
template <typename T, int PB, int NB>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, Q = p.Q;
  const int ns = odd_stride(N);
  float* hs = smem;                    // [P][ns]   the carried state
  float* ct = hs + P * ns;             // [BQ][ns]  c rows of a query tile
  float* bt = ct + BQ * ns;            // [BK][ns]  b rows of a key tile
  float* xt = bt + BK * ns;            // [BK][P]   x rows of a key tile
  float* st = xt + BK * P;             // [BQ][BK + 1] masked, decayed scores
  float* cs = st + BQ * (BK + 1);      // [MAXQ] prefix sum of the log-decay
  float* dts = cs + MAXQ;              // [MAXQ] dt
  float* ws = dts + MAXQ;              // [MAXQ] dt * exp(cs_last - cs)

  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* X = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + g * p.c_sg;
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh;
  const float* L = p.l != nullptr ? p.l + bb * p.dt_sb + h * p.dt_sh : nullptr;
  const float rate = p.l != nullptr ? 0.f : p.A[h];
  const long long bh = static_cast<long long>(bb) * p.H + h;
  const long long y_st = static_cast<long long>(p.H) * P;
  float* Y = p.y + (static_cast<long long>(bb) * p.T * p.H + h) * P;

  for (int e = tid; e < P * N; e += NT) hs[(e / N) * ns + e % N] = p.h0[bh * P * N + e];

  for (int t0 = 0; t0 < p.T; t0 += Q) {
    __syncthreads();  // the state is written; the last chunk's tiles are consumed
    for (int i = tid; i < Q; i += NT) {
      const long long o = static_cast<long long>(t0 + i) * p.dt_st;
      const float d = DT[o];
      dts[i] = d;
      cs[i] = L != nullptr ? L[o] : -d * rate;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum: runs per lane, then the run totals
      const int per = (Q + 31) / 32, i0 = tid * per, i1 = min(Q, i0 + per);
      float run = 0.f;
      for (int i = i0; i < i1; ++i) {
        run += cs[i];
        cs[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float base = incl - run;
      for (int i = i0; i < i1; ++i) cs[i] += base;
    }
    __syncthreads();
    const float cs_last = cs[Q - 1];
    for (int i = tid; i < Q; i += NT) ws[i] = dts[i] * expf(cs_last - cs[i]);

    // ---- y, one query tile at a time ----
    for (int i0 = 0; i0 < Q; i0 += BQ) {
      __syncthreads();  // the previous query tile's c rows are consumed
      for (int e = tid; e < BQ * N; e += NT) {
        const int i = e / N, n = e % N;
        ct[i * ns + n] =
            i0 + i < Q ? to_f(Cg[static_cast<long long>(t0 + i0 + i) * p.c_st + n]) : 0.f;
      }
      __syncthreads();
      // the carried-state term: exp(cs_i) * (c_i . h_p)
      float acc[RA][PB];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int k = 0; k < PB; ++k) acc[a][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) cv[a] = ct[(ty + 16 * a) * ns + n];
#pragma unroll
        for (int k = 0; k < PB; ++k) {
          if (tx + 16 * k < P) {
            const float hv = hs[(tx + 16 * k) * ns + n];
#pragma unroll
            for (int a = 0; a < RA; ++a) acc[a][k] = fmaf(cv[a], hv, acc[a][k]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int i = i0 + ty + 16 * a;
        const float dec = i < Q ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int k = 0; k < PB; ++k) acc[a][k] *= dec;
      }
      // the intra-chunk term, key tiles at or below the diagonal only
      const int jend = min(Q, i0 + BQ);
      for (int j0 = 0; j0 < jend; j0 += BK) {
        __syncthreads();  // the previous key tile is consumed
        for (int e = tid; e < BK * N; e += NT) {
          const int j = e / N, n = e % N;
          bt[j * ns + n] =
              j0 + j < Q ? to_f(Bg[static_cast<long long>(t0 + j0 + j) * p.b_st + n]) : 0.f;
        }
        for (int e = tid; e < BK * P; e += NT) {
          const int j = e / P, q = e % P;
          xt[j * P + q] =
              j0 + j < Q ? to_f(X[static_cast<long long>(t0 + j0 + j) * p.x_st + q]) : 0.f;
        }
        __syncthreads();
        float sc[RA][CB];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int k = 0; k < CB; ++k) sc[a][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RA], bv[CB];
#pragma unroll
          for (int a = 0; a < RA; ++a) cv[a] = ct[(ty + 16 * a) * ns + n];
#pragma unroll
          for (int k = 0; k < CB; ++k) bv[k] = bt[(tx + 16 * k) * ns + n];
#pragma unroll
          for (int a = 0; a < RA; ++a)
#pragma unroll
            for (int k = 0; k < CB; ++k) sc[a][k] = fmaf(cv[a], bv[k], sc[a][k]);
        }
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int k = 0; k < CB; ++k) {
            const int j = j0 + tx + 16 * k;
            // mask before the exp: above the diagonal the decay would overflow
            const float v = (j <= i && i < Q) ? sc[a][k] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
            st[(ty + 16 * a) * (BK + 1) + tx + 16 * k] = v;
          }
        }
        __syncthreads();
        for (int j = 0; j < BK; ++j) {
          float sv[RA];
#pragma unroll
          for (int a = 0; a < RA; ++a) sv[a] = st[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
          for (int k = 0; k < PB; ++k) {
            if (tx + 16 * k < P) {
              const float xv = xt[j * P + tx + 16 * k];
#pragma unroll
              for (int a = 0; a < RA; ++a) acc[a][k] = fmaf(sv[a], xv, acc[a][k]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i < Q) {
#pragma unroll
          for (int k = 0; k < PB; ++k)
            if (tx + 16 * k < P) Y[static_cast<long long>(t0 + i) * y_st + tx + 16 * k] = acc[a][k];
        }
      }
    }

    // ---- the state update: h = exp(cs_last) h + (x * w)^T b ----
    __syncthreads();  // every query tile has read h
    const float dlast = expf(cs_last);
    float hacc[PB][NB];
#pragma unroll
    for (int a = 0; a < PB; ++a)
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int q = ty + 16 * a, n = tx + 16 * k;
        hacc[a][k] = (q < P && n < N) ? dlast * hs[q * ns + n] : 0.f;
      }
    for (int j0 = 0; j0 < Q; j0 += BK) {
      __syncthreads();  // the previous key tile is consumed
      for (int e = tid; e < BK * N; e += NT) {
        const int j = e / N, n = e % N;
        bt[j * ns + n] =
            j0 + j < Q ? to_f(Bg[static_cast<long long>(t0 + j0 + j) * p.b_st + n]) : 0.f;
      }
      for (int e = tid; e < BK * P; e += NT) {
        const int j = e / P, q = e % P;
        xt[j * P + q] = j0 + j < Q
            ? to_f(X[static_cast<long long>(t0 + j0 + j) * p.x_st + q]) * ws[j0 + j]
            : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < BK; ++j) {
        float xv[PB], bv[NB];
#pragma unroll
        for (int a = 0; a < PB; ++a) xv[a] = ty + 16 * a < P ? xt[j * P + ty + 16 * a] : 0.f;
#pragma unroll
        for (int k = 0; k < NB; ++k) bv[k] = tx + 16 * k < N ? bt[j * ns + tx + 16 * k] : 0.f;
#pragma unroll
        for (int a = 0; a < PB; ++a)
#pragma unroll
          for (int k = 0; k < NB; ++k) hacc[a][k] = fmaf(xv[a], bv[k], hacc[a][k]);
      }
    }
    // each thread writes back only the state entries it read
#pragma unroll
    for (int a = 0; a < PB; ++a)
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int q = ty + 16 * a, n = tx + 16 * k;
        if (q < P && n < N) hs[q * ns + n] = hacc[a][k];
      }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += NT) p.h_out[bh * P * N + e] = hs[(e / N) * ns + e % N];
}

template <typename T, int PB, int NB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N);
  constexpr size_t smem_max = sizeof(float) * smem_floats(16 * PB, 16 * NB);
  auto kern = ssd_scan_kernel<T, PB, NB>;
  // above 48 KB only as opted-in dynamic shared memory, set once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const dim3 grid(p.H, p.B);
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_widths(const Params& p, cudaStream_t stream) {
  // mamba2-1.3b's heads (P 64, N 128) get register tiles of their size;
  // every other width up to 128 x 128 takes the widest tiles
  if ((p.P + 15) / 16 == 4 && (p.N + 15) / 16 == 8) return launch<T, 4, 8>(p, stream);
  return launch<T, 8, 8>(p, stream);
}

}  // namespace

// dtype code of x, b, c: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 = launched).
extern "C" int ssd_chunk_scan(
    int dtype, const void* x, const void* b, const void* c, const void* dt,
    const void* l, const void* A, const void* h0, void* y, void* h_out,
    int B, int T, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_st, long long x_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dt_sb, long long dt_st, long long dt_sh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0) return cudaErrorInvalidValue;
  if (P <= 0 || P > 128 || N <= 0 || N > 128) return cudaErrorInvalidValue;
  if (Q <= 0 || Q > MAXQ || T % Q != 0) return cudaErrorInvalidValue;
  if (l == nullptr && A == nullptr) return cudaErrorInvalidValue;
  Params p;
  p.x = x; p.b = b; p.c = c;
  p.dt = static_cast<const float*>(dt);
  p.l = static_cast<const float*>(l);
  p.A = static_cast<const float*>(A);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  p.B = B; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q;
  p.x_sb = x_sb; p.x_st = x_st; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_st = b_st; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_st = c_st; p.c_sg = c_sg;
  p.dt_sb = dt_sb; p.dt_st = dt_st; p.dt_sh = dt_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_widths<float>(p, s);
  if (dtype == 1) return launch_widths<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
