// RMSNorm for Hopper (sm_90a), forward and backward, plain C interface.
//
// Replaces the TPU kernel `rmsnorm_pallas` (src/repro/kernels/rmsnorm.py,
// body `_rmsnorm_kernel`) and the model's `rms_norm`
// (src/repro/models/common.py), which compute, per row of x [n, d]:
//   rstd = rsqrt(mean(x^2) + eps)          (fp32)
//   y    = (x * rstd).to(x.dtype) * gamma  (the product in x's dtype)
// The backward is the one JAX's autodiff takes through that expression:
//   g     = (dy * gamma).to(x.dtype), widened to fp32
//   dx    = rstd * (g - xh * mean(g * xh)),  xh = x * rstd in fp32
//   dgamma = sum over rows of dy * xh.to(x.dtype), in fp32
//
// What bounds it on an H100: bytes.  A row of d values takes 3 operations
// per element against 2 (forward) or 3 (backward) element reads and writes,
// far below the ~20 fp32 operations per byte where arithmetic would bind.
// What the design does about it: one block per row (forward) reads x once
// from device memory into registers, reduces in fp32 with warp shuffles,
// and writes y once; the backward keeps a row's x and dy in registers
// between its reduction and its dx.  dgamma is reduced without atomics, so
// it does not change from run to run: each backward block sums its rows'
// products into a per-block fp32 row of a [n_blocks, d] scratch, and a
// second launch from the same call sums those rows in a fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAXV = 32;       // values per thread at most: d <= NT * MAXV = 8192
constexpr int BWD_BLOCKS = 264;  // backward blocks: two per SM of an H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x's dtype round trip: the cast that the model applies before gamma
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// sum over the block; `red` holds NT / 32 floats; every thread gets the sum
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// one block per row; thread t owns columns t, t + NT, ... (V of them)
template <typename T, int V>
__global__ void __launch_bounds__(NT) rmsnorm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ y,
    float* __restrict__ rstd_out, int d, float eps) {
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float xv[V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = threadIdx.x + i * NT;
    xv[i] = c < d ? to_f(xr[c]) : 0.f;
    ss = fmaf(xv[i], xv[i], ss);
  }
  const float rstd = rsqrtf(block_sum(ss, red) / d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < d) yr[c] = from_f<T>(round_to<T>(xv[i] * rstd) * to_f(gamma[c]));
  }
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[row] = rstd;
}

// block b owns rows [b * rpb, (b + 1) * rpb); writes dx for them and its
// fp32 dgamma partial row part[b, :]
template <typename T, int V>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ dy,
    const float* __restrict__ rstd_in, T* __restrict__ dx, float* __restrict__ part,
    int n, int d, int rpb) {
  __shared__ float red[NT / 32];
  float gv[V], dg[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = threadIdx.x + i * NT;
    gv[i] = c < d ? to_f(gamma[c]) : 0.f;
    dg[i] = 0.f;
  }
  const int r0 = blockIdx.x * rpb, r1 = min(n, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * d;
    const float rstd = rstd_in[r];
    float xh[V], g[V];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = threadIdx.x + i * NT;
      xh[i] = 0.f;
      g[i] = 0.f;
      if (c < d) {
        const float dyv = to_f(dy[off + c]);
        xh[i] = to_f(x[off + c]) * rstd;
        g[i] = round_to<T>(dyv * gv[i]);
        dg[i] = fmaf(dyv, round_to<T>(xh[i]), dg[i]);
        dot = fmaf(g[i], xh[i], dot);
      }
    }
    const float mean = block_sum(dot, red) / d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = threadIdx.x + i * NT;
      if (c < d) dx[off + c] = from_f<T>(rstd * (g[i] - xh[i] * mean));
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = threadIdx.x + i * NT;
    if (c < d) part[static_cast<long long>(blockIdx.x) * d + c] = dg[i];
  }
}

// dgamma[c] = sum over b of part[b, c], in ascending b
template <typename T>
__global__ void __launch_bounds__(NT) dgamma_reduce_kernel(
    const float* __restrict__ part, T* __restrict__ dgamma, int nb, int d) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[static_cast<long long>(b) * d + c];
  dgamma[c] = from_f<T>(s);
}

template <typename T, int V>
cudaError_t fwd_v(const void* x, const void* gamma, void* y, float* rstd, int n, int d,
                  float eps, cudaStream_t s) {
  rmsnorm_fwd_kernel<T, V><<<n, NT, 0, s>>>(static_cast<const T*>(x),
                                            static_cast<const T*>(gamma),
                                            static_cast<T*>(y), rstd, d, eps);
  return cudaGetLastError();
}

// registers per thread follow the row width: 4, 8, 16 or 32 values
template <typename T>
cudaError_t fwd(const void* x, const void* gamma, void* y, float* rstd, int n, int d,
                float eps, cudaStream_t s) {
  if (d <= 4 * NT) return fwd_v<T, 4>(x, gamma, y, rstd, n, d, eps, s);
  if (d <= 8 * NT) return fwd_v<T, 8>(x, gamma, y, rstd, n, d, eps, s);
  if (d <= 16 * NT) return fwd_v<T, 16>(x, gamma, y, rstd, n, d, eps, s);
  return fwd_v<T, MAXV>(x, gamma, y, rstd, n, d, eps, s);
}

template <typename T, int V>
void bwd_v(const void* x, const void* gamma, const void* dy, const float* rstd, void* dx,
           float* part, int n, int d, int nb, int rpb, cudaStream_t s) {
  rmsnorm_bwd_kernel<T, V><<<nb, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
      rstd, static_cast<T*>(dx), part, n, d, rpb);
}

template <typename T>
cudaError_t bwd(const void* x, const void* gamma, const void* dy, const float* rstd,
                void* dx, void* dgamma, float* part, int n, int d, cudaStream_t s) {
  const int rpb = (n + BWD_BLOCKS - 1) / BWD_BLOCKS;
  const int nb = (n + rpb - 1) / rpb;
  if (d <= 4 * NT) bwd_v<T, 4>(x, gamma, dy, rstd, dx, part, n, d, nb, rpb, s);
  else if (d <= 8 * NT) bwd_v<T, 8>(x, gamma, dy, rstd, dx, part, n, d, nb, rpb, s);
  else if (d <= 16 * NT) bwd_v<T, 16>(x, gamma, dy, rstd, dx, part, n, d, nb, rpb, s);
  else bwd_v<T, MAXV>(x, gamma, dy, rstd, dx, part, n, d, nb, rpb, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dgamma_reduce_kernel<T><<<(d + NT - 1) / NT, NT, 0, s>>>(part, static_cast<T*>(dgamma),
                                                           nb, d);
  return cudaGetLastError();
}

}  // namespace

// Rows the backward's dgamma scratch needs for n rows ([result, d] fp32).
extern "C" int rmsnorm_bwd_blocks(int n) {
  if (n <= 0) return 0;
  const int rpb = (n + BWD_BLOCKS - 1) / BWD_BLOCKS;
  return (n + rpb - 1) / rpb;
}

// dtype codes: 0 = float32, 1 = bfloat16.  x, y [n, d] and gamma [d]
// contiguous in one dtype; rstd [n] fp32, or null when no backward follows.
// Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* gamma, void* y,
                           void* rstd, int n, int d, float eps, void* stream) {
  if (n <= 0 || d <= 0 || d > NT * MAXV) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return fwd<float>(x, gamma, y, r, n, d, eps, s);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, gamma, y, r, n, d, eps, s);
  return cudaErrorInvalidValue;
}

// dx [n, d] and dgamma [d] in x's dtype; part is fp32 scratch of
// [rmsnorm_bwd_blocks(n), d].  Two launches on one stream.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* gamma, const void* dy,
                           const void* rstd, void* dx, void* dgamma, void* part, int n,
                           int d, void* stream) {
  if (n <= 0 || d <= 0 || d > NT * MAXV) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  if (dtype == 0) return bwd<float>(x, gamma, dy, r, dx, dgamma, pt, n, d, s);
  if (dtype == 1) return bwd<__nv_bfloat16>(x, gamma, dy, r, dx, dgamma, pt, n, d, s);
  return cudaErrorInvalidValue;
}
