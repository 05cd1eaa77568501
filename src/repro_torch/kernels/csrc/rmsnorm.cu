// RMSNorm forward and backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel, launched by rmsnorm_2d through pl.pallas_call):
//   y = x * rsqrt(mean(x^2) + eps) * gain
// over the last axis of x (R, D), with fp32 statistics and y in x's dtype.
// The forward also writes rstd = rsqrt(mean(x^2) + eps) (R,) fp32, which the
// backward reads instead of recomputing. The backward has no TPU
// counterpart (the reference differentiates its inline norm math; its
// Pallas kernel has no VJP). With x^ = x * rstd and g = gain:
//   dx    = rstd * (g * dy - x^ * mean(g * dy * x^))      (per row)
//   dgain = sum over rows of dy * x^                       (fp32)
//
// Inputs contiguous: x and dy (R, D) in one dtype (bf16 or fp32), gain (D,)
// fp32, D a multiple of 16 bytes' worth of elements (8 bf16 or 4 fp32) and
// every pointer 16-byte aligned, D at most 8192.
//
// Design. The TPU kernel takes a block of 256 rows with the whole row width
// resident in VMEM. Here one thread block owns one row at a time: each
// thread loads its 16-byte vectors of the row (a vector of 8 bf16 or 4 fp32
// values, K vectors a thread), keeps them in registers while the block sums
// the squares (warp shuffles, then one partial per warp in shared memory,
// summed in a fixed order), and writes its part of the output from the
// registers, so x is read from device memory once. The forward launches one
// block per row. The backward launches a fixed number of blocks that walk
// the rows with a grid stride; each thread keeps its columns' dgain sums in
// registers across the rows, and each block writes one row of partial sums.
// A second, small kernel adds those partial rows in a fixed order, so dgain
// is the same from run to run (no atomics).
//
// Bound on an H100 SXM. Both kernels move bytes and do little arithmetic
// (about 4 FLOP an element): at the serving prefill (R = 8 x 2081 = 16648,
// D = 896, bf16) the forward moves 60 MB (x read, y written), 18 us at
// 3.35 TB/s, against 1 us of fp32 FMAs at 67 TFLOP/s; the backward moves
// 89 MB (x and dy read, dx written). So both are bound by bytes; the
// vector loads and the single read of x are what this design does about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxD = 8192;

template <typename T>
struct Vec {};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// One 16-byte vector of T, widened to fp32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::N]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[Vec<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// N fp32 values (N a multiple of 4) as float4 loads.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float4 f = *reinterpret_cast<const float4*>(p + i);
    out[i] = f.x;
    out[i + 1] = f.y;
    out[i + 2] = f.z;
    out[i + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32), returned to every
// thread; the warps' partials are added in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();  // red is free for the next call
  return s;
}

// Thread t owns the vectors t, t + T, ..., t + (K-1) T of a row (T threads).
template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gain, T* __restrict__ y,
                   float* __restrict__ rstd, int d, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float v[K][N];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * N;
    if (c < d) {
      load_vec<T>(xr + c, v[k]);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = fmaf(v[k][i], v[k][i], ss);
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * N;
    if (c < d) {
      float g[N];
      load_f32<N>(gain + c, g);
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = v[k][i] * r * g[i];
      store_vec<T>(yr + c, v[k]);
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                   const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[32];
  float g[K][N], acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;
    if (c < d) load_f32<N>(gain + c, g[k]);
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float r = rstd[row];
    const T* xr = x + static_cast<size_t>(row) * d;
    const T* dyr = dy + static_cast<size_t>(row) * d;
    float xh[K][N], gdy[K][N];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * blockDim.x + threadIdx.x) * N;
      if (c < d) {
        float w[N];
        load_vec<T>(xr + c, xh[k]);
        load_vec<T>(dyr + c, w);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          xh[k][i] *= r;
          gdy[k][i] = g[k][i] * w[i];
          dot = fmaf(gdy[k][i], xh[k][i], dot);
          acc[k][i] = fmaf(w[i], xh[k][i], acc[k][i]);
        }
      }
    }
    const float m = block_sum(dot, red) / d;
    T* dxr = dx + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * blockDim.x + threadIdx.x) * N;
      if (c < d) {
#pragma unroll
        for (int i = 0; i < N; ++i) gdy[k][i] = r * (gdy[k][i] - xh[k][i] * m);
        store_vec<T>(dxr + c, gdy[k]);
      }
    }
  }
  float* pr = partial + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * N;
    if (c < d) store_f32<N>(pr + c, acc[k]);
  }
}

// dgain[c] = sum over b of partial[b, c], in a fixed order: a (32, 8) block
// takes 32 columns, each of its 8 rows of threads a strided eighth of the
// partial rows, then the 8 sums are added in order.
__global__ void __launch_bounds__(256)
rmsnorm_dgain_kernel(const float* __restrict__ partial, float* __restrict__ dgain, int blocks,
                     int d) {
  __shared__ float sums[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d)
    for (int b = threadIdx.y; b < blocks; b += 8) s += partial[static_cast<size_t>(b) * d + c];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += sums[i][threadIdx.x];
    dgain[c] = t;
  }
}

// Threads a block (a multiple of 32, at most kMaxThreads) and vectors a
// thread (K) for rows of d elements; 0 when d is out of range.
template <typename T>
int pick_k(int d, int* threads) {
  constexpr int N = Vec<T>::N;
  if (d < 1 || d > kMaxD || d % N) return 0;
  const int nvec = d / N;
  for (int k = 1; k <= 4; k *= 2) {
    const int t = (nvec + k - 1) / k;
    if (t <= kMaxThreads) {
      *threads = (t + 31) / 32 * 32;
      return k;
    }
  }
  return 0;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int forward(const void* x, const void* gain, void* y, void* rstd, int rows, int d, float eps,
            cudaStream_t st) {
  int threads = 0;
  const int k = pick_k<T>(d, &threads);
  if (!k) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gain);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rstd);
  if (k == 1)
    rmsnorm_fwd_kernel<T, 1><<<rows, threads, 0, st>>>(xp, gp, yp, rp, d, eps);
  else if (k == 2)
    rmsnorm_fwd_kernel<T, 2><<<rows, threads, 0, st>>>(xp, gp, yp, rp, d, eps);
  else
    rmsnorm_fwd_kernel<T, 4><<<rows, threads, 0, st>>>(xp, gp, yp, rp, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* gain, const void* rstd, const void* dy, void* dx,
             void* partial, void* dgain, int rows, int d, int blocks, cudaStream_t st) {
  int threads = 0;
  const int k = pick_k<T>(d, &threads);
  if (!k) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gain);
  const float* rp = static_cast<const float*>(rstd);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  if (k == 1)
    rmsnorm_bwd_kernel<T, 1><<<blocks, threads, 0, st>>>(xp, gp, rp, dyp, dxp, pp, rows, d);
  else if (k == 2)
    rmsnorm_bwd_kernel<T, 2><<<blocks, threads, 0, st>>>(xp, gp, rp, dyp, dxp, pp, rows, d);
  else
    rmsnorm_bwd_kernel<T, 4><<<blocks, threads, 0, st>>>(xp, gp, rp, dyp, dxp, pp, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dgain_kernel<<<(d + 31) / 32, dim3(32, 8), 0, st>>>(pp, static_cast<float*>(dgain),
                                                             blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, d), gain (d,) fp32 -> y (rows, d) in x's dtype, rstd (rows,) fp32.
extern "C" int rmsnorm_forward(const void* x, const void* gain, void* y, void* rstd, int rows,
                               int d, float eps, int is_bf16, void* stream) {
  if (rows < 1 || !aligned(x) || !aligned(gain) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return forward<__nv_bfloat16>(x, gain, y, rstd, rows, d, eps, st);
  return forward<float>(x, gain, y, rstd, rows, d, eps, st);
}

// x, dy (rows, d), gain (d,) fp32, rstd (rows,) fp32 from the forward ->
// dx (rows, d) in x's dtype, dgain (d,) fp32; partial is (blocks, d) fp32
// scratch, one row per block of the row pass.
extern "C" int rmsnorm_backward(const void* x, const void* gain, const void* rstd,
                                const void* dy, void* dx, void* partial, void* dgain, int rows,
                                int d, int blocks, int is_bf16, void* stream) {
  if (rows < 1 || blocks < 1 || !aligned(x) || !aligned(gain) || !aligned(dy) ||
      !aligned(dx) || !aligned(partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return backward<__nv_bfloat16>(x, gain, rstd, dy, dx, partial, dgain, rows, d, blocks, st);
  return backward<float>(x, gain, rstd, dy, dx, partial, dgain, rows, d, blocks, st);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
