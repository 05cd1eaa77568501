// Mamba2 SSD chunked scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_kernel,
// launched by ssd_scan_bhlp through pl.pallas_call). Per (batch, head) and
// per chunk of Q rows, with x the pre-scaled input x*dt, B and C shared
// across heads, and cum the inclusive cumulative sum of dt*A within the
// chunk:
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x_s + exp(cum_t) C_t . S_prev
//   S   = exp(cum_end) S_prev + sum_s exp(cum_end - cum_s) B_s x_s^T
// with the N x P state S carried from chunk to chunk, starting at zero. It
// also writes the final state, which the reference rebuilds outside its
// kernel (src/repro/kernels/ops.py:56-61).
//
// Inputs in the model layout, contiguous: xb (B, L, H, P) and bmat/cmat
// (B, L, N) in one dtype (bf16 or fp32), dt (B, L, H) fp32, a_neg (H,) fp32.
// Outputs: y (B, L, H, P) in xb's dtype, state (B, H, N, P) fp32.
//
// Design. The TPU kernel walks the chunks on a sequential grid axis and
// keeps the state in VMEM scratch between grid steps. Blocks on a GPU run
// in no order, so here one block of 256 threads owns one (batch, head) and
// loops over the chunks itself, keeping the state in shared memory. A
// 256 x 256 fp32 C.B^T tile would not fit in shared memory, so a chunk is
// cut into 64-row sub-tiles: each query tile sums over the key tiles at or
// below the diagonal (G = C B^T masked by the decay, then G x), adds the
// inter-chunk term from the state, and stores its rows; the key tile on the
// diagonal also adds its part of the chunk's state update to registers. A
// barrier after the last query tile orders every read of S_prev before the
// state is rewritten. Entries above the causal diagonal are selected to 0,
// never multiplied (exp of a positive difference can overflow, inf * 0 is
// NaN). Ragged lengths are masked here: rows past L read as zero, take no
// part in the decay and are not stored, which equals the reference's
// padding with x = 0, dt = 0 (decay exactly 1). Q = min(chunk, L) as in
// the reference, any Q up to 256.
//
// Arithmetic: every product runs in fp32 FMAs on the CUDA cores, for both
// input dtypes (bf16 inputs are widened on their way into shared memory).
// The decay-weighted operands are fp32 and are not rounded to bf16 or TF32,
// so the state holds to 2e-4 of the plain fp32 scan. Each thread holds a
// 4 x 4 (or 4 x P/16) register tile and reads its operands from shared
// memory as float4 (transposed tiles are padded by 4 floats per row).
//
// Bound on an H100 SXM at the serving prefill this slice runs (B=8, L=2081,
// H=32, P=64, N=128, chunk 256, bf16): the useful work is C B^T once per
// batch and chunk (5.4e8 FLOP on bf16 operands, 0.5 us at the 989 TFLOP/s
// of bf16 tensor cores) and, per head, the causal G x, C S_prev and the
// state update (2.5e10 FLOP on fp32 decay-weighted operands, 0.37 ms at
// the 67 TFLOP/s of fp32 FMAs): 0.374 ms in all. The bytes (x and y 68 MB
// each, B, C, dt and the state 19 MB) take 0.046 ms at 3.35 TB/s. So the
// kernel is bound by operations. This first version
// recomputes C B^T in every head's block and computes the diagonal key
// tiles whole, about 5.1e10 FLOP, and holds one 138 KB block per SM (256
// blocks in two waves on 132 SMs); bf16 C B^T on the tensor cores
// (mma.sync, exact for bf16 operands) and C B^T shared across heads are
// the ways to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // rows of a sub-tile of the chunk
constexpr int kPad = kTile + 4;     // row of a transposed tile in shared memory, floats
constexpr int kMaxChunk = 256;      // == kThreads: one thread per row in the cumsum
constexpr int kMaxN = 128;
constexpr int kMaxRows = kMaxN / 16;  // state rows a thread owns (n = ty + 16 r)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// TN consecutive floats of shared memory (16-byte aligned for TN = 4).
template <int TN>
__device__ __forceinline__ void lds(float (&v)[TN], const float* p) {
  if constexpr (TN == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (TN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// rows x n of a (rows, n) row-major source into dst[n * kPad + row]; rows
// from `valid` to kTile are zero.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int valid, int n) {
  for (int i = threadIdx.x; i < kTile * n; i += kThreads) {
    const int row = i / n, col = i % n;
    dst[col * kPad + row] = row < valid ? widen(src[i]) : 0.f;
  }
}

// rows x P of x, rows `stride` elements apart, into dst[row * P + p].
template <typename T, int P>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int valid, size_t stride) {
  for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
    const int row = i / P, col = i % P;
    dst[i] = row < valid ? widen(src[row * stride + col]) : 0.f;
  }
}

// Inclusive prefix sum of v over the block's 256 threads.
__device__ __forceinline__ float block_cumsum(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kThreads / 32) part[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? v + part[warp - 1] : v;
}

size_t smem_floats(int n, int p) {
  return static_cast<size_t>(n) * p        // state
         + 2 * static_cast<size_t>(n) * kPad  // C and B tiles, transposed
         + static_cast<size_t>(kTile) * p  // x tile
         + static_cast<size_t>(kTile) * kPad  // masked G, transposed
         + 2 * kMaxChunk;                  // cum and exp(cum_end - cum)
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xb, const float* __restrict__ dt,
                const float* __restrict__ a_neg, const T* __restrict__ bmat,
                const T* __restrict__ cmat, T* __restrict__ y, float* __restrict__ state,
                int len_total, int heads, int n_state, int chunk) {
  constexpr int P = 16 * TN;
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                         // (N, P) carried state
  float* sC = sS + n_state * P;             // (N, kPad): C of the query tile, C[t][n] at n*kPad+t
  float* sB = sC + n_state * kPad;          // (N, kPad): B of the key tile
  float* sX = sB + n_state * kPad;          // (kTile, P): x of the key tile
  float* sG = sX + kTile * P;               // (kTile, kPad): G^T[s][t]
  float* sCum = sG + kTile * kPad;          // (kMaxChunk,) cum within the chunk
  float* sW = sCum + kMaxChunk;             // (kMaxChunk,) exp(cum_end - cum_s)
  __shared__ float sPart[kThreads / 32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = a_neg[h];
  const size_t x_stride = static_cast<size_t>(heads) * P;  // between rows of x and y

  for (int i = tid; i < n_state * P; i += kThreads) sS[i] = 0.f;

  for (int c0 = 0; c0 < len_total; c0 += chunk) {
    const int len = min(chunk, len_total - c0);  // valid rows of this chunk
    const size_t row0 = static_cast<size_t>(b) * len_total + c0;

    // cum_t = sum_{s<=t} dt_s * A over the chunk; rows past len add 0
    const float loga = tid < len ? dt[(row0 + tid) * heads + h] * a : 0.f;
    const float cum = block_cumsum(loga, sPart);
    sCum[tid] = cum;
    __syncthreads();
    const float cum_end = sCum[len - 1];
    sW[tid] = expf(cum_end - cum);

    float ds[kMaxRows][TN];  // this chunk's sum_s w_s B_s x_s^T, n = ty + 16 r, p = tx*TN + c
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) ds[r][c] = 0.f;

    for (int t0 = 0; t0 < len; t0 += kTile) {
      const int tlen = min(kTile, len - t0);
      __syncthreads();  // the last tile's readers of sC are done
      load_transposed(sC, cmat + (row0 + t0) * n_state, tlen, n_state);

      float acc[4][TN];  // y rows t0 + ty*4 + r, columns tx*TN + c
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int slen = min(kTile, len - s0);
        __syncthreads();  // the last key tile's readers of sB, sX and sG are done
        load_transposed(sB, bmat + (row0 + s0) * n_state, slen, n_state);
        load_rows<T, P>(sX, xb + (row0 + s0) * x_stride + static_cast<size_t>(h) * P, slen,
                        x_stride);
        __syncthreads();

        // G^T[s][t] = C_t . B_s for s = s0 + ty*4 + r, t = t0 + tx*4 + c
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < n_state; ++n) {
          float bv[4], cv[4];
          lds<4>(bv, sB + n * kPad + ty * 4);
          lds<4>(cv, sC + n * kPad + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(bv[r], cv[c], g[r][c]);
        }
        // causal decay, selected (never multiplied) to 0 above the diagonal
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = s0 + ty * 4 + r;
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int t = t0 + tx * 4 + c;
            o[c] = (s <= t && t < len) ? g[r][c] * expf(sCum[t] - sCum[s]) : 0.f;
          }
          *reinterpret_cast<float4*>(sG + (ty * 4 + r) * kPad + tx * 4) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();

        // y[t][p] += sum_s G^T[s][t] x[s][p] for t = t0 + ty*4 + r, p = tx*TN + c
#pragma unroll 4
        for (int s = 0; s < slen; ++s) {
          float gv[4], xv[TN];
          lds<4>(gv, sG + s * kPad + ty * 4);
          lds<TN>(xv, sX + s * P + tx * TN);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(gv[r], xv[c], acc[r][c]);
        }

        if (s0 == t0) {  // the diagonal key tile: its part of the state update
          for (int s = 0; s < slen; ++s) {
            const float w = sW[s0 + s];
            float xv[TN];
            lds<TN>(xv, sX + s * P + tx * TN);
#pragma unroll
            for (int c = 0; c < TN; ++c) xv[c] *= w;
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r) {
              const int n = ty + 16 * r;
              if (n < n_state) {
                const float bn = sB[n * kPad + s];
#pragma unroll
                for (int c = 0; c < TN; ++c) ds[r][c] = fmaf(bn, xv[c], ds[r][c]);
              }
            }
          }
        }
      }

      // inter-chunk term: y_t += exp(cum_t) C_t . S_prev
      float cs[4][TN];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) cs[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < n_state; ++n) {
        float cv[4], sv[TN];
        lds<4>(cv, sC + n * kPad + ty * 4);
        lds<TN>(sv, sS + n * P + tx * TN);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) cs[r][c] = fmaf(cv[r], sv[c], cs[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ty * 4 + r;
        if (t < tlen) {
          const float e = expf(sCum[t0 + t]);
          T* dst = y + (row0 + t0 + t) * x_stride + static_cast<size_t>(h) * P + tx * TN;
#pragma unroll
          for (int c = 0; c < TN; ++c) narrow(dst + c, acc[r][c] + e * cs[r][c]);
        }
      }
    }

    __syncthreads();  // every query tile has read S_prev
    const float decay = expf(cum_end);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int n = ty + 16 * r;
      if (n < n_state) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          float* sp = sS + n * P + tx * TN + c;
          *sp = fmaf(decay, *sp, ds[r][c]);
        }
      }
    }
    __syncthreads();  // the new state is whole before the next chunk reads it
  }

  float* out = state + (static_cast<size_t>(b) * heads + h) * n_state * P;
  for (int i = tid; i < n_state * P; i += kThreads) out[i] = sS[i];
}

template <typename T, int TN>
int launch(const void* xb, const void* dt, const void* a_neg, const void* bmat,
           const void* cmat, void* y, void* state, int batch, int len, int heads,
           int n_state, int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats(n_state, 16 * TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, TN><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(xb), static_cast<const float*>(dt),
      static_cast<const float*>(a_neg), static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<T*>(y), static_cast<float*>(state), len, heads,
      n_state, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* xb, const void* dt, const void* a_neg,
             const void* bmat, const void* cmat, void* y, void* state, int batch, int len,
             int heads, int n_state, int chunk, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 1>(xb, dt, a_neg, bmat, cmat, y, state, batch, len, heads, n_state,
                          chunk, stream);
    case 32:
      return launch<T, 2>(xb, dt, a_neg, bmat, cmat, y, state, batch, len, heads, n_state,
                          chunk, stream);
    case 64:
      return launch<T, 4>(xb, dt, a_neg, bmat, cmat, y, state, batch, len, heads, n_state,
                          chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xb (batch, len, heads, head_dim), bmat/cmat (batch, len, n_state): contiguous,
// bf16 if is_bf16 else fp32; dt (batch, len, heads) and a_neg (heads,) fp32.
// Writes y like xb and state (batch, heads, n_state, head_dim) fp32. chunk is
// the reference's min(chunk, len), 1..256; head_dim 16, 32 or 64; n_state
// 1..128. Launches on `stream` and returns the cudaError_t of the launch (0
// on success); it does not synchronise.
extern "C" int ssd_scan_forward(const void* xb, const void* dt, const void* a_neg,
                                const void* bmat, const void* cmat, void* y, void* state,
                                int batch, int len, int heads, int head_dim, int n_state,
                                int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || n_state < 1 || n_state > kMaxN || len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(head_dim, xb, dt, a_neg, bmat, cmat, y, state, batch, len,
                                   heads, n_state, chunk, st);
  return dispatch<float>(head_dim, xb, dt, a_neg, bmat, cmat, y, state, batch, len, heads,
                         n_state, chunk, st);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
